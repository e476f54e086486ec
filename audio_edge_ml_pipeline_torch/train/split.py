"""Train/validation splits and stratified folds, without scikit-learn.

The JAX package splits with ``sklearn.model_selection.train_test_split`` and
``StratifiedKFold``. The port runs where scikit-learn is not installed, so it
carries the same algorithms here, drawing from the same
``np.random.RandomState(seed)`` in the same order: for a given seed both
packages pick the same rows (tests/test_torch_train.py holds them equal).
"""

from __future__ import annotations

import math

import numpy as np


def _approximate_mode(class_counts: np.ndarray, n_draws: int, rng: np.random.RandomState) -> np.ndarray:
    """Per-class draws nearest the multivariate hypergeometric mode, ties
    broken at random (sklearn.utils.extmath._approximate_mode)."""
    continuous = class_counts / class_counts.sum() * n_draws
    floored = np.floor(continuous)
    need_to_add = int(n_draws - floored.sum())
    if need_to_add > 0:
        remainder = continuous - floored
        for value in np.sort(np.unique(remainder))[::-1]:
            (inds,) = np.where(remainder == value)
            add_now = min(len(inds), need_to_add)
            inds = rng.choice(inds, size=add_now, replace=False)
            floored[inds] += 1
            need_to_add -= add_now
            if need_to_add == 0:
                break
    return floored.astype(int)


def split_indices(n: int, test_size: float, seed: int, stratify: np.ndarray | None = None):
    """(train_idx, test_idx) of ``train_test_split(..., test_size, random_state=seed,
    stratify=stratify)`` for a float ``test_size`` in (0, 1).

    Raises ValueError where sklearn does: a class with one member, or fewer
    train or test rows than classes, when stratifying."""
    if not 0.0 < test_size < 1.0:
        raise ValueError(f"test_size={test_size} should be a float in the (0, 1) range")
    n_test = math.ceil(test_size * n)
    n_train = n - n_test
    if n_train == 0:
        raise ValueError(f"with n_samples={n} and test_size={test_size} the train set would be empty")
    rng = np.random.RandomState(seed)
    if stratify is None:
        perm = rng.permutation(n)
        return perm[n_test : n_test + n_train], perm[:n_test]

    classes, y_indices, class_counts = np.unique(np.asarray(stratify), return_inverse=True, return_counts=True)
    if class_counts.min() < 2:
        raise ValueError(f"the least populated classes {classes[class_counts < 2].tolist()} have only 1 member")
    if n_train < len(classes) or n_test < len(classes):
        raise ValueError(f"train ({n_train}) and test ({n_test}) sizes must each cover the {len(classes)} classes")
    class_indices = np.split(np.argsort(y_indices, kind="stable"), np.cumsum(class_counts)[:-1])
    n_i = _approximate_mode(class_counts, n_train, rng)
    t_i = _approximate_mode(class_counts - n_i, n_test, rng)
    train: list = []
    test: list = []
    for i in range(len(classes)):
        perm = class_indices[i].take(rng.permutation(class_counts[i]), mode="clip")
        train.extend(perm[: n_i[i]])
        test.extend(perm[n_i[i] : n_i[i] + t_i[i]])
    return rng.permutation(train), rng.permutation(test)


def stratified_kfold(y: np.ndarray, n_splits: int, seed: int):
    """The (train_idx, test_idx) pairs of ``StratifiedKFold(n_splits,
    shuffle=True, random_state=seed).split(X, y)``."""
    y = np.asarray(y)
    _, y_idx, y_inv = np.unique(y, return_index=True, return_inverse=True)
    # classes numbered by first appearance, as sklearn does
    _, class_perm = np.unique(y_idx, return_inverse=True)
    y_encoded = class_perm[y_inv]
    n_classes = len(y_idx)
    counts = np.bincount(y_encoded)
    if np.all(n_splits > counts):
        raise ValueError(f"n_splits={n_splits} cannot be greater than the number of members in each class")
    rng = np.random.RandomState(seed)
    y_order = np.sort(y_encoded)
    allocation = np.asarray([np.bincount(y_order[i::n_splits], minlength=n_classes) for i in range(n_splits)])
    test_folds = np.empty(len(y), dtype="i")
    for k in range(n_classes):
        folds_for_class = np.arange(n_splits).repeat(allocation[:, k])
        rng.shuffle(folds_for_class)
        test_folds[y_encoded == k] = folds_for_class
    indices = np.arange(len(y))
    return [(indices[test_folds != i], indices[test_folds == i]) for i in range(n_splits)]
