"""Fold-batched grid search for the classical models of the classical core.

Counterpart of the JAX package's ``train/search_jax.py``: in place of
GridSearchCV's process pool, every CV fold of a grid cell runs as ONE batch
on the device:

- the fold split is encoded as weight vectors ``w (F, N)`` over a single
  resident ``X``: no per-fold data copies, no host loop;
- for ``svm``, the F folds x P pairs of a cell are one batch of QPs for the
  pair-batched dual solver (``classical_core.svm_cv``), one captured CUDA
  graph a cell on a card;
- for ``pca_*``, the per-fold scaler + PCA bases come from one batched
  sqrt(w)-weighted Gram eigendecomposition, computed once per
  ``n_components`` and kept on the device for every cell that shares it;
- the OvO fold layout depends only on (y, folds): it is built and placed on
  the device once per search.

With ``devices`` > 1 the fold axis splits over min(devices, cards, folds)
cards, as JAX shards it (``parallel/mesh.py::part_devices``; a list of
devices names them outright): each part holds X and its folds' weights and
OvO layout on its card and runs the cell's program there (the svm's solve a
captured CUDA graph on that card), every part issued before any is
fetched, and the decisions are concatenated in fold order. On the CPU, or
with one card, the folds run as one part.
"""

from __future__ import annotations

import itertools
import logging
import numpy as np
import torch

from ..models import classical_core as cc
from ..models.registry import get_model
from ..utils.device import resolve_device
from .evaluate import f1_macro

logger = logging.getLogger(__name__)

# models this engine tunes on the device; the trees stay on sklearn
DEVICE_TUNABLE = {"svm", "lda", "knn", "pca_svm", "pca_lda", "pca_knn"}

_DEFAULT_ITERS = 400  # dual-solver steps per CV fit (refit uses the trainer default)

# grid keys each family's CV program actually consumes (+ no-op keys the
# trainers accept for sklearn-grid compatibility). Anything else is a typo
# or an unsupported knob and must fail loudly: a silently-ignored key would
# score every cell identically and pick an arbitrary winner.
_SVM_KEYS = {"C", "kernel", "gamma", "iters"}
_GRID_KEYS = {
    "svm": _SVM_KEYS,
    # sklearn's `shrinkage` changes LDA's covariance estimate (and so its
    # predictions); the closed-form core does not implement it, so it is
    # rejected. n_components / solver never affect sklearn LDA classification.
    "lda": {"n_components", "solver"},
    "knn": {"n_neighbors", "metric"},
    # grids use `n_components` for every pca_* pipeline; `n_components_pca`
    # is accepted too, where the trainer names its knob that way
    "pca_svm": _SVM_KEYS | {"n_components"},
    "pca_lda": {"n_components", "n_components_pca", "n_components_lda", "solver"},
    "pca_knn": {"n_components", "n_neighbors", "metric"},
}
_SVM_KERNELS = ("rbf", "linear")
_KNN_METRICS = ("minkowski", "euclidean", "cosine")


def validate_grid(model_name: str, param_grid: dict) -> None:
    """Reject unknown grid keys and unsupported kernel/metric values BEFORE
    any device work (the batched programs would otherwise fall through to
    their default formulation and mis-score the cell)."""
    allowed = _GRID_KEYS[model_name]
    unknown = set(param_grid) - allowed
    if unknown:
        raise ValueError(
            f"unknown grid key(s) {sorted(unknown)} for {model_name!r}; "
            f"supported: {sorted(allowed)}"
        )
    for kern in param_grid.get("kernel", ()):
        if kern not in _SVM_KERNELS:
            raise ValueError(f"svm kernel must be one of {_SVM_KERNELS}, got {kern!r}")
    for metric in param_grid.get("metric", ()):
        if metric not in _KNN_METRICS:
            raise ValueError(f"knn metric must be one of {_KNN_METRICS}, got {metric!r}")
    for gamma in param_grid.get("gamma", ()):
        if gamma in ("scale", "auto"):
            continue
        try:
            float(gamma)
        except (TypeError, ValueError):
            raise ValueError(
                f"svm gamma must be 'scale', 'auto', or numeric, got {gamma!r}"
            ) from None


def stratified_fold_ids(y: np.ndarray, cv: int, seed: int = 42) -> np.ndarray:
    """Per-sample fold assignment: shuffle within each class, deal
    round-robin; stratified like sklearn's StratifiedKFold(shuffle=True).
    Draws from ``np.random.default_rng(seed)`` as JAX does: the same folds."""
    rng = np.random.default_rng(seed)
    fold_of = np.empty(len(y), np.int32)
    for c in np.unique(y):
        idx = np.flatnonzero(y == c)
        rng.shuffle(idx)
        fold_of[idx] = np.arange(len(idx)) % cv
    return fold_of


def _expand_grid(param_grid: dict) -> list[dict]:
    if not param_grid:
        return [{}]
    keys = sorted(param_grid)
    return [dict(zip(keys, combo)) for combo in itertools.product(*(param_grid[k] for k in keys))]


def _score(y_true: np.ndarray, y_pred: np.ndarray, scoring: str) -> float:
    """sklearn's ``f1_score(average="macro", zero_division=0)`` (over the
    classes present in y_true or y_pred) or ``accuracy_score``, in numpy."""
    if scoring in ("f1_macro", "f1"):
        return f1_macro(y_true, y_pred)
    if scoring == "accuracy":
        return float((np.asarray(y_true) == np.asarray(y_pred)).mean())
    raise ValueError(f"unsupported scoring {scoring!r} (f1_macro | accuracy)")


def _fold_ovo_arrays(y: np.ndarray, fold_of: np.ndarray, n_classes: int):
    """Per-fold padded OvO layouts over the SAME sample space. Returns
    (pairs, idx[F,P,M], ypm[F,P,M], cw[F,P,M]) where cw holds the UNIT-C box
    bounds: balanced class weights computed per fold (sklearn fits
    class_weight on each fold's data); a cell's bounds are ``C * cw``."""
    cv = int(fold_of.max()) + 1
    per_fold = []
    M = 0
    for f in range(cv):
        tr = np.flatnonzero(fold_of != f)
        pairs, idx_l, ypm_l = cc._ovo_layout(y[tr], n_classes)
        per_fold.append((tr, pairs, idx_l, ypm_l))
        M = max(M, idx_l.shape[1])
    P = per_fold[0][1].shape[0]
    idx = np.zeros((cv, P, M), np.int32)
    ypm = np.zeros((cv, P, M), np.float32)
    cw = np.zeros((cv, P, M), np.float32)
    pairs = per_fold[0][1]
    for f, (tr, _, idx_l, ypm_l) in enumerate(per_fold):
        m = idx_l.shape[1]
        idx[f, :, :m] = tr[idx_l]  # local -> global sample indices
        ypm[f, :, :m] = ypm_l
        counts = np.bincount(y[tr], minlength=n_classes).astype(np.float64)
        w = len(tr) / (n_classes * np.maximum(counts, 1))
        cw[f, :, :m] = np.where(ypm_l > 0, w[pairs[:, 0]][:, None],
                                np.where(ypm_l < 0, w[pairs[:, 1]][:, None], 0.0))
    return pairs, idx, ypm, cw


class _FoldPart:
    """The folds ``folds`` of a CV engine on one device: X, their weights and
    the labels' one-hot placed there once; the OvO layout and the PCA
    features cached there."""

    def __init__(self, engine: "_CVEngine", folds: np.ndarray, device: torch.device) -> None:
        self.folds, self.device = folds, device
        self.X = cc._tensor(engine.X, device)
        self.W = cc._tensor(engine.W[folds], device)
        self.onehot = cc._tensor(np.eye(engine.n_classes, dtype=np.float32)[engine.y], device)
        self.pca: dict[int, torch.Tensor] = {}   # ncomp -> its folds' Z (f, N, k)
        self.ovo = None   # (idx, ypm) of its folds


class _CVEngine:
    """Evaluates one grid cell for one model family, fold-batched, on
    ``device``, or with the folds split over ``devices`` (a count or a
    list; module docstring). ``X`` and the fold weights are placed once."""

    def __init__(self, X: np.ndarray, y: np.ndarray, fold_of: np.ndarray,
                 n_classes: int, device=None, devices=1):
        from ..parallel.mesh import part_devices, split_parts

        self.device = resolve_device(device)
        self.X = np.asarray(X, np.float32)
        self.y = np.asarray(y, np.int32)
        self.fold_of = fold_of
        self.cv = int(fold_of.max()) + 1
        self.n_classes = n_classes
        self.W = np.stack([(fold_of != f) for f in range(self.cv)]).astype(np.float32)
        devs = part_devices(devices, self.device, self.cv)
        self.parts = [_FoldPart(self, folds, d) for folds, d in zip(split_parts(self.cv, len(devs)), devs)]
        self.device = self.parts[0].device
        self._ovo = None  # cached (pairs, cw): C-independent; each part keeps its folds' idx / ypm

    # -- per-family cell evaluation (returns per-fold val scores) ---------

    def _per_fold_scores(self, class_scores: np.ndarray, scoring: str) -> list[float]:
        """class_scores (F, N, K): argmax prediction scored on each fold's
        own validation rows."""
        out = []
        for f in range(self.cv):
            val = self.fold_of == f
            out.append(_score(self.y[val], class_scores[f, val].argmax(-1), scoring))
        return out

    def _ovo_cached(self):
        """(pairs, cw): the OvO fold layout depends only on (y, folds), so it
        is built, and each part's folds' idx / ypm placed on its device, ONCE
        per search, not per cell."""
        if self._ovo is None:
            pairs, idx, ypm, cw = _fold_ovo_arrays(self.y, self.fold_of, self.n_classes)
            for part in self.parts:
                part.ovo = (cc._tensor(idx[part.folds], part.device, torch.int64),
                            cc._tensor(ypm[part.folds], part.device))
            self._ovo = (pairs, cw)
        return self._ovo

    def _parts_of(self, Z) -> list:
        """Per-fold features as one entry a part: None (the shared X), a list
        (one a part, as ``_pca_parts`` gives), or one (F, N, k) tensor, cut
        by each part's folds onto its device."""
        if Z is None or isinstance(Z, (list, tuple)):
            return [None] * len(self.parts) if Z is None else list(Z)
        if len(self.parts) == 1:
            return [Z]
        return [Z[torch.as_tensor(p.folds, device=Z.device)].to(p.device) for p in self.parts]

    @staticmethod
    def _fetch(outs: list[torch.Tensor]) -> np.ndarray:
        """The parts' results on the host in fold order: every part was
        issued before this first fetch."""
        return np.concatenate([cc._np(o) for o in outs])

    def svm_decisions(self, cell: dict, Z=None) -> np.ndarray:
        """The cell's fold-batched decision values (F, N, P) on the host."""
        C = float(cell.get("C", 1.0))
        kernel = str(cell.get("kernel", "rbf"))
        if kernel not in _SVM_KERNELS:
            raise ValueError(f"svm kernel must be one of {_SVM_KERNELS}, got {kernel!r}")
        gamma = cell.get("gamma", "scale")
        gamma_mode, gval = (str(gamma), 0.0) if gamma in ("scale", "auto") else ("value", float(np.float32(gamma)))
        _, cw = self._ovo_cached()
        # honor a gridded solver budget: a pinned _DEFAULT_ITERS would score
        # every iters cell identically and pick an arbitrary winner
        iters = int(cell.get("iters", _DEFAULT_ITERS))
        outs = []
        for part, Zp in zip(self.parts, self._parts_of(Z)):
            u = cc._tensor((C * cw[part.folds]).astype(np.float32), part.device)
            idx, ypm = part.ovo
            outs.append(cc.svm_cv(part.X if Zp is None else Zp, part.W, idx, ypm, u, gval, kernel, gamma_mode,
                                  iters))
        return self._fetch(outs)

    def eval_svm(self, cell: dict, scoring: str, Z=None) -> list[float]:
        dec = self.svm_decisions(cell, Z)  # (F, N, P)
        pairs = self._ovo_cached()[0]
        scores = []
        for f in range(self.cv):
            val = self.fold_of == f
            votes = cc.ovo_vote(dec[f, val], pairs, self.n_classes)
            scores.append(_score(self.y[val], votes.argmax(1), scoring))
        return scores

    def eval_lda(self, cell: dict, scoring: str, Z=None) -> list[float]:
        outs = [cc.lda_cv(part.X if Zp is None else Zp, part.onehot, part.W)
                for part, Zp in zip(self.parts, self._parts_of(Z))]
        return self._per_fold_scores(self._fetch(outs), scoring)

    def eval_knn(self, cell: dict, scoring: str, Z=None) -> list[float]:
        n_neighbors = int(cell.get("n_neighbors", 5))
        metric = str(cell.get("metric", "minkowski"))
        if metric not in _KNN_METRICS:
            raise ValueError(f"knn metric must be one of {_KNN_METRICS}, got {metric!r}")
        min_fold = int(self.W.sum(1).min()) or 1
        outs = [cc.knn_cv(part.X if Zp is None else Zp, part.W, part.onehot, min(n_neighbors, min_fold), metric)
                for part, Zp in zip(self.parts, self._parts_of(Z))]
        return self._per_fold_scores(self._fetch(outs), scoring)

    def _pca_parts(self, cell: dict) -> list[torch.Tensor]:
        """Each part's per-fold PCA features (f, N, k) of a pca_* cell,
        computed once per n_components and kept on its device for the cells
        sharing it."""
        # n_components_pca is the pca_lda trainer's knob name; honor it here too
        ncomp = int(cell.get("n_components_pca", cell.get("n_components", 50)))
        ncomp = min(ncomp, self.X.shape[1], int(self.W.sum(1).min()))
        for part in self.parts:
            if ncomp not in part.pca:
                part.pca[ncomp] = cc.pca_cv(part.X, part.W, ncomp)
        return [part.pca[ncomp] for part in self.parts]

    def pca_features(self, cell: dict) -> torch.Tensor:
        """The per-fold PCA features (F, N, k) of a pca_* cell: the cached
        tensor with one part, else the parts' gathered on the first part's
        device."""
        zs = self._pca_parts(cell)
        return zs[0] if len(zs) == 1 else torch.cat([z.to(self.device) for z in zs])

    def eval_cell(self, model_name: str, cell: dict, scoring: str) -> list[float]:
        Z = self._pca_parts(cell) if model_name.startswith("pca_") else None
        tail = model_name.split("_")[-1]
        if tail == "svm":
            return self.eval_svm(cell, scoring, Z)
        if tail == "lda":
            return self.eval_lda(cell, scoring, Z)
        if tail == "knn":
            return self.eval_knn(cell, scoring, Z)
        raise ValueError(f"unsupported model {model_name!r}")


def grid_search_cv_device(model_name: str, param_grid: dict, X, y, cv: int = 5,
                          scoring: str = "f1_macro", seed: int = 42, devices=1, device=None):
    """Fold-batched grid search over the classical core's models on
    ``device`` (the first CUDA card unless the caller passes
    ``device="cpu"``), the folds split over ``devices`` (a count or a list;
    module docstring). Returns (best_trainer, best_params, best_score), the
    contract of search.grid_search_cv, with the best cell refit on ALL of
    (X, y) by its trainer on ``device``."""
    if model_name not in DEVICE_TUNABLE:
        raise ValueError(f"{model_name!r} is not tunable on the device; use search.grid_search_cv")
    device = resolve_device(device)
    validate_grid(model_name, param_grid or {})
    X = np.asarray(X, np.float32)
    y = np.asarray(y, np.int64)
    n_classes = int(y.max()) + 1
    fold_of = stratified_fold_ids(y, cv, seed)
    engine = _CVEngine(X, y, fold_of, n_classes, device=device, devices=devices)
    if len(engine.parts) > 1:
        logger.info("[grid-device %s] %d folds split over %d devices", model_name, cv, len(engine.parts))

    best_cell, best_score = None, -np.inf
    for cell in _expand_grid(param_grid):
        mean = float(np.mean(engine.eval_cell(model_name, cell, scoring)))
        logger.info("[grid-device %s] %s -> %s=%.4f", model_name, cell or "(defaults)", scoring, mean)
        if mean > best_score:
            best_cell, best_score = cell, mean

    trainer = get_model(model_name)(**best_cell, device=device)
    trainer._fit_body(X, np.asarray(y, np.int32), n_classes)
    return trainer, dict(best_cell), best_score
