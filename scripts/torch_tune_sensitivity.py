#!/usr/bin/env python3
"""How far the tuning stage's results move when their input moves by one
rounding step: the noise floor that any two implementations (or devices)
of the same computation share, on the CPU.

1. The fold-batched svm CV (``classical_core.svm_cv``): decision values of
   all rows and folds with X scaled by (1 + 1e-7 * noise), against X as it
   is, over their largest, the most of 5 seeded draws of the noise; rbf at
   400 iterations and linear at 400 and
   2000, on the data of tests/test_search_jax.py (6 x 40 x 32, 4 folds) and
   of the ``cuda`` tests (6 x 40 x 32 blobs, 4 folds), and a pca_svm cell
   (50 components, rbf, C 1) at chip_smoke.py phase 5e's size (1133 rows
   of 302 dims, 27 classes, 5 folds).
2. One epoch of a trial group (``tune_batched.TrialGroup``: the flagship
   cnn [16, 64, 64], strides 4 and 2, 4 trials at learning rates 3e-4 to
   9e-3, dropout 0, 35 steps of 32 on 1123 seeded rows of (40, 501)):
   each trial's largest parameter change over its tensor's largest entry,
   in float32 with the input moved 1e-7 and in float64 moved 1e-14.

Usage: python3 scripts/torch_tune_sensitivity.py [--skip-group]
(about 2 minutes on 8 CPU threads).
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from audio_edge_ml_pipeline_torch.train import search_cv as sc  # noqa: E402
from audio_edge_ml_pipeline_torch.train import tune_batched as tb  # noqa: E402


def perturbed(X: np.ndarray, rel: float, seed: int = 1) -> np.ndarray:
    return (X * (1 + rel * np.random.default_rng(seed).standard_normal(X.shape))).astype(X.dtype)


def svm_cv_shift(X, y, n_folds, kernel, iters, Z=None, draws: int = 5) -> float:
    """The most of max|dec(X') - dec(X)| / max|dec(X)| over ``draws`` X'
    = X moved 1e-7 (the per-fold PCA features, when ``Z`` components)."""
    fold_of = sc.stratified_fold_ids(y, n_folds, seed=0)
    n_classes = int(y.max()) + 1
    engine = sc._CVEngine(X, y.astype(np.int32), fold_of, n_classes, device="cpu")
    cell = {"C": 1.0, "kernel": kernel, "iters": iters}
    Zt = None if Z is None else engine.pca_features({"n_components": Z})
    base = engine.svm_decisions(cell, Zt)
    worst = 0.0
    for seed in range(1, draws + 1):
        if Zt is None:
            moved = sc._CVEngine(perturbed(X, 1e-7, seed), y.astype(np.int32), fold_of, n_classes,
                                 device="cpu").svm_decisions(cell)
        else:
            moved = engine.svm_decisions(cell, torch.from_numpy(perturbed(Zt.numpy(), 1e-7, seed)))
        worst = max(worst, float(np.abs(moved - base).max() / np.abs(base).max()))
    return worst


def search_jax_fixture():
    K, per, D = 6, 40, 32
    rng = np.random.default_rng(5)
    means = rng.standard_normal((K, D)) * 0.8
    X = np.concatenate([means[k] + rng.standard_normal((per, D)) for k in range(K)]).astype(np.float32)
    y = np.repeat(np.arange(K), per).astype(np.int64)
    perm = rng.permutation(len(X))
    return X[perm], y[perm]


def cuda_blobs():
    rng = np.random.default_rng(3)
    means = rng.standard_normal((6, 32)) * 1.2
    y = np.repeat(np.arange(6), 40).astype(np.int64)
    return (means[y] + rng.standard_normal((len(y), 32))).astype(np.float32), y


def fsc22_classical_fit():
    """chip_smoke.py's 5d/5e classical rows after the shipped 70 % train and
    the CLI's 20 % validation splits."""
    import chip_smoke

    X_fit, y_fit, _, _ = chip_smoke.fsc22_classical(np.random.default_rng(22))
    return X_fit, y_fit.astype(np.int64)


def group_shift(dtype: torch.dtype, rel: float) -> list[float]:
    arch = {"type": "cnn", "filters": [16, 64, 64], "dropout": 0.0, "n_classes": 27, "first_stride": 4,
            "second_stride": 2, "input_shape": [40, 501, 1]}
    rng = np.random.default_rng(0)
    n = 1123
    y = rng.integers(0, 27, n)
    X = rng.standard_normal((n, 40, 501, 1)) * 0.5
    for c in range(27):
        X[y == c, c % 40, :, 0] += 1.0
    X = (X - X.mean()) / X.std()
    states = tb.init_states(arch, 4, seed=42)
    idx = np.random.default_rng(42).permutation(n)[: (n // 32) * 32].reshape(-1, 32)
    groups = []
    for x in (X, X * (1 + rel * rng.standard_normal(X.shape))):
        g = tb.TrialGroup(arch, states, [3e-4, 1e-3, 3e-3, 9e-3], [0.0] * 4, "cpu", dtype, noise_seeds=range(4))
        g.epoch(torch.from_numpy(x).to(dtype), torch.from_numpy(y), idx)
        groups.append(g)
    a, b = groups
    return [max(float((b.params[k].detach()[t] - a.params[k].detach()[t]).abs().max() / a.params[k].detach()[t].abs().max())
                for k in a.params) for t in range(4)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--skip-group", action="store_true", help="only the svm CV part")
    args = ap.parse_args()
    for label, (X, y), n_folds in (("tests/test_search_jax.py fixture", search_jax_fixture(), 4),
                                   ("cuda-test blobs", cuda_blobs(), 4)):
        for kernel, iters in (("rbf", 400), ("linear", 400), ("linear", 2000)):
            print(f"svm_cv {label}, {kernel}, {iters} iterations: decisions move "
                  f"{svm_cv_shift(X, y, n_folds, kernel, iters):.3e} of their largest under a 1e-7 input change")
    X, y = fsc22_classical_fit()
    print(f"svm_cv pca_svm cell at phase 5e's size ({len(X)} rows, 50 components, rbf, C 1, 400 iterations): "
          f"decisions move {svm_cv_shift(X, y, 5, 'rbf', 400, Z=50):.3e} under a 1e-7 change of the features")
    if not args.skip_group:
        for dtype, rel in ((torch.float32, 1e-7), (torch.float64, 1e-14)):
            shifts = group_shift(dtype, rel)
            print(f"trial group, one epoch in {str(dtype).split('.')[-1]}, input moved {rel:g}: each trial's "
                  f"largest parameter change over its tensor's largest "
                  + ", ".join(f"lr {lr:g} {v:.3e}" for lr, v in zip((3e-4, 1e-3, 3e-3, 9e-3), shifts)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
