"""Dry-run the training input path and report anything that would hurt
training: batch shapes, normalization stats, degenerate features, class
leakage between train/val (role of reference scripts/diagnose_training.py).

The port's counterpart of the repository's ``scripts/diagnose_training.py``,
on the port's ``FeaturePipeline.load`` and ``stratified_train_val_split``
(the train CLI's split). Host only.

Usage: python -m audio_edge_ml_pipeline_torch.tools.diagnose_training <featureset dir> [--val-split 0.2]
"""

from __future__ import annotations

import argparse

import numpy as np

from ..features.pipeline import FeaturePipeline
from ..train.train import stratified_train_val_split


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("features_dir")
    ap.add_argument("--val-split", type=float, default=0.2)
    args = ap.parse_args(argv)
    fs = FeaturePipeline.load(args.features_dir)
    X, y = fs.features, fs.labels
    print(fs)
    issues = 0
    if y is None:
        print("ISSUE: no labels — supervised training will fail")
        return
    X_train, X_val, y_train, y_val = stratified_train_val_split(X, y, args.val_split)
    mean = X_train.mean(axis=0)
    var = X_train.var(axis=0)
    dead = int((var.ravel() < 1e-12).sum())
    print(f"normalization stats: mean range [{mean.min():.4f}, {mean.max():.4f}], "
          f"var range [{var.min():.2e}, {var.max():.4f}]")
    if dead:
        print(f"ISSUE: {dead} constant feature dims (zero variance) — normalization will null them")
        issues += 1
    if not np.isfinite(X).all():
        print("ISSUE: non-finite feature values")
        issues += 1
    # duplicate rows across train/val = leakage
    tr_hash = {h.tobytes() for h in np.ascontiguousarray(X_train.reshape(len(X_train), -1))[:2000]}
    dup = sum(1 for h in np.ascontiguousarray(X_val.reshape(len(X_val), -1)) if h.tobytes() in tr_hash)
    if dup:
        print(f"ISSUE: {dup} validation rows identical to training rows (leakage)")
        issues += 1
    missing_val = set(np.unique(y_train)) - set(np.unique(y_val))
    if missing_val:
        print(f"note: classes absent from val split: {sorted(missing_val)}")
    print("OK — no blocking issues found" if not issues else f"{issues} issue(s) found")


if __name__ == "__main__":
    main()
