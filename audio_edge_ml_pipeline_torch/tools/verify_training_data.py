"""Load a FeatureSet exactly as the training CLI does (split, class filter)
and inspect the resulting batches (role of reference
scripts/verify_training_data.py + diagnose_training.py).

The port's counterpart of the repository's
``scripts/verify_training_data.py``, on the port's ``apply_class_filter``
and ``stratified_train_val_split``. Host only.

Usage: python -m audio_edge_ml_pipeline_torch.tools.verify_training_data <featureset dir>
           [--val-split 0.2] [--classes A B ...]
"""

from __future__ import annotations

import argparse

import numpy as np

from ..features.pipeline import FeaturePipeline
from ..train.train import apply_class_filter, stratified_train_val_split


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("features_dir")
    ap.add_argument("--val-split", type=float, default=0.2)
    ap.add_argument("--classes", nargs="+", default=None)
    args = ap.parse_args(argv)

    fs = FeaturePipeline.load(args.features_dir)
    X, y, names = fs.features, fs.labels, fs.label_names or []
    print(fs)
    if args.classes:
        X, y, names = apply_class_filter(X, y, names, args.classes)
        print(f"after class_filter: {len(X)} samples, classes {names}")
    X_train, X_val, y_train, y_val = stratified_train_val_split(X, y, args.val_split)
    print(f"train: {X_train.shape}  val: {X_val.shape}")
    print(f"train label counts: {np.bincount(y_train, minlength=len(names)).tolist()}")
    print(f"val   label counts: {np.bincount(y_val, minlength=len(names)).tolist()}")
    batch = X_train[:32]
    print(f"first batch: shape {batch.shape} range [{batch.min():.4f}, {batch.max():.4f}]")
    assert np.isfinite(batch).all(), "non-finite values in training batch!"
    print("OK: batches are finite and stratified.")


if __name__ == "__main__":
    main()
