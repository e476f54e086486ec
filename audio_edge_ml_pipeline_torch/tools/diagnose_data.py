"""Inspect a FeatureSet directory: label distribution, shapes, value ranges,
NaN/Inf screening (role of reference scripts/diagnose_data.py).

The port's counterpart of the repository's ``scripts/diagnose_data.py``,
printing the same report from the port's ``FeaturePipeline.load``. Host only.

Usage: python -m audio_edge_ml_pipeline_torch.tools.diagnose_data <featureset dir>
"""

from __future__ import annotations

import argparse

import numpy as np

from ..features.pipeline import FeaturePipeline


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("features_dir")
    args = ap.parse_args(argv)
    fs = FeaturePipeline.load(args.features_dir)
    print(fs)
    X = fs.features
    print(f"dtype={X.dtype}  min={X.min():.4f}  max={X.max():.4f}  mean={X.mean():.4f}  std={X.std():.4f}")
    n_nan, n_inf = int(np.isnan(X).sum()), int(np.isinf(X).sum())
    print(f"NaN: {n_nan}  Inf: {n_inf}" + ("  <-- PROBLEM" if n_nan or n_inf else ""))
    if fs.labels is not None:
        counts = np.bincount(fs.labels, minlength=fs.n_classes or 0)
        print("label distribution:")
        for i, name in enumerate(fs.label_names or map(str, range(len(counts)))):
            bar = "#" * int(40 * counts[i] / max(counts.max(), 1))
            print(f"  {name:<24} {counts[i]:>5}  {bar}")
        if counts.min() == 0:
            print("WARNING: empty classes present")
        elif counts.max() / max(counts.min(), 1) > 3:
            print("WARNING: class imbalance > 3x")


if __name__ == "__main__":
    main()
