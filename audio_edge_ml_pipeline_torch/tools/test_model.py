"""Manual inference sanity check: load a saved model and run it on N random
samples from a FeatureSet (role of reference scripts/test_model.py).

The port's counterpart of the repository's ``scripts/test_model.py``: the
same seeded rows and printout, the bundle loaded by the port's
``load_trainer_any`` on the first CUDA card, or on ``--device`` (without a
card and without ``--device`` it raises). The module keeps the script's
name; pytest collects only ``tests/``, so it is not taken for a test.

Usage: python -m audio_edge_ml_pipeline_torch.tools.test_model <model file> <featureset dir>
           [--n 10] [--model-name cnn] [--device cuda:0|cpu]
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from ..features.pipeline import FeaturePipeline
from ..optimize.quantize import load_trainer_any


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("model")
    ap.add_argument("features_dir")
    ap.add_argument("--n", type=int, default=10)
    ap.add_argument("--model-name", default="cnn", help="registry name when loading classical files")
    ap.add_argument("--device", default=None, help="torch device (default: the first CUDA card)")
    args = ap.parse_args(argv)

    trainer = load_trainer_any(Path(args.model), args.model_name, device=args.device)
    fs = FeaturePipeline.load(args.features_dir)
    rng = np.random.default_rng(0)
    idx = rng.choice(len(fs.features), size=min(args.n, len(fs.features)), replace=False)
    preds = trainer.predict(fs.features[idx])
    proba = trainer.predict_proba(fs.features[idx])
    names = fs.label_names or [str(i) for i in range(int(preds.max()) + 1)]
    correct = 0
    for j, i in enumerate(idx):
        true = names[fs.labels[i]] if fs.labels is not None else "?"
        pred = names[preds[j]] if preds[j] < len(names) else str(preds[j])
        conf = f"{proba[j].max():.3f}" if proba is not None else "n/a"
        mark = "OK " if true == pred else "BAD"
        correct += int(true == pred)
        print(f"[{mark}] sample {i}: true={true:<20} pred={pred:<20} conf={conf}")
    print(f"{correct}/{len(idx)} correct")


if __name__ == "__main__":
    main()
