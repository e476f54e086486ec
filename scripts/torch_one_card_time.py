#!/usr/bin/env python3
"""Time the port's one-card extraction, train step and trial epoch, in one tree.

Imports audio_edge_ml_pipeline_torch from ``--repo`` (default: this
checkout) and times, on the first card, the paths that the data-parallel
layer runs through when there is one card:

- the extraction CLI (``features.pipeline``, ``audio_mel_spec``, split all)
  on an fsc22-sized tree of 27 x 75 five-second 16 kHz clips, written once
  into ``--work`` by ``chip_smoke.write_fsc22_tree`` (host clock, each run);
- one host batch of 256 clips through the extractor's ``_device_batch``
  (host clock, synchronised);
- the flagship CNN's train step at B=32 and B=512, dropout 0.3, called as
  ``fit`` calls it (with the fit's dropout-noise source where the tree's
  ``train_step`` takes one; CUDA events over 20 steps);
- one epoch of a 4-trial cnn ``TrialGroup`` on 1024 rows at batch 32,
  learning rates 3e-4 to 9e-3, at dropout 0.3 and at 0, built as
  ``train_trial_group`` builds it (each trial's masks from its own
  generator where the tree's ``TrialGroup`` takes seeds; host clock).

TF32 is off. Prints one JSON line: the tree, the card and its power limit,
and the times. To compare two trees on one card, run them in turns in one
command, a parent unpacked with ``git archive`` beside this checkout:

    python3 scripts/torch_one_card_time.py --repo build/parent   # then this tree, this tree, the parent
"""

from __future__ import annotations

import argparse
import importlib.util
import inspect
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parents[1]


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--repo", type=Path, default=HERE, help="the tree whose port is timed")
    parser.add_argument("--work", type=Path, default=HERE / "build" / "one_card_time",
                        help="where the clip tree is written (reused when it is there)")
    parser.add_argument("--runs", type=int, default=3, help="extraction CLI runs")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(args.repo.resolve()))
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    from audio_edge_ml_pipeline_torch.features import get, pipeline
    from audio_edge_ml_pipeline_torch.models.deep import CNNTrainer
    from audio_edge_ml_pipeline_torch.train import tune_batched

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    out: dict = {"repo": str(args.repo)}

    tree = args.work / "fsc22"
    if not tree.exists():
        chip_smoke.write_fsc22_tree(tree, dev, chip_smoke.FSC22_CLIPS)
    extract_s = []
    for i in range(args.runs):
        t0 = time.perf_counter()
        pipeline.main(["--loader", "fsc22", "--dataset", str(tree), "--extractor", "audio_mel_spec", "--split", "all",
                       "--output", str(args.work / f"features_{i}")])
        torch.cuda.synchronize()
        extract_s.append(time.perf_counter() - t0)
    out["extract_2025_clips_s"] = extract_s

    ext = get("audio_mel_spec")(device=dev)
    waves = np.tile(chip_smoke.synth_clips(np.random.default_rng(0), 8), (32, 1))   # (256, 80000) on the host
    out["device_batch_256_ms"] = chip_smoke.host_ms(lambda: ext._device_batch(waves, None), reps=10)

    try:   # the fit's dropout noise, where the tree has one
        from audio_edge_ml_pipeline_torch.utils.dropout import GlobalBatchNoise
    except ImportError:
        GlobalBatchNoise = None
    for b in (32, 512):
        tr = CNNTrainer(**chip_smoke.CNN_PARAMS, batch_size=b, dropout=0.3, device=dev)
        Xb = np.random.default_rng(b).random((b, chip_smoke.N_MELS, 1 + chip_smoke.CLIP // chip_smoke.HOP, 1),
                                            dtype=np.float32)
        tr.prepare_fit(Xb, chip_smoke.N_CLASSES)
        tr._net.train()
        opt = torch.optim.Adam(tr._net.parameters(), lr=1e-3)
        X_d = torch.from_numpy(Xb).to(dev)
        y_d = torch.from_numpy(np.arange(b) % chip_smoke.N_CLASSES).to(dev)
        idx, w = torch.arange(b, device=dev), torch.ones(b, device=dev)
        kw = {}
        if GlobalBatchNoise is not None and "noise" in inspect.signature(tr.train_step).parameters:
            kw["noise"] = GlobalBatchNoise(torch.Generator(dev).manual_seed(0))
        out[f"train_step_b{b}_ms"] = chip_smoke.cuda_ms(lambda: tr.train_step(opt, X_d, y_d, idx, w, **kw), iters=20)
        out[f"train_step_b{b}_noise_source"] = bool(kw)

    n, k, bs = 1024, 4, 32
    rng = np.random.default_rng(42)
    X = rng.standard_normal((n, 1 + chip_smoke.CLIP // chip_smoke.HOP, chip_smoke.N_MELS, 1)).astype(np.float32)
    y = rng.integers(0, chip_smoke.N_CLASSES, n)
    X_d, y_d = torch.from_numpy(X).to(dev), torch.from_numpy(y).to(dev)
    idx = rng.permutation(n).reshape(-1, bs)
    arch = {"type": "cnn", **chip_smoke.CNN_PARAMS, "dropout": 0.0, "n_classes": chip_smoke.N_CLASSES,
            "input_shape": list(X.shape[1:])}
    states = tune_batched.init_states(arch, k, 42)
    seeded = "noise_seeds" in inspect.signature(tune_batched.TrialGroup).parameters
    for rate in (0.3, 0.0):
        def epoch(rate=rate):
            kw = {"noise_seeds": [43 + i for i in range(k)]} if seeded else {}
            g = tune_batched.TrialGroup(arch, states, [3e-4, 1e-3, 3e-3, 9e-3], [rate] * k, dev, **kw)
            return g.epoch(X_d, y_d, idx)
        out[f"trial_epoch_k4_dropout{rate:g}_ms"] = chip_smoke.host_ms(epoch, reps=3)
    out["trial_group_seeded"] = seeded
    out["card"] = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                                 capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
