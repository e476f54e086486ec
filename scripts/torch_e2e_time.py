#!/usr/bin/env python3
"""Time the port's flagship forward, waveform -> mel -> CNN, in one tree.

Imports audio_edge_ml_pipeline_torch from ``--repo`` (default: this
checkout), builds its kernels there, and times ``entry.flagship()``'s
forward and its mel kernel alone on B five-second fsc22-like clips at 16
kHz (chip_smoke.synth_clips, seed 0) with CUDA events, TF32 off; then the
mel kernel at n_fft 400 on the same clips, and its float64 instantiation
(what the MFCC features launch) at 22.05 kHz, n_fft 1024, hop 512, 128
mels. Prints one JSON line: the tree, the card and its power limit, and
the times in ms.

To compare two trees on one card, run them in turns in one command, for
example a parent unpacked with ``git archive`` beside this checkout:

    python3 scripts/torch_e2e_time.py --repo build/parent   # then this tree, this tree, the parent
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parents[1]


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--repo", type=Path, default=HERE, help="the tree whose port is timed")
    parser.add_argument("--batch", type=int, default=512)
    parser.add_argument("--iters", type=int, default=20)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    sys.path.insert(0, str(args.repo.resolve()))
    from audio_edge_ml_pipeline_torch.entry import flagship
    from audio_edge_ml_pipeline_torch.models.deep import CNNTrainer
    from audio_edge_ml_pipeline_torch.ops import mel_kernel

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    waves = torch.from_numpy(np.tile(chip_smoke.synth_clips(np.random.default_rng(0), 8),
                                     (args.batch // 8, 1))).to(dev)
    trainer = CNNTrainer(filters=[16, 64, 64], first_stride=4, second_stride=2, device=dev)
    trainer.initialize((40, 501, 1), 27, torch.Generator().manual_seed(0))
    module, forward = flagship()
    module.to(dev)
    params = dict(trainer._net.state_dict())
    waves22 = torch.from_numpy(np.tile(chip_smoke.synth_clips(np.random.default_rng(1), 8, 5 * 22050, 22050),
                                       (args.batch // 8, 1))).to(dev)
    with torch.inference_mode():
        ms_e2e = chip_smoke.cuda_ms(lambda: forward(params, waves), iters=args.iters)
        ms_mel = chip_smoke.cuda_ms(lambda: mel_kernel.mel_power_folded(waves), iters=args.iters)
        ms_400 = chip_smoke.cuda_ms(lambda: mel_kernel.mel_power_folded(waves, n_fft=400), iters=args.iters)
        ms_mfcc = chip_smoke.cuda_ms(lambda: mel_kernel.mel_power_folded(waves22, 22050, 128, 1024, 512, precise=True),
                                     iters=args.iters)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({"repo": str(args.repo), "card": card, "batch": args.batch, "e2e_ms": ms_e2e,
                      "mel_kernel_ms": ms_mel, "mel_kernel_400_ms": ms_400, "mel_kernel_f64_mfcc_ms": ms_mfcc}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
