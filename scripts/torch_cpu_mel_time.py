#!/usr/bin/env python3
"""CPU time of the port's mel feature: ``mel_kernel.mel_spec_feature`` on a
CPU tensor (the kernel's plain version, then the dB and min-max epilogue),
which is what ``audio_mel_spec`` extraction runs a batch with ``--device cpu``.

It imports the package from ``--repo``, so that two checkouts can be timed
on one host in turns:

    python3 scripts/torch_cpu_mel_time.py [--repo DIR] [--batch 64] [--iters 20]

Prints one JSON line: the host's CPU count, torch's thread count, the shape,
and the median and each ms of a call.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
from pathlib import Path

import numpy as np


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repo", default=str(Path(__file__).resolve().parents[1]), help="checkout to import from")
    ap.add_argument("--batch", type=int, default=64, help="clips of 5 s at 16 kHz")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    sys.path.insert(0, str(Path(args.repo).resolve()))
    import torch

    from audio_edge_ml_pipeline_torch.ops import mel_kernel

    y = torch.from_numpy((0.3 * np.random.default_rng(args.seed).standard_normal((args.batch, 80000)))
                         .astype(np.float32))
    mel_kernel.mel_spec_feature(y)  # warm-up: tables and allocator
    ms = []
    for _ in range(args.iters):
        t0 = time.perf_counter()
        mel_kernel.mel_spec_feature(y)
        ms.append(1e3 * (time.perf_counter() - t0))
    print(json.dumps({"repo": args.repo, "cpus": os.cpu_count(), "torch_threads": torch.get_num_threads(),
                      "shape": [args.batch, 80000], "median_ms": statistics.median(ms), "ms": ms}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
