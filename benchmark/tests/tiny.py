"""A copy of the benchmark whose mixes are cut to a few short clips, so
that a whole run takes a second on the CPU. Limits stay the real ones."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from benchmark import run
from benchmark.harness import files

CELLS = ("mel-cnn.score-b32", "feat22.classical-b256", "mel-cnn.extract-b256", "feat22.mfcc-b256")
MIX = {"classes": 3, "per_class": 3, "batch": 4, "clip_seconds": 1.0, "warm_batches": 1}
CELL = {"check_rows": 8, "trace_batches": 2}


def make(root: Path) -> Path:
    """Copy BENCHMARK.json and the benchmark under ``root``, cut to size;
    returns the copy's benchmark directory."""
    shutil.copytree(files.BENCH, root / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(files.ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    for kind, update in (("traffic", MIX), ("workloads", CELL)):
        for path in (root / "benchmark" / kind).glob("*.json"):
            path.write_text(json.dumps({**json.loads(path.read_text()), **update}))
    return root / "benchmark"


def args(cell: str, seed: int = 2_900_000_017, trace: int = 0, seconds: float = 0.3):
    return run.parse_args(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds), "--trace", str(trace)])
