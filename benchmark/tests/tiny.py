"""A copy of the benchmark whose mixes are cut to a few short clips, so
that a whole run takes a second on the CPU. Limits stay the real ones."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from benchmark import run
from benchmark.harness import files

LISTED = ("mel-cnn.score-b32", "feat22.classical-b256", "mel-cnn.extract-b256", "feat22.mfcc-b256")
# Built but held out of BENCHMARK.json (its runs spread more than half the
# bounds; PERF.md §7): the tests run it in a copy that lists it, under the
# per-layer metrics it would report.
HELD_OUT = {"mel-cnn.extract-4card": ("mel_roofline", "device_idle", "issue_ms")}
CELLS = LISTED + tuple(HELD_OUT)
MIX = {"classes": 3, "per_class": 3, "batch": 4, "clip_seconds": 1.0, "warm_batches": 1}
CELL = {"check_rows": 8, "trace_batches": 2}


def copy(root: Path) -> Path:
    """Copy BENCHMARK.json, with the held-out cells listed, and the
    benchmark under ``root`` at full size; returns the copy's benchmark
    directory."""
    shutil.copytree(files.BENCH, root / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    spec = files.spec()
    for name, metrics in HELD_OUT.items():
        cell = files.load_json("workloads", name)
        spec["workloads"].append({k: cell[k] for k in ("name", "config", "traffic", "chips", "why")})
        for m in spec["per_layer"]:
            if m["name"] in metrics:
                m["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root / "benchmark"


def make(root: Path) -> Path:
    """``copy``, its mixes and cells cut to size."""
    bench = copy(root)
    for kind, update in (("traffic", MIX), ("workloads", CELL)):
        for path in (bench / kind).glob("*.json"):
            path.write_text(json.dumps({**json.loads(path.read_text()), **update}))
    return bench


def args(cell: str, seed: int = 2_900_000_017, trace: int = 0, seconds: float = 0.3):
    return run.parse_args(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds), "--trace", str(trace)])
