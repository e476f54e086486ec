"""Readings that a cell's limits are set from (not run by the benchmark's
own runs).

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,... [--control-seeds 1,2,3] [--seconds 2]

For each seed, in one process: a run of the cell as ``run.py`` makes it,
with a short window, and the numbers that decide ``correct`` (the lower
readings). For each control seed, the same sample's control (the reference
one precision below the configuration's) judged by the same numbers (the
upper readings); for the scoring entry also the program itself with TF32
allowed. One JSON line per reading.
``--whole-pool`` judges every clip of each seed's pool, one at a time, and
prints the worst (a look at what crossed a limit).
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark import run  # noqa: E402
from benchmark.harness import files  # noqa: E402


def readings(cell_name: str, seed: int, seconds: float, control: bool, device: torch.device,
             bench: Path = files.BENCH, root: Path = files.ROOT) -> list[dict]:
    t = time.perf_counter()
    args = run.parse_args(["--workload", cell_name, "--seed", str(seed), "--seconds", str(seconds), "--trace", "0"])
    done = run.run_cell(args, device, t, bench, root)
    entry = done.entry
    base = {"cell": cell_name, "seed": seed, "batches": done.result["attempted"], "rows": len(done.clips),
            "correct": done.result["correct"], "run_s": time.perf_counter() - t,
            **{k: m["value"] for k, m in done.result["metrics"].items()}}
    out = [{**base, "side": "program", **{k: c["value"] for k, c in done.result["checks"].items()}}]
    if control:
        out.append({**base, "side": "control", **entry.numbers(entry.control(done.clips, device), done.ref)})
        if run.load_cell(cell_name, bench, root)[3]["entry"] == "flagship_score" and device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = True
            torch.backends.cudnn.allow_tf32 = True
            with torch.inference_mode():
                tf32 = entry(torch.from_numpy(done.clips).to(device)).cpu().numpy()
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
            out.append({**base, "side": "program_tf32", **entry.numbers(tf32, done.ref)})
    return out


def whole_pool(cell_name: str, seed: int, device: torch.device, top: int = 8, bench: Path = files.BENCH,
               root: Path = files.ROOT) -> list[dict]:
    """Every clip of the seed's pool through the entry, each judged alone:
    the clips with the largest numbers, and for each the value whose gap
    over max(|reference|, 1) is largest (where a limit was crossed, what
    crossed it)."""
    _, _, _, _, entry, traffic, _ = run.prepare(cell_name, seed, device, bench, root)
    batches = -(-traffic.n_clips // traffic.batch)
    with torch.inference_mode():
        outs = np.concatenate([np.asarray(torch.as_tensor(entry(traffic.waves(i))).cpu())
                               for i in range(batches)])[:traffic.n_clips]
    clips = traffic.clips([(0, r) for r in range(traffic.n_clips)])
    found = []
    for i in range(traffic.n_clips):
        ref = entry.reference(clips[i:i + 1])
        rel = (np.abs(outs[i:i + 1].astype(np.float64) - ref) / np.maximum(np.abs(ref), 1.0)).reshape(-1)
        k = int(rel.argmax())
        found.append({"cell": cell_name, "seed": seed, "clip": i, **entry.numbers(outs[i:i + 1], ref),
                      "worst_index": k, "worst_rel_gap": float(rel[k]), "program": float(outs[i].reshape(-1)[k]),
                      "reference": float(ref.reshape(-1)[k])})
    key = next(k for k in found[0] if k.endswith("_gap") and k != "worst_rel_gap")
    return sorted(found, key=lambda r: -r["worst_rel_gap"])[:top] + sorted(found, key=lambda r: -r[key])[:1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--whole-pool", action="store_true", help="judge every clip of each seed's pool instead")
    args = p.parse_args(argv)
    device = torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")
    if args.whole_pool:
        for seed in [int(s) for s in args.seeds.split(",")]:
            for r in whole_pool(args.workload, seed, device):
                print(json.dumps(r), flush=True)
        return 0
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in [int(s) for s in args.seeds.split(",")]:
        for r in readings(args.workload, seed, args.seconds, seed in controls, device):
            print(json.dumps(r), flush=True)
    print(f"calibrate {args.workload}: {time.perf_counter() - T0:.1f} s", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
