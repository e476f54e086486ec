"""Run one cell of the port's benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout on a machine with the cards the cell asks for.
The cell (``workloads/<cell>.json``) names its configuration
(``configs/``) and traffic mix (``traffic/``); the mix names its generator
and the program entry it drives (``entries/``); every metric that
``BENCHMARK.json`` lists for the cell is read by ``metrics/<metric>.py``.
With ``--trace 0`` the line holds the end-to-end metrics, with ``--trace
1`` the per-layer ones, read from a profiler trace of the window's first
batches. After the window a sample of the outputs that reached the host,
drawn from the seed, is held to the reference; ``checks`` gives each
number compared beside its limit.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from dataclasses import dataclass  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark.harness import files, judge, trace  # noqa: E402

HOST_THREADS = 2   # the window issues from one thread; the reference's products need few
FORBIDDEN = ("jax", "jaxlib", "flax", "audio_edge_ml_pipeline_tpu")   # top-level module names, compared whole


@dataclass
class Run:
    """One run of a cell: its result line and what the check compared."""
    result: dict
    lines: list[str]    # the check lines for standard error
    entry: object       # the cell's entry: its reference, control and numbers
    clips: np.ndarray   # the sampled clips, on the host
    outs: np.ndarray    # the window's outputs for them
    ref: np.ndarray     # the reference's outputs for them
    setup: dict         # seconds of the set-up's parts


@dataclass
class Context:
    """What the metric readers read."""
    cell: dict
    config: dict
    mix: dict
    setup_s: float
    window: object
    trace: trace.Summary | None = None
    trace_batches: int = 0


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def load_cell(name: str, bench: Path = files.BENCH, root: Path = files.ROOT) -> tuple[dict, dict, dict, dict]:
    """(BENCHMARK.json, the cell, its configuration, its mix); the cell
    file must agree with its entry in BENCHMARK.json."""
    spec = files.spec(root)
    listed = {w["name"]: w for w in spec["workloads"]}
    if name not in listed:
        raise KeyError(f"{name!r} is not a cell of BENCHMARK.json: {sorted(listed)}")
    cell = files.load_json("workloads", name, bench)
    for key in ("config", "traffic", "chips"):
        if cell[key] != listed[name][key]:
            raise ValueError(f"{name}: {key} is {cell[key]!r} in its file and {listed[name][key]!r} in BENCHMARK.json")
    return spec, cell, files.load_json("configs", cell["config"], bench), files.load_json("traffic", cell["traffic"],
                                                                                          bench)


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def build_kernels(config: dict, device: torch.device) -> float:
    """Build the program's native libraries that the configuration names
    (``libraries``) before anything runs; the seconds the compilers took,
    0 where every one was built already (a checkout's later runs)."""
    if device.type != "cuda" or not config.get("libraries"):
        return 0.0
    from audio_edge_ml_pipeline_torch.ops import _build

    t = time.perf_counter()
    built = _build.build(list(config["libraries"]))
    return time.perf_counter() - t if built else 0.0


def prepare(name: str, seed: int, device: torch.device, bench: Path = files.BENCH, root: Path = files.ROOT):
    """(BENCHMARK.json, the cell, its configuration, its mix, the entry, the
    traffic with its pool made, the build's seconds): a cell's set-up before
    its warm-up."""
    spec, cell, config, mix = load_cell(name, bench, root)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(HOST_THREADS)
    build_s = build_kernels(config, device)
    entry = files.load_module("entries", mix["entry"], bench).build(config, mix, seed, device)
    traffic = files.load_module("traffic", mix["generator"], bench).Traffic(mix, config, seed, device)
    return spec, cell, config, mix, entry, traffic, build_s


def run_cell(args: argparse.Namespace, device: torch.device, t0: float, bench: Path = files.BENCH,
             root: Path = files.ROOT) -> Run:
    """One run of the cell on ``device`` (cuda:0 of the cell's ``chips``
    cards, or the CPU)."""
    t_start = time.perf_counter()
    spec, cell, config, mix, entry, traffic, build_s = prepare(args.workload, args.seed, device, bench, root)
    cuda = device.type == "cuda"
    chips = int(cell["chips"])
    cards = [torch.device("cuda", k) for k in range(chips)] if cuda else []
    t_prepared = time.perf_counter()
    traffic.warm(entry)
    prof = None
    if args.trace:
        prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]
                                      + ([torch.profiler.ProfilerActivity.CUDA] if cuda else []))
        prof.start()
    for card in cards:
        torch.cuda.synchronize(card)
        torch.cuda.reset_peak_memory_stats(card)
    sampler = judge.Sampler(int(cell["check_rows"]), args.seed)
    setup_s = time.perf_counter() - t0
    setup = {"imports": t_start - t0, "build": build_s, "entry_and_pool": t_prepared - t_start - build_s,
             "warm_up": setup_s - (t_prepared - t0)}
    window = traffic.run(entry, args.seconds, sampler, prof, int(cell["trace_batches"]))
    memory_peak = max((torch.cuda.max_memory_allocated(card) for card in cards), default=0)   # the fullest card

    ctx = Context(cell, config, mix, setup_s, window)
    if prof is not None:
        with tempfile.TemporaryDirectory(prefix="benchmark-trace-") as tmp:
            path = Path(tmp) / "trace.json"
            prof.export_chrome_trace(str(path))
            ctx.trace = trace.summarize(path, cards=chips)
        ctx.trace_batches = min(int(cell["trace_batches"]), window.batches)
        del prof

    picks = [(i, r) for i, r, _ in sampler.rows]
    outs = np.stack([row for _, _, row in sampler.rows])
    clips = traffic.clips(picks)
    del traffic
    if cuda:
        torch.cuda.empty_cache()
    ref = entry.reference(clips)
    numbers = entry.numbers(outs, ref)
    ok, checks = judge.verdict(numbers, cell["limits"])
    failed = window.batches - sum(window.finite)

    group = "per_layer" if args.trace else "end_to_end"
    metrics = {}
    for m in files.cell_metrics(spec, args.workload, group):
        value = files.load_module("metrics", m["name"], bench).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else device.type, "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": chips, "memory_peak_bytes": int(memory_peak), "build_s": build_s}
    if ctx.trace is not None:
        dev.update(busy_s=ctx.trace.busy_s, window_s=ctx.trace.window_s)
    result = {"correct": bool(ok and failed == 0 and window.batches > 0), "attempted": window.batches,
              "failed": failed, "metrics": metrics, "device": dev}
    if ctx.trace is not None:
        result["breakdown"] = ctx.trace.breakdown()
    checks["failed_batches"] = {"value": failed, "limit": 0}
    result["checks"] = checks
    lines = [f"check {k}: {c['value']!r} limit {c['limit']!r}" for k, c in checks.items()]
    return Run(result, lines, entry, clips, outs, ref, setup)


def main(argv=None) -> int:
    args = parse_args(argv)
    _, cell, _, _ = load_cell(args.workload)
    chips = int(cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        seen = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {chips} CUDA card(s); {seen} visible", file=sys.stderr)
        return 2
    run = run_cell(args, torch.device("cuda", 0), T0)
    found = forbidden_modules()
    if found:
        print(f"the run loaded {found}: the benchmark measures the PyTorch port alone", file=sys.stderr)
        return 3
    print(json.dumps(run.result))
    sys.stdout.flush()
    print("setup: " + ", ".join(f"{k} {v:.3f} s" for k, v in run.setup.items()), file=sys.stderr)
    print("\n".join(run.lines), file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
