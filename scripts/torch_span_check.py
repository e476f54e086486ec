#!/usr/bin/env python3
"""Check the port's spans (``utils/profiling.py::span``) in the benchmark's
cells on a card, and time a span's cost.

For each cell: its set-up and warm-up as ``benchmark/run.py`` makes them,
then ``--batches`` batches through the cell's traffic under a
``torch.profiler`` (CPU and CUDA), each issued as ``closed_batches`` issues
a traced batch and timed by its own pair of CUDA events. Then, from the spans
that ``take_spans`` returns and the profiler's chrome trace:

- ``self_sum_rel``: the largest gap, over the batches, between the sum of
  the device-clock self times under a root span and that root's interval,
  over the interval;
- ``roots_inside``: how many root spans lie on the device's clock inside
  their batch's CUDA-event interval, and the median share of the batch
  that the root covers;
- ``cnn_vs_kernels`` (where a ``cnn`` span runs): the least, over the
  batches, of the ``cnn`` span's device ms less the device time of the
  kernels, copies and sets launched inside its ``aep.cnn`` range;
- the top-10 idle gaps of the window, each with the innermost host event
  (the name ``benchmark/harness/trace.py`` gives it), the innermost
  ``aep.*`` range and the innermost ``benchmark.*`` range around it;
- each span's median device and host self ms, and the root spans'
  ``cudaMalloc`` count.

Last, the cost of one span's enter and exit on this host with no profiler
and under a CPU-and-CUDA profiler, and of its parts (``span_cost``). One JSON line
each on standard output.

    python3 scripts/torch_span_check.py [--cells mel-cnn.score-b32,...] [--batches 200] [--seed 7]
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmark import run  # noqa: E402
from benchmark.harness import trace  # noqa: E402

CELLS = ("mel-cnn.score-b32", "mel-cnn.extract-b256", "feat22.classical-b256", "feat22.mfcc-b256")


def _launched_inside(events: list[dict], name: str) -> list[float]:
    """Per ``name`` range of the trace, in order: the device ms of the
    kernels, copies and sets whose launch lies inside it."""
    ranges = sorted((e for e in events if e.get("cat") == "user_annotation" and e["name"] == name),
                    key=lambda e: e["ts"])
    launches = [e for e in events if e.get("cat") == "cuda_runtime" and "correlation" in e.get("args", {})]
    device = {}
    for e in events:
        if e.get("cat") in trace.DEVICE_CATS and "correlation" in e.get("args", {}):
            device[e["args"]["correlation"]] = device.get(e["args"]["correlation"], 0.0) + e["dur"] * 1e-3
    out = []
    for r in ranges:
        inside = [e["args"]["correlation"] for e in launches
                  if e["tid"] == r["tid"] and r["ts"] <= e["ts"] <= r["ts"] + r["dur"]]
        out.append(sum(device.get(c, 0.0) for c in inside))
    return out


def _gaps(events: list[dict], n: int = 10) -> list[list]:
    """The ``n`` longest idle gaps of the device inside the extent of the
    ``benchmark.batch`` ranges: [ms, the innermost host event as
    ``benchmark/harness/trace.py`` names it, the innermost ``aep.*`` range,
    the innermost ``benchmark.*`` range] (None where there is none)."""
    batches = [e for e in events if e.get("cat") == "user_annotation" and e["name"] == "benchmark.batch"]
    t0, t1 = min(e["ts"] for e in batches), max(e["ts"] + e["dur"] for e in batches)
    busy = trace.union([(e["ts"], e["ts"] + e["dur"]) for e in events if e.get("cat") in trace.DEVICE_CATS])
    busy = [(max(a, t0), min(b, t1)) for a, b in busy if b > t0 and a < t1]
    edges = [t0, *[x for ab in busy for x in ab], t1]
    gaps = sorted(((a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a), key=lambda g: g[0] - g[1])[:n]
    host = [e for e in events if e.get("cat") in trace.HOST_CATS]

    def innermost(t: float, prefix: str | None) -> str | None:
        hits = [e for e in host if e["ts"] <= t < e["ts"] + e["dur"]
                and (prefix is None or (e.get("cat") == "user_annotation" and e["name"].startswith(prefix)))]
        return min(hits, key=lambda e: e["dur"])["name"] if hits else None

    return [[(b - a) * 1e-3, innermost((a + b) / 2, None), innermost((a + b) / 2, "aep."),
             innermost((a + b) / 2, "benchmark.")] for a, b in gaps]


def check_cell(name: str, seed: int, batches: int, device: torch.device) -> dict:
    from torch.profiler import record_function

    from audio_edge_ml_pipeline_torch.utils import profiling

    _, _, _, _, entry, traffic, _ = run.prepare(name, seed, device)
    traffic.warm(entry)
    profiling.clear_spans()
    sums = torch.empty(batches, device=device)
    pairs = []
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                              torch.profiler.ProfilerActivity.CUDA])
    prof.start()
    with torch.inference_mode():
        for i in range(batches):   # as closed_batches runs a traced batch, with a new pair of events each
            with record_function("benchmark.batch"):
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                traffic._issue(entry, i, sums, lambda: record_function("benchmark.entry"))
                end.record()
                end.synchronize()
            pairs.append((start, end))
    prof.stop()
    records = profiling.take_spans()
    with tempfile.TemporaryDirectory(prefix="span-check-") as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = [e for e in json.loads(path.read_text())["traceEvents"] if e.get("ph") == "X" and "dur" in e]
    roots = [r for r in records if r.parent is None]
    under = {r.id: [s for s in records if s.root == r.id] for r in roots}
    self_gap = max(abs(sum(s.device_self_ms for s in under[r.id]) - r.device_ms) / r.device_ms for r in roots)
    inside, shares = 0, []
    for r, (start, end) in zip(roots, pairs):
        a, b = start.elapsed_time(r.events[0]), r.events[1].elapsed_time(end)
        inside += a >= 0 and b >= 0
        shares.append(r.device_ms / start.elapsed_time(end))
    by_name: dict[str, dict[str, list]] = {}
    for s in records:
        t = by_name.setdefault(s.name, {"device": [], "host": []})
        t["device"].append(s.device_self_ms)
        t["host"].append(s.host_self_ms)
    out = {"cell": name, "seed": seed, "batches": len(roots), "self_sum_rel": self_gap,
           "roots_inside": [inside, len(roots)], "root_share_median": statistics.median(shares),
           "spans": {k: {"calls": len(v["device"]), "device_self_ms": statistics.median(v["device"]),
                         "host_self_ms": statistics.median(v["host"])} for k, v in by_name.items()},
           "mallocs": sum(r.mallocs for r in roots), "idle_gaps": _gaps(events), "dropped": profiling.STORE.dropped}
    cnn = [s for s in records if s.name == "cnn"]
    if cnn:
        kernels = _launched_inside(events, "aep.cnn")
        out["cnn_vs_kernels"] = {"ranges": len(kernels), "spans": len(cnn),
                                 "least_ms": min(s.device_ms - k for s, k in zip(cnn, kernels)),
                                 "median_kernel_ms": statistics.median(kernels),
                                 "median_cnn_ms": statistics.median(s.device_ms for s in cnn)}
    return out


def span_cost(n: int = 200_000, m: int = 2000) -> dict:
    """µs of one ``with span("x"): pass`` with no profiler (``off_us``), and
    under a CPU-and-CUDA profiler as a root (``on_root_us``) and as a child
    (``on_child_us``); and, under that profiler, of the parts a span on a
    card adds: its ``record_function``, a pair of CUDA timing events
    recorded, the capture check, one read of the allocator's count."""
    from torch.profiler import record_function

    from audio_edge_ml_pipeline_torch.utils import profiling

    def per(k: int, body) -> float:
        t = time.perf_counter()
        for _ in range(k):
            body()
        return (time.perf_counter() - t) / k * 1e6

    def root():
        with profiling.span("x"):
            pass

    def events():
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        b.record()

    def rf():
        with record_function("aep.x"):
            pass

    out = {"off_us": min(per(n, root) for _ in range(3))}
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]):
        out["on_root_us"] = min(per(m, root) for _ in range(3))
        with profiling.span("parent"):
            out["on_child_us"] = min(per(m, root) for _ in range(3))
        out["record_function_us"] = min(per(m, rf) for _ in range(3))
        out["event_pair_us"] = min(per(m, events) for _ in range(3))
        out["capture_check_us"] = min(per(m, torch.cuda.is_current_stream_capturing) for _ in range(3))
        out["allocator_read_us"] = min(per(m, profiling._device_allocs) for _ in range(3))
    profiling.clear_spans()
    return out


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--cells", default=",".join(CELLS))
    p.add_argument("--batches", type=int, default=200)
    p.add_argument("--seed", type=int, default=7)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    lines = [check_cell(c, args.seed + i, args.batches, device) for i, c in enumerate(args.cells.split(","))]
    lines.insert(0, {"card": card, "torch": torch.__version__, **span_cost()})   # CUDA is initialised by now
    for line in lines:
        print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
