"""Reduction of a ``torch.profiler`` chrome trace to what the per-layer
metrics read: device time by operation, each card's union of device
intervals (kernels, copies and sets), the idle gaps with what the host was
doing in them, and the host spans the harness recorded around its calls
into the program."""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "python_function", "cuda_runtime", "cuda_driver")
SPAN_PREFIX = "benchmark."   # record_function names of the harness's own spans


def union(spans: list[tuple[float, float]]) -> list[tuple[float, float]]:
    """The union of [start, end) intervals, sorted and merged."""
    out: list[list[float]] = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def covered(merged: list[tuple[float, float]], a: float, b: float) -> float:
    return sum(max(0.0, min(b, y) - max(a, x)) for x, y in merged)


@dataclass
class Summary:
    """Times in seconds. ``device_ops``: name -> [seconds, count]."""
    window_s: float
    busy_s: float
    device_ops: dict[str, list] = field(default_factory=dict)
    gaps: list[tuple[str, float]] = field(default_factory=list)
    spans: dict[str, list[float]] = field(default_factory=dict)

    def kernels_matching(self, patterns: tuple[str, ...]) -> tuple[float, int]:
        """(seconds, launches) of the device operations whose name holds any of ``patterns``."""
        hits = [v for k, v in self.device_ops.items() if any(p in k for p in patterns)]
        return sum(v[0] for v in hits), sum(v[1] for v in hits)

    def breakdown(self, n: int = 10) -> dict:
        ops = sorted(self.device_ops.items(), key=lambda kv: -kv[1][0])[:n]
        return {"device_ops": [[k, v[0]] for k, v in ops], "idle_gaps": [[k, s] for k, s in self.gaps[:n]]}


def _host_at(host: list[dict], t: float) -> str:
    """The innermost host event running at ``t``, by name."""
    inner = None
    for e in host:
        if e["ts"] <= t < e["ts"] + e["dur"] and (inner is None or e["dur"] < inner["dur"]):
            inner = e
    return f"host: {inner['name']}" if inner else "host: outside any traced call"


def _card(event: dict) -> int:
    """The card a device event ran on (its ``args.device``; card 0 without one)."""
    return int(event.get("args", {}).get("device", 0))


def summarize(path: Path, window: tuple[float, float] | None = None, cards: int = 1) -> Summary:
    """``path``'s chrome trace reduced over ``window`` (µs of the trace's
    clock; by default the extent of the harness's ``benchmark.batch``
    spans, or of every event where there are none). ``busy_s`` is the mean
    over the cell's ``cards`` (cuda:0 on) of each card's own union of
    device intervals, so a card left idle while another works counts as
    idle; a card with no events is idle the whole window. The idle gaps are
    each card's, the longest over all of them, each named by the host's call
    at its middle, after ``card k · `` where there are several cards."""
    events = [e for e in json.loads(Path(path).read_text())["traceEvents"] if e.get("ph") == "X" and "dur" in e]
    device = [e for e in events if e.get("cat") in DEVICE_CATS]
    host = [e for e in events if e.get("cat") in HOST_CATS]
    if window is None:
        batches = [e for e in host if e.get("cat") == "user_annotation" and e["name"] == SPAN_PREFIX + "batch"]
        edge = batches or events
        window = (min(e["ts"] for e in edge), max(e["ts"] + e["dur"] for e in edge))
    t0, t1 = window
    device = [e for e in device if e["ts"] < t1 and e["ts"] + e["dur"] > t0]
    busy = 0.0
    gaps: list[tuple[float, float, int]] = []
    for card in range(cards):
        merged = [(max(a, t0), min(b, t1))
                  for a, b in union([(e["ts"], e["ts"] + e["dur"]) for e in device if _card(e) == card])]
        busy += covered(merged, t0, t1)
        edges = [t0, *[x for ab in merged for x in ab], t1]
        gaps += [(a, b, card) for a, b in zip(edges[::2], edges[1::2]) if b > a]
    ops: dict[str, list] = {}
    for e in device:
        op = ops.setdefault(e["name"], [0.0, 0])
        op[0] += e["dur"] * 1e-6
        op[1] += 1
    gaps.sort(key=lambda g: g[0] - g[1])
    named = [(("" if cards == 1 else f"card {k} · ") + _host_at(host, (a + b) / 2), (b - a) * 1e-6)
             for a, b, k in gaps[:10]]
    spans: dict[str, list[float]] = {}
    for e in host:
        if e.get("cat") == "user_annotation" and e["name"].startswith(SPAN_PREFIX):
            spans.setdefault(e["name"][len(SPAN_PREFIX):], []).append(e["dur"] * 1e-6)
    return Summary(window_s=(t1 - t0) * 1e-6, busy_s=busy / cards * 1e-6, device_ops=ops, gaps=named, spans=spans)
