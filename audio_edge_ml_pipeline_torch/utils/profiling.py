"""Stage timing, device tracing and the program's spans.

Counterpart of the JAX package's ``utils/profiling.py``:

- ``stage_timer(name)``: context manager accumulating wall-clock per stage
  into a process-global report; CLIs dump it with ``timing_report()``.
- device tracing: when AEP_PROFILE_DIR is set, ``stage_timer`` runs the
  stage under ``torch.profiler`` (CPU activity, and CUDA activity where a
  card is present) and writes its trace, a Chrome trace that TensorBoard's
  profiler plugin reads, to
  ``$AEP_PROFILE_DIR/<name>/<host>_<pid>.<ns>.pt.trace.json``, as the JAX
  package writes a ``jax.profiler`` trace under ``$AEP_PROFILE_DIR/<name>``.
  A stage inside a traced stage is timed but gets no trace of its own (in
  JAX the inner ``jax.profiler.trace`` fails and is skipped). Any other
  failure to start or write the trace raises: the trace was asked for.
- spans: ``span(name)`` marks one layer of the program's hot paths (the
  flagship forward, each audio extractor's batch, the mel power, the
  epilogue, the CNN, the STFT, the MFCC, the spectral groups, a train
  step). A span is on only while a ``torch.profiler`` records on the
  calling thread (``torch.autograd._profiler_enabled()``): a traced stage
  above, or a caller's own profiler. Off, it costs that one check and
  allocates nothing. On, it opens ``record_function("aep.<name>")``, so
  the trace's timeline shows the layer, and keeps a record in a bounded
  in-memory store: its id, its parent's and its root's (the outermost span
  of the thread's stack, one a batch), its host interval, and its device
  interval from two CUDA timing events on the current stream once CUDA is
  initialised (none while that stream captures a CUDA graph; before CUDA
  is initialised, as on a CPU, the host interval). A root
  span also keeps how many device allocations (``cudaMalloc``) the caching
  allocator made inside it. ``take_spans()`` drains the store and returns
  each record with its self time on both clocks: its interval less the
  part its children cover. A traced stage clears the store when it starts
  and folds its spans into ``timing_report()`` when it ends.
"""

from __future__ import annotations

import itertools
import json
import logging
import os
import socket
import statistics
import threading
import time
from collections import defaultdict, deque
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass
from pathlib import Path

import torch
from torch.autograd import _profiler_enabled
from torch.profiler import record_function

logger = logging.getLogger(__name__)

_TIMINGS: dict[str, dict] = defaultdict(lambda: {"calls": 0, "total_s": 0.0})
_SPAN_TIMES: dict[str, dict[str, list]] = defaultdict(lambda: {"host": [], "device": []})   # self ms by span name
_tracing = False   # a traced stage is open

SPAN_PREFIX = "aep."   # a span's record_function name is SPAN_PREFIX + its name
SPAN_CAP = 1 << 16     # records the store holds; past it the oldest go
_OFF = nullcontext()   # what span() returns when no profiler records: shared, allocates nothing


@dataclass(frozen=True)
class SpanRecord:
    """One span as ``take_spans`` resolves it. Times in ms; ``device_*`` on
    the device's clock from the root span's start (the host's clock on a
    CPU; None where the span ran during a CUDA graph capture). ``mallocs``:
    on a root span, the caching allocator's device allocations inside it
    (0 on a CPU); None below the root. ``events``: the (start, end) CUDA
    events, or None."""
    name: str
    id: int
    parent: int | None
    root: int
    host_start_ns: int
    host_end_ns: int
    device_start_ms: float | None
    device_end_ms: float | None
    host_self_ms: float
    device_self_ms: float | None
    mallocs: int | None
    events: tuple | None

    @property
    def host_ms(self) -> float:
        return (self.host_end_ns - self.host_start_ns) * 1e-6

    @property
    def device_ms(self) -> float | None:
        return None if self.device_start_ms is None else self.device_end_ms - self.device_start_ms


class SpanStore:
    """Closed spans' records, at most ``cap``: past it the newest are kept
    and ``dropped`` counts the others (until ``clear``)."""

    def __init__(self, cap: int = SPAN_CAP) -> None:
        self._records: deque = deque(maxlen=cap)
        self._lock = threading.Lock()
        self.dropped = 0

    def add(self, span: "_Span") -> None:
        with self._lock:
            if len(self._records) == self._records.maxlen:
                self.dropped += 1
            self._records.append(span)

    def take(self) -> list["_Span"]:
        with self._lock:
            out = list(self._records)
            self._records.clear()
        return out

    def clear(self) -> None:
        with self._lock:
            self._records.clear()
            self.dropped = 0


STORE = SpanStore()
_ids = itertools.count(1)
_local = threading.local()


def _device_allocs() -> int:
    """The caching allocator's device allocations so far on the current card."""
    return torch.cuda.memory_stats_as_nested_dict()["num_device_alloc"]


class _Span:
    """A span while open, and its raw record after (see ``span``)."""

    __slots__ = ("name", "id", "parent", "root", "rf", "t0", "t1", "events", "mallocs")

    def __init__(self, name: str) -> None:
        self.name = name

    def __enter__(self) -> "_Span":
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        parent = stack[-1] if stack else None
        self.id = next(_ids)
        self.parent = parent
        self.root = parent.root if parent is not None else self
        self.rf = record_function(SPAN_PREFIX + self.name)
        self.rf.__enter__()
        cuda = torch.cuda.is_initialized()
        self.mallocs = _device_allocs() if cuda and parent is None else 0
        self.events = None
        if cuda and not torch.cuda.is_current_stream_capturing():
            self.events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            self.events[0].record()
        elif cuda:
            self.events = ()   # on a card, but capturing: no device interval
        stack.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        self.t1 = time.perf_counter_ns()
        _local.stack.pop()
        if self.events:
            self.events[1].record()
        if self.parent is None and torch.cuda.is_initialized():
            self.mallocs = _device_allocs() - self.mallocs
        self.rf.__exit__(*exc)
        STORE.add(self)


def span(name: str):
    """A context manager around one layer of the program (see the module
    docstring); a shared no-op unless a profiler records on this thread."""
    if not _profiler_enabled():
        return _OFF
    return _Span(name)


def take_spans() -> list[SpanRecord]:
    """Drain the store: every record, resolved, in order of host start.
    Waits for the device where a record has CUDA events."""
    raw = STORE.take()
    if any(s.events for s in raw):
        torch.cuda.synchronize()

    def interval(s: _Span) -> tuple[float | None, float | None]:
        root = s.root
        if s.events is None:   # recorded on the host alone: a CPU's device clock is the host's
            return (s.t0 - root.t0) * 1e-6, (s.t1 - root.t0) * 1e-6
        if not s.events or not root.events:
            return None, None
        start = root.events[0]
        return start.elapsed_time(s.events[0]), start.elapsed_time(s.events[1])

    spans = {s.id: (s, *interval(s)) for s in raw}
    host_kids: dict[int, float] = defaultdict(float)
    device_kids: dict[int, float] = defaultdict(float)
    for s, a, b in spans.values():
        if s.parent is not None:
            host_kids[s.parent.id] += (s.t1 - s.t0) * 1e-6
            if a is not None:
                device_kids[s.parent.id] += b - a
    out = [SpanRecord(s.name, s.id, None if s.parent is None else s.parent.id, s.root.id, s.t0, s.t1, a, b,
                      (s.t1 - s.t0) * 1e-6 - host_kids[s.id], None if a is None else b - a - device_kids[s.id],
                      s.mallocs if s.parent is None else None, s.events or None)
           for s, a, b in spans.values()]
    return sorted(out, key=lambda r: r.host_start_ns)


def clear_spans() -> None:
    STORE.clear()


def _fold(records: list[SpanRecord]) -> None:
    for r in records:
        times = _SPAN_TIMES[r.name]
        times["host"].append(r.host_self_ms)
        if r.device_self_ms is not None:
            times["device"].append(r.device_self_ms)


def _start_trace():
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.__enter__()
    return prof


def _write_trace(prof, profile_dir: str, name: str) -> Path:
    prof.__exit__(None, None, None)
    out = Path(profile_dir) / name
    out.mkdir(parents=True, exist_ok=True)
    path = out / f"{socket.gethostname()}_{os.getpid()}.{time.time_ns()}.pt.trace.json"
    prof.export_chrome_trace(str(path))
    logger.info("trace of %s written to %s", name, path)
    return path


@contextmanager
def stage_timer(name: str):
    global _tracing
    profile_dir = os.environ.get("AEP_PROFILE_DIR")
    prof = None
    if profile_dir and not _tracing:
        clear_spans()
        prof = _start_trace()
        _tracing = True
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        rec = _TIMINGS[name]
        rec["calls"] += 1
        rec["total_s"] += dt
        if prof is not None:
            _tracing = False
            try:
                _write_trace(prof, profile_dir, name)
            finally:
                _fold(take_spans())


def timing_report() -> dict[str, dict]:
    """Each stage's calls, total and mean seconds; and, where spans were
    recorded, each span's (``aep.<name>``) calls and median self ms on the
    host's and the device's clock."""
    report = {
        name: {"calls": rec["calls"], "total_s": round(rec["total_s"], 4),
               "mean_s": round(rec["total_s"] / max(rec["calls"], 1), 4)}
        for name, rec in sorted(_TIMINGS.items())
    }
    for name, times in sorted(_SPAN_TIMES.items()):
        report[SPAN_PREFIX + name] = {
            "calls": len(times["host"]), "host_self_ms": round(statistics.median(times["host"]), 4),
            "device_self_ms": round(statistics.median(times["device"]), 4) if times["device"] else None}
    return report


def log_timing_report() -> None:
    report = timing_report()
    if report:
        logger.info("stage timings: %s", json.dumps(report))


def reset() -> None:
    _TIMINGS.clear()
    _SPAN_TIMES.clear()
    clear_spans()
