"""Stage timing and device tracing.

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
"""

from __future__ import annotations

import json
import logging
import os
import socket
import time
from collections import defaultdict
from contextlib import contextmanager
from pathlib import Path

logger = logging.getLogger(__name__)

_TIMINGS: dict[str, dict] = defaultdict(lambda: {"calls": 0, "total_s": 0.0})
_tracing = False   # a traced stage is open


def _start_trace():
    import torch

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
            _write_trace(prof, profile_dir, name)


def timing_report() -> dict[str, dict]:
    return {
        name: {"calls": rec["calls"], "total_s": round(rec["total_s"], 4),
               "mean_s": round(rec["total_s"] / max(rec["calls"], 1), 4)}
        for name, rec in sorted(_TIMINGS.items())
    }


def log_timing_report() -> None:
    report = timing_report()
    if report:
        logger.info("stage timings: %s", json.dumps(report))


def reset() -> None:
    _TIMINGS.clear()
