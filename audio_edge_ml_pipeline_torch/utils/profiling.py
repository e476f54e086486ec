"""Stage timing.

Counterpart of the JAX package's ``utils/profiling.py``:

- ``stage_timer(name)``: context manager accumulating wall-clock per stage
  into a process-global report; CLIs dump it with ``timing_report()``.

The JAX package also writes a device trace per stage when AEP_PROFILE_DIR
is set (``jax.profiler``). That trace is not yet ported, and ``stage_timer``
raises while the variable is set rather than ignoring it.
"""

from __future__ import annotations

import json
import logging
import os
import time
from collections import defaultdict
from contextlib import contextmanager

logger = logging.getLogger(__name__)

_TIMINGS: dict[str, dict] = defaultdict(lambda: {"calls": 0, "total_s": 0.0})


@contextmanager
def stage_timer(name: str):
    if os.environ.get("AEP_PROFILE_DIR"):
        raise NotImplementedError(
            "the AEP_PROFILE_DIR device trace is not yet ported to audio_edge_ml_pipeline_torch; "
            "unset AEP_PROFILE_DIR")
    t0 = time.perf_counter()
    try:
        yield
    finally:
        rec = _TIMINGS[name]
        rec["calls"] += 1
        rec["total_s"] += time.perf_counter() - t0


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
