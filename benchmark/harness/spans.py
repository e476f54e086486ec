"""The program's own spans, as the per-layer metrics that read them see them.

The program (``audio_edge_ml_pipeline_torch.utils.profiling``) keeps a
record of each span it opens while a profiler records: the layers of its
hot paths, each with its parent and its root, the outermost span of one
call into the program. ``records(ctx)`` drains that store on its first use
in a run and keeps what it drained on the run's ``Context``, so that every
metric of the run reads the same records. Of them it keeps the spans under
the newest ``ctx.trace_batches`` roots: each traced batch is one call into
the program, one root, and the profiler stops after them, so an older root
belongs to an earlier run in the same process. An untraced run, or a
program without spans (a checkout from before them), gives no records, and
the metrics then read None.

A span's device-clock self time is its interval on the device's clock
(two CUDA events on the stream, the clock of ``batch_ms_p95``'s events)
less the part its child spans cover: the time that layer adds to the batch
on that clock. Where the device lags the host (the classical and MFCC
features, the CNN's convolutions) it is the layer's device work; where the
host lags the device (the scoring and extraction glue) it is the layer's
issue time. Its host self time, on the host's clock, says which. On a CPU
both clocks are the host's.
"""

from __future__ import annotations

import statistics


def _take() -> list:
    try:
        from audio_edge_ml_pipeline_torch.utils.profiling import take_spans
    except ImportError:
        return []
    return take_spans()


def records(ctx) -> list:
    """The run's traced batches' span records (``profiling.SpanRecord``)."""
    cached = getattr(ctx, "program_spans", None)
    if cached is None:
        cached = []
        if ctx.trace is not None and ctx.trace_batches:
            drained = _take()
            roots = sorted((r for r in drained if r.parent is None), key=lambda r: r.host_start_ns)
            own = {r.id for r in roots[-ctx.trace_batches:]}
            cached = [r for r in drained if r.root in own]
        ctx.program_spans = cached
    return cached


def roots(ctx) -> list:
    """One root span a traced batch."""
    return [r for r in records(ctx) if r.parent is None]


def batch_self_ms(ctx, name: str, clock: str = "device") -> list[float]:
    """Per traced batch in which span ``name`` ran: the sum of its self ms
    on ``clock`` ("device" or "host") over its runs in that batch."""
    sums: dict[int, float] = {}
    for r in records(ctx):
        if r.name == name:
            value = r.device_self_ms if clock == "device" else r.host_self_ms
            if value is not None:
                sums[r.root] = sums.get(r.root, 0.0) + value
    return list(sums.values())


def median_self_ms(ctx, name: str, clock: str = "device") -> float | None:
    """The median over the traced batches of ``batch_self_ms``; None where
    the span never ran."""
    per_batch = batch_self_ms(ctx, name, clock)
    return statistics.median(per_batch) if per_batch else None
