"""issue_ms: the host's time from calling the program's entry to its
return, median over the traced batches (the ``benchmark.entry`` spans the
harness records around the call)."""

import statistics


def read(ctx):
    spans = ctx.trace.spans.get("entry") if ctx.trace is not None else None
    return 1e3 * statistics.median(spans) if spans else None
