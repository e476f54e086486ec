"""epilogue_ms: the dB + min-max epilogue's device-clock self time, ms a
batch, median over the traced batches: the program's ``epilogue`` span
(``ops/dsp.py::mel_epilogue``: the frame mask, dB at ref max, top_db floor,
per-clip min-max). Device-clock self time (``harness/spans.py``): the time
the layer adds to the batch on ``batch_ms_p95``'s clock, its device work
where the device lags the host and its issue time where the host lags."""

from benchmark.harness import spans


def read(ctx):
    return spans.median_self_ms(ctx, "epilogue")
