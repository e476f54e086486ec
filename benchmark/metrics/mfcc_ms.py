"""mfcc_ms: the MFCC's dB and DCT, device-clock self time, ms a batch,
median over the traced batches: the program's ``mfcc`` span (``ops/
audio_features.py::mfcc``) less its ``mel`` child, the mel power, which
``mel_roofline`` reads. Device-clock self time (``harness/spans.py``): the
time the layer adds to the batch on ``batch_ms_p95``'s clock, its device
work where the device lags the host and its issue time where the host
lags."""

from benchmark.harness import spans


def read(ctx):
    return spans.median_self_ms(ctx, "mfcc")
