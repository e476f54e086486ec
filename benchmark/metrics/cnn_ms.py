"""cnn_ms: the CNN forward's device-clock self time, ms a batch, median over
the traced batches: the program's ``cnn`` span (``models/deep.py::
CNNModule.forward``: the convolutions, pools, global average, two dense
layers). Device-clock self time (``harness/spans.py``): the time the layer
adds to the batch on ``batch_ms_p95``'s clock, its device work where the
device lags the host (cuDNN's convolutions) and its issue time where the
host lags; ``cnn_issue_ms`` beside it says which."""

from benchmark.harness import spans


def read(ctx):
    return spans.median_self_ms(ctx, "cnn")
