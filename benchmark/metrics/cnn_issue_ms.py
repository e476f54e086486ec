"""cnn_issue_ms: the CNN forward's host self time, ms a batch, median over
the traced batches: the host's time inside the program's ``cnn`` span
(``models/deep.py::CNNModule.forward``) issuing its launches. Against
``cnn_ms``, the same span on the device's clock: where the two are close
the host's issue sets the layer's time, where ``cnn_ms`` is larger the
device's work does (``harness/spans.py``)."""

from benchmark.harness import spans


def read(ctx):
    return spans.median_self_ms(ctx, "cnn", clock="host")
