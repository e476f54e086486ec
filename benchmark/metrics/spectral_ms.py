"""spectral_ms: the spectral groups' device-clock self time, ms a batch,
median over the traced batches: the program's ``spectral`` span (``ops/
audio_features.py::classical_feature_vector``: centroid, rolloff,
bandwidth, contrast, flatness, chroma, tonnetz, every group that reads the
magnitude STFT). Device-clock self time (``harness/spans.py``): the time
the layer adds to the batch on ``batch_ms_p95``'s clock, its device work
where the device lags the host and its issue time where the host lags."""

from benchmark.harness import spans


def read(ctx):
    return spans.median_self_ms(ctx, "spectral")
