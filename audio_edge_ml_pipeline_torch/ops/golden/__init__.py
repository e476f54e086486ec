"""ops.golden — float64 numpy reference for the mel path (the parity oracle)."""

from .librosa_ref import (  # noqa: F401
    fft_frequencies,
    frame_signal,
    hann_periodic,
    hz_to_mel,
    mel_filterbank,
    mel_frequencies,
    mel_spec_feature,
    mel_to_hz,
    melspectrogram,
    minmax_normalize,
    power_to_db,
    stft,
)
