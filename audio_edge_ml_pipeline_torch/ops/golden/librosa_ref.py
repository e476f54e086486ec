"""Float64 numpy reference DSP for the mel path, algorithmically compatible
with librosa.

The port's own copy of the functions its mel path is checked against; the
JAX package keeps the full oracle. Conventions (librosa 0.10/0.11 defaults):

- STFT: win_length = n_fft, periodic Hann, center=True, pad_mode="constant".
  n_frames = 1 + len(y) // hop_length for even n_fft.
- mel filterbank: slaney scale, slaney area normalization, fmin=0,
  fmax=sr/2, weights from librosa.filters.mel.
- power_to_db: amin=1e-10, top_db=80, ref may be a scalar or the array max.
"""

from __future__ import annotations

import numpy as np


def hann_periodic(n: int) -> np.ndarray:
    """Periodic ("fftbins") Hann window, scipy.signal.get_window('hann', n)."""
    if n == 1:
        return np.ones(1)
    k = np.arange(n, dtype=np.float64)
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * k / n)


def frame_signal(y: np.ndarray, frame_length: int, hop_length: int) -> np.ndarray:
    """Frame a 1-D signal into overlapping frames, shape (n_frames, frame_length)."""
    n_frames = 1 + (len(y) - frame_length) // hop_length
    idx = np.arange(frame_length)[None, :] + hop_length * np.arange(n_frames)[:, None]
    return y[idx]


def stft(y: np.ndarray, n_fft: int, hop_length: int, center: bool = True) -> np.ndarray:
    """Complex Hann-window STFT, shape (1 + n_fft//2, n_frames)."""
    y = np.asarray(y, dtype=np.float64)
    if center:
        y = np.pad(y, n_fft // 2, mode="constant")
    frames = frame_signal(y, n_fft, hop_length) * hann_periodic(n_fft)[None, :]
    return np.fft.rfft(frames, n=n_fft, axis=-1).T  # (freq, time)


def fft_frequencies(sr: float, n_fft: int) -> np.ndarray:
    return np.linspace(0, sr / 2.0, 1 + n_fft // 2, endpoint=True)


def hz_to_mel(f, htk: bool = False):
    f = np.asarray(f, dtype=np.float64)
    if htk:
        return 2595.0 * np.log10(1.0 + f / 700.0)
    f_min, f_sp = 0.0, 200.0 / 3
    mels = (f - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(f >= min_log_hz, min_log_mel + np.log(np.maximum(f, 1e-30) / min_log_hz) / logstep, mels)


def mel_to_hz(m, htk: bool = False):
    m = np.asarray(m, dtype=np.float64)
    if htk:
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    f_min, f_sp = 0.0, 200.0 / 3
    freqs = f_min + f_sp * m
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)), freqs)


def mel_frequencies(n_mels: int, fmin: float, fmax: float, htk: bool = False) -> np.ndarray:
    return mel_to_hz(np.linspace(hz_to_mel(fmin, htk), hz_to_mel(fmax, htk), n_mels), htk)


def mel_filterbank(
    sr: float,
    n_fft: int,
    n_mels: int,
    fmin: float = 0.0,
    fmax: float | None = None,
    htk: bool = False,
    norm: str | None = "slaney",
) -> np.ndarray:
    """Slaney-style triangular mel filterbank, shape (n_mels, 1 + n_fft//2)."""
    if fmax is None:
        fmax = sr / 2.0
    fftfreqs = fft_frequencies(sr, n_fft)
    mel_f = mel_frequencies(n_mels + 2, fmin, fmax, htk)
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    if norm == "slaney":
        enorm = 2.0 / (mel_f[2 : n_mels + 2] - mel_f[:n_mels])
        weights *= enorm[:, None]
    return weights


def power_to_db(S, ref=1.0, amin: float = 1e-10, top_db: float | None = 80.0):
    """10*log10(S/ref) with amin floor and top_db clipping; ``ref`` may be a
    scalar or the string "max" (librosa's ``ref=np.max``)."""
    S = np.asarray(S, dtype=np.float64)
    magnitude = np.abs(S)
    if isinstance(ref, str) and ref == "max":
        ref_value = magnitude.max()
    else:
        ref_value = np.abs(ref)
    log_spec = 10.0 * np.log10(np.maximum(amin, magnitude))
    log_spec -= 10.0 * np.log10(np.maximum(amin, ref_value))
    if top_db is not None:
        log_spec = np.maximum(log_spec, log_spec.max() - top_db)
    return log_spec


def minmax_normalize(x, eps: float = 1e-8):
    """Min-max normalize to [0,1]."""
    x = np.asarray(x, dtype=np.float64)
    lo, hi = x.min(), x.max()
    return (x - lo) / (hi - lo + eps)


def melspectrogram(
    y: np.ndarray,
    sr: float,
    n_mels: int,
    n_fft: int,
    hop_length: int,
    power: float = 2.0,
    fmin: float = 0.0,
    fmax: float | None = None,
) -> np.ndarray:
    """Mel power spectrogram, shape (n_mels, n_frames)."""
    S = np.abs(stft(y, n_fft=n_fft, hop_length=hop_length)) ** power
    fb = mel_filterbank(sr, n_fft, n_mels, fmin=fmin, fmax=fmax)
    return fb @ S


def mel_spec_feature(
    y: np.ndarray, sr: float = 16000, n_mels: int = 40, n_fft: int = 512, hop_length: int = 160
) -> np.ndarray:
    """audio_mel_spec contract: log-mel(ref=max) -> [0,1], shape (n_mels, T)."""
    mel = melspectrogram(y, sr, n_mels=n_mels, n_fft=n_fft, hop_length=hop_length)
    log_mel = power_to_db(mel, ref="max")
    return minmax_normalize(log_mel)
