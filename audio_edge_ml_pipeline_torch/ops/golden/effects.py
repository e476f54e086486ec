"""Time-stretch / pitch-shift via phase vocoder (float64 numpy reference).

The port's own copy of the JAX package's ``ops/golden/effects.py``: the
float64 oracle of the augmentation stage, in the role of
librosa.effects.time_stretch / pitch_shift (reference augment.py:105-118),
and of the device vocoder (``ops/effects_device.py``). Algorithm: STFT (n_fft
2048, hop 512, periodic Hann, center=True) -> classic phase-vocoder frame
interpolation with phase accumulation -> inverse STFT with windowed
overlap-add; pitch shift = time stretch by 2^(-steps/12) then polyphase
resample back to the original rate.
"""

from __future__ import annotations

import numpy as np

from .librosa_ref import hann_periodic, stft

_N_FFT = 2048
_HOP = 512


def istft(D: np.ndarray, hop_length: int = _HOP, n_fft: int = _N_FFT, length: int | None = None) -> np.ndarray:
    """Inverse STFT with hann-squared overlap-add normalization."""
    win = hann_periodic(n_fft)
    n_frames = D.shape[1]
    out_len = n_fft + hop_length * (n_frames - 1)
    y = np.zeros(out_len)
    norm = np.zeros(out_len)
    frames = np.fft.irfft(D, n=n_fft, axis=0)  # (n_fft, n_frames)
    for t in range(n_frames):
        start = t * hop_length
        y[start : start + n_fft] += frames[:, t] * win
        norm[start : start + n_fft] += win**2
    y = y / np.maximum(norm, 1e-8)
    # undo center padding
    y = y[n_fft // 2 :]
    if length is not None:
        y = y[:length] if len(y) >= length else np.pad(y, (0, length - len(y)))
    return y


def phase_vocoder(D: np.ndarray, rate: float, hop_length: int = _HOP) -> np.ndarray:
    """Stretch an STFT by `rate` (rate > 1 speeds up)."""
    n_freq, n_frames = D.shape
    time_steps = np.arange(0, n_frames, rate)
    phi_advance = np.linspace(0, np.pi * hop_length, n_freq)
    out = np.zeros((n_freq, len(time_steps)), dtype=np.complex128)
    phase_acc = np.angle(D[:, 0])
    D_pad = np.concatenate([D, np.zeros((n_freq, 2), dtype=D.dtype)], axis=1)
    for i, step in enumerate(time_steps):
        lo = int(np.floor(step))
        frac = step - lo
        mag = (1 - frac) * np.abs(D_pad[:, lo]) + frac * np.abs(D_pad[:, lo + 1])
        out[:, i] = mag * np.exp(1j * phase_acc)
        dphase = np.angle(D_pad[:, lo + 1]) - np.angle(D_pad[:, lo]) - phi_advance
        dphase -= 2 * np.pi * np.round(dphase / (2 * np.pi))
        phase_acc += phi_advance + dphase
    return out


def time_stretch(y: np.ndarray, rate: float) -> np.ndarray:
    """Stretch audio to len(y)/rate samples without changing pitch."""
    if rate <= 0:
        raise ValueError("rate must be positive")
    D = stft(y, n_fft=_N_FFT, hop_length=_HOP)
    D_st = phase_vocoder(D, rate, _HOP)
    return istft(D_st, _HOP, _N_FFT, length=int(round(len(y) / rate)))


def pitch_shift(y: np.ndarray, sr: int, n_steps: float, bins_per_octave: int = 12) -> np.ndarray:
    """Shift pitch by n_steps semitones, preserving duration."""
    from ...data.audio_io import resample

    rate = 2.0 ** (-float(n_steps) / bins_per_octave)
    stretched = time_stretch(np.asarray(y, dtype=np.float64), rate)
    # resample from sr/rate back to sr (quantized to an integer ratio)
    shifted = resample(stretched.astype(np.float32), int(round(sr / rate)), sr)
    if len(shifted) >= len(y):
        return shifted[: len(y)].astype(np.float64)
    return np.pad(shifted, (0, len(y) - len(shifted))).astype(np.float64)
