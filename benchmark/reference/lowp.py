"""The control of a configuration in float32 with TF32 off: the reference
in TF32, every product's operands rounded to TF32's 10-bit mantissa,
products accumulated in float32, as the tensor cores do with TF32 allowed.
The rounding is explicit, so the control is the same on a card and on a
CPU. (A configuration in float64 gets the frozen reference computed in
float32: ``librosa_ref``'s ``dtype``.)
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from . import librosa_ref

_TF32_DROP = 13   # float32 keeps 23 mantissa bits, TF32 10


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to the nearest TF32 value (ties away from zero)."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + (1 << (_TF32_DROP - 1))) & ~((1 << _TF32_DROP) - 1)
    return bits.view(torch.float32)


def mel_feature_tf32(y: torch.Tensor, sr: int, n_mels: int, n_fft: int, hop: int) -> torch.Tensor:
    """(B, n) float32 clips -> (B, n_mels, T) ``mel_spec_feature`` with the
    STFT and the mel bank as TF32 products: centre padding, periodic Hann,
    DFT bases, power, slaney bank, dB at ref max with top_db 80, min-max."""
    dev = y.device
    n_freq = 1 + n_fft // 2
    k = np.arange(n_fft)[:, None] * np.arange(n_freq)[None, :] % n_fft
    ang = 2 * math.pi * k / n_fft
    window = librosa_ref.hann_periodic(n_fft)[:, None]
    cos = torch.from_numpy(window * np.cos(ang)).to(dev, torch.float32)
    sin = torch.from_numpy(window * np.sin(ang)).to(dev, torch.float32)
    bank = torch.from_numpy(librosa_ref.mel_filterbank(sr, n_fft, n_mels).T.copy()).to(dev, torch.float32)
    frames = F.pad(y, (n_fft // 2, n_fft // 2)).unfold(1, n_fft, hop)      # (B, T, n_fft)
    fr = tf32(frames)
    power = torch.matmul(fr, tf32(cos)) ** 2 + torch.matmul(fr, tf32(sin)) ** 2
    mel = torch.matmul(tf32(power), tf32(bank)).transpose(1, 2)           # (B, n_mels, T)
    db = 10.0 * torch.log10(torch.clamp_min(mel, 1e-10))
    db = db - 10.0 * torch.log10(torch.clamp_min(mel.amax(dim=(1, 2), keepdim=True), 1e-10))
    db = torch.maximum(db, db.amax(dim=(1, 2), keepdim=True) - 80.0)
    lo, hi = db.amin(dim=(1, 2), keepdim=True), db.amax(dim=(1, 2), keepdim=True)
    return (db - lo) / (hi - lo + 1e-8)
