"""Batched DSP for the mel path, in PyTorch float32.

The plain tensor path of the audio_mel_spec contract: folded windowed-DFT
GEMMs for the STFT, the slaney mel GEMM, and the per-clip masked dB and
min-max epilogue. Mirrors ``audio_edge_ml_pipeline_tpu/ops/dsp.py`` function
by function so the CPU tests can hold one against the other. The feature
itself, ``mel_spec_feature``, lives in ``ops/mel_kernel.py``: on a CUDA card
the mel power runs in the hand-written kernel there, on the CPU in
``melspectrogram`` below, and the epilogue below stays torch ops.

Numerical contract: float32 outputs match ``ops.golden`` (float64) to
max|delta| <= 1e-5. Every GEMM here must run in full float32: a TF32 or
3-pass product measured 8.8e-5 mel error on the reference, which fails it.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .golden import librosa_ref as ref

# ----------------------------------------------------------------------
# Constant builders (numpy, float64 -> float32 constants)
# ----------------------------------------------------------------------


def dft_bases(n_fft: int) -> np.ndarray:
    """Hann-windowed DFT basis, shape (2 * n_freq, n_fft) float32.

    Row k < n_freq is w[n]*cos(2*pi*k*n/N); row n_freq+k is
    -w[n]*sin(2*pi*k*n/N) (the imaginary part of e^{-2pi i kn/N}).
    """
    n_freq = 1 + n_fft // 2
    w = ref.hann_periodic(n_fft)
    n = np.arange(n_fft, dtype=np.float64)
    k = np.arange(n_freq, dtype=np.float64)
    ang = 2.0 * np.pi * np.outer(k, n) / n_fft
    basis = np.concatenate([np.cos(ang) * w[None, :], -np.sin(ang) * w[None, :]], axis=0)
    return basis.astype(np.float32)


def mel_fb(sr: float, n_fft: int, n_mels: int, fmin: float = 0.0, fmax: float | None = None) -> np.ndarray:
    return ref.mel_filterbank(sr, n_fft, n_mels, fmin=fmin, fmax=fmax).astype(np.float32)


# ----------------------------------------------------------------------
# Frame / STFT machinery
# ----------------------------------------------------------------------


def n_frames_for(n_samples: int, hop_length: int) -> int:
    """Frame count with center=True, even n_fft: 1 + n // hop."""
    return 1 + n_samples // hop_length


def fold_indices(n: int, n_fft: int, hop_length: int, n_frames: int):
    """Gather indices of the folded STFT into the center-padded clip.

    For frame t (start = t * hop in padded coordinates) and k < n_fft/2:
    front[t, k] = start + k, rev[t, k] = start + n_fft - k, except that rev
    column 0 points at start + n_fft (the next frame's first sample) and is
    zeroed by ``rmask``; center[t] = start + n_fft/2. Every index is clamped
    to the last padded sample, n + n_fft - 1, so frames past the clip's end
    (a kernel's tail tile) stay in bounds. ``csrc/mel_folded.cu`` computes
    the same indices per element.

    Returns numpy (idx_front (T, half), idx_rev (T, half), idx_center (T,),
    rmask (half,) float32).
    """
    half = n_fft // 2
    limit = n + n_fft - 1
    starts = np.arange(n_frames, dtype=np.int64) * hop_length
    idx_front = np.minimum(starts[:, None] + np.arange(half)[None, :], limit)
    rev_cols = np.concatenate([[n_fft], n_fft - np.arange(1, half)])
    idx_rev = np.minimum(starts[:, None] + rev_cols[None, :], limit)
    idx_center = np.minimum(starts + half, limit)
    rmask = np.r_[0.0, np.ones(half - 1)].astype(np.float32)
    return idx_front, idx_rev, idx_center, rmask


@functools.lru_cache(maxsize=None)
def _folded_dft_bases(n_fft: int):
    """Folded Hann-windowed DFT bases (numpy constants, built once).

    The windowed real-DFT basis is symmetric about the frame midpoint, so
    with p[n] = x[n] + x[N-n] and m[n] = x[n] - x[N-n]:

        re = p_vec @ A.T + x[N/2] * wr_half        A:  (F, N/2)
        im = m_vec @ B.T                           B:  (F, N/2)

    half the multiply-adds of the unfolded (2F, N) basis.

    Returns (A_T, B_T, wr_half) as float32 numpy: (N/2, F), (N/2, F), (F,).
    """
    n_freq = 1 + n_fft // 2
    half = n_fft // 2
    basis = dft_bases(n_fft).astype(np.float64)
    Wr, Wi = basis[:n_freq], basis[n_freq:]
    if not (np.allclose(Wr[:, 1:half], Wr[:, half + 1:][:, ::-1], atol=1e-12)
            and np.allclose(Wi[:, 1:half], -Wi[:, half + 1:][:, ::-1], atol=1e-12)):
        raise ValueError(f"the Hann DFT basis of n_fft={n_fft} is not symmetric")
    A = np.zeros((n_freq, half))
    A[:, 0] = Wr[:, 0]
    A[:, 1:] = Wr[:, 1:half]
    B = np.zeros((n_freq, half))
    B[:, 1:] = Wi[:, 1:half]
    # im(DC) and im(Nyquist) are identically zero for real input; pin the
    # basis rows' sin(pi*n) rounding dust to exact zeros
    B[0, :] = 0.0
    B[n_freq - 1, :] = 0.0
    return (A.T.astype(np.float32), B.T.astype(np.float32),
            Wr[:, half].astype(np.float32))


@functools.lru_cache(maxsize=8)
def _stft_tables(n: int, n_fft: int, hop_length: int, device: torch.device) -> tuple[torch.Tensor, ...]:
    """``_folded_dft_bases`` and ``fold_indices`` as tensors on ``device``,
    built once per (clip length, device)."""
    bases = _folded_dft_bases(n_fft)
    indices = fold_indices(n, n_fft, hop_length, n_frames_for(n, hop_length))
    return tuple(torch.from_numpy(a).to(device) for a in (*bases, *indices))


@functools.lru_cache(maxsize=8)
def _mel_fb_tensor(sr: float, n_fft: int, n_mels: int, fmin: float, fmax: float | None,
                   device: torch.device) -> torch.Tensor:
    """``mel_fb`` as a (n_mels, n_freq) tensor on ``device``, built once."""
    return torch.from_numpy(mel_fb(sr, n_fft, n_mels, fmin=fmin, fmax=fmax)).to(device)


def stft_re_im(y: torch.Tensor, n_fft: int, hop_length: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched Hann STFT via folded half-size GEMMs.

    y: (B, n) float32 -> (re, im) each (B, T, n_freq) float32 (frames-major).
    """
    if y.ndim != 2:
        raise ValueError(f"stft_re_im expects a (B, n) batch, got shape {tuple(y.shape)}")
    if n_fft % 2:
        raise ValueError(f"stft_re_im requires even n_fft (got {n_fft}): the fold pairs x[n] with x[n_fft-n]")
    A_T, B_T, wr_half, idx_front, idx_rev, idx_center, rmask = _stft_tables(
        y.shape[1], n_fft, hop_length, y.device)
    pad = n_fft // 2
    ypad = torch.nn.functional.pad(y, (pad, pad))
    front = ypad[:, idx_front]          # (B, T, half)
    rev = ypad[:, idx_rev] * rmask
    center = ypad[:, idx_center]        # (B, T)
    re = torch.matmul(front + rev, A_T) + center[..., None] * wr_half
    im = torch.matmul(front - rev, B_T)
    return re, im


# ----------------------------------------------------------------------
# Precise log10
#
# x = m * 2^e with m in [sqrt(1/2), sqrt(2)), ln(m) by the atanh series,
# e * log10(2) with a two-float constant: the same arithmetic as the JAX
# package (which needed it for the TPU's log approximation), so both sides
# compute the same thing on any device.
# ----------------------------------------------------------------------

_SQRT_HALF = 0.7071067811865476
_LOG10_2_HI = float(np.float32(0.30102998))
_LOG10_2_LO = float(np.float32(np.float64(0.30102999566398119521) - np.float64(np.float32(0.30102998))))
_INV_LN10 = float(np.float32(0.4342944819032518))


def _ln_mantissa(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(ln m, e) with x = m * 2^e, m in [sqrt(1/2), sqrt(2))."""
    m, e = torch.frexp(x)
    shift = m < _SQRT_HALF
    m = torch.where(shift, m * 2.0, m)
    e = torch.where(shift, e - 1, e).to(x.dtype)
    r = (m - 1.0) / (m + 1.0)
    r2 = r * r
    p = 1.0 + r2 * (1.0 / 3 + r2 * (1.0 / 5 + r2 * (1.0 / 7 + r2 * (1.0 / 9 + r2 * (1.0 / 11 + r2 / 13)))))
    return 2.0 * r * p, e


def log10_precise(x: torch.Tensor) -> torch.Tensor:
    """Accurate float32 log10 for x > 0 (use after an amin floor)."""
    ln_m, e = _ln_mantissa(x)
    return e * _LOG10_2_HI + (e * _LOG10_2_LO + ln_m * _INV_LN10)


# ----------------------------------------------------------------------
# Masked reductions and the dB / min-max epilogue
# ----------------------------------------------------------------------


def frame_mask(n_frames: int, lengths: torch.Tensor | None, hop_length: int) -> torch.Tensor | None:
    """(B, n_frames) bool mask of valid frames, or None when lengths is None."""
    if lengths is None:
        return None
    valid = 1 + torch.div(lengths, hop_length, rounding_mode="floor")  # per-clip frame count
    t = torch.arange(n_frames, device=lengths.device)[None, :]
    return t < valid[:, None]


def _masked_max(x: torch.Tensor, mask: torch.Tensor | None, dims: tuple[int, ...]) -> torch.Tensor:
    if mask is not None:
        x = torch.where(mask, x, torch.finfo(x.dtype).min)
    return torch.amax(x, dim=dims, keepdim=True)


def _masked_min(x: torch.Tensor, mask: torch.Tensor | None, dims: tuple[int, ...]) -> torch.Tensor:
    if mask is not None:
        x = torch.where(mask, x, torch.finfo(x.dtype).max)
    return torch.amin(x, dim=dims, keepdim=True)


def power_to_db(
    S: torch.Tensor,
    ref_mode: str | float = 1.0,
    amin: float = 1e-10,
    top_db: float | None = 80.0,
    mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Batched power_to_db; S: (B, F, T). ref_mode: "max" (per-clip max over
    valid frames, librosa ref=np.max) or a scalar. Matches ops.golden."""
    m3 = None if mask is None else mask[:, None, :]
    log_spec = 10.0 * log10_precise(torch.clamp_min(S, amin))
    if isinstance(ref_mode, str) and ref_mode == "max":
        ref_val = _masked_max(S, m3, (1, 2))
        log_spec = log_spec - 10.0 * log10_precise(torch.clamp_min(ref_val, amin))
    else:
        log_spec = log_spec - 10.0 * float(np.log10(max(amin, abs(float(ref_mode)))))
    if top_db is not None:
        peak = _masked_max(log_spec, m3, (1, 2))
        log_spec = torch.maximum(log_spec, peak - top_db)
    return log_spec


def minmax_normalize(x: torch.Tensor, mask: torch.Tensor | None = None, eps: float = 1e-8) -> torch.Tensor:
    """Per-clip [0,1] normalization over (F, T)."""
    m3 = None if mask is None else mask[:, None, :]
    lo = _masked_min(x, m3, (1, 2))
    hi = _masked_max(x, m3, (1, 2))
    return (x - lo) / (hi - lo + eps)


def mel_epilogue(mel: torch.Tensor, lengths: torch.Tensor | None, hop_length: int) -> torch.Tensor:
    """(B, n_mels, T) mel power -> masked power_to_db(ref=max) -> [0, 1]."""
    mask = frame_mask(mel.shape[-1], lengths, hop_length)
    log_mel = power_to_db(mel, ref_mode="max", mask=mask)
    return minmax_normalize(log_mel, mask=mask).to(torch.float32)


# ----------------------------------------------------------------------
# Mel
# ----------------------------------------------------------------------


def melspectrogram(
    y: torch.Tensor, sr: float, n_mels: int, n_fft: int, hop_length: int,
    fmin: float = 0.0, fmax: float | None = None,
) -> torch.Tensor:
    """(B, n) -> (B, n_mels, T) mel power spectrogram, frames-major through
    power + mel with one swap on the small mel output. Even n_fft only: the
    unfolded basis that covers odd sizes is not ported yet."""
    fb = _mel_fb_tensor(sr, n_fft, n_mels, fmin, fmax, y.device)
    re, im = stft_re_im(y, n_fft, hop_length)
    pw = re * re + im * im                               # (B, T, F)
    return torch.matmul(pw, fb.T).transpose(1, 2)

