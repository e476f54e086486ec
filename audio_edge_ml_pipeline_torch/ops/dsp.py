"""Batched DSP building blocks of the audio features, in PyTorch float32.

The plain tensor paths: folded windowed-DFT GEMMs for the STFT (and a
framed basis product for odd n_fft or edge padding), the slaney mel GEMM,
the per-clip masked dB and min-max epilogue, the Savitzky-Golay deltas, the
spectral descriptors, zero-crossing rate and RMS. Mirrors
``audio_edge_ml_pipeline_tpu/ops/dsp.py`` function by function so the CPU
tests can hold one against the other. The features whose mel power runs in
the hand-written kernel live elsewhere: ``mel_spec_feature`` in
``ops/mel_kernel.py``, the MFCC and classical features in
``ops/audio_features.py``.

Numerical contract: float32 outputs match ``ops.golden`` (float64) to
max|delta| <= 1e-5. A TF32 or 3-pass product measured 8.8e-5 mel error on
the reference, which fails it, and even a full float32 GEMM sits at the
gate (see ``_matmul64``). So every product here runs in float64, on the
float32 inputs and float64 constants, and its result is rounded to float32
once; no global flag (``allow_tf32``, ``set_float32_matmul_precision``)
reaches a float64 product. That is the counterpart, and more, of JAX's
per-op ``precision=HIGHEST``. Nothing here runs a cuDNN convolution either:
FIRs and window sums are shifted sums, frames are ``unfold`` views times a
basis.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..utils.profiling import span
from .golden import librosa_ref as ref

# ----------------------------------------------------------------------
# Products
# ----------------------------------------------------------------------


def _matmul64(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in float64, rounded to float32 once.

    A float32 GEMM chain cancels on the weak bins of a frame that holds a
    strong tone: on the CPU the folded STFT at n_fft 1024 in float32 left
    spectral contrast 8.8e-3 dB from float64 (gate 1e-2 dB) and the
    classical vector 7.3e-5 relative (gate 1e-4), and the DCT over 128 dB
    values alone put the z-scored MFCC at 1.07e-5 (gate 1e-5). The float32
    constants alone cost the contrast of a clip resampled from 16 kHz
    5.9e-4. In float64 on float64 constants what is left is each result's
    rounding to float32. An H100 runs float64 GEMMs on its tensor cores at
    about the rate of float32 ones on its CUDA cores."""
    return torch.matmul(x.to(torch.float64), w.to(torch.float64)).to(torch.float32)


@functools.lru_cache(maxsize=64)
def _on(device: torch.device, build, *args) -> torch.Tensor:
    """``build(*args)`` (a numpy constant) as a tensor of its dtype on
    ``device``, built once."""
    return torch.from_numpy(np.ascontiguousarray(build(*args))).to(device)


# ----------------------------------------------------------------------
# Constants (numpy float64; the float32 ones are what the JAX
# package and the kernels use)
# ----------------------------------------------------------------------


def dft_bases(n_fft: int, window: str = "hann") -> np.ndarray:
    """Windowed DFT basis, shape (2 * n_freq, n_fft) float32 (see ``_dft_bases64``)."""
    return _dft_bases64(n_fft, window).astype(np.float32)


def _dft_bases64(n_fft: int, window: str = "hann") -> np.ndarray:
    """Windowed DFT basis, shape (2 * n_freq, n_fft) float64.

    Row k < n_freq is w[n]*cos(2*pi*k*n/N); row n_freq+k is
    -w[n]*sin(2*pi*k*n/N) (the imaginary part of e^{-2pi i kn/N}).
    """
    n_freq = 1 + n_fft // 2
    if window == "hann":
        w = ref.hann_periodic(n_fft)
    elif window == "ones":
        w = np.ones(n_fft)
    else:
        raise ValueError(f"unsupported window: {window!r}")
    n = np.arange(n_fft, dtype=np.float64)
    k = np.arange(n_freq, dtype=np.float64)
    ang = 2.0 * np.pi * np.outer(k, n) / n_fft
    return np.concatenate([np.cos(ang) * w[None, :], -np.sin(ang) * w[None, :]], axis=0)


def mel_fb(sr: float, n_fft: int, n_mels: int, fmin: float = 0.0, fmax: float | None = None) -> np.ndarray:
    return ref.mel_filterbank(sr, n_fft, n_mels, fmin=fmin, fmax=fmax).astype(np.float32)


def dct_mat(n_mfcc: int, n_mels: int) -> np.ndarray:
    return ref.dct_ii_ortho_matrix(n_mfcc, n_mels).astype(np.float32)


def chroma_fb(sr: float, n_fft: int, n_chroma: int = 12) -> np.ndarray:
    return ref.chroma_filterbank(sr, n_fft, n_chroma=n_chroma).astype(np.float32)


def tonnetz_basis(n_chroma: int = 12) -> np.ndarray:
    return _tonnetz_basis64(n_chroma).astype(np.float32)


def _tonnetz_basis64(n_chroma: int = 12) -> np.ndarray:
    dim_map = np.linspace(0, 12, num=n_chroma, endpoint=False)
    scale = np.asarray([7.0 / 6, 7.0 / 6, 3.0 / 2, 3.0 / 2, 2.0 / 3, 2.0 / 3])
    V = np.multiply.outer(scale, dim_map)
    V[::2] -= 0.5
    R = np.array([1, 1, 1, 1, 0.5, 0.5])
    return R[:, None] * np.cos(np.pi * V)


def delta_coeffs(width: int = 9, order: int = 1) -> tuple[np.ndarray, np.ndarray]:
    """(interior FIR coeffs, edge row), both float32.

    For savgol with deriv == polyorder the 'interp' edge values are constant
    across each edge region: order! * (pinv of the uncentered Vandermonde)
    [order] dotted with the edge window. The same row serves both edges.
    """
    half = (width - 1) // 2
    t = np.arange(-half, half + 1, dtype=np.float64)
    A = np.vander(t, order + 1, increasing=True)
    interior = np.linalg.pinv(A)[order] * math.factorial(order)
    t0 = np.arange(width, dtype=np.float64)
    A0 = np.vander(t0, order + 1, increasing=True)
    edge_row = np.linalg.pinv(A0)[order] * math.factorial(order)
    return interior.astype(np.float32), edge_row.astype(np.float32)


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
def _folded_dft_bases(n_fft: int, window: str = "hann"):
    """``_folded_dft_bases64`` as float32: the dense kernel's constants."""
    return tuple(a.astype(np.float32) for a in _folded_dft_bases64(n_fft, window))


@functools.lru_cache(maxsize=None)
def _folded_dft_bases64(n_fft: int, window: str = "hann"):
    """Folded windowed DFT bases (numpy float64 constants, built once).

    The windowed real-DFT basis is symmetric about the frame midpoint for a
    symmetric window, so with p[n] = x[n] + x[N-n] and m[n] = x[n] - x[N-n]:

        re = p_vec @ A.T + x[N/2] * wr_half        A:  (F, N/2)
        im = m_vec @ B.T                           B:  (F, N/2)

    half the multiply-adds of the unfolded (2F, N) basis.

    Returns (A_T, B_T, wr_half): (N/2, F), (N/2, F), (F,).
    """
    n_freq = 1 + n_fft // 2
    half = n_fft // 2
    basis = _dft_bases64(n_fft, window)
    Wr, Wi = basis[:n_freq], basis[n_freq:]
    # The mirrored halves differ by the rounding of angles up to pi n_fft,
    # which grows with n_fft. The JAX package checks them at atol 1e-12 and
    # so refuses large even n_fft (3000 and 4096 among them,
    # tests/test_torch_mel_repairs.py); 1e-9 keeps the check for a window
    # that is not symmetric.
    if not (np.allclose(Wr[:, 1:half], Wr[:, half + 1:][:, ::-1], atol=1e-9)
            and np.allclose(Wi[:, 1:half], -Wi[:, half + 1:][:, ::-1], atol=1e-9)):
        raise ValueError(f"the {window} DFT basis of n_fft={n_fft} is not symmetric")
    A = np.zeros((n_freq, half))
    A[:, 0] = Wr[:, 0]
    A[:, 1:] = Wr[:, 1:half]
    B = np.zeros((n_freq, half))
    B[:, 1:] = Wi[:, 1:half]
    # im(DC) and im(Nyquist) are identically zero for real input; pin the
    # basis rows' sin(pi*n) rounding dust to exact zeros
    B[0, :] = 0.0
    B[n_freq - 1, :] = 0.0
    return A.T, B.T, Wr[:, half]


@functools.lru_cache(maxsize=8)
def _stft_tables(n: int, n_fft: int, hop_length: int, window: str,
                 device: torch.device) -> tuple[torch.Tensor, ...]:
    """``_folded_dft_bases64`` and ``fold_indices`` as tensors on ``device``,
    built once per (clip length, window, device)."""
    bases = _folded_dft_bases64(n_fft, window)
    indices = fold_indices(n, n_fft, hop_length, n_frames_for(n, hop_length))
    return tuple(torch.from_numpy(a).to(device) for a in (*bases, *indices))


@functools.lru_cache(maxsize=8)
def _mel_fb_tensor(sr: float, n_fft: int, n_mels: int, fmin: float, fmax: float | None,
                   device: torch.device) -> torch.Tensor:
    """The float64 mel filterbank as a (n_mels, n_freq) tensor on ``device``, built once."""
    return torch.from_numpy(ref.mel_filterbank(sr, n_fft, n_mels, fmin=fmin, fmax=fmax)).to(device)


def _center_pad(y: torch.Tensor, pad: int, pad_mode: str) -> torch.Tensor:
    """(B, n) -> (B, n + 2 pad), zeros ("constant") or the end samples repeated ("edge")."""
    if pad_mode == "constant":
        return torch.nn.functional.pad(y, (pad, pad))
    if pad_mode == "edge":
        return torch.nn.functional.pad(y[:, None, :], (pad, pad), mode="replicate")[:, 0, :]
    raise ValueError(f"unsupported pad_mode: {pad_mode!r}")


def _re_im64(y: torch.Tensor, n_fft: int, hop_length: int, window: str, pad_mode: str):
    """The folded STFT of ``stft_re_im`` in float64: (re, im) each (B, T, n_freq)."""
    if y.ndim != 2:
        raise ValueError(f"stft_re_im expects a (B, n) batch, got shape {tuple(y.shape)}")
    if n_fft % 2:
        raise ValueError(f"stft_re_im requires even n_fft (got {n_fft}): the fold pairs x[n] with x[n_fft-n]; "
                         "use stft_spectrum for odd sizes")
    A_T, B_T, wr_half, idx_front, idx_rev, idx_center, rmask = _stft_tables(
        y.shape[1], n_fft, hop_length, window, y.device)
    ypad = _center_pad(y, n_fft // 2, pad_mode).to(torch.float64)
    front = ypad[:, idx_front]          # (B, T, half)
    rev = ypad[:, idx_rev] * rmask
    center = ypad[:, idx_center]        # (B, T)
    re = torch.matmul(front + rev, A_T) + center[..., None] * wr_half
    im = torch.matmul(front - rev, B_T)
    return re, im


def stft_re_im(
    y: torch.Tensor, n_fft: int, hop_length: int, window: str = "hann", pad_mode: str = "constant",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched windowed STFT via folded half-size GEMMs (in float64).

    y: (B, n) float32 -> (re, im) each (B, T, n_freq) float32 (frames-major).
    """
    re, im = _re_im64(y, n_fft, hop_length, window, pad_mode)
    return re.to(torch.float32), im.to(torch.float32)


def _power64(y: torch.Tensor, n_fft: int, hop_length: int, window: str, pad_mode: str) -> torch.Tensor:
    """|STFT|^2 in float64, (B, T, n_freq): the folded GEMMs for even n_fft
    with constant padding and a Hann window, else the frames (an ``unfold``
    view of the padded clip) times the unfolded basis, JAX's strided
    convolution as one product."""
    if y.ndim != 2:
        raise ValueError(f"stft_spectrum expects a (B, n) batch, got shape {tuple(y.shape)}")
    if n_fft % 2 == 0 and pad_mode == "constant" and window == "hann":
        re, im = _re_im64(y, n_fft, hop_length, window, pad_mode)
    else:
        n_freq = 1 + n_fft // 2
        frames = _center_pad(y, n_fft // 2, pad_mode).to(torch.float64).unfold(1, n_fft, hop_length)
        out = torch.matmul(frames, _on(y.device, _dft_bases64, n_fft, window).T)   # (B, T, 2F)
        re, im = out[..., :n_freq], out[..., n_freq:]
    return re * re + im * im


def stft_spectrum(
    y: torch.Tensor, n_fft: int, hop_length: int, window: str = "hann", power: float = 2.0,
    pad_mode: str = "constant",
) -> torch.Tensor:
    """Batched |STFT|^power. y: (B, n) float32 -> (B, n_freq, n_frames)
    float32. Even n_fft with constant padding and a Hann window takes the
    folded GEMMs; odd n_fft (no symmetric fold) and edge padding the framed
    basis product (``_power64``)."""
    mag_sq = _power64(y, n_fft, hop_length, window, pad_mode).transpose(1, 2)
    if power != 2.0:
        mag_sq = torch.sqrt(mag_sq) if power == 1.0 else mag_sq ** (power / 2.0)
    return mag_sq.to(torch.float32)


def _frame_index(n: int, n_fft: int, hop_length: int) -> np.ndarray:
    """(T, n_fft) gather indices of each centred frame into the padded clip,
    clamped to its last sample as an XLA gather clamps them (only an odd
    n_fft with n % hop == 0 reaches past the end)."""
    starts = np.arange(n_frames_for(n, hop_length)) * hop_length
    return np.minimum(starts[:, None] + np.arange(n_fft)[None, :], n + 2 * (n_fft // 2) - 1)


def stft_complex_fft(y: torch.Tensor, n_fft: int, hop_length: int, window: str = "ones") -> torch.Tensor:
    """Batched complex STFT by ``torch.fft.rfft`` on ``y``'s device (for
    large transforms, e.g. the CQT). y: (B, n) float32 -> (B, n_freq,
    n_frames) complex64; centred with zero padding; ``window`` "hann" (the
    periodic one) or "ones"."""
    pad = n_fft // 2
    ypad = torch.nn.functional.pad(y, (pad, pad))
    frames = ypad[:, _on(y.device, _frame_index, y.shape[1], n_fft, hop_length)]   # (B, T, n_fft)
    if window == "hann":
        frames = frames * _on(y.device, _hann32, n_fft)
    return torch.fft.rfft(frames, n=n_fft, dim=-1).transpose(1, 2)


def _hann32(n_fft: int) -> np.ndarray:
    return ref.hann_periodic(n_fft).astype(np.float32)


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
_LN2_HI = float(np.float32(0.6931472))
_LN2_LO = float(np.float32(np.float64(0.6931471805599453) - np.float64(np.float32(0.6931472))))
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


def log_precise(x: torch.Tensor) -> torch.Tensor:
    """Accurate float32 natural log for x > 0."""
    ln_m, e = _ln_mantissa(x)
    return e * _LN2_HI + (e * _LN2_LO + ln_m)


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


def _masked_mean(x: torch.Tensor, mask: torch.Tensor | None, dim: int) -> torch.Tensor:
    if mask is None:
        return torch.mean(x, dim=dim)
    m = mask.to(x.dtype)
    return torch.sum(x * m, dim=dim) / torch.clamp_min(torch.sum(m, dim=dim), 1.0)


def _masked_std(x: torch.Tensor, mask: torch.Tensor | None, dim: int) -> torch.Tensor:
    mu = _masked_mean(x, mask, dim).unsqueeze(dim)
    return torch.sqrt(_masked_mean((x - mu) ** 2, mask, dim))


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


def amplitude_to_db(
    S: torch.Tensor,
    ref_mode: str | float = 1.0,
    amin: float = 1e-5,
    top_db: float | None = 80.0,
    mask: torch.Tensor | None = None,
) -> torch.Tensor:
    if isinstance(ref_mode, str):
        return power_to_db(S * S, ref_mode=ref_mode, amin=amin * amin, top_db=top_db, mask=mask)
    return power_to_db(S * S, ref_mode=float(ref_mode) ** 2, amin=amin * amin, top_db=top_db, mask=mask)


def minmax_normalize(x: torch.Tensor, mask: torch.Tensor | None = None, eps: float = 1e-8) -> torch.Tensor:
    """Per-clip [0,1] normalization over (F, T)."""
    m3 = None if mask is None else mask[:, None, :]
    lo = _masked_min(x, m3, (1, 2))
    hi = _masked_max(x, m3, (1, 2))
    return (x - lo) / (hi - lo + eps)


def mel_epilogue(mel: torch.Tensor, lengths: torch.Tensor | None, hop_length: int) -> torch.Tensor:
    """(B, n_mels, T) mel power -> masked power_to_db(ref=max) -> [0, 1]."""
    with span("epilogue"):
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
    power + mel with one swap on the small mel output. Odd n_fft (no
    symmetric fold) takes ``stft_spectrum``'s framed basis product. A
    ``mel`` span."""
    with span("mel"):
        fb = _mel_fb_tensor(sr, n_fft, n_mels, fmin, fmax, y.device)
        pw = _power64(y, n_fft, hop_length, "hann", "constant")   # (B, T, F)
        return torch.matmul(pw, fb.T).transpose(1, 2).to(torch.float32)


# ----------------------------------------------------------------------
# Deltas and the waveform feature
# ----------------------------------------------------------------------


def delta(x: torch.Tensor, width: int = 9, order: int = 1) -> torch.Tensor:
    """Batched savgol delta along the last axis; x: (B, K, T).

    Interior frames use the centered SG FIR, as ``width`` shifted
    multiply-adds; edge frames use the constant 'interp' value
    (deriv == polyorder => the fitted derivative is constant over each edge
    window). Matches ops.golden.delta / scipy savgol interp.
    """
    T = x.shape[-1]
    if T < width:
        raise ValueError(f"delta width {width} exceeds sequence length {T}")
    interior, edge_row = delta_coeffs(width, order)
    half = (width - 1) // 2
    n_mid = T - width + 1
    mid = float(interior[0]) * x[..., :n_mid]
    for j in range(1, width):
        mid = mid + float(interior[j]) * x[..., j:j + n_mid]
    e = torch.from_numpy(edge_row).to(x.device)
    first = (x[..., :width] * e).sum(-1, keepdim=True)
    last = (x[..., -width:] * e).sum(-1, keepdim=True)
    return torch.cat([first.expand(*x.shape[:-1], half), mid, last.expand(*x.shape[:-1], half)], dim=-1)


def waveform_feature(y: torch.Tensor, lengths: torch.Tensor | None = None) -> torch.Tensor:
    """audio_waveform contract: peak normalize each clip to [-1, 1]."""
    if lengths is not None:
        m = torch.arange(y.shape[1], device=y.device)[None, :] < lengths[:, None]
        y = torch.where(m, y, 0.0)
    peak = torch.amax(torch.abs(y), dim=1, keepdim=True)
    return torch.where(peak > 0, y / torch.clamp_min(peak, 1e-30), y).to(torch.float32)


# ----------------------------------------------------------------------
# Spectral descriptors (batched; share one |STFT|)
# ----------------------------------------------------------------------

_F32_TINY = float(np.finfo(np.float32).tiny)


def _fft_freqs(sr: float, n_fft: int) -> np.ndarray:
    return ref.fft_frequencies(sr, n_fft).astype(np.float32)


def _l1_normalize_freq(S: torch.Tensor) -> torch.Tensor:
    """librosa.util.normalize(norm=1, axis=freq): tiny columns unchanged."""
    length = torch.sum(torch.abs(S), dim=1, keepdim=True)
    return S / torch.where(length < _F32_TINY, 1.0, length)


def spectral_centroid_from_mag(S: torch.Tensor, sr: float, n_fft: int) -> torch.Tensor:
    freq = _on(S.device, _fft_freqs, sr, n_fft)
    return torch.sum(freq[None, :, None] * _l1_normalize_freq(S), dim=1)  # (B, T)


def spectral_rolloff_from_mag(S: torch.Tensor, sr: float, n_fft: int, roll_percent: float = 0.85) -> torch.Tensor:
    """The lowest bin frequency at which a frame's cumulative magnitude
    reaches ``roll_percent`` of its total, (B, F, T) -> (B, T). The running
    sum is float64: the bin jumps by sr / n_fft where the sum meets the
    threshold within float32 rounding, and a card's scan sums in another
    order than golden's (the rolloff std of BIRDeep segments read 7.9e-5
    card vs CPU on an NVIDIA H100 80GB HBM3 at 700 W, chip_smoke.py phase
    4e; gate 1e-4)."""
    freq = _on(S.device, _fft_freqs, sr, n_fft)
    total = torch.cumsum(S.to(torch.float64), dim=1)
    threshold = roll_percent * total[:, -1:, :]
    cand = torch.where(total < threshold, torch.finfo(S.dtype).max, freq[None, :, None])
    return torch.amin(cand, dim=1)  # (B, T)


def spectral_bandwidth_from_mag(S: torch.Tensor, sr: float, n_fft: int, p: float = 2.0) -> torch.Tensor:
    freq = _on(S.device, _fft_freqs, sr, n_fft)
    centroid = spectral_centroid_from_mag(S, sr, n_fft)  # (B, T)
    deviation = torch.abs(freq[None, :, None] - centroid[:, None, :])
    return torch.sum(_l1_normalize_freq(S) * deviation**p, dim=1) ** (1.0 / p)


def spectral_contrast_from_mag(
    S: torch.Tensor,
    sr: float,
    n_fft: int,
    fmin: float = 200.0,
    n_bands: int = 6,
    quantile: float = 0.02,
    mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """(B, F, T) -> (B, n_bands+1, T). Band membership is static given
    sr/n_fft, so each band is a static slice and a full sort over it."""
    freq = ref.fft_frequencies(sr, n_fft)
    octa = np.zeros(n_bands + 2)
    octa[1:] = fmin * (2.0 ** np.arange(0, n_bands + 1))
    peaks, valleys = [], []
    for k, (f_low, f_high) in enumerate(zip(octa[:-1], octa[1:])):
        current_band = np.logical_and(freq >= f_low, freq <= f_high)
        idx = np.flatnonzero(current_band)
        if k > 0:
            current_band[idx[0] - 1] = True
        if k == n_bands:
            current_band[idx[-1] + 1 :] = True
        sel = np.flatnonzero(current_band)
        stop = sel[-1] if k < n_bands else sel[-1] + 1   # the bands are contiguous; all but the last drop their top bin
        sorted_sub = torch.sort(S[:, sel[0]:stop, :], dim=1).values
        nsel = int(max(np.rint(quantile * current_band.sum()), 1))
        valleys.append(torch.mean(sorted_sub[:, :nsel, :], dim=1))
        peaks.append(torch.mean(sorted_sub[:, -nsel:, :], dim=1))
    peak = torch.stack(peaks, dim=1)  # (B, n_bands+1, T)
    valley = torch.stack(valleys, dim=1)
    return power_to_db(peak, ref_mode=1.0, mask=mask) - power_to_db(valley, ref_mode=1.0, mask=mask)


def spectral_flatness_from_mag(S: torch.Tensor, amin: float = 1e-10, power: float = 2.0) -> torch.Tensor:
    S_thresh = torch.clamp_min(S**power, amin)
    gmean = torch.exp(torch.mean(log_precise(S_thresh), dim=1))
    return gmean / torch.mean(S_thresh, dim=1)  # (B, T)


def chroma_from_power(Spow: torch.Tensor, sr: float, n_fft: int, n_chroma: int = 12) -> torch.Tensor:
    raw = _matmul64(_on(Spow.device, ref.chroma_filterbank, sr, n_fft, n_chroma), Spow)  # (B, C, T)
    peak = torch.amax(torch.abs(raw), dim=1, keepdim=True)
    return raw / torch.where(peak < _F32_TINY, 1.0, peak)


def tonnetz_from_chroma(chroma: torch.Tensor) -> torch.Tensor:
    length = torch.sum(torch.abs(chroma), dim=1, keepdim=True)
    length = torch.where(length < _F32_TINY, 1.0, length)
    return _matmul64(_on(chroma.device, _tonnetz_basis64, chroma.shape[1]), chroma / length)


# ----------------------------------------------------------------------
# Zero-crossing rate and RMS
# ----------------------------------------------------------------------


def _windowed_sum(x: torch.Tensor, window: int, hop: int) -> torch.Tensor:
    """Strided window sums, (B, n) -> (B, 1 + (n - window) // hop): each
    window of an ``unfold`` view summed in float32."""
    return x.unfold(1, window, hop).sum(-1)


def _framed_count(n: int, frame_length: int, hop_length: int) -> int:
    """librosa frame count over the center-padded signal: even frame_length
    gives the canonical 1 + n//hop; odd frame_length pads one sample less
    (2*(frame//2) = frame-1), yielding 1 + (n-1)//hop like util.frame."""
    return 1 + (n + 2 * (frame_length // 2) - frame_length) // hop_length


def zero_crossing_rate(
    y: torch.Tensor, frame_length: int = 2048, hop_length: int = 512, threshold: float = 1e-10
) -> torch.Tensor:
    """(B, n) -> (B, T). Frame t's within-frame adjacent pairs are the global
    adjacent pairs at positions [t*hop, t*hop + frame_length - 1), so each
    count is the difference of two gathered prefix sums of the 0/1 crossings
    (exact in float32 up to 2^24 samples)."""
    ypad = _center_pad(y, frame_length // 2, "edge")
    yy = torch.where(torch.abs(ypad) <= threshold, 0.0, ypad)
    cross = torch.abs(torch.diff(torch.signbit(yy).to(torch.float32), dim=1))  # (B, n_pad-1)
    csum = torch.nn.functional.pad(torch.cumsum(cross, dim=1), (1, 0))
    T = _framed_count(y.shape[1], frame_length, hop_length)
    starts = torch.arange(T, device=y.device) * hop_length
    ends = torch.clamp_max(starts + frame_length - 1, csum.shape[1] - 1)
    return (csum[:, ends] - csum[:, starts]) / frame_length


def rms(y: torch.Tensor, frame_length: int, hop_length: int) -> torch.Tensor:
    """(B, n) -> (B, T); center=True constant padding, window energy sums."""
    T = _framed_count(y.shape[1], frame_length, hop_length)
    ypad = _center_pad(y, frame_length // 2, "constant")
    sq = ypad * ypad
    if frame_length % hop_length == 0:
        # frame t is exactly hop-blocks [t, t + frame/hop): sum each block
        # once and slide-add the r block sums; the framed count guarantees
        # (T-1+r)*hop <= n_pad, so every slice is in range
        r = frame_length // hop_length
        nb = -(-sq.shape[1] // hop_length)
        sq = torch.nn.functional.pad(sq, (0, nb * hop_length - sq.shape[1]))
        blocks = sq.reshape(y.shape[0], nb, hop_length).sum(dim=2)
        sums = sum(blocks[:, j : j + T] for j in range(r))
    else:
        sums = _windowed_sum(sq, frame_length, hop_length)[:, :T]
    return torch.sqrt(sums / frame_length)


# ----------------------------------------------------------------------
# CQT
# ----------------------------------------------------------------------

# float64 partial products materialized per batch block (each clip holds
# n_chunks x (n_fft / hop) x 2 n_bins of them: 10.7 MB for a 5 s clip at
# 22.05 kHz, hop 512, 84 bins), so B=512 runs in three blocks
_CQT_BLOCK_BYTES = 2 << 30


@functools.lru_cache(maxsize=8)
def _cqt_n_fft(sr: float, fmin: float, n_bins: int, bins_per_octave: int) -> int:
    return ref.cqt_time_basis(sr, fmin, n_bins, bins_per_octave)[1]


@functools.lru_cache(maxsize=8)
def _cqt_taps64(sr: float, fmin: float, n_bins: int, bins_per_octave: int, hop_length: int) -> np.ndarray:
    """(hop, R * 2 n_bins) float64: the golden time-domain kernels h (real
    parts, then imaginary) zero-extended to R = ceil(n_fft / hop) hops and
    cut into hop-long pieces, piece r in columns [r * 2K, (r + 1) * 2K)."""
    h, n_fft = ref.cqt_time_basis(sr, fmin, n_bins, bins_per_octave)
    R = -(-n_fft // hop_length)
    w = np.zeros((2 * n_bins, R * hop_length))
    w[:n_bins, :n_fft], w[n_bins:, :n_fft] = h.real, h.imag
    return np.ascontiguousarray(w.reshape(2 * n_bins, R, hop_length).transpose(2, 1, 0).reshape(hop_length, -1))


def cqt_magnitude(
    y: torch.Tensor,
    sr: float,
    hop_length: int,
    n_bins: int,
    bins_per_octave: int = 12,
    fmin: float | None = None,
) -> torch.Tensor:
    """(B, n) -> (B, n_bins, T) |CQT| in float64 (contract:
    ``ops.golden.cqt``), as products against the golden time-domain kernels
    (``golden.cqt_time_basis``).

    Frame t of the padded clip is the hop-long chunks t .. t + R - 1 (R =
    n_fft / hop, the kernels zero-extended to whole hops), so one GEMM of
    every chunk against every hop-long piece of every kernel, (B * chunks,
    hop) x (hop, R * 2 n_bins), followed by R shifted adds of its pieces
    gives every frame's products without building the (B, T, n_fft) frames.
    The products run in float64 on the float64 kernels: a float32
    contraction over 16384 taps cancels on the weak bins and leaves the
    feature about 1.5e-5 from golden, over its 1e-5 gate. Clips are taken in
    blocks of at most ``_CQT_BLOCK_BYTES`` of partial products; each clip's
    result does not depend on the others but for the GEMM's summation order
    (float64 rounding)."""
    if fmin is None:
        fmin = ref.C1_HZ
    B, n = y.shape
    n_fft = _cqt_n_fft(float(sr), float(fmin), n_bins, bins_per_octave)
    w = _on(y.device, _cqt_taps64, float(sr), float(fmin), n_bins, bins_per_octave, hop_length)
    R, K2 = w.shape[1] // (2 * n_bins), 2 * n_bins
    T = n_frames_for(n, hop_length)
    n_chunks = T + R - 1
    pad = n_fft // 2
    ypad = torch.nn.functional.pad(y.to(torch.float64), (pad, n_chunks * hop_length - n - pad))
    chunks = ypad.reshape(B, n_chunks, hop_length)
    per_clip = 8 * n_chunks * R * K2
    step = max(1, min(B, _CQT_BLOCK_BYTES // per_clip))
    out = []
    for s in range(0, B, step):
        parts = torch.matmul(chunks[s : s + step], w).reshape(-1, n_chunks, R, K2)
        acc = parts[:, 0:T, 0]
        for r in range(1, R):
            acc = acc + parts[:, r : r + T, r]
        out.append(torch.sqrt(acc[..., :n_bins] ** 2 + acc[..., n_bins:] ** 2).transpose(1, 2))
    return torch.cat(out)


def cqt_feature(
    y: torch.Tensor,
    sr: float = 22050,
    hop_length: int = 512,
    n_bins: int = 84,
    bins_per_octave: int = 12,
    fmin: float | None = None,
    lengths: torch.Tensor | None = None,
) -> torch.Tensor:
    """audio_cqt contract: |CQT| -> amplitude_to_db(ref=max) -> [0, 1] per
    clip (``lengths``: the valid frames only), (B, n_bins, T) float32; the
    dB and min-max run in float64 and are rounded once."""
    C = cqt_magnitude(y, sr, hop_length, n_bins, bins_per_octave, fmin)
    mask = frame_mask(C.shape[-1], lengths, hop_length)
    log_cqt = amplitude_to_db(C, ref_mode="max", mask=mask)
    return minmax_normalize(log_cqt, mask=mask).to(torch.float32)
