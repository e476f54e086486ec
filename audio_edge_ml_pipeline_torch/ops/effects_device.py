"""Device-batched phase-vocoder time stretch / pitch shift, in PyTorch.

Counterpart of the JAX package's ``ops/effects_jax.py``, replacing the
augment stage's per-clip host vocoder (``ops/golden/effects.py``, the float64
oracle; reference augment.py:105-118): a whole batch of clips stretches in
one pass on the card, each clip at its own rate.

Why this vectorizes at all: the vocoder loop looks sequential
(phase_acc += phi_advance + dphase each step), but dphase depends only on
the input STFT columns, never on phase_acc, so the recurrence is an
exclusive cumsum over steps:

    phase_i = angle(D[:, 0]) + sum_{j<i} (phi_advance + dphase_j)

Everything else is gathers (frame interpolation, ``torch.gather`` along the
frames) and products: the STFT through ``dsp.stft_re_im``'s folded bases,
the inverse DFT as two (F, n_fft) basis products times the window, the
overlap-add as four shifted slice adds (n_fft = 4 hop) divided by the
window-square sum. The products run in float64 and are rounded to float32
once, so no TF32 flag of the caller reaches them (JAX runs them at
``Precision.HIGHEST``); ``torch.round`` rounds half to even, as
``jnp.round`` does.

float32 numerics: the unwrapped accumulated phase reaches ~3e5 rad
(phi_advance tops out at pi*hop = 1608 a step), where float32 cos/sin
resolution is ~0.03 rad. Each step's delta is therefore wrapped to
[-pi, pi) before the cumsum (cos/sin are 2 pi-periodic, so wrapping deltas
keeps the phase modulo 2 pi); the wrapped cumsum stays under ~600 rad and
the waveform sits ~1e-3 from the float64 oracle. This path makes training
data: it is not under the 1e-5 feature gate.

The step grids (``lo``, ``frac``, ``valid``) are built on the host in
float64, exactly the oracle's ``np.arange(0, T, rate)``: a float32
``i * rate`` on the device lands on the wrong side of frame boundaries at
rates such as 1.05. Clip lengths are padded to 4096-sample buckets and the
step count to a multiple of 32, with each clip's frames at or past its own
frame count masked to zero (plus one zero column, the oracle's pad), so
clips of any length share a batch.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..utils.device import resolve_device
from . import dsp
from .golden.librosa_ref import hann_periodic

_N_FFT = 2048
_HOP = 512
_LEN_QUANT = 8 * _HOP    # clip lengths padded up to 4096-sample buckets
_STEP_QUANT = 32         # step counts padded up to a multiple of 32
_TWO_PI = float(np.float32(2.0 * np.pi))


@functools.lru_cache(maxsize=None)
def _irfft_bases(n_fft: int) -> tuple[np.ndarray, np.ndarray]:
    """(re_basis, im_basis), each (F, n_fft) float64, of irfft as products:

    irfft(X)_n = (1/N) [ X0.re + (-1)^n X_{N/2}.re
                         + sum_{k=1}^{N/2-1} 2 (re_k cos(2 pi k n / N)
                                                - im_k sin(2 pi k n / N)) ]
    """
    F = n_fft // 2 + 1
    k = np.arange(F)[:, None]
    n = np.arange(n_fft)[None, :]
    c = np.full(F, 2.0)
    c[0] = c[-1] = 1.0
    ang = 2.0 * np.pi * k * n / n_fft
    re_b = (c[:, None] * np.cos(ang)) / n_fft
    im_b = (-c[:, None] * np.sin(ang)) / n_fft
    im_b[0, :] = 0.0
    im_b[-1, :] = 0.0
    return re_b, im_b


@functools.lru_cache(maxsize=8)
def _constants(device: torch.device) -> tuple[torch.Tensor, ...]:
    """(re_basis, im_basis) float64, (window, window squared, phi_advance)
    float32, on ``device``, built once."""
    re_b, im_b = _irfft_bases(_N_FFT)
    win = hann_periodic(_N_FFT)
    phi_adv = np.linspace(0.0, np.pi * _HOP, _N_FFT // 2 + 1)
    return (torch.from_numpy(re_b).to(device), torch.from_numpy(im_b).to(device),
            torch.from_numpy(win.astype(np.float32)).to(device),
            torch.from_numpy((win**2).astype(np.float32)).to(device),
            torch.from_numpy(phi_adv.astype(np.float32)).to(device))


def stretch_padded(Y: torch.Tensor, lo: torch.Tensor, frac: torch.Tensor, valid: torch.Tensor,
                   t_valid: torch.Tensor) -> torch.Tensor:
    """The batched vocoder on one device: ``Y`` (B, n) float32 clips, zero
    past each clip's end; ``lo`` (B, S) int64 frame of each step (padding
    steps read the zero column, index T), ``frac`` (B, S) float32 its
    fraction, ``valid`` (B, S) bool the real steps, ``t_valid`` (B,) int64
    each clip's frame count. Returns (B, (S - 1) hop + n_fft / 2) float32,
    the stretched clips (still to be cut to their lengths)."""
    re_b, im_b, win, win_sq, phi_adv = _constants(Y.device)
    B, S = lo.shape
    re, im = dsp.stft_re_im(Y, _N_FFT, _HOP)                     # (B, T, F)
    T, F = re.shape[1], re.shape[2]
    # frames at t >= the clip's frame count are zero: the oracle's STFT has
    # exactly t_valid frames (+ a zero pad column), while the padded signal's
    # boundary frames still overlap the real tail
    fmask = (torch.arange(T, device=Y.device)[None, :] < t_valid[:, None])[:, :, None]
    re = torch.where(fmask, re, 0.0)
    im = torch.where(fmask, im, 0.0)
    ang = torch.nn.functional.pad(torch.atan2(im, re), (0, 0, 0, 1))   # one zero column past the end
    mag = torch.nn.functional.pad(torch.sqrt(re * re + im * im), (0, 0, 0, 1))

    def col(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:   # gather along the frames: (B, S, F)
        return torch.gather(a, 1, idx[:, :, None].expand(B, S, F))

    hi = torch.clamp(lo + 1, max=T)
    fr = frac[:, :, None]
    mag_i = torch.where(valid[:, :, None], (1.0 - fr) * col(mag, lo) + fr * col(mag, hi), 0.0)
    dphase = col(ang, hi) - col(ang, lo) - phi_adv
    dphase = dphase - _TWO_PI * torch.round(dphase / _TWO_PI)
    delta = phi_adv + dphase
    delta = delta - _TWO_PI * torch.round(delta / _TWO_PI)      # wrapped before the cumsum
    cum = torch.cumsum(delta, dim=1)
    phase = ang[:, 0:1, :] + (cum - delta)                      # exclusive cumsum
    frames = (torch.matmul((mag_i * torch.cos(phase)).to(torch.float64), re_b)
              + torch.matmul((mag_i * torch.sin(phase)).to(torch.float64), im_b)).to(torch.float32) * win

    # overlap-add: n_fft = 4 hop, so chunk q of frame s lands at (s + q) hop + r
    out_len = (S + 3) * _HOP
    acc = torch.zeros((B, out_len), dtype=torch.float32, device=Y.device)
    nrm = torch.zeros_like(acc)
    w_frames = valid[:, :, None].to(torch.float32) * win_sq
    for q in range(_N_FFT // _HOP):
        acc[:, q * _HOP:(q + S) * _HOP] += frames[:, :, q * _HOP:(q + 1) * _HOP].reshape(B, S * _HOP)
        nrm[:, q * _HOP:(q + S) * _HOP] += w_frames[:, :, q * _HOP:(q + 1) * _HOP].reshape(B, S * _HOP)
    out = acc / torch.clamp_min(nrm, 1e-8)
    return out[:, _N_FFT // 2:]                                  # undo the center padding


def step_grids(n_b: np.ndarray, rates: np.ndarray) -> tuple[int, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Host-side float64 step grids of clips of lengths ``n_b`` at ``rates``:
    (n_pad, lo (B, S) int64, frac (B, S) float32, valid (B, S) bool,
    t_valid (B,) int64), each clip's grid exactly the oracle's
    ``np.arange(0, T_b, rate)``, padded to a shared S."""
    n_pad = int(-(-int(n_b.max()) // _LEN_QUANT) * _LEN_QUANT)
    T = dsp.n_frames_for(n_pad, _HOP)
    t_valid = np.array([dsp.n_frames_for(int(nb), _HOP) for nb in n_b], np.int64)
    grids = [np.arange(0.0, float(tb), r) for tb, r in zip(t_valid, rates)]
    S = -(-max(len(g) for g in grids) // _STEP_QUANT) * _STEP_QUANT
    lo = np.full((len(grids), S), T, np.int64)    # padding steps read the zero column
    frac = np.zeros((len(grids), S), np.float32)
    valid = np.zeros((len(grids), S), bool)
    for b, g in enumerate(grids):
        lo[b, : len(g)] = np.floor(g).astype(np.int64)
        frac[b, : len(g)] = (g - np.floor(g)).astype(np.float32)
        valid[b, : len(g)] = True
    return n_pad, lo, frac, valid, t_valid


def time_stretch_batch(y, rates, device: torch.device | str | None = None) -> list[np.ndarray]:
    """Stretch a batch of clips, each by its own rate, on ``device`` (None:
    the first CUDA card, raising without one; ``"cpu"`` when asked).

    y: (B, n) array, or a list of 1-D clips of differing lengths. rates (B,)
    in (0, inf). Returns a list of B float32 arrays of length
    round(n_b / rate_b): the ``ops/golden/effects.py`` time_stretch
    contract, batched.
    """
    if isinstance(y, np.ndarray):
        if y.ndim != 2:
            raise ValueError("time_stretch_batch expects a (B, n) batch or a list of clips")
        clips = [np.asarray(c, np.float32) for c in y]
    else:
        clips = [np.ascontiguousarray(np.asarray(c, np.float32)) for c in y]
        if any(c.ndim != 1 for c in clips):
            raise ValueError("time_stretch_batch expects a (B, n) batch or a list of 1-D clips")
    rates = np.asarray(rates, np.float64)
    if np.any(rates <= 0):
        raise ValueError("rates must be positive")
    dev = resolve_device(device)
    n_b = np.array([len(c) for c in clips])
    n_pad, lo, frac, valid, t_valid = step_grids(n_b, rates)
    Y = np.zeros((len(clips), n_pad), np.float32)
    for b, c in enumerate(clips):
        Y[b, : len(c)] = c
    out = stretch_padded(*(torch.from_numpy(a).to(dev) for a in (Y, lo, frac, valid, t_valid))).cpu().numpy()
    lengths = np.round(n_b / rates).astype(int)
    return [out[b, : lengths[b]] for b in range(len(clips))]


def pitch_shift_batch(y, sr: int, n_steps, bins_per_octave: int = 12,
                      device: torch.device | str | None = None) -> list[np.ndarray]:
    """Shift each clip's pitch by its own semitone amount, duration kept:
    the batched stretch on ``device``, then each clip's polyphase resample
    back on the host (its ratio differs by clip).

    y: (B, n) array or a list of 1-D clips of differing lengths. Returns a
    list of B float32 arrays, each its input clip's length.
    """
    from ..data.audio_io import resample

    clips = [np.asarray(c, np.float32) for c in y]
    rates = 2.0 ** (-np.asarray(n_steps, np.float64) / bins_per_octave)
    stretched = time_stretch_batch(clips, rates, device=device)
    out = []
    for c, seg, rate in zip(clips, stretched, rates):
        n = len(c)
        shifted = resample(seg.astype(np.float32), int(round(sr / rate)), sr)
        out.append(shifted[:n] if len(shifted) >= n else np.pad(shifted, (0, n - len(shifted))))
    return out
