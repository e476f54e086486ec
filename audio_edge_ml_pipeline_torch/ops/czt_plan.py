"""The chirp-z mel kernel's plans, tables and index math, and a torch emulation.

``csrc/mel_czt.cu`` computes the folded kernel's function (center-padded
Hann STFT power -> slaney mel, (B, n) -> (B, T, n_mels)) for every even
n_fft that ``rfft_plan`` has no plan for. As in ``csrc/mel_rfft.cu`` the
windowed frame xw of N = n_fft samples is packed as M = N/2 complex values
z[m] = xw[2m] + i xw[2m+1], their M-point DFT Z is taken and split into the
N/2 + 1 bins of the real FFT, whose power goes through the mel bank's
nonzero bands. The M-point DFT is taken one of two ways (``plan``):

- direct, where M is 5-smooth: one M-point FFT;
- chirp-z (Bluestein), elsewhere: with w[m] = exp(-i pi m^2 / M), the
  identity mk = (m^2 + k^2 - (k-m)^2) / 2 makes Z[k] = w[k] (a * b)[k], the
  linear convolution of a[m] = z[m] w[m] with b[j] = conj w[j], taken as a
  circular one of a 5-smooth length P >= 2M - 1:

      A = FFT_P(a),  F = FFT_P(conj(A H / P)),  Z[k] = w[k] conj(F[k])

  where H = FFT_P(b_P) is precomputed (b_P[j] = b_P[P-j] = b[j], j < M) and
  the inverse FFT is a forward one between two conjugations.

The FFTs run in place, a frame a warp, as mixed-radix passes over radices 8,
4, 2, 5 and 3 of run-time plans. The forward FFT of the chirp-z mode is
decimation in frequency (DIF): natural order in, digit-reversed order out
(``positions``), and the filter H is stored in that order, so the second
FFT, decimation in time (DIT: the same passes transposed, in reverse order,
twiddles before the butterflies), takes the digit-reversed product and
gives natural order: no permutation is ever applied. The direct mode writes
z at its digit-reversed positions and runs the DIT passes alone.

Pass s of the DIF (length L_s = P / (R_0 ... R_{s-1}), m_s = L_s / R_s)
runs P / R_s butterflies: butterfly b = g m_s + j reads the R_s values at
g L_s + j + r m_s, takes their R_s-point DFT, multiplies output q by
exp(-2 pi i q j / L_s) and writes it back to g L_s + j + q m_s. A DIT pass
multiplies input q by the same twiddle before the DFT. Butterflies of one
pass touch disjoint slots, so a warp needs no barrier inside a pass.

This module builds the float64 tables, each rounded once to the
instantiation's type (angles that are multiples of pi/2 exact, chirp
phases from m^2 mod 2M in integers), and ``mel_power_emulated``, which walks
the kernel's framing, packing, chirp, passes, scratch addressing, filter
product, split and chunk sums in the kernel's order, as torch ops. The CPU
tests hold it against float64 ``np.fft.rfft``, the golden mel and the Pallas
kernels; no path of the port calls it.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from . import rfft_plan
from .golden import librosa_ref as ref

MAX_PASSES = 16                 # csrc/mel_czt.cu's kMaxPasses


def smooth_radices(n: int) -> tuple[int, ...] | None:
    """The radices of an n-point FFT in pass order, or None unless n is
    5-smooth: as many 8s as fit, then a 4 (or two 4s in place of 8 x 2) or
    a 2, then the 5s and the 3s. n = 1 takes no pass."""
    a = b = c = 0
    while n % 2 == 0:
        n //= 2
        a += 1
    while n % 3 == 0:
        n //= 3
        b += 1
    while n % 5 == 0:
        n //= 5
        c += 1
    if n != 1:
        return None
    eights, rest = divmod(a, 3)
    twos: tuple[int, ...] = ()
    if rest == 2:
        twos = (4,)
    elif rest == 1:
        twos = (4, 4) if eights else (2,)
        eights -= bool(eights)
    return (8,) * eights + twos + (5,) * c + (3,) * b


def chirp_length(M: int) -> int:
    """P of the chirp-z mode: the 5-smooth length >= 2M - 1, up to the next
    power of two, with the least P x passes (the slots each pass reads and
    writes), the shorter on a tie: 512 (8 8 8) at M = 241, not 486 (six
    passes) or 500 (four); 2560 (8 8 8 5) at M = 1025."""
    lo = 2 * M - 1
    hi = 1 << (lo - 1).bit_length()
    return min((n * len(smooth_radices(n)), n) for n in _smooth_up_to(hi) if n >= lo)[1]


@functools.lru_cache(maxsize=None)
def _smooth_up_to(hi: int) -> tuple[int, ...]:
    """The 5-smooth numbers <= hi, ascending."""
    out, p2 = [], 1
    while p2 <= hi:
        p3 = p2
        while p3 <= hi:
            p5 = p3
            while p5 <= hi:
                out.append(p5)
                p5 *= 5
            p3 *= 3
        p2 *= 2
    return tuple(sorted(out))


class Plan(NamedTuple):
    """The M-point DFT's plan at n_fft = 2M.

    mode       "direct" (M 5-smooth) or "chirp"
    length     L, the FFT length: M, or P of the chirp-z mode
    radices    (S,) the passes' radices, DIF order
    lengths    (S,) each pass's group length L_s
    tw_offsets (S,) each pass's first row in the twiddle table
    """

    n_fft: int
    M: int
    mode: str
    length: int
    radices: tuple[int, ...]
    lengths: tuple[int, ...]
    tw_offsets: tuple[int, ...]


@functools.lru_cache(maxsize=None)
def plan(n_fft: int) -> Plan:
    if n_fft % 2 or n_fft < 2:
        raise ValueError(f"the chirp-z kernel needs an even n_fft, got {n_fft}")
    M = n_fft // 2
    radices = smooth_radices(M)
    mode = "direct" if radices is not None else "chirp"
    length = M if radices is not None else chirp_length(M)
    radices = smooth_radices(length)
    if len(radices) > MAX_PASSES:
        raise ValueError(f"{len(radices)} passes at n_fft {n_fft} (> {MAX_PASSES})")
    lengths, offsets, L, off = [], [], length, 0
    for R in radices:
        lengths.append(L)
        offsets.append(off)
        off += (L // R) * (R - 1)
        L //= R
    return Plan(n_fft, M, mode, length, radices, tuple(lengths), tuple(offsets))


def positions(p: Plan) -> np.ndarray:
    """(L,) int: the slot that index f occupies after the DIF passes (the
    digit reversal of f over the plan's radices); the DIT passes take their
    input in the same order."""
    pos = np.zeros(p.length, np.int64)
    f = np.arange(p.length)
    rest = f.copy()
    for R, L in zip(p.radices, p.lengths):
        pos += (rest % R) * (L // R)
        rest //= R
    return pos


def butterfly_slots(p: Plan, s: int) -> tuple[np.ndarray, np.ndarray]:
    """(slots (L / R, R), j (L / R,)) of pass s: butterfly b = g m + j reads
    and writes g L_s + j + r m (m = L_s / R); its twiddle of output q is row
    (q - 1) m + j past the pass's offset, so neighbouring lanes read
    neighbouring rows."""
    R, L = p.radices[s], p.lengths[s]
    m = L // R
    b = np.arange(p.length // R)
    g, j = b // m, b % m
    slots = (g * L + j)[:, None] + m * np.arange(R)[None, :]
    return slots, j


def filter_rows(p: Plan) -> np.ndarray:
    """(L,) int: the row of the filter table that slot x reads. The middle
    pass (radix R, m = 1) gives butterfly b the slots b R + r; row
    r (L / R) + b, so neighbouring lanes read neighbouring rows."""
    x = np.arange(p.length)
    R = p.radices[-1]
    return (x % R) * (p.length // R) + x // R


def scratch_size(p: Plan) -> int:
    """Values of one scratch array: the FFT's L slots, at least M + 1 (the
    split writes the power of bins 0 .. M back in place)."""
    return rfft_plan.pad_index(max(p.length, p.M + 1) - 1) + 1


def unit(num: np.ndarray, den: int) -> np.ndarray:
    """(..., 2) exp(-2 pi i num / den) in float64 from integer ``num``,
    reduced in integers to an angle in [-pi, pi) (so its rounding does not
    grow with num), exact where 4 num / den is whole."""
    num = np.asarray(num, np.int64) % den
    ang = 2.0 * np.pi * np.where(2 * num >= den, num - den, num) / den
    out = np.stack([np.cos(ang), -np.sin(ang)], axis=-1)
    quarter = (4 * num) % den == 0
    exact = np.array([(1.0, 0.0), (0.0, -1.0), (-1.0, 0.0), (0.0, 1.0)])
    out[quarter] = exact[(4 * num[quarter]) // den]
    return out


def chirp64(M: int) -> np.ndarray:
    """(M, 2) w[m] = exp(-i pi m^2 / M), the phase taken from m^2 mod 2M in
    integers, so its error does not grow with m^2."""
    m = np.arange(M, dtype=np.int64)
    return unit((m * m) % (2 * M), 2 * M)


class Tables(NamedTuple):
    """The kernel's arrays (float32 or float64; ints int32), in its order.

    window    (N,)            periodic Hann
    chirp     (M, 2)          w[m] (chirp-z mode; empty in the direct one)
    filt      (P, 2)          conj(H[f]) / P at row filter_rows[positions[f]] (chirp-z mode; empty otherwise)
    positions (L,) int32      ``positions`` (the direct mode's load writes z[f] there)
    twiddles  (n_tw, 2)       pass s, butterfly j, output q at tw_offsets[s] + (q - 1) m_s + j:
                              exp(-2 pi i q j / L_s)
    split     (M // 2 + 1, 2) W^k = exp(-2 pi i k / N)
    bands, weights, chunks, slots: the mel bank's bands and lane schedule, as in ``rfft_plan.Tables``
    """

    window: np.ndarray
    chirp: np.ndarray
    filt: np.ndarray
    positions: np.ndarray
    twiddles: np.ndarray
    split: np.ndarray
    bands: np.ndarray
    weights: np.ndarray
    chunks: np.ndarray
    slots: np.ndarray


@functools.lru_cache(maxsize=64)
def tables64(sr: int, n_fft: int, n_mels: int) -> Tables:
    """The float64 instantiation's tables, built in float64."""
    p = plan(n_fft)
    M, L = p.M, p.length
    tw = np.concatenate([unit(np.arange(1, R)[:, None] * np.arange(Ls // R)[None, :], Ls).reshape(-1, 2)
                         for R, Ls in zip(p.radices, p.lengths)] or [np.zeros((0, 2))])
    pos = positions(p)
    if p.mode == "chirp":
        chirp = chirp64(M)
        b = np.zeros(L, np.complex128)
        w = chirp[:, 0] + 1j * chirp[:, 1]
        b[:M] = np.conj(w)
        b[L - M + 1:] = np.conj(w[1:])[::-1]
        H = np.fft.fft(b)
        filt = np.zeros((L, 2))
        rows = filter_rows(p)[pos]
        filt[rows, 0] = H.real / L
        filt[rows, 1] = -H.imag / L
    else:
        chirp, filt = np.zeros((0, 2)), np.zeros((0, 2))
    split = unit(np.arange(M // 2 + 1), n_fft)
    bands, _ = rfft_plan.mel_bands(sr, n_fft, n_mels)
    fb = ref.mel_filterbank(sr, n_fft, n_mels)
    weights = np.concatenate([fb[j, lo : lo + length] for j, (lo, length, _) in enumerate(bands.tolist())])
    return Tables(ref.hann_periodic(n_fft), chirp, filt, pos.astype(np.int32), tw, split, bands, weights,
                  *rfft_plan.mel_schedule(bands))


@functools.lru_cache(maxsize=64)
def tables(sr: int, n_fft: int, n_mels: int) -> Tables:
    """The float32 instantiation's tables: ``tables64`` rounded to float32
    once, the weights from the float32 bank."""
    t = tables64(sr, n_fft, n_mels)
    f32 = {k: getattr(t, k).astype(np.float32) for k in ("window", "chirp", "filt", "twiddles", "split")}
    return t._replace(**f32, weights=rfft_plan.mel_bands(sr, n_fft, n_mels)[1])


# ----------------------------------------------------------------------
# The emulation: the kernel's arithmetic as torch ops over a stack of frames
# ----------------------------------------------------------------------


def _dft2(v, constants=None):
    (a0r, a0i), (a1r, a1i) = v
    return [(a0r + a1r, a0i + a1i), (a0r - a1r, a0i - a1i)]


_DFT = {2: _dft2, **rfft_plan._DFT}


def _passes(sr_, si_, p: Plan, tw: torch.Tensor, order, dit: bool, constants) -> None:
    """The passes ``order`` over the padded scratch (sr_, si_), in place."""
    for s in order:
        R = p.radices[s]
        slots, j = butterfly_slots(p, s)
        addr = torch.from_numpy(rfft_plan.pad_index(slots))
        v = [(sr_[:, addr[:, r]], si_[:, addr[:, r]]) for r in range(R)]
        m = p.lengths[s] // R
        rows = [torch.from_numpy(p.tw_offsets[s] + (q - 1) * m + j) for q in range(R)]
        twiddled = m > 1        # the last DIF pass (m = 1) has none
        if dit and twiddled:
            v = [v[0]] + [rfft_plan._cmul(*v[q], tw[rows[q], 0], tw[rows[q], 1]) for q in range(1, R)]
        v = _DFT[R](v, constants)
        if not dit and twiddled:
            v = [v[0]] + [rfft_plan._cmul(*v[q], tw[rows[q], 0], tw[rows[q], 1]) for q in range(1, R)]
        for r in range(R):
            sr_[:, addr[:, r]] = v[r][0]
            si_[:, addr[:, r]] = v[r][1]


def frame_power_emulated(frames: torch.Tensor, tab: Tables) -> torch.Tensor:
    """(F, N) float32 frames (before the window) -> (F, N/2 + 1) power, by
    the kernel's load, passes, filter, split and scratch addressing, in the
    tables' precision (``tables``: float32, ``tables64``: float64)."""
    n_fft = frames.shape[1]
    p = plan(n_fft)
    M, S = p.M, len(p.radices)
    dtype = torch.float64 if tab.window.dtype == np.float64 else torch.float32
    constants = rfft_plan.CONSTANTS64 if dtype == torch.float64 else None
    tw = torch.from_numpy(tab.twiddles)
    xw = frames.to(dtype) * torch.from_numpy(tab.window)
    zr, zi = xw[:, 0::2], xw[:, 1::2]
    sr_ = torch.zeros((frames.shape[0], scratch_size(p)), dtype=dtype)
    si_ = torch.zeros_like(sr_)
    if p.mode == "direct":
        addr = torch.from_numpy(rfft_plan.pad_index(tab.positions.astype(np.int64)))
        sr_[:, addr], si_[:, addr] = zr, zi
        _passes(sr_, si_, p, tw, reversed(range(S)), True, constants)
        fr, fi = sr_[:, rfft_plan.pad_index(np.arange(M))], si_[:, rfft_plan.pad_index(np.arange(M))]
        zk_r, zk_i = fr, fi
    else:
        chirp = torch.from_numpy(tab.chirp)
        ar, ai = rfft_plan._cmul(zr, zi, chirp[:, 0], chirp[:, 1])
        addr = torch.from_numpy(rfft_plan.pad_index(np.arange(M)))
        sr_[:, addr], si_[:, addr] = ar, ai
        _passes(sr_, si_, p, tw, range(S), False, constants)
        addr = torch.from_numpy(rfft_plan.pad_index(np.arange(p.length)))
        filt = torch.from_numpy(tab.filt)[torch.from_numpy(filter_rows(p))]
        gr, gi = rfft_plan._cmul(sr_[:, addr], -si_[:, addr], filt[:, 0], filt[:, 1])   # conj(A) conj(H) / P
        sr_[:, addr], si_[:, addr] = gr, gi
        _passes(sr_, si_, p, tw, reversed(range(S)), True, constants)
        fr, fi = sr_[:, rfft_plan.pad_index(np.arange(M))], si_[:, rfft_plan.pad_index(np.arange(M))]
        zk_r, zk_i = rfft_plan._cmul(chirp[:, 0], chirp[:, 1], fr, -fi)                 # w[k] conj(F[k])
    k = np.arange(M // 2 + 1)
    a, b = torch.from_numpy(k), torch.from_numpy((M - k) % M)
    ar, ai, br, bi = zk_r[:, a], zk_i[:, a], zk_r[:, b], zk_i[:, b]
    er, ei = (ar + br) * 0.5, (ai - bi) * 0.5
    orr, oi = (ai + bi) * 0.5, (br - ar) * 0.5
    split = torch.from_numpy(tab.split)
    wr, wi = rfft_plan._cmul(orr, oi, split[:, 0], split[:, 1])
    power = torch.zeros((frames.shape[0], M + 1), dtype=dtype)
    lo = torch.from_numpy(k)
    hi = torch.from_numpy(np.where(k == 0, M, M - k))
    keep = torch.from_numpy(2 * k != M)                  # the middle bin of an even M: its first power
    power[:, hi[keep]] = ((er - wr) * (er - wr) + (ei - wi) * (ei - wi))[:, keep]
    power[:, lo] = (er + wr) * (er + wr) + (ei + wi) * (ei + wi)
    return power


def mel_power_emulated(
    y: torch.Tensor, sr: int = 16000, n_mels: int = 40, n_fft: int = 482, hop_length: int = 160,
    precise: bool = False,
) -> torch.Tensor:
    """(B, n) float32 CPU waveforms -> (B, T, n_mels) float32 mel power, by
    the kernel's stages in the kernel's order (``precise``: its float64
    instantiation's)."""
    tab = (tables64 if precise else tables)(sr, n_fft, n_mels)
    frames = rfft_plan.tile_frames(y, n_fft, hop_length)
    batch, T, _ = frames.shape
    power = frame_power_emulated(frames.reshape(batch * T, n_fft), tab)
    return rfft_plan.band_mel(power, tab).reshape(batch, T, n_mels).to(torch.float32)
