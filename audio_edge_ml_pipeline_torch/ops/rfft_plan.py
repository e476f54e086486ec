"""The FFT-shaped mel kernel's tables and index math, and a torch emulation.

``csrc/mel_rfft.cu`` computes the folded kernel's function (center-padded
Hann STFT power -> slaney mel, (B, n) -> (B, T, n_mels)) through a real FFT:
the windowed frame xw of N = n_fft samples is packed as M = N/2 complex
values z[m] = xw[2m] + i xw[2m+1], Z = FFT_M(z) runs as three or four
mixed-radix Stockham passes over radices 3, 4, 5 and 8 (``RADICES``), and
the real split

    E = (Z[k] + conj Z[M-k]) / 2,  O = (Z[k] - conj Z[M-k]) / 2i
    X[k] = E + W^k O,  X[M-k] = conj(E - W^k O),  W = exp(-2 pi i / N)

gives the N/2 + 1 bins, whose power goes through the mel bank's nonzero band
of each filter, cut into chunks that ``mel_schedule`` spreads evenly over a
warp's lanes. This module builds the float32 tables the kernel reads (in
float64, with the angles that are multiples of pi/2 pinned to exact 0 and 1),
the lane schedule, and ``mel_power_emulated``, which walks the kernel's tile
framing, passes, scratch addressing, real split, chunk sums and their
combination in the same order with those tables, as torch ops. The CPU tests hold the emulation against float64
``np.fft.rfft`` and against the plain and Pallas versions; the CUDA kernel
itself runs only on a card. No path of the port calls the emulation.

The kernel's float64 instantiation takes the same steps in float64 on
``tables64``; the emulation follows it when given those tables.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from .golden import librosa_ref as ref

LANES = 32            # a warp: one frame per warp, M / LANES values a lane
TILE_T = 32           # frames per tile (csrc/mel_rfft.cu kTileT)
RADICES = {           # n_fft -> radices of the M = n_fft / 2 point complex FFT, in pass order
    256: (8, 4, 4),
    320: (8, 4, 5),
    400: (8, 5, 5),
    480: (4, 4, 3, 5),
    512: (8, 8, 4),
    640: (8, 8, 5),
    1024: (8, 8, 8),
    2048: (8, 8, 4, 4),
}
# The butterflies' constants, each rounded to float32 once, as the kernel rounds them.
SQRT_HALF = float(np.float32(math.sqrt(0.5)))                       # radix 8
COS1, SIN1, COS2, SIN2 = (float(np.float32(v)) for v in (           # radix 5: cos, sin of 2 pi/5 and 4 pi/5
    math.cos(0.4 * math.pi), math.sin(0.4 * math.pi), math.cos(0.8 * math.pi), math.sin(0.8 * math.pi)))
SIN3 = float(np.float32(math.sqrt(0.75)))                           # radix 3: sin of pi/3
# The same in float64, correctly rounded, for the kernel's float64 instantiation
# (math.cos(0.8 * math.pi) is one ulp off: 0.8 * pi is rounded first): the
# radix-8 constant, the four radix-5 ones, the radix-3 one.
CONSTANTS64 = (0.70710678118654752440, 0.30901699437494742410, 0.95105651629515357212, -0.80901699437494742410,
               0.58778525229247312917, 0.86602540378443864676)


def supports(n_fft: int) -> bool:
    return n_fft in RADICES


def pad_index(i):
    """Scratch address of complex value i: five floats of padding every 32,
    so the passes' strided writes spread over the shared-memory banks (at
    M = 256, 62 bank wavefronts per array and frame against 78 with one
    float of padding and 130 with none; 50 would be conflict-free)."""
    return i + 5 * (i >> 5)


def scratch_size(M: int) -> int:
    return pad_index(M - 1) + 1


def _unit(num: int, den: int) -> tuple[float, float]:
    """exp(-2 pi i num / den) in float64; exact where 4 num / den is whole."""
    num %= den
    if (4 * num) % den == 0:
        return ((1.0, 0.0), (0.0, -1.0), (-1.0, 0.0), (0.0, 1.0))[4 * num // den]
    ang = 2.0 * math.pi * num / den
    return math.cos(ang), -math.sin(ang)


def pass_strides(M: int) -> list[tuple[int, int]]:
    """(R, Ns) of each pass: its radix and the product of the radices before it."""
    out, ns = [], 1
    for r in RADICES[2 * M]:
        out.append((r, ns))
        ns *= r
    if ns != M:
        raise ValueError(f"radices {RADICES[2 * M]} do not multiply to {M}")
    return out


def pass_indices(M: int, s: int) -> tuple[np.ndarray, np.ndarray]:
    """(read, write) complex indices of pass s, each (M / R, R): butterfly j
    reads z[j + r M/R] and writes (j // Ns) Ns R + j % Ns + r Ns."""
    R, ns = pass_strides(M)[s]
    nb = M // R
    j = np.arange(nb)[:, None]
    r = np.arange(R)[None, :]
    return j + r * nb, (j // ns) * ns * R + j % ns + r * ns


class Tables(NamedTuple):
    """The kernel's float32 / int32 numpy arrays (all but ``bands``, which
    the schedule is built from).

    window    (N,)          periodic Hann
    twiddles  (P, M, 2)     pass s, butterfly j, input r at [s, j R + r]: exp(-2 pi i r (j % Ns) / (Ns R))
    split     (M/2 + 1, 2)  W^k = exp(-2 pi i k / N)
    bands     (n_mels, 3)   each filter's first nonzero bin, band length, offset into ``weights``
    weights   (n_weights,)  the bank's weights over each band, filter by filter
    chunks    (Q, 32, 4)    round q of lane l: a chunk's first bin, length, weight offset and
                            partial-sum slot (-1: no chunk)
    slots     (n_mels, 2)   filter j's first slot and chunk count
    """

    window: np.ndarray
    twiddles: np.ndarray
    split: np.ndarray
    bands: np.ndarray
    weights: np.ndarray
    chunks: np.ndarray
    slots: np.ndarray


def mel_bands(sr: int, n_fft: int, n_mels: int) -> tuple[np.ndarray, np.ndarray]:
    """(bands (n_mels, 3) int32, weights float32) of the slaney bank, as
    float32: each filter's [lo, lo + len) holds all its nonzero weights."""
    fb = ref.mel_filterbank(sr, n_fft, n_mels).astype(np.float32)
    bands = np.zeros((n_mels, 3), np.int32)
    weights = []
    off = 0
    for j, row in enumerate(fb):
        nz = np.flatnonzero(row)
        lo, hi = (int(nz[0]), int(nz[-1]) + 1) if nz.size else (0, 0)
        bands[j] = (lo, hi - lo, off)
        weights.append(row[lo:hi])
        off += hi - lo
    return bands, np.concatenate(weights).astype(np.float32)


def mel_schedule(bands: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Spread the bands' weights evenly over a warp's lanes.

    A lane summing whole filters waits on the longest: at 512 / 40 mels the
    lane with filters 7 and 39 walks 41 bins while the mean is 15.3. So each
    band is cut into chunks of at most ceil(n_weights / 32) bins (near-equal
    lengths, ascending), the chunks go longest first to the least-loaded
    lane (17 bins at most there), each chunk's partial sum lands in its own
    slot, and filter j adds its slots in ascending order. Returns (chunks
    (Q, LANES, 4), slots (n_mels, 2)), as in ``Tables``."""
    cap = max(1, -(-int(bands[:, 1].sum()) // LANES))
    found, slots = [], np.zeros((len(bands), 2), np.int32)
    for j, (lo, length, off) in enumerate(bands.tolist()):
        nc = max(1, -(-length // cap))
        edges = [length * c // nc for c in range(nc + 1)]
        slots[j] = (len(found), nc)
        found += [(lo + edges[c], edges[c + 1] - edges[c], off + edges[c], len(found) + c) for c in range(nc)]
    load = [0] * LANES
    lanes: list[list[tuple[int, ...]]] = [[] for _ in range(LANES)]
    for chunk in sorted(found, key=lambda c: -c[1]):
        lane = min(range(LANES), key=lambda l: (load[l], l))
        lanes[lane].append(chunk)
        load[lane] += chunk[1]
    chunks = np.full((max(map(len, lanes)), LANES, 4), -1, np.int32)
    chunks[..., :3] = 0
    for lane, mine in enumerate(lanes):
        for q, chunk in enumerate(mine):
            chunks[q, lane] = chunk
    return chunks, slots


@functools.lru_cache(maxsize=None)
def tables64(sr: int, n_fft: int, n_mels: int) -> Tables:
    """The tables of the kernel's float64 instantiation: window, twiddles,
    split and weights in float64 (the weights are the float64 bank over the
    same bands), the schedule as in ``tables``."""
    if not supports(n_fft):
        raise ValueError(f"the FFT kernel takes n_fft in {sorted(RADICES)}, got {n_fft}")
    M = n_fft // 2
    tw = np.zeros((len(RADICES[n_fft]), M, 2))
    for s, (R, ns) in enumerate(pass_strides(M)):
        for j in range(M // R):
            for r in range(R):
                tw[s, j * R + r] = _unit(r * (j % ns), ns * R)
    split = np.array([_unit(k, n_fft) for k in range(M // 2 + 1)])
    bands, _ = mel_bands(sr, n_fft, n_mels)
    fb = ref.mel_filterbank(sr, n_fft, n_mels)
    weights = np.concatenate([fb[j, lo : lo + length] for j, (lo, length, _) in enumerate(bands.tolist())])
    return Tables(ref.hann_periodic(n_fft), tw, split, bands, weights, *mel_schedule(bands))


@functools.lru_cache(maxsize=None)
def tables(sr: int, n_fft: int, n_mels: int) -> Tables:
    """The float32 kernel's tables: ``tables64`` rounded to float32 once, the
    weights from the float32 bank."""
    t = tables64(sr, n_fft, n_mels)
    return t._replace(window=t.window.astype(np.float32), twiddles=t.twiddles.astype(np.float32),
                      split=t.split.astype(np.float32), weights=mel_bands(sr, n_fft, n_mels)[1])


# ----------------------------------------------------------------------
# The emulation: the kernel's arithmetic as torch ops over a stack of frames
# ----------------------------------------------------------------------


def _cmul(ar, ai, br, bi):
    return ar * br - ai * bi, ar * bi + ai * br


def _dft4(v):
    (a0r, a0i), (a1r, a1i), (a2r, a2i), (a3r, a3i) = v
    t0r, t0i, t1r, t1i = a0r + a2r, a0i + a2i, a0r - a2r, a0i - a2i
    t2r, t2i, t3r, t3i = a1r + a3r, a1i + a3i, a1i - a3i, a3r - a1r  # t3 = -i (a1 - a3)
    return [(t0r + t2r, t0i + t2i), (t1r + t3r, t1i + t3i), (t0r - t2r, t0i - t2i), (t1r - t3r, t1i - t3i)]


def _dft8(v, constants=None):
    h = SQRT_HALF if constants is None else constants[0]
    e = _dft4(v[0::2])
    o = _dft4(v[1::2])
    (o1r, o1i), (o2r, o2i), (o3r, o3i) = o[1], o[2], o[3]
    o = [o[0],
         ((o1r + o1i) * h, (o1i - o1r) * h),     # exp(-i pi/4) o1
         (o2i, -o2r),                             # -i o2
         ((o3i - o3r) * h, -(o3r + o3i) * h)]     # exp(-3i pi/4) o3
    lo = [(er + orr, ei + oi) for (er, ei), (orr, oi) in zip(e, o)]
    hi = [(er - orr, ei - oi) for (er, ei), (orr, oi) in zip(e, o)]
    return lo + hi


def _dft5(v, constants=None):
    """With t1 = v1 + v4, t2 = v2 + v3, t3 = v1 - v4, t4 = v2 - v3 (c1, s1 the
    cos and sin of 2 pi/5, c2, s2 of 4 pi/5): X0 = v0 + (t1 + t2),
    X1, X4 = a1 -+ i b1 and X2, X3 = a2 -+ i b2, where a1 = v0 + c1 t1 + c2 t2,
    a2 = v0 + c2 t1 + c1 t2, b1 = s1 t3 + s2 t4, b2 = s2 t3 - s1 t4."""
    c1, s1, c2, s2 = (COS1, SIN1, COS2, SIN2) if constants is None else constants[1:5]
    (a0r, a0i), (a1r, a1i), (a2r, a2i), (a3r, a3i), (a4r, a4i) = v
    t1r, t1i, t2r, t2i = a1r + a4r, a1i + a4i, a2r + a3r, a2i + a3i
    t3r, t3i, t4r, t4i = a1r - a4r, a1i - a4i, a2r - a3r, a2i - a3i
    p1r, p1i = a0r + c1 * t1r + c2 * t2r, a0i + c1 * t1i + c2 * t2i
    p2r, p2i = a0r + c2 * t1r + c1 * t2r, a0i + c2 * t1i + c1 * t2i
    q1r, q1i = s1 * t3r + s2 * t4r, s1 * t3i + s2 * t4i
    q2r, q2i = s2 * t3r - s1 * t4r, s2 * t3i - s1 * t4i
    return [(a0r + (t1r + t2r), a0i + (t1i + t2i)),
            (p1r + q1i, p1i - q1r), (p2r + q2i, p2i - q2r),     # a - i b
            (p2r - q2i, p2i + q2r), (p1r - q1i, p1i + q1r)]     # a + i b


def _dft3(v, constants=None):
    """With t = v1 + v2, d = v1 - v2, m = v0 - t/2 and s the sin of pi/3:
    X0 = v0 + t, X1, X2 = m -+ i s d."""
    s = SIN3 if constants is None else constants[5]
    (a0r, a0i), (a1r, a1i), (a2r, a2i) = v
    tr, ti, dr, di = a1r + a2r, a1i + a2i, a1r - a2r, a1i - a2i
    mr, mi = a0r - 0.5 * tr, a0i - 0.5 * ti
    return [(a0r + tr, a0i + ti), (mr + s * di, mi - s * dr), (mr - s * di, mi + s * dr)]


_DFT = {3: _dft3, 4: lambda v, constants=None: _dft4(v), 5: _dft5, 8: _dft8}


def frame_power_emulated(frames: torch.Tensor, tab: Tables) -> torch.Tensor:
    """(F, N) float32 frames (before the window) -> (F, N/2 + 1) power, by
    the kernel's passes, scratch addressing and real split, in the tables'
    precision (``tables``: float32, ``tables64``: float64)."""
    n_fft = frames.shape[1]
    M = n_fft // 2
    dtype = torch.float64 if tab.window.dtype == np.float64 else torch.float32
    constants = CONSTANTS64 if dtype == torch.float64 else None
    window = torch.from_numpy(tab.window)
    tw = torch.from_numpy(tab.twiddles)
    xw = frames.to(dtype) * window
    zr, zi = xw[:, 0::2], xw[:, 1::2]                    # the first pass reads the frame
    sr = torch.zeros((frames.shape[0], scratch_size(M)), dtype=dtype)
    si = torch.zeros_like(sr)
    for s, (R, _) in enumerate(pass_strides(M)):
        read, write = (torch.from_numpy(a) for a in pass_indices(M, s))
        if s == 0:
            v = [(zr[:, read[:, r]], zi[:, read[:, r]]) for r in range(R)]
        else:
            v = [(sr[:, pad_index(read[:, r])], si[:, pad_index(read[:, r])]) for r in range(R)]
            j = torch.arange(M // R)
            v = [v[0]] + [_cmul(*v[r], tw[s, j * R + r, 0], tw[s, j * R + r, 1]) for r in range(1, R)]
        v = _DFT[R](v, constants)
        for r in range(R):
            sr[:, pad_index(write[:, r])] = v[r][0]
            si[:, pad_index(write[:, r])] = v[r][1]
    k = torch.arange(M // 2 + 1)
    a = pad_index(k)
    b = pad_index((M - k) % M)
    ar, ai, br, bi = sr[:, a], si[:, a], sr[:, b], si[:, b]
    er, ei = (ar + br) * 0.5, (ai - bi) * 0.5
    orr, oi = (ai + bi) * 0.5, (br - ar) * 0.5
    split = torch.from_numpy(tab.split)
    wr, wi = _cmul(orr, oi, split[:, 0], split[:, 1])
    power = torch.zeros((frames.shape[0], M + 1), dtype=dtype)
    power[:, k] = (er + wr) * (er + wr) + (ei + wi) * (ei + wi)
    power[:, M - k] = (er - wr) * (er - wr) + (ei - wi) * (ei - wi)
    return power


def band_mel(power: torch.Tensor, tab: Tables) -> torch.Tensor:
    """(F, N/2 + 1) power -> (F, n_mels): each chunk of the schedule summed
    in ascending bin order into its slot, then each filter's slots added in
    ascending order, in the power's precision."""
    weights = torch.from_numpy(tab.weights)
    n_slots = int(tab.slots[:, 1].sum())
    part = torch.zeros((power.shape[0], n_slots), dtype=power.dtype)
    for lo, length, off, slot in tab.chunks.reshape(-1, 4).tolist():
        if slot < 0:
            continue
        acc = torch.zeros(power.shape[0], dtype=power.dtype)
        for f in range(length):
            acc = acc + power[:, lo + f] * weights[off + f]
        part[:, slot] = acc
    out = torch.zeros((power.shape[0], len(tab.slots)), dtype=power.dtype)
    for j, (base, count) in enumerate(tab.slots.tolist()):
        acc = part[:, base]
        for c in range(1, count):
            acc = acc + part[:, base + c]
        out[:, j] = acc
    return out


def tile_frames(y: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """(B, n) -> (B, T, n_fft) frames of the center-padded clip, cut as the
    kernel cuts them: each tile of TILE_T frames from one span of
    (TILE_T - 1) hop + n_fft samples starting at clip index t0 hop - n_fft/2,
    zero outside [0, n); frames past T are dropped."""
    batch, n = y.shape
    T = 1 + n // hop
    n_tiles = -(-T // TILE_T)
    span = (TILE_T - 1) * hop + n_fft
    first = torch.arange(n_tiles)[:, None] * TILE_T * hop - n_fft // 2
    idx = first + torch.arange(span)[None, :]                          # (tiles, span)
    inside = (idx >= 0) & (idx < n)
    spans = torch.where(inside, y[:, idx.clamp(0, n - 1)], torch.zeros((), dtype=y.dtype))
    f = torch.arange(TILE_T)[:, None] * hop + torch.arange(n_fft)[None, :]  # (TILE_T, n_fft)
    frames = spans[:, :, f]                                              # (B, tiles, TILE_T, n_fft)
    return frames.reshape(batch, n_tiles * TILE_T, n_fft)[:, :T]


def mel_power_emulated(
    y: torch.Tensor, sr: int = 16000, n_mels: int = 40, n_fft: int = 512, hop_length: int = 160,
    precise: bool = False,
) -> torch.Tensor:
    """(B, n) float32 CPU waveforms -> (B, T, n_mels) float32 mel power, by
    the kernel's stages in the kernel's order (``precise``: its float64
    instantiation's)."""
    tab = (tables64 if precise else tables)(sr, n_fft, n_mels)
    frames = tile_frames(y, n_fft, hop_length)
    batch, T, _ = frames.shape
    power = frame_power_emulated(frames.reshape(batch * T, n_fft), tab)
    return band_mel(power, tab).reshape(batch, T, n_mels).to(torch.float32)
