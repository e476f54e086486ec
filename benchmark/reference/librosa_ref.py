"""Float64 numpy reference DSP, algorithmically compatible with librosa.

The benchmark's frozen copy of the oracle the port's audio features are
held to. It imports nothing of the program, so a later change to the
program cannot move the yardstick.

Precision: the feature functions take ``dtype``, the type every step
computes in (float64 for the reference; float32 for the control that the
benchmark's comparison has to fail). The steps below them compute in the
type of the data they are given, and the constants they build (window,
banks, DCT, filters) are made in that type, so no step runs wider than
``dtype``. ``mag_dtype`` rounds the STFT magnitudes of the spectral
descriptors to a narrower type, where a configuration states that its
magnitudes are held in one.

Conventions (librosa 0.10/0.11 defaults):

- STFT: win_length = n_fft, periodic Hann, center=True, pad_mode="constant".
  n_frames = 1 + len(y) // hop_length for even n_fft.
- mel filterbank: slaney scale, slaney area normalization, fmin=0,
  fmax=sr/2, weights from librosa.filters.mel.
- power_to_db: amin=1e-10, top_db=80, ref may be a scalar or the array max.
- mfcc: log-mel (power_to_db with ref=1.0) -> DCT-II ortho over mel axis.
- delta: Savitzky-Golay filter, width=9, mode="interp".
"""

from __future__ import annotations

import numpy as np


def _real(x) -> np.ndarray:
    """``x`` as an array of its own float type (float32 or float64), or
    float64."""
    x = np.asarray(x)
    return x if x.dtype in (np.float32, np.float64) else x.astype(np.float64)


def hann_periodic(n: int, dtype=np.float64) -> np.ndarray:
    """Periodic ("fftbins") Hann window, scipy.signal.get_window('hann', n)."""
    if n == 1:
        return np.ones(1, dtype)
    k = np.arange(n, dtype=dtype)
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * k / n)


def frame_signal(y: np.ndarray, frame_length: int, hop_length: int) -> np.ndarray:
    """Frame a 1-D signal into overlapping frames, shape (n_frames, frame_length)."""
    n_frames = 1 + (len(y) - frame_length) // hop_length
    idx = np.arange(frame_length)[None, :] + hop_length * np.arange(n_frames)[:, None]
    return y[idx]


def stft(
    y: np.ndarray,
    n_fft: int,
    hop_length: int,
    window: str | np.ndarray = "hann",
    center: bool = True,
    pad_mode: str = "constant",
) -> np.ndarray:
    """Complex STFT, shape (1 + n_fft//2, n_frames) (librosa.stft)."""
    y = _real(y)
    if isinstance(window, str):
        if window == "hann":
            win = hann_periodic(n_fft, y.dtype)
        elif window in ("ones", "rect", "boxcar"):
            win = np.ones(n_fft, y.dtype)
        else:
            raise ValueError(f"unsupported window: {window}")
    else:
        win = np.asarray(window, dtype=y.dtype)
    if center:
        y = np.pad(y, n_fft // 2, mode=pad_mode)
    frames = frame_signal(y, n_fft, hop_length) * win[None, :]
    return np.fft.rfft(frames, n=n_fft, axis=-1).T  # (freq, time)


def fft_frequencies(sr: float, n_fft: int, dtype=np.float64) -> np.ndarray:
    return np.linspace(0, sr / 2.0, 1 + n_fft // 2, endpoint=True, dtype=dtype)


def magnitude(y: np.ndarray, n_fft: int, hop_length: int, mag_dtype=None) -> np.ndarray:
    """|STFT| of the spectral descriptors, rounded to ``mag_dtype`` and back
    where that is given."""
    S = np.abs(stft(y, n_fft=n_fft, hop_length=hop_length))
    return S if mag_dtype is None else S.astype(mag_dtype).astype(S.dtype)


def hz_to_mel(f, htk: bool = False):
    f = _real(f)
    if htk:
        return 2595.0 * np.log10(1.0 + f / 700.0)
    f_min, f_sp = 0.0, 200.0 / 3
    mels = (f - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = float(np.log(6.4)) / 27.0
    return np.where(f >= min_log_hz, min_log_mel + np.log(np.maximum(f, 1e-30) / min_log_hz) / logstep, mels)


def mel_to_hz(m, htk: bool = False):
    m = _real(m)
    if htk:
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    f_min, f_sp = 0.0, 200.0 / 3
    freqs = f_min + f_sp * m
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = float(np.log(6.4)) / 27.0
    return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)), freqs)


def mel_frequencies(n_mels: int, fmin: float, fmax: float, htk: bool = False, dtype=np.float64) -> np.ndarray:
    return mel_to_hz(np.linspace(hz_to_mel(fmin, htk), hz_to_mel(fmax, htk), n_mels, dtype=dtype), htk)


def mel_filterbank(
    sr: float,
    n_fft: int,
    n_mels: int,
    fmin: float = 0.0,
    fmax: float | None = None,
    htk: bool = False,
    norm: str | None = "slaney",
    dtype=np.float64,
) -> np.ndarray:
    """Slaney-style triangular mel filterbank, shape (n_mels, 1 + n_fft//2)."""
    if fmax is None:
        fmax = sr / 2.0
    fftfreqs = fft_frequencies(sr, n_fft, dtype)
    mel_f = mel_frequencies(n_mels + 2, fmin, fmax, htk, dtype)
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
    mag = np.abs(_real(S))
    if isinstance(ref, str) and ref == "max":
        ref_value = mag.max()
    else:
        ref_value = np.abs(ref)
    log_spec = 10.0 * np.log10(np.maximum(amin, mag))
    log_spec -= 10.0 * np.log10(np.maximum(amin, ref_value))
    if top_db is not None:
        log_spec = np.maximum(log_spec, log_spec.max() - top_db)
    return log_spec


def amplitude_to_db(S, ref=1.0, amin: float = 1e-5, top_db: float | None = 80.0):
    """20*log10(|S|/ref); librosa.amplitude_to_db."""
    mag = np.abs(_real(S))
    if isinstance(ref, str) and ref == "max":
        ref_value = mag.max()
    else:
        ref_value = np.abs(ref)
    return power_to_db(mag**2, ref=ref_value**2, amin=amin**2, top_db=top_db)


def minmax_normalize(x, eps: float = 1e-8):
    """Min-max normalize to [0,1]."""
    x = _real(x)
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
    fb = mel_filterbank(sr, n_fft, n_mels, fmin=fmin, fmax=fmax, dtype=S.dtype)
    return fb @ S


def mel_spec_feature(
    y: np.ndarray, sr: float = 16000, n_mels: int = 40, n_fft: int = 512, hop_length: int = 160,
    dtype=np.float64,
) -> np.ndarray:
    """audio_mel_spec contract: log-mel(ref=max) -> [0,1], shape (n_mels, T)."""
    mel = melspectrogram(np.asarray(y, dtype), sr, n_mels=n_mels, n_fft=n_fft, hop_length=hop_length)
    log_mel = power_to_db(mel, ref="max")
    return minmax_normalize(log_mel)


# ----------------------------------------------------------------------
# MFCC + deltas
# ----------------------------------------------------------------------


def dct_ii_ortho_matrix(n_out: int, n_in: int, dtype=np.float64) -> np.ndarray:
    """Orthonormal DCT-II matrix (n_out, n_in): scipy.fft.dct(type=2, norm='ortho').

    Same matrix the reference bakes into the device SVM bundle
    (export_svm.py:69) and that mfcc applies along the mel axis.
    """
    k = np.arange(n_out, dtype=dtype)[:, None]
    n = np.arange(n_in, dtype=dtype)[None, :]
    mat = 2.0 * np.cos(np.pi * k * (2 * n + 1) / (2.0 * n_in))
    # ortho scaling
    mat *= np.sqrt(1.0 / (4.0 * n_in))
    mat[0] *= np.sqrt(0.5)
    return mat * float(np.sqrt(2.0))


def mfcc(
    y: np.ndarray,
    sr: float,
    n_mfcc: int,
    n_fft: int,
    hop_length: int,
    n_mels: int = 128,
) -> np.ndarray:
    """MFCC sequence (n_mfcc, n_frames); librosa.feature.mfcc defaults:
    log-mel via power_to_db(ref=1.0, top_db=80) then ortho DCT-II over mels.
    Reference audio/classical.py:284-285, audio/deep.py:318-324.
    """
    S = melspectrogram(y, sr, n_mels=n_mels, n_fft=n_fft, hop_length=hop_length)
    S_db = power_to_db(S, ref=1.0, amin=1e-10, top_db=80.0)
    D = dct_ii_ortho_matrix(n_mfcc, n_mels, S_db.dtype)
    return D @ S_db


def _savgol_coeffs(window_length: int, polyorder: int, deriv: int, dtype=np.float64) -> np.ndarray:
    """Savitzky-Golay FIR coefficients (centered), via least-squares design."""
    import math

    half = (window_length - 1) // 2
    t = np.arange(-half, half + 1, dtype=dtype)
    A = np.vander(t, polyorder + 1, increasing=True)  # (w, p+1)
    pinv = np.linalg.pinv(A)
    # deriv-th derivative at t=0 of the LS polynomial = deriv! * c_deriv
    return pinv[deriv] * math.factorial(deriv)


def delta(data: np.ndarray, width: int = 9, order: int = 1, axis: int = -1) -> np.ndarray:
    """librosa.feature.delta: savgol_filter(width, polyorder=order,
    deriv=order, mode='interp'). Reference audio/classical.py:289-293.
    """
    data = np.moveaxis(_real(data), axis, -1)
    n = data.shape[-1]
    if n < width:
        raise ValueError(f"delta width {width} exceeds sequence length {n}")
    half = (width - 1) // 2
    coeffs = _savgol_coeffs(width, polyorder=order, deriv=order, dtype=data.dtype)
    # interior: correlation with coeffs
    out = np.empty_like(data)
    # full correlation over valid positions
    windows = np.lib.stride_tricks.sliding_window_view(data, width, axis=-1)
    out[..., half : n - half] = windows @ coeffs
    # edges, mode='interp': fit polyorder polynomial to first/last window,
    # evaluate its deriv-th derivative at the edge positions.
    import math

    t = np.arange(width, dtype=data.dtype)
    A = np.vander(t, order + 1, increasing=True)
    pinv = np.linalg.pinv(A)  # (order+1, width)
    # derivative polynomial coefficients evaluated at positions 0..half-1
    def _edge(block, positions):
        # block: (..., width); returns (..., len(positions)).
        # deriv-th derivative of sum_m c_m t^m is sum_{m>=d} c_m m!/(m-d)! t^{m-d}
        poly = block @ pinv.T  # (..., order+1) polynomial coeffs c0..c_order
        vals = np.zeros(block.shape[:-1] + (len(positions),), data.dtype)
        d = order
        for j, pos in enumerate(positions):
            acc = np.zeros(block.shape[:-1], data.dtype)
            for m in range(d, order + 1):
                fac = math.factorial(m) / math.factorial(m - d)
                acc = acc + poly[..., m] * fac * (pos ** (m - d))
            vals[..., j] = acc
        return vals

    out[..., :half] = _edge(data[..., :width], list(range(half)))
    out[..., n - half :] = _edge(data[..., n - width :], [width - half + i for i in range(half)])
    return np.moveaxis(out, -1, axis)


# ----------------------------------------------------------------------
# Chroma + tonnetz
# ----------------------------------------------------------------------


def _hz_to_octs(freqs: np.ndarray, tuning: float = 0.0, bins_per_octave: int = 12) -> np.ndarray:
    A440 = 440.0 * 2.0 ** (tuning / bins_per_octave)
    return np.log2(freqs / (A440 / 16))


def chroma_filterbank(
    sr: float,
    n_fft: int,
    n_chroma: int = 12,
    tuning: float = 0.0,
    ctroct: float = 5.0,
    octwidth: float = 2.0,
    base_c: bool = True,
    dtype=np.float64,
) -> np.ndarray:
    """Ellis chroma filterbank, shape (n_chroma, 1 + n_fft//2).

    Models librosa.filters.chroma. NOTE: librosa.feature.chroma_stft by
    default *estimates* tuning from the signal; this framework fixes
    tuning=0.0 (documented deviation — deterministic and batch-friendly).
    """
    frequencies = np.linspace(0, sr, n_fft, endpoint=False, dtype=dtype)[1:]
    frqbins = n_chroma * _hz_to_octs(frequencies, tuning=tuning, bins_per_octave=n_chroma)
    frqbins = np.concatenate(([frqbins[0] - 1.5 * n_chroma], frqbins))
    binwidthbins = np.concatenate((np.maximum(frqbins[1:] - frqbins[:-1], 1.0), np.ones(1, dtype)))
    D = np.subtract.outer(frqbins, np.arange(0, n_chroma, dtype=dtype)).T
    n_chroma2 = float(np.round(float(n_chroma) / 2))
    D = np.remainder(D + n_chroma2 + 10 * n_chroma, n_chroma) - n_chroma2
    wts = np.exp(-0.5 * (2 * D / np.tile(binwidthbins, (n_chroma, 1))) ** 2)
    # normalize each column by its L2 norm
    norms = np.sqrt(np.sum(wts**2, axis=0, keepdims=True))
    norms[norms < np.finfo(dtype).tiny] = 1.0
    wts = wts / norms
    if octwidth is not None:
        wts *= np.tile(np.exp(-0.5 * (((frqbins / n_chroma - ctroct) / octwidth) ** 2)), (n_chroma, 1))
    if base_c:
        wts = np.roll(wts, -3 * (n_chroma // 12), axis=0)
    return np.ascontiguousarray(wts[:, : int(1 + n_fft / 2)])


def _normalize_cols(S: np.ndarray, norm: float, axis: int = 0) -> np.ndarray:
    """librosa.util.normalize: columns with norm below float tiny unchanged."""
    if norm == np.inf:
        length = np.max(np.abs(S), axis=axis, keepdims=True)
    elif norm == 1:
        length = np.sum(np.abs(S), axis=axis, keepdims=True)
    elif norm == 2:
        length = np.sqrt(np.sum(np.abs(S) ** 2, axis=axis, keepdims=True))
    else:
        raise ValueError(norm)
    length = np.where(length < np.finfo(S.dtype).tiny, 1.0, length)
    return S / length


def chroma_stft(
    y: np.ndarray, sr: float, n_fft: int, hop_length: int, n_chroma: int = 12, mag_dtype=None
) -> np.ndarray:
    """Chromagram from power STFT, max-normalized per frame (tuning=0.0).

    Reference audio/classical.py:323-324.
    """
    S = magnitude(y, n_fft, hop_length, mag_dtype) ** 2
    fb = chroma_filterbank(sr, n_fft, n_chroma=n_chroma, dtype=S.dtype)
    raw = fb @ S
    return _normalize_cols(raw, norm=np.inf, axis=0)


def tonnetz(chroma: np.ndarray) -> np.ndarray:
    """Tonal centroid features (6, n_frames); librosa.feature.tonnetz
    (chroma= path). Reference audio/classical.py:336.
    """
    n_chroma = chroma.shape[-2]
    dim_map = np.linspace(0, 12, num=n_chroma, endpoint=False, dtype=chroma.dtype)
    scale = np.asarray([7.0 / 6, 7.0 / 6, 3.0 / 2, 3.0 / 2, 2.0 / 3, 2.0 / 3], dtype=chroma.dtype)
    V = np.multiply.outer(scale, dim_map)
    V[::2] -= 0.5
    R = np.array([1, 1, 1, 1, 0.5, 0.5], dtype=chroma.dtype)
    phi = R[:, None] * np.cos(np.pi * V)
    return phi @ _normalize_cols(chroma, norm=1, axis=-2)


# ----------------------------------------------------------------------
# Spectral descriptors
# ----------------------------------------------------------------------


def spectral_centroid(y: np.ndarray, sr: float, n_fft: int, hop_length: int, mag_dtype=None) -> np.ndarray:
    S = magnitude(y, n_fft, hop_length, mag_dtype)
    freq = fft_frequencies(sr, n_fft, S.dtype)
    Sn = _normalize_cols(S, norm=1, axis=-2)
    return np.sum(freq[:, None] * Sn, axis=-2, keepdims=True)


def spectral_rolloff(
    y: np.ndarray, sr: float, n_fft: int, hop_length: int, roll_percent: float = 0.85, mag_dtype=None
) -> np.ndarray:
    S = magnitude(y, n_fft, hop_length, mag_dtype)
    freq = fft_frequencies(sr, n_fft, S.dtype)
    total = np.cumsum(S, axis=-2)
    threshold = roll_percent * total[-1:, :]
    ind = np.where(total < threshold, np.nan, 1.0).astype(S.dtype)
    return np.nanmin(ind * freq[:, None], axis=-2, keepdims=True)


def spectral_bandwidth(
    y: np.ndarray, sr: float, n_fft: int, hop_length: int, p: float = 2.0, mag_dtype=None
) -> np.ndarray:
    S = magnitude(y, n_fft, hop_length, mag_dtype)
    freq = fft_frequencies(sr, n_fft, S.dtype)
    centroid = spectral_centroid(y, sr, n_fft, hop_length, mag_dtype)
    deviation = np.abs(freq[:, None] - centroid)
    Sn = _normalize_cols(S, norm=1, axis=-2)
    return np.sum(Sn * deviation**p, axis=-2, keepdims=True) ** (1.0 / p)


def spectral_contrast(
    y: np.ndarray,
    sr: float,
    n_fft: int,
    hop_length: int,
    fmin: float = 200.0,
    n_bands: int = 6,
    quantile: float = 0.02,
    linear: bool = False,
    mag_dtype=None,
) -> np.ndarray:
    """Octave-band peak-valley contrast (n_bands+1, n_frames)."""
    S = magnitude(y, n_fft, hop_length, mag_dtype)
    freq = fft_frequencies(sr, n_fft, S.dtype)
    octa = np.zeros(n_bands + 2)
    octa[1:] = fmin * (2.0 ** np.arange(0, n_bands + 1))
    valley = np.zeros((n_bands + 1, S.shape[-1]), S.dtype)
    peak = np.zeros_like(valley)
    for k, (f_low, f_high) in enumerate(zip(octa[:-1], octa[1:])):
        current_band = np.logical_and(freq >= f_low, freq <= f_high)
        idx = np.flatnonzero(current_band)
        if k > 0:
            current_band[idx[0] - 1] = True
        if k == n_bands:
            current_band[idx[-1] + 1 :] = True
        sub_band = S[current_band]
        if k < n_bands:
            sub_band = sub_band[:-1]
        nsel = int(np.maximum(np.rint(quantile * np.sum(current_band)), 1))
        sortedr = np.sort(sub_band, axis=-2)
        valley[k] = np.mean(sortedr[:nsel], axis=-2)
        peak[k] = np.mean(sortedr[-nsel:], axis=-2)
    if linear:
        return peak - valley
    return power_to_db(peak) - power_to_db(valley)


def spectral_flatness(
    y: np.ndarray, n_fft: int, hop_length: int, amin: float = 1e-10, power: float = 2.0, mag_dtype=None
) -> np.ndarray:
    S = magnitude(y, n_fft, hop_length, mag_dtype)
    S_thresh = np.maximum(amin, S**power)
    gmean = np.exp(np.mean(np.log(S_thresh), axis=-2, keepdims=True))
    amean = np.mean(S_thresh, axis=-2, keepdims=True)
    return gmean / amean


def zero_crossing_rate(
    y: np.ndarray, frame_length: int = 2048, hop_length: int = 512, threshold: float = 1e-10
) -> np.ndarray:
    """librosa.feature.zero_crossing_rate: edge padding, signbit diffs,
    pad=True so the first row of each frame counts as no crossing.
    Reference audio/classical.py:328.
    """
    y = _real(y)
    y_pad = np.pad(y, frame_length // 2, mode="edge")
    frames = frame_signal(y_pad, frame_length, hop_length)  # (n_frames, frame_length)
    yy = frames.copy()
    yy[np.abs(yy) <= threshold] = 0.0
    sb = np.signbit(yy)
    crossings = np.abs(np.diff(sb, axis=-1)).astype(y.dtype)
    crossings = np.concatenate([np.zeros((frames.shape[0], 1), y.dtype), crossings], axis=-1)
    return crossings.mean(axis=-1)[None, :]


def rms(y: np.ndarray, frame_length: int, hop_length: int) -> np.ndarray:
    """librosa.feature.rms with center=True constant padding.
    Reference audio/classical.py:332.
    """
    y = _real(y)
    y_pad = np.pad(y, frame_length // 2, mode="constant")
    frames = frame_signal(y_pad, frame_length, hop_length)
    return np.sqrt(np.mean(frames**2, axis=-1))[None, :]


# ----------------------------------------------------------------------
# End-to-end feature functions (mirror the registered extractors)
# ----------------------------------------------------------------------


def mfcc_seq_feature(
    y: np.ndarray, sr: float = 22050, n_mfcc: int = 40, n_fft: int = 1024, hop_length: int = 512,
    dtype=np.float64,
) -> np.ndarray:
    """audio_mfcc_seq contract: per-coefficient z-score; audio/deep.py:304-328."""
    M = mfcc(np.asarray(y, dtype), sr, n_mfcc=n_mfcc, n_fft=n_fft, hop_length=hop_length)
    mean = M.mean(axis=1, keepdims=True)
    std = M.std(axis=1, keepdims=True) + 1e-8
    return (M - mean) / std


def waveform_feature(y: np.ndarray) -> np.ndarray:
    """audio_waveform contract: peak-normalize to [-1,1]; audio/deep.py:170-188."""
    y = _real(y)
    peak = np.abs(y).max()
    return y / peak if peak > 0 else y


# ----------------------------------------------------------------------
# Constant-Q transform (single-resolution frequency-domain filterbank)
# ----------------------------------------------------------------------

C1_HZ = 32.70319566257483  # librosa.note_to_hz('C1'), default cqt fmin


def cqt_basis(
    sr: float,
    fmin: float,
    n_bins: int,
    bins_per_octave: int,
    filter_scale: float = 1.0,
) -> tuple[np.ndarray, np.ndarray, int]:
    """Frequency-domain CQT kernels.

    Returns (fft_basis (n_bins, 1+n_fft//2) complex, lengths (n_bins,), n_fft).

    The CQT here is a single-resolution frequency-domain filterbank (one
    rectangular-window STFT times a complex kernel matrix), not librosa's
    recursive multirate algorithm. Each kernel is a centered, L1-normalized,
    periodic-Hann-windowed complex exponential; the output is scaled by
    1/sqrt(len_k) (librosa's scale=True convention).
    """
    Q = filter_scale / (2.0 ** (1.0 / bins_per_octave) - 1.0)
    freqs = fmin * 2.0 ** (np.arange(n_bins) / bins_per_octave)
    if freqs[-1] > sr / 2.0:
        raise ValueError("CQT top bin exceeds Nyquist; lower n_bins or raise sr")
    lengths = np.ceil(Q * sr / freqs).astype(int)
    n_fft = int(2 ** np.ceil(np.log2(lengths.max())))
    basis = np.zeros((n_bins, n_fft), dtype=np.complex128)
    for k in range(n_bins):
        Nk = int(lengths[k])
        win = hann_periodic(Nk)
        t = np.arange(Nk, dtype=np.float64) - Nk // 2
        kernel = win * np.exp(2j * np.pi * freqs[k] * t / sr)
        kernel /= np.sum(np.abs(kernel))
        start = (n_fft - Nk) // 2
        basis[k, start : start + Nk] = kernel
    basis *= lengths[:, None] / float(n_fft)
    fft_basis = np.fft.fft(basis, axis=-1)[:, : n_fft // 2 + 1]
    return fft_basis, lengths.astype(np.float64), n_fft


def cqt_time_basis(
    sr: float,
    fmin: float,
    n_bins: int,
    bins_per_octave: int,
    filter_scale: float = 1.0,
) -> tuple[np.ndarray, int]:
    """Exact time-domain equivalent of the half-spectrum product
    ``fft_basis @ rfft(frame)``: with G the fft_basis zero-extended to the
    full spectrum, sum_f G[f] X[f] = sum_n h[n] x[n] where h = FFT(G).
    With the 1/sqrt(len) output scale folded into h, the CQT is one pair of
    real products against each frame (the FFTs run here, in float64).

    Returns (h (n_bins, n_fft) complex128, n_fft).
    """
    fft_basis, lengths, n_fft = cqt_basis(sr, fmin, n_bins, bins_per_octave, filter_scale)
    G = np.zeros((n_bins, n_fft), dtype=np.complex128)
    G[:, : n_fft // 2 + 1] = fft_basis
    h = np.fft.fft(G, axis=-1) / np.sqrt(lengths)[:, None]
    return h, n_fft


def cqt(
    y: np.ndarray,
    sr: float,
    hop_length: int,
    n_bins: int,
    bins_per_octave: int = 12,
    fmin: float | None = None,
) -> np.ndarray:
    """|CQT| magnitude, shape (n_bins, n_frames), in the role of librosa.cqt
    (see cqt_basis for the algorithm)."""
    if fmin is None:
        fmin = C1_HZ
    fft_basis, lengths, n_fft = cqt_basis(sr, fmin, n_bins, bins_per_octave)
    D = stft(y, n_fft=n_fft, hop_length=hop_length, window="ones")
    C = fft_basis @ D
    C /= np.sqrt(lengths)[:, None]
    return np.abs(C)


def cqt_feature(
    y: np.ndarray,
    sr: float = 22050,
    hop_length: int = 512,
    n_bins: int = 84,
    bins_per_octave: int = 12,
    fmin: float | None = None,
) -> np.ndarray:
    """audio_cqt contract: |CQT| -> amplitude_to_db(ref=max) -> [0,1]."""
    C = cqt(y, sr, hop_length=hop_length, n_bins=n_bins, bins_per_octave=bins_per_octave, fmin=fmin)
    log_cqt = amplitude_to_db(C, ref="max")
    return minmax_normalize(log_cqt)


_ALL_CLASSICAL = [
    "mfcc",
    "delta_mfcc",
    "delta2_mfcc",
    "spectral_centroid",
    "spectral_rolloff",
    "spectral_bandwidth",
    "spectral_contrast",
    "spectral_flatness",
    "chroma",
    "zcr",
    "rms",
    "tonnetz",
]


def classical_feature_vector(
    y: np.ndarray,
    sr: float = 22050,
    n_mfcc: int = 40,
    n_mels: int = 128,
    n_fft: int = 1024,
    hop_length: int = 512,
    features: list[str] | None = None,
    aggregations: list[str] | None = None,
    dtype=np.float64,
    mag_dtype=None,
) -> np.ndarray:
    """audio_classical contract: per-group mean/std aggregation in canonical
    order -> flat vector (302-d default). Reference audio/classical.py:272-355.
    """
    y = np.asarray(y, dtype)
    feats = list(_ALL_CLASSICAL) if features is None else [k for k in _ALL_CLASSICAL if k in set(features)]
    aggs = ["mean", "std"] if aggregations is None else [a for a in ["mean", "std"] if a in set(aggregations)]
    active = set(feats)

    def agg(x, scalar=False):
        parts = []
        if "mean" in aggs:
            parts.append(np.array([x.mean()], x.dtype) if scalar else x.mean(axis=1))
        if "std" in aggs:
            parts.append(np.array([x.std()], x.dtype) if scalar else x.std(axis=1))
        return np.concatenate(parts)

    cache: dict[str, np.ndarray] = {}
    if active & {"mfcc", "delta_mfcc", "delta2_mfcc"}:
        cache["mfcc"] = mfcc(y, sr, n_mfcc=n_mfcc, n_fft=n_fft, hop_length=hop_length, n_mels=n_mels)
    if "delta_mfcc" in active:
        cache["delta_mfcc"] = delta(cache["mfcc"], order=1)
    if "delta2_mfcc" in active:
        cache["delta2_mfcc"] = delta(cache["mfcc"], order=2)
    if "spectral_centroid" in active:
        cache["spectral_centroid"] = spectral_centroid(y, sr, n_fft, hop_length, mag_dtype=mag_dtype)
    if "spectral_rolloff" in active:
        cache["spectral_rolloff"] = spectral_rolloff(y, sr, n_fft, hop_length, mag_dtype=mag_dtype)
    if "spectral_bandwidth" in active:
        cache["spectral_bandwidth"] = spectral_bandwidth(y, sr, n_fft, hop_length, mag_dtype=mag_dtype)
    if "spectral_contrast" in active:
        cache["spectral_contrast"] = spectral_contrast(y, sr, n_fft, hop_length, mag_dtype=mag_dtype)
    if "spectral_flatness" in active:
        cache["spectral_flatness"] = spectral_flatness(y, n_fft, hop_length, mag_dtype=mag_dtype)
    if active & {"chroma", "tonnetz"}:
        cache["chroma"] = chroma_stft(y, sr, n_fft, hop_length, mag_dtype=mag_dtype)
    if "zcr" in active:
        cache["zcr"] = zero_crossing_rate(y, hop_length=hop_length)
    if "rms" in active:
        cache["rms"] = rms(y, frame_length=n_fft, hop_length=hop_length)
    if "tonnetz" in active:
        cache["tonnetz"] = tonnetz(cache["chroma"])

    scalar_groups = {"spectral_centroid", "spectral_rolloff", "spectral_bandwidth", "spectral_flatness", "zcr", "rms"}
    parts = [agg(cache[k], scalar=(k in scalar_groups)) for k in feats]
    return np.concatenate(parts)
