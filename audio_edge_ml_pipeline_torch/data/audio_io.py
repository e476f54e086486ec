"""Host-side audio I/O: WAV codec + polyphase resampling (numpy).

The framework needs neither librosa nor soundfile: it ships its own
vectorized WAV reader/writer (RIFF PCM 8/16/24/32-bit and IEEE float) and a
kaiser-windowed polyphase resampler (scipy.signal.resample_poly). The
public ``load_audio`` mirrors the semantics of ``librosa.load(path, sr=...,
offset=..., duration=..., mono=True)`` as used by the reference extractors
(reference audio/deep.py:30-55, audio/classical.py:240-270): native-rate
seek, channel-mean downmix, float32 in [-1, 1], resample to the target rate.
"""

from __future__ import annotations

import math
import struct
import wave
from functools import lru_cache
from pathlib import Path

import numpy as np

__all__ = ["read_wav", "write_wav", "load_audio", "probe_audio", "resample"]

_WAVE_FORMAT_PCM = 1
_WAVE_FORMAT_IEEE_FLOAT = 3
_WAVE_FORMAT_EXTENSIBLE = 0xFFFE


def _parse_chunks(buf: bytes):
    """Yield (chunk_id, offset, size) for every RIFF chunk in the file."""
    if len(buf) < 12 or buf[:4] != b"RIFF" or buf[8:12] != b"WAVE":
        raise ValueError("not a RIFF/WAVE file")
    pos = 12
    while pos + 8 <= len(buf):
        cid = buf[pos : pos + 4]
        (size,) = struct.unpack_from("<I", buf, pos + 4)
        yield cid, pos + 8, size
        pos += 8 + size + (size & 1)  # chunks are word-aligned


def read_wav(path: Path | str) -> tuple[np.ndarray, int]:
    """Read a WAV file -> (float32 samples (n, channels) in [-1, 1], rate)."""
    buf = Path(path).read_bytes()
    fmt = None
    fmt_off = fmt_size = 0
    data_off = data_size = None
    for cid, off, size in _parse_chunks(buf):
        if cid == b"fmt ":
            fmt = struct.unpack_from("<HHIIHH", buf, off)
            fmt_off, fmt_size = off, size
        elif cid == b"data":
            data_off, data_size = off, min(size, len(buf) - off)
    if fmt is None or data_off is None:
        raise ValueError(f"WAV missing fmt/data chunk: {path}")
    audio_format, n_channels, rate, _, block_align, bits = fmt
    if audio_format == _WAVE_FORMAT_EXTENSIBLE and fmt_size >= 26:
        # WAVE_FORMAT_EXTENSIBLE: real format tag = first 2 bytes of the
        # SubFormat GUID at fmt offset + 24
        (audio_format,) = struct.unpack_from("<H", buf, fmt_off + 24)
        if audio_format not in (_WAVE_FORMAT_PCM, _WAVE_FORMAT_IEEE_FLOAT):
            audio_format = _WAVE_FORMAT_IEEE_FLOAT if bits == 32 else _WAVE_FORMAT_PCM
    raw = buf[data_off : data_off + data_size]
    if audio_format == _WAVE_FORMAT_IEEE_FLOAT:
        dt = np.float32 if bits == 32 else np.float64
        x = np.frombuffer(raw, dtype=dt).astype(np.float32)
    elif audio_format == _WAVE_FORMAT_PCM:
        if bits == 16:
            x = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
        elif bits == 32:
            x = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
        elif bits == 8:
            x = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
        elif bits == 24:
            b = np.frombuffer(raw, dtype=np.uint8)
            b = b[: (len(b) // 3) * 3].reshape(-1, 3)
            vals = (
                b[:, 0].astype(np.int32)
                | (b[:, 1].astype(np.int32) << 8)
                | (b[:, 2].astype(np.int32) << 16)
            )
            vals = np.where(vals & 0x800000, vals - 0x1000000, vals)
            x = vals.astype(np.float32) / 8388608.0
        else:
            raise ValueError(f"unsupported PCM bit depth {bits}: {path}")
    else:
        raise ValueError(f"unsupported WAV format tag {audio_format}: {path}")
    n = len(x) // n_channels
    return x[: n * n_channels].reshape(n, n_channels), rate


def write_wav(path: Path | str, y: np.ndarray, rate: int) -> None:
    """Write float [-1,1] (n,) or (n, channels) as 16-bit PCM WAV."""
    y = np.asarray(y)
    if y.ndim == 1:
        y = y[:, None]
    pcm = np.clip(np.round(y * 32767.0), -32768, 32767).astype("<i2")
    with wave.open(str(path), "wb") as w:
        w.setnchannels(y.shape[1])
        w.setsampwidth(2)
        w.setframerate(int(rate))
        w.writeframes(pcm.tobytes())


def probe_audio(path: Path | str) -> dict:
    """Header-only probe -> {duration, sample_rate, n_channels}; zeros on
    failure (contract of reference audio_folder_loader._audio_meta:76-103)."""
    try:
        buf_head = Path(path).open("rb").read(64 * 1024)
        fmt = None
        data_size = None
        for cid, off, size in _parse_chunks(buf_head):
            if cid == b"fmt ":
                fmt = struct.unpack_from("<HHIIHH", buf_head, off)
            elif cid == b"data":
                data_size = size
        if fmt is None:
            return {"duration": 0.0, "sample_rate": 0, "n_channels": 0}
        _, n_channels, rate, _, block_align, bits = fmt
        if data_size is None:
            data_size = max(Path(path).stat().st_size - 44, 0)
        n_frames = data_size // max(block_align, 1)
        return {
            "duration": n_frames / rate if rate else 0.0,
            "sample_rate": int(rate),
            "n_channels": int(n_channels),
        }
    except Exception:
        return {"duration": 0.0, "sample_rate": 0, "n_channels": 0}


_RATIO_EXACT_CAP = 1024  # all standard rate pairs (441/320 etc.) stay exact
_RATIO_APPROX_DEN = 256  # near-coprime ratios: preferred denominator cap
_RATIO_REL_TOL = 1.5e-5  # <= 0.03 cent of rate error, always honoured


@lru_cache(maxsize=64)
def _resample_ratio(orig: int, target: int) -> tuple[int, int]:
    """Reduced up/down for resample_poly; near-coprime pairs are snapped to
    a bounded-denominator rational. Pitch-shift ratios like 16000/17959 are
    coprime, and resample_poly's FIR taps scale with max(up, down) —
    measured 817 ms/clip for a 2-semitone shift at the exact ratio vs
    ~milliseconds at the 0.03-cent approximation. Every standard rate pair
    (16k/22.05k/44.1k/48k...) reduces under the cap and remains exact.

    The denominator cap escalates until the snapped ratio is within
    _RATIO_REL_TOL of the true one: near-unity ratios (tiny pitch shifts,
    e.g. 16000/15977) would otherwise snap to 1/1 — a silent no-op resample
    with ~1e-3 rate error, ~100x the documented bound."""
    gg = math.gcd(int(orig), int(target))
    up, down = int(target) // gg, int(orig) // gg
    if max(up, down) <= _RATIO_EXACT_CAP:
        return up, down
    from fractions import Fraction

    exact = Fraction(int(target), int(orig))
    cap = _RATIO_APPROX_DEN
    while cap < max(up, down):
        fr = exact.limit_denominator(cap)
        if fr > 0 and abs(fr - exact) / exact <= _RATIO_REL_TOL:
            return fr.numerator, fr.denominator
        cap *= 4
    return up, down


def resample(y: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Polyphase FIR resampling (kaiser window), float32 out."""
    if orig_sr == target_sr:
        return y.astype(np.float32, copy=False)
    from scipy.signal import resample_poly

    up, down = _resample_ratio(orig_sr, target_sr)
    return resample_poly(y.astype(np.float64), up, down).astype(np.float32)


def load_audio(
    path: Path | str,
    sr: int | None = None,
    offset: float = 0.0,
    duration: float | None = None,
    mono: bool = True,
) -> tuple[np.ndarray, int]:
    """librosa.load-compatible decode: seek at native rate, mean-downmix,
    resample to ``sr``. Returns (float32 (n,), sample_rate). Numpy decoder
    only; the samples equal those of the JAX package's native C++ reader."""
    y, native_sr = read_wav(path)
    y = (y.mean(axis=1) if y.shape[1] > 1 else y[:, 0]) if mono else y
    if offset or duration is not None:
        start = int(round(offset * native_sr))
        stop = len(y) if duration is None else start + int(round(duration * native_sr))
        y = y[start:stop]
    out_sr = native_sr if sr is None else int(sr)
    y = resample(y, native_sr, out_sr)
    return np.ascontiguousarray(y, dtype=np.float32), out_sr
