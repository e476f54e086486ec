"""The port's native WAV reader (audio_edge_ml_pipeline_torch.data.
native_wavio, built from csrc/wavio.cpp by ops/_build.py with g++) against
the JAX package's native reader and the port's numpy codec: the same samples,
bit for bit, on 8-, 16-, 24- and 32-bit PCM, float32 and float64, mono and
stereo, odd lengths; the same failures; and load_audio with the library and
without it."""

from __future__ import annotations

import hashlib
import logging
import struct
from pathlib import Path

import numpy as np
import pytest

from audio_edge_ml_pipeline_tpu.data import audio_io as jaudio_io
from audio_edge_ml_pipeline_tpu.data import native_wavio as jnative
from audio_edge_ml_pipeline_torch.data import audio_io, native_wavio
from audio_edge_ml_pipeline_torch.ops import _build

REPO = Path(__file__).resolve().parent.parent


def _riff(path: Path, data: bytes, fmt_tag: int, channels: int, rate: int, bits: int) -> Path:
    block = channels * bits // 8
    fmt = struct.pack("<HHIIHH", fmt_tag, channels, rate, rate * block, block, bits)
    body = b"WAVE" + b"fmt " + struct.pack("<I", len(fmt)) + fmt + b"data" + struct.pack("<I", len(data)) + data
    if len(data) & 1:
        body += b"\x00"  # chunks are word-aligned
    path.write_bytes(b"RIFF" + struct.pack("<I", len(body)) + body)
    return path


def _encode(rng: np.random.Generator, kind: str, n: int, channels: int) -> tuple[bytes, int, int]:
    """Random samples of ``kind`` -> (data bytes, format tag, bits)."""
    shape = (n, channels)
    if kind == "pcm8":
        return rng.integers(0, 256, shape, dtype=np.uint8).tobytes(), 1, 8
    if kind == "pcm16":
        return rng.integers(-32768, 32768, shape).astype("<i2").tobytes(), 1, 16
    if kind == "pcm24":
        v = rng.integers(-(1 << 23), 1 << 23, shape).astype("<i4").reshape(-1)
        return v.view(np.uint8).reshape(-1, 4)[:, :3].tobytes(), 1, 24
    if kind == "pcm32":
        return rng.integers(-(1 << 31), 1 << 31, shape).astype("<i4").tobytes(), 1, 32
    if kind == "float32":
        return rng.uniform(-1, 1, shape).astype("<f4").tobytes(), 3, 32
    return rng.uniform(-1, 1, shape).astype("<f8").tobytes(), 3, 64


CASES = [(kind, 1, n) for kind in ("pcm8", "pcm16", "pcm24", "pcm32", "float32", "float64")
         for n in (1, 4001)] + [("pcm16", 2, 3999), ("float32", 2, 3001), ("pcm24", 2, 777)]


@pytest.fixture(scope="module")
def wav_files(tmp_path_factory):
    root = tmp_path_factory.mktemp("wavio")
    rng = np.random.default_rng(13)
    files = {}
    for kind, channels, n in CASES:
        data, tag, bits = _encode(rng, kind, n, channels)
        files[(kind, channels, n)] = _riff(root / f"{kind}_{channels}_{n}.wav", data, tag, channels, 22050, bits)
    return files


def test_the_library_builds_under_build_and_leaves_native_alone():
    def snapshot():
        return {p.name: hashlib.sha256(p.read_bytes()).hexdigest() for p in sorted((REPO / "native").iterdir())}

    before = snapshot()
    assert native_wavio.available()
    lib = _build.library_path("wavio")
    assert lib.is_file() and lib.parent == REPO / "build" / "kernels" and lib.name.startswith("libwavio-")
    assert snapshot() == before
    assert _build.CXX_FLAGS == ("-O3", "-std=c++17", "-fPIC", "-Wall", "-pthread", "-shared")


def test_the_source_is_the_jax_readers_code():
    """csrc/wavio.cpp is native/wavio.cpp with its header comment rewritten."""
    ours = (REPO / "audio_edge_ml_pipeline_torch" / "csrc" / "wavio.cpp").read_text()
    theirs = (REPO / "native" / "wavio.cpp").read_text()
    body = "#include <cstdint>"
    assert ours[ours.index(body):] == theirs[theirs.index(body):]


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-{c[1]}ch-{c[2]}")
def test_decode_equals_jax_native_and_the_numpy_codec(wav_files, case):
    path = wav_files[case]
    kind, channels, n = case
    ours, rate = native_wavio.decode(path, n)
    theirs, jrate = jnative.decode(path, n)
    y, nrate = audio_io.read_wav(path)
    mono = y.mean(axis=1) if channels > 1 else y[:, 0]
    assert rate == jrate == nrate == 22050
    assert ours.dtype == np.float32 and ours.shape == (n,)
    np.testing.assert_array_equal(ours, theirs)
    np.testing.assert_array_equal(ours, mono)
    # a larger capacity trims to the true length; a smaller one caps it
    np.testing.assert_array_equal(native_wavio.decode(path, n + 10)[0], ours)
    np.testing.assert_array_equal(native_wavio.decode(path, max(n // 2, 1))[0], ours[: max(n // 2, 1)])


def test_stereo_on_the_numpy_path_equals_jax(wav_files):
    for case in [c for c in CASES if c[1] == 2]:
        path = wav_files[case]
        y, rate = audio_io.load_audio(path, mono=False)
        jy, jrate = jaudio_io.load_audio(path, mono=False)
        assert y.shape == (case[2], 2) and rate == jrate
        np.testing.assert_array_equal(y, jy)


def test_failures_return_none_and_negative_batch_lengths(wav_files, tmp_path):
    good = wav_files[("pcm16", 1, 4001)]
    missing = tmp_path / "missing.wav"
    truncated = tmp_path / "truncated.wav"
    truncated.write_bytes(good.read_bytes()[:20])   # cut inside the fmt chunk
    garbage = tmp_path / "garbage.wav"
    garbage.write_bytes(b"not a riff file at all")
    for bad in (missing, truncated, garbage):
        assert native_wavio.decode(bad, 100) is None and jnative.decode(bad, 100) is None
    waves, lengths, rates = native_wavio.decode_batch([good, missing, truncated, garbage, good], 5000)
    jwaves, jlengths, _ = jnative.decode_batch([good, missing, truncated, garbage, good], 5000)
    assert waves.shape == (5, 5000) and waves.dtype == np.float32
    assert lengths[0] == lengths[4] == 4001 and (lengths[1:4] < 0).all()
    np.testing.assert_array_equal(lengths, jlengths)
    np.testing.assert_array_equal(waves, jwaves)
    assert rates[0] == 22050 and not waves[1:4].any()
    np.testing.assert_array_equal(waves[0, :4001], native_wavio.decode(good, 4001)[0])


def test_decode_batch_threads_agree(wav_files):
    paths = [wav_files[c] for c in CASES if c[2] > 1]
    cap = max(c[2] for c in CASES)
    one = native_wavio.decode_batch(paths, cap, n_threads=1)
    many = native_wavio.decode_batch(paths, cap, n_threads=4)
    for a, b in zip(one, many):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kwargs", [{}, {"sr": 16000}, {"sr": 16000, "offset": 0.05, "duration": 0.1}])
def test_load_audio_with_and_without_the_library(wav_files, monkeypatch, kwargs):
    for case in [("pcm16", 1, 4001), ("float32", 2, 3001), ("pcm24", 1, 4001)]:
        path = wav_files[case]
        calls = []
        decode = native_wavio.decode
        monkeypatch.setattr(native_wavio, "decode", lambda *a: calls.append(a) or decode(*a))
        with_lib, sr1 = audio_io.load_audio(path, **kwargs)
        assert len(calls) == 1
        monkeypatch.setattr(native_wavio, "decode", lambda *a: None)
        without, sr2 = audio_io.load_audio(path, **kwargs)
        jy, jsr = jaudio_io.load_audio(path, **kwargs)
        assert sr1 == sr2 == jsr
        np.testing.assert_array_equal(with_lib, without)
        np.testing.assert_array_equal(with_lib, jy)


def test_no_compiler_falls_back_with_one_warning(wav_files, monkeypatch, caplog, tmp_path):
    monkeypatch.setattr(native_wavio, "_lib", None)
    monkeypatch.setattr(native_wavio, "_load_attempted", False)
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")   # nothing built there

    def no_cxx():
        raise RuntimeError("no C++ compiler found")

    monkeypatch.setattr(_build, "cxx_path", no_cxx)
    path = wav_files[("pcm16", 1, 4001)]
    with caplog.at_level(logging.WARNING, logger=native_wavio.__name__):
        assert not native_wavio.available()
        assert native_wavio.decode(path, 4001) is None and native_wavio.decode_batch([path], 4001) is None
        y, _ = audio_io.load_audio(path)
    warnings = [r for r in caplog.records if r.name == native_wavio.__name__]
    assert len(warnings) == 1 and warnings[0].levelno == logging.WARNING
    assert "numpy codec" in warnings[0].getMessage()
    np.testing.assert_array_equal(y, audio_io.read_wav(path)[0][:, 0])
