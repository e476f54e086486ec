"""Port parity: the port's own copies of the WAV codec and the audio loaders
against the JAX package's data/audio_io.py and data/loaders.py."""

import json
import struct
import wave

import numpy as np
import pytest
import torch

import make_synth_dataset
from audio_edge_ml_pipeline_tpu.data import audio_io as jio
from audio_edge_ml_pipeline_tpu.data import loaders as jloaders
from audio_edge_ml_pipeline_torch.data import audio_io as tio
from audio_edge_ml_pipeline_torch.data import loaders as tloaders


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _write_raw(path, frames: bytes, rate: int, channels: int, bits: int, fmt_tag: int = 1):
    block = channels * bits // 8
    fmt = struct.pack("<HHIIHH", fmt_tag, channels, rate, rate * block, block, bits)
    body = b"WAVE" + b"fmt " + struct.pack("<I", len(fmt)) + fmt + b"data" + struct.pack("<I", len(frames)) + frames
    path.write_bytes(b"RIFF" + struct.pack("<I", len(body)) + body)


def _wav_variants(tmp_path, rng):
    y = (0.6 * rng.standard_normal((2205, 2))).clip(-1, 1)
    files = {}
    files["pcm16_stereo"] = tmp_path / "a.wav"
    tio.write_wav(files["pcm16_stereo"], y, 22050)
    files["float32"] = tmp_path / "b.wav"
    _write_raw(files["float32"], y[:, 0].astype("<f4").tobytes(), 16000, 1, 32, fmt_tag=3)
    ints = np.round(y[:, 0] * 8388607).astype(np.int32)
    files["pcm24"] = tmp_path / "c.wav"
    _write_raw(files["pcm24"], b"".join(int(v).to_bytes(3, "little", signed=True) for v in ints), 48000, 1, 24)
    files["pcm8"] = tmp_path / "d.wav"
    _write_raw(files["pcm8"], (np.round(y[:, 1] * 127) + 128).astype(np.uint8).tobytes(), 8000, 1, 8)
    return files


def test_write_wav_bytes_equal_jax(tmp_path, rng):
    y = (0.5 * rng.standard_normal(3000)).astype(np.float32)
    tio.write_wav(tmp_path / "t.wav", y, 16000)
    jio.write_wav(tmp_path / "j.wav", y, 16000)
    assert (tmp_path / "t.wav").read_bytes() == (tmp_path / "j.wav").read_bytes()
    with wave.open(str(tmp_path / "t.wav")) as w:
        assert (w.getnchannels(), w.getsampwidth(), w.getframerate()) == (1, 2, 16000)


@pytest.mark.parametrize("kind", ["pcm16_stereo", "float32", "pcm24", "pcm8"])
def test_decode_equals_jax(tmp_path, rng, kind):
    path = _wav_variants(tmp_path, rng)[kind]
    (ty, tsr), (jy, jsr) = tio.read_wav(path), jio.read_wav(path)
    assert tsr == jsr
    np.testing.assert_array_equal(ty, jy)
    assert tio.probe_audio(path) == jio.probe_audio(path)
    for kw in ({"sr": 16000}, {"sr": None, "offset": 0.01, "duration": 0.05}):
        (tl, tr), (jl, jr) = tio.load_audio(path, **kw), jio.load_audio(path, **kw)
        assert tr == jr and tl.dtype == jl.dtype == np.float32
        np.testing.assert_array_equal(tl, jl)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = tmp_path_factory.mktemp("trees")
    make_synth_dataset.make_fsc22(root / "fsc22", n_classes=4, per_class=5, sr=8000)
    make_synth_dataset.make_audio_folder(root / "af", n_classes=2, per_class=3, sr=8000)
    return root


def _listing(loader):
    return [(str(p), label, meta) for p, label, meta in loader]


@pytest.mark.parametrize("split", ["train", "validation", "test", "all"])
def test_fsc22_loader_equals_jax(trees, split):
    for cf in (None, ["Fire", "Rain"]):
        ours = tloaders.build_loader("fsc22", str(trees / "fsc22"), split, class_filter=cf)
        theirs = jloaders.build_loader("fsc22", str(trees / "fsc22"), split, class_filter=cf)
        assert _listing(ours) == _listing(theirs)
        assert len(ours) == len(theirs) and ours.class_names == theirs.class_names


def test_audio_folder_loader_with_manifest_equals_jax(trees):
    manifest = trees / "manifest.json"
    manifest.write_text(json.dumps({"train": ["Chainsaw/clip_000.wav", "Fire/clip_002.wav"]}))
    for kw in ({}, {"manifest": str(manifest), "manifest_split": "train"}):
        ours = tloaders.build_loader("audio_folder", str(trees / "af"), "all", **kw)
        theirs = jloaders.build_loader("audio_folder", str(trees / "af"), "all", **kw)
        assert _listing(ours) == _listing(theirs)
    assert tloaders.stratified_split_indices(list("aabbbcccc"), 0.5, 0.25, 3) == \
        jloaders.stratified_split_indices(list("aabbbcccc"), 0.5, 0.25, 3)
