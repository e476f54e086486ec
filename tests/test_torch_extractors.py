"""Port parity: the audio_waveform, audio_mfcc_seq and audio_classical
extractors of audio_edge_ml_pipeline_torch, the exact-length batching of
features/base.py, and the extraction CLI on a copy of
configs/feature_extraction.yaml, against the JAX package and the float64
golden oracle (CPU)."""

from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

import make_synth_dataset
from audio_edge_ml_pipeline_tpu import features as jfeatures
from audio_edge_ml_pipeline_tpu.features import pipeline as jpipeline
from audio_edge_ml_pipeline_tpu.features.config import load_config as jload_config
from audio_edge_ml_pipeline_torch import features as tfeatures
from audio_edge_ml_pipeline_torch.data.audio_io import load_audio, write_wav
from audio_edge_ml_pipeline_torch.data.loaders import AudioFolderLoader
from audio_edge_ml_pipeline_torch.features import audio as taudio
from audio_edge_ml_pipeline_torch.features import pipeline as tpipeline
from audio_edge_ml_pipeline_torch.features.registry import NOT_YET_PORTED
from audio_edge_ml_pipeline_torch.ops import golden as tgolden

REPO = Path(__file__).resolve().parent.parent
SR = 22050


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _rel(a, gold):
    return float(np.max(np.abs(a - gold) / np.maximum(np.abs(gold), 1.0)))


def test_registry_has_the_three_extractors_and_not_cqt():
    assert tfeatures.get("audio_waveform") is taudio.AudioWaveform
    assert tfeatures.get("audio_mfcc_seq") is taudio.AudioMFCCSequence
    assert tfeatures.get("audio_classical") is taudio.AudioClassicalExtractor
    assert not NOT_YET_PORTED & set(tfeatures.list_extractors())
    assert not {n for n in NOT_YET_PORTED if n.startswith("audio_")}
    assert tfeatures.get("audio_cqt") is taudio.AudioCQT


@pytest.mark.parametrize("name,kwargs", [
    ("audio_waveform", {}),
    ("audio_mfcc_seq", {"duration": 2.0}),
    ("audio_classical", {"features": ["rms", "mfcc", "chroma"], "aggregations": ["std"], "n_mfcc": 13}),
    ("audio_classical", {}),
])
def test_extractor_attributes_match_jax(name, kwargs):
    ours = tfeatures.get(name)(**kwargs, device="cpu")
    theirs = jfeatures.get(name)(**kwargs)
    for attr in ("sample_rate", "duration", "feature_type", "modality", "n_mfcc", "n_mels", "n_fft", "hop_length",
                 "min_duration", "features", "aggregations", "feature_dim", "exact_length_batching"):
        assert getattr(ours, attr, None) == getattr(theirs, attr, None), attr
    assert ours.min_samples() == theirs.min_samples()
    assert ours.frames_for(44100) == theirs.frames_for(44100)
    assert ours.target_samples() == theirs.target_samples()


def test_classical_rejects_unknown_groups_and_aggregations():
    for kwargs, match in [({"features": ["mfcc", "nope"]}, "Unknown feature group"),
                          ({"aggregations": ["max"]}, "Unknown aggregation"),
                          ({"aggregations": []}, "at least one")]:
        with pytest.raises(ValueError, match=match):
            taudio.AudioClassicalExtractor(device="cpu", **kwargs)


def test_extractors_without_device_raise_when_cuda_is_absent(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cls in (taudio.AudioWaveform, taudio.AudioMFCCSequence, taudio.AudioClassicalExtractor):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cls()


def _write_tree(root: Path, lengths, sr=SR, seed=11):
    """One class folder of clips of the given lengths (the mixed-length tree
    of tests/test_data_plane.py)."""
    rng = np.random.default_rng(seed)
    d = root / "x"
    d.mkdir(parents=True)
    for i, n in enumerate(lengths):
        y = (0.4 * np.sin(2 * np.pi * (200 + 90 * i) * np.arange(n) / sr) + 0.04 * rng.standard_normal(n))
        write_wav(d / f"{i}.wav", y.astype(np.float32), sr)
    return AudioFolderLoader(root)


def test_classical_mixed_lengths_exact(tmp_path, monkeypatch):
    """audio_classical on clips of 44100, 66150, 44100 and 52000 samples:
    one unmasked device batch per length, rows padded to a power of two,
    each clip within 1e-4 relative of its own golden vector."""
    loader = _write_tree(tmp_path / "mixed", [44100, 66150, 44100, 52000])
    ex = taudio.AudioClassicalExtractor(sample_rate=SR, device="cpu")
    shapes = []
    run = ex._device_batch
    monkeypatch.setattr(ex, "_device_batch", lambda w, l: (shapes.append((w.shape, l)), run(w, l))[1])
    fs = ex.extract_dataset(loader)
    assert fs.features.shape == (4, 302) and fs.feature_type == "classical"
    assert sorted(shapes, key=str) == sorted([((2, 44100), None), ((1, 52000), None), ((1, 66150), None)], key=str)
    for i, (path, _, _) in enumerate(loader):
        y, _ = load_audio(path, sr=SR)
        assert _rel(fs.features[i], tgolden.classical_feature_vector(y)) <= 1e-4, i


def test_exact_length_batching_refuses_framed_outputs(tmp_path):
    class FramedExact(taudio.AudioMFCCSequence):
        exact_length_batching = True

    loader = _write_tree(tmp_path / "t", [22050, 30000])
    with pytest.raises(TypeError, match="length-independent"):
        FramedExact(device="cpu").extract_dataset(loader)


@pytest.mark.parametrize("duration", [1.0, 1.5])
def test_mfcc_seq_and_waveform_datasets_match_golden(tmp_path, duration):
    """Clips of three lengths cut or zero-padded to ``duration``, one fixed
    (batch_size, n) device batch, against each clip's golden."""
    loader = _write_tree(tmp_path / "v", [22050, 30001, 16000])
    seq = taudio.AudioMFCCSequence(duration=duration, device="cpu").extract_dataset(loader)
    wav = taudio.AudioWaveform(sample_rate=SR, duration=duration, device="cpu").extract_dataset(loader)
    n = int(duration * SR)
    assert seq.features.shape == (3, 40, 1 + n // 512) and wav.features.shape == (3, n)
    for i, (path, _, _) in enumerate(loader):
        y, _ = load_audio(path, sr=SR)
        y = np.pad(y[:n], (0, max(0, n - len(y))))
        assert np.max(np.abs(seq.features[i] - tgolden.mfcc_seq_feature(y))) <= 1e-5
        assert np.max(np.abs(wav.features[i] - tgolden.waveform_feature(y))) <= 1e-6


def test_single_clip_extract_matches_jax(tmp_path):
    loader = _write_tree(tmp_path / "s", [30000])
    (path, _, _), = list(loader)
    for name, kwargs, tol in [("audio_waveform", {"sample_rate": SR}, 1e-6), ("audio_mfcc_seq", {}, 1e-5)]:
        ours = tfeatures.get(name)(**kwargs, device="cpu").extract(path)
        theirs = jfeatures.get(name)(**kwargs).extract(path)
        assert ours.shape == theirs.shape and ours.dtype == np.float32
        assert np.max(np.abs(ours - theirs)) <= tol, name
    ours = taudio.AudioClassicalExtractor(device="cpu").extract(path)
    theirs = jfeatures.get("audio_classical")().extract(path)
    assert ours.shape == theirs.shape == (302,) and _rel(ours, theirs) <= 1e-4


def _config_copy(src: Path, dst: Path, dataset: Path, out_root: Path, max_samples: int) -> Path:
    """configs/feature_extraction.yaml with its dataset and outputs moved."""
    doc = yaml.safe_load(src.read_text())
    doc["dataset"] = str(dataset)
    doc["max_samples"] = max_samples
    for exp in doc["experiments"]:
        exp["output"] = str(out_root / Path(exp["output"]).name)
    dst.write_text(yaml.safe_dump(doc, sort_keys=False))
    return dst


@pytest.fixture(scope="module")
def shipped_config_runs(tmp_path_factory):
    """The shipped extraction config on a synthetic fsc22 tree (3 classes x
    5 five-second clips at 16 kHz, so that the train and validation splits
    both hold clips), through the JAX CLI and through the port's CLI with
    --device cpu. Rows per device batch are cut to 8 on both sides: they do
    not change a clip's features."""
    root = tmp_path_factory.mktemp("shipped")
    make_synth_dataset.make_fsc22(root / "fsc22", n_classes=3, per_class=5, sr=16000)
    src = REPO / "configs" / "feature_extraction.yaml"
    mp = pytest.MonkeyPatch()
    for module in (jfeatures, tfeatures):
        for name in ("audio_mel_spec", "audio_mfcc_seq", "audio_classical"):
            mp.setattr(module.get(name), "batch_size", 8)
    try:
        jcfg = _config_copy(src, root / "jax.yaml", root / "fsc22", root / "jax", max_samples=4)
        for exp in jload_config(jcfg).resolved_experiments():
            jpipeline._run_experiment(exp)
        tcfg = _config_copy(src, root / "port.yaml", root / "fsc22", root / "port", max_samples=4)
        tpipeline.main(["--config", str(tcfg), "--device", "cpu"])
    finally:
        mp.undo()
    names = [Path(e["output"]).name for e in yaml.safe_load(src.read_text())["experiments"]]
    return root, names


EXPECTED = {  # output dir -> (feature shape of a 5 s clip, gate against golden, relative)
    "fsc22_mel_train": ((40, 501), 1e-5, False),
    "fsc22_mel_val": ((40, 501), 1e-5, False),
    "fsc22_classical_train": ((302,), 1e-4, True),
    "fsc22_mfcc_seq_train": ((40, 216), 1e-5, False),
}


GOLDEN = {
    "fsc22_mel_train": lambda y: tgolden.mel_spec_feature(y),
    "fsc22_mel_val": lambda y: tgolden.mel_spec_feature(y),
    "fsc22_classical_train": lambda y: tgolden.classical_feature_vector(y),
    "fsc22_mfcc_seq_train": lambda y: tgolden.mfcc_seq_feature(y),
}


@pytest.mark.parametrize("experiment", sorted(EXPECTED))
def test_shipped_config_through_the_port_cli_matches_jax(shipped_config_runs, experiment):
    """Each experiment's FeatureSet has the JAX CLI's shape, labels and
    metadata, and every row is within its gate of the golden feature of the
    clip as ``load_audio`` resamples it. Rows are not held to JAX's: on
    these 16 kHz clips at 22.05 kHz JAX's float32 STFT is itself 3.6e-5
    from golden on the MFCC sequence and 1.1e-3 relative on the classical
    vector's 0-200 Hz contrast, over their gates."""
    root, names = shipped_config_runs
    assert sorted(names) == sorted(EXPECTED)
    shape, tol, relative = EXPECTED[experiment]
    ours = tpipeline.FeaturePipeline.load(root / "port" / experiment)
    theirs = jpipeline.FeaturePipeline.load(root / "jax" / experiment)
    n = 3 if experiment == "fsc22_mel_val" else 4
    assert ours.features.shape == theirs.features.shape == (n, *shape)
    assert ours.features.dtype == np.float32 and np.isfinite(ours.features).all()
    np.testing.assert_array_equal(ours.labels, theirs.labels)
    assert ours.label_names == theirs.label_names and ours.metadata == theirs.metadata
    assert (root / "port" / experiment / "config.yaml").exists()
    sr = 16000 if "mel" in experiment else SR
    for row, meta in zip(ours.features, ours.metadata):
        y, _ = load_audio(root / "fsc22" / "Audio Wise V1.0-20260101" / "Audio Wise V1.0" / meta["filename"], sr=sr)
        gold = GOLDEN[experiment](y)
        assert (_rel(row, gold) if relative else float(np.max(np.abs(row - gold)))) <= tol
