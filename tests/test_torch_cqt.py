"""Port parity: the golden CQT, ``ops.dsp.cqt_magnitude`` / ``cqt_feature``
and the ``audio_cqt`` extractor of audio_edge_ml_pipeline_torch against the
JAX package and the float64 oracle (CPU)."""

import numpy as np
import pytest
import torch
import yaml

import make_synth_dataset
from audio_edge_ml_pipeline_tpu import features as jfeatures
from audio_edge_ml_pipeline_tpu.features import pipeline as jpipeline
from audio_edge_ml_pipeline_tpu.features.config import load_config as jload_config
from audio_edge_ml_pipeline_tpu.ops import dsp as jdsp
from audio_edge_ml_pipeline_tpu.ops import golden as jgolden
from audio_edge_ml_pipeline_torch import features as tfeatures
from audio_edge_ml_pipeline_torch.data.audio_io import load_audio
from audio_edge_ml_pipeline_torch.features import audio as taudio
from audio_edge_ml_pipeline_torch.features import pipeline as tpipeline
from audio_edge_ml_pipeline_torch.ops import dsp as tdsp
from audio_edge_ml_pipeline_torch.ops import golden as tgolden

SR = 22050


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _clips(n: int, seconds: float, seed: int = 0, sr: int = SR) -> np.ndarray:
    """A tone with harmonics over noise, a chirp, and noise alone: strong and
    weak bins in one clip, so the dB clamp and the weak bins are exercised."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    out = []
    for i in range(n):
        f0 = rng.uniform(60.0, 2000.0)
        kind = i % 3
        if kind == 0:
            y = sum(0.4 / h * np.sin(2 * np.pi * f0 * h * t) for h in range(1, 4)) + 0.01 * rng.standard_normal(len(t))
        elif kind == 1:
            y = 0.5 * np.sin(2 * np.pi * (f0 + 800.0 * t) * t)
        else:
            y = 0.2 * rng.standard_normal(len(t))
        out.append(y)
    return np.stack(out).astype(np.float32)


def _jax_recipe(n: int, seconds: float, seed: int = 22) -> np.ndarray:
    """Clips as JAX's own CQT parity test makes them (a tone over 0.1 noise,
    tests/test_dsp_parity.py::batch22k): the regime where JAX's float32 CQT
    meets its 1e-5 gate."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * SR)) / SR
    return np.stack([0.5 * np.sin(2 * np.pi * (220 + 97 * i) * t) + 0.1 * rng.standard_normal(len(t))
                     for i in range(n)]).astype(np.float32)


GOLDEN_CASES = {  # name -> (port function, JAX function, args)
    "cqt_basis": (tgolden.cqt_basis, jgolden.cqt_basis, (SR, tgolden.C1_HZ, 84, 12)),
    "cqt_basis_16k_48": (tgolden.cqt_basis, jgolden.cqt_basis, (16000, 55.0, 48, 12)),
    "cqt_time_basis": (tgolden.cqt_time_basis, jgolden.librosa_ref.cqt_time_basis, (SR, tgolden.C1_HZ, 84, 12)),
    "cqt": (tgolden.cqt, jgolden.cqt, (_clips(1, 1.0)[0].astype(np.float64), SR, 512, 84)),
    "cqt_feature": (tgolden.cqt_feature, jgolden.cqt_feature, (_clips(2, 1.2, seed=1)[1].astype(np.float64),)),
}


@pytest.mark.parametrize("case", sorted(GOLDEN_CASES))
def test_golden_cqt_equals_jax_golden(case):
    """The port's copy of the float64 oracle is JAX's, bit for bit."""
    ours_fn, theirs_fn, args = GOLDEN_CASES[case]
    ours, theirs = ours_fn(*args), theirs_fn(*args)
    ours, theirs = (ours, theirs) if isinstance(ours, tuple) else ((ours,), (theirs,))
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert tgolden.C1_HZ == jgolden.librosa_ref.C1_HZ


CONFIGS = {  # name -> (sr, hop, n_bins, bins_per_octave, fmin)
    "default": (SR, 512, 84, 12, None),
    "16k_hop256": (16000, 256, 60, 12, 55.0),
    "24bpo_hop300": (SR, 300, 96, 24, 65.4),  # hop does not divide n_fft: the kernels are zero-extended
}


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_cqt_feature_matches_golden(config):
    """float64 products leave only the final rounding: ~1e-7 against the
    1e-5 gate."""
    sr, hop, n_bins, bpo, fmin = CONFIGS[config]
    y = _clips(3, 1.3, seed=2, sr=sr)
    out = tdsp.cqt_feature(torch.from_numpy(y), sr=sr, hop_length=hop, n_bins=n_bins, bins_per_octave=bpo,
                           fmin=fmin).numpy()
    assert out.dtype == np.float32 and out.shape == (3, n_bins, 1 + y.shape[1] // hop)
    for row, clip in zip(out, y):
        gold = tgolden.cqt_feature(clip.astype(np.float64), sr=sr, hop_length=hop, n_bins=n_bins,
                                   bins_per_octave=bpo, fmin=fmin)
        assert float(np.max(np.abs(row - gold))) <= 1e-6


def test_cqt_magnitude_matches_golden_in_float64():
    y = _clips(2, 1.0, seed=3)
    mag = tdsp.cqt_magnitude(torch.from_numpy(y), SR, 512, 84)
    assert mag.dtype == torch.float64
    for row, clip in zip(mag.numpy(), y):
        gold = tgolden.cqt(clip.astype(np.float64), SR, 512, 84)
        assert float(np.max(np.abs(row - gold)) / np.max(gold)) <= 1e-12


def test_cqt_feature_matches_jax():
    """Within 2e-5 of JAX's float32 CQT on JAX's own parity clips: the sum of
    the two packages' gates (JAX sits near 7e-6 from golden there)."""
    y = _jax_recipe(3, 1.5)
    ours = tdsp.cqt_feature(torch.from_numpy(y)).numpy()
    theirs = np.asarray(jdsp.cqt_feature(y))
    assert ours.shape == theirs.shape
    assert float(np.max(np.abs(ours - theirs))) <= 2e-5


def test_cqt_gap_to_jax_on_clean_tones_is_jax_own():
    """On a noiseless chirp and a tone over weak noise JAX's float32 CQT is
    itself 1.2e-5 to 4.5e-5 from golden, over its 1e-5 gate (ROADMAP §3): the
    port stays within 1e-6 of golden there, so its whole gap to JAX is
    JAX's own distance from golden."""
    y = _clips(3, 1.5, seed=4)
    ours = tdsp.cqt_feature(torch.from_numpy(y)).numpy()
    theirs = np.asarray(jdsp.cqt_feature(y))
    for i, clip in enumerate(y):
        gold = tgolden.cqt_feature(clip.astype(np.float64))
        assert float(np.max(np.abs(ours[i] - gold))) <= 1e-6
        jax_gap = float(np.max(np.abs(theirs[i] - gold)))
        assert float(np.max(np.abs(ours[i] - theirs[i]))) <= jax_gap + 1e-6


def test_cqt_feature_masks_variable_lengths():
    """A padded batch with lengths: each clip's valid frames equal the golden
    feature of the clip alone, and the port equals JAX's masked feature."""
    lengths = np.array([33075, 25000, 11025], np.int64)
    y = _jax_recipe(3, 1.5, seed=5)
    for i, n in enumerate(lengths):
        y[i, n:] = 0.0
    ours = tdsp.cqt_feature(torch.from_numpy(y), lengths=torch.from_numpy(lengths)).numpy()
    theirs = np.asarray(jdsp.cqt_feature(y, lengths=lengths))
    for i, n in enumerate(lengths):
        t = 1 + n // 512
        gold = tgolden.cqt_feature(y[i, :n].astype(np.float64))
        assert float(np.max(np.abs(ours[i, :, :t] - gold))) <= 1e-6
        assert float(np.max(np.abs(ours[i, :, :t] - theirs[i, :, :t]))) <= 2e-5


@pytest.mark.parametrize("block_bytes", [1, 3 * 8 * 75 * 32 * 168])
def test_cqt_clip_alone_equals_it_in_a_blocked_batch(block_bytes, monkeypatch):
    """A clip's float64 magnitude does not depend on its batch-mates: alone
    against inside a batch cut into blocks (one clip a block, or three)."""
    y = torch.from_numpy(_clips(7, 1.0, seed=6))
    monkeypatch.setattr(tdsp, "_CQT_BLOCK_BYTES", block_bytes)
    batch = tdsp.cqt_magnitude(y, SR, 512, 84)
    monkeypatch.undo()
    for i in (0, 4, 6):
        alone = tdsp.cqt_magnitude(y[i : i + 1], SR, 512, 84)
        assert float(((batch[i] - alone[0]).abs() / alone.abs().max()).max()) <= 1e-12


def test_audio_cqt_attributes_match_jax():
    ours = tfeatures.get("audio_cqt")(device="cpu")
    theirs = jfeatures.get("audio_cqt")()
    assert isinstance(ours, taudio.AudioCQT)
    for attr in ("sample_rate", "hop_length", "n_bins", "bins_per_octave", "fmin", "duration", "batch_size",
                 "feature_type", "modality"):
        assert getattr(ours, attr) == getattr(theirs, attr), attr
    assert ours.min_samples() == theirs.min_samples() and ours.frames_for(110250) == theirs.frames_for(110250)


def test_audio_cqt_cli_matches_jax(tmp_path):
    """``audio_cqt`` through both extraction CLIs on a synthetic fsc22 tree
    (3 classes x 2 five-second clips at 16 kHz, resampled to 22.05 kHz by
    ``load_audio``), rows a device batch cut to 4 on both sides: same
    shape, labels and metadata, rows within 1e-6 of golden. JAX's rows are
    up to 3.1e-5 from golden on these clean tones (ROADMAP §3), so each
    port row is held to JAX's within JAX's own distance from golden."""
    make_synth_dataset.make_fsc22(tmp_path / "fsc22", n_classes=3, per_class=2, sr=16000)
    exp = {"name": "cqt", "extractor": "audio_cqt", "loader": "fsc22", "split": "all"}
    mp = pytest.MonkeyPatch()
    for module in (jfeatures, tfeatures):
        mp.setattr(module.get("audio_cqt"), "batch_size", 4)
    try:
        for side in ("jax", "port"):
            doc = {"dataset": str(tmp_path / "fsc22"),
                   "experiments": [{**exp, "output": str(tmp_path / side / "cqt")}]}
            (tmp_path / f"{side}.yaml").write_text(yaml.safe_dump(doc))
        for e in jload_config(tmp_path / "jax.yaml").resolved_experiments():
            jpipeline._run_experiment(e)
        tpipeline.main(["--config", str(tmp_path / "port.yaml"), "--device", "cpu"])
    finally:
        mp.undo()
    ours = tpipeline.FeaturePipeline.load(tmp_path / "port" / "cqt")
    theirs = jpipeline.FeaturePipeline.load(tmp_path / "jax" / "cqt")
    assert ours.features.shape == theirs.features.shape == (6, 84, 216)
    np.testing.assert_array_equal(ours.labels, theirs.labels)
    assert ours.label_names == theirs.label_names and ours.metadata == theirs.metadata
    audio_dir = tmp_path / "fsc22" / "Audio Wise V1.0-20260101" / "Audio Wise V1.0"
    for row, jrow, meta in zip(ours.features, theirs.features, ours.metadata):
        y, _ = load_audio(audio_dir / meta["filename"], sr=SR)
        gold = tgolden.cqt_feature(y)
        assert float(np.max(np.abs(row - gold))) <= 1e-6
        assert float(np.max(np.abs(row - jrow))) <= float(np.max(np.abs(jrow - gold))) + 1e-6
