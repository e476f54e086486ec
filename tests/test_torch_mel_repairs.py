"""Port parity: the mel sizes the port used to refuse. ``audio_mel_spec`` at odd
n_fft (the framed basis product, one frame fewer than ``n_frames_for``),
through ``mel_kernel.mel_spec_feature`` and the edge simulator, against the
JAX package and the golden copy; and the plain mel power at large n_fft, where
the JAX package's basis check refuses, against the golden copy. The kernels
that take the even sizes on a card are held to their plain versions in
tests/test_torch_cuda.py and chip_smoke.py."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import make_synth_dataset
from audio_edge_ml_pipeline_tpu.models import deep as jdeep
from audio_edge_ml_pipeline_tpu.ops import dsp as jdsp
from audio_edge_ml_pipeline_tpu.serve import edge_simulator as jsim
from audio_edge_ml_pipeline_torch.ops import audio_features, golden, mel_kernel
from audio_edge_ml_pipeline_torch.serve import edge_simulator as tsim

TOL = 1e-5  # the repo's DSP parity gate


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.mark.parametrize("n_fft", [511, 401])
@pytest.mark.parametrize("with_lengths", [False, True])
def test_mel_spec_feature_at_odd_n_fft_matches_jax_and_golden(n_fft, with_lengths):
    """Two seeded clips of 16,000 samples at hop 160: JAX returns (2, 40, 100),
    one frame fewer than n_frames_for; so does the port, with the same mask."""
    rng = np.random.default_rng(n_fft)
    y = (0.3 * rng.standard_normal((2, 16000))).astype(np.float32)
    lengths = np.array([16000, 9001]) if with_lengths else np.array([16000, 16000])
    y[1, lengths[1]:] = 0.0
    kw = {"lengths": torch.from_numpy(lengths)} if with_lengths else {}
    before = mel_kernel.counter.launches
    ours = mel_kernel.mel_spec_feature(torch.from_numpy(y), n_fft=n_fft, **kw).numpy()
    jkw = {"lengths": jnp.asarray(lengths.astype(np.int32))} if with_lengths else {}
    theirs = np.asarray(jdsp.mel_spec_feature(jnp.asarray(y), n_fft=n_fft, **jkw))
    assert mel_kernel.counter.launches == before
    assert ours.shape == theirs.shape == (2, 40, 100)
    for i, n in enumerate(lengths):
        t = 1 + (n - 1) // 160              # frames of a clip of n samples at odd n_fft
        assert np.max(np.abs(ours[i, :, :t] - theirs[i, :, :t])) <= TOL
        gold = golden.mel_spec_feature(y[i, :n], n_fft=n_fft)
        assert gold.shape[1] == t
        assert np.max(np.abs(ours[i, :, :t] - gold)) <= TOL


def test_edge_simulator_at_odd_n_fft_matches_jax(tmp_path):
    """The simulator's _extract goes through mel_spec_feature: an odd n_fft
    serves the same predictions as the JAX simulator."""
    make_synth_dataset.make_audio_folder(tmp_path / "audio_folder", n_classes=3, per_class=2, sr=16000)
    labels = [make_synth_dataset.class_name(c) for c in range(3)]
    mel = {"sample_rate": 16000, "n_mels": 40, "n_fft": 511, "hop_length": 160, "duration": 1.0}
    module = jdeep.MLPModule((8,), dropout=0.0, n_classes=3)
    params = module.init(jax.random.PRNGKey(2), jnp.zeros((1, 40 * 100)), train=False)["params"]
    arch = {"type": "mlp", "hidden_units": [8], "dropout": 0.0, "n_classes": 3, "input_shape": [40 * 100]}
    bundle = tmp_path / "model.flax.npz"
    jdeep.save_model_bundle(bundle, arch, params, np.float32([0.5]), np.float32([0.08]))

    def run(sim_cls, tag, **kw):
        sim = sim_cls.EdgeDeviceSimulator(bundle, labels, tmp_path / "audio_folder", device_id=tag,
                                          telemetry_dir=tmp_path / tag, stats_dir=tmp_path / tag, mel_params=mel,
                                          seed=5, **kw)
        return [sim.step() for _ in range(3)]

    theirs = run(jsim, "jax")
    ours = run(tsim, "port", device="cpu")
    for a, b in zip(ours, theirs):
        assert (a["clip"], a["prediction"]) == (b["clip"], b["prediction"])
        assert abs(a["confidence"] - b["confidence"]) <= 1e-6


@pytest.mark.parametrize("n_fft", [3000, 4096])
def test_plain_mel_power_at_large_n_fft_meets_golden(n_fft):
    """The JAX package's folded basis asserts its mirrored halves agree to
    1e-12, which float64 angle rounding misses at most even n_fft from 1678
    up; the port's check allows 1e-9, so its plain mel power and MFCC
    sequence compute there, within their gates of the golden copy."""
    rng = np.random.default_rng(n_fft)
    y = (0.3 * rng.standard_normal((1, 44100))).astype(np.float32)
    with pytest.raises(AssertionError):
        jdsp.melspectrogram(jnp.asarray(y), 22050, 128, n_fft, 1024)
    ours = mel_kernel.mel_power_folded(torch.from_numpy(y), 22050, 128, n_fft, 1024)[0].numpy().T
    gold = golden.melspectrogram(y[0].astype(np.float64), sr=22050, n_mels=128, n_fft=n_fft, hop_length=1024)
    assert np.max(np.abs(ours - gold)) / np.max(gold) <= 1e-6
    seq = audio_features.mfcc_seq_feature(torch.from_numpy(y), n_fft=n_fft).numpy()[0]
    assert np.max(np.abs(seq - golden.mfcc_seq_feature(y[0].astype(np.float64), n_fft=n_fft))) <= TOL
