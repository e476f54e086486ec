"""Port parity: audio_edge_ml_pipeline_torch.ops.dsp, its golden copy and
the feature on a CPU tensor (mel_kernel.mel_spec_feature: dsp's plain path
and epilogue) against the JAX package's ops.dsp and ops.golden (CPU,
float32)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from audio_edge_ml_pipeline_tpu.ops import dsp as jdsp
from audio_edge_ml_pipeline_tpu.ops import golden as jgolden
from audio_edge_ml_pipeline_torch.ops import dsp as tdsp
from audio_edge_ml_pipeline_torch.ops import golden as tgolden
from audio_edge_ml_pipeline_torch.ops import mel_kernel

TOL = 1e-5  # the repo's DSP parity gate (max|delta| vs the float64 oracle)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _clips(rng, batch, n, sr=16000):
    t = np.arange(n) / sr
    out = []
    for i in range(batch):
        y = 0.4 * np.sin(2 * np.pi * (250 + 180 * i) * t) + 0.05 * rng.standard_normal(n)
        y[n // 5 : n // 5 + 1600] += 0.6 * rng.standard_normal(min(1600, n - n // 5))
        out.append(y.astype(np.float32))
    return np.stack(out)


def test_golden_copy_equals_jax_golden(rng):
    y = _clips(rng, 1, 16000)[0]
    np.testing.assert_array_equal(tgolden.hann_periodic(512), jgolden.hann_periodic(512))
    np.testing.assert_array_equal(tgolden.mel_filterbank(16000, 512, 40), jgolden.mel_filterbank(16000, 512, 40))
    np.testing.assert_array_equal(tgolden.stft(y, 512, 160), jgolden.stft(y, 512, 160))
    np.testing.assert_array_equal(tgolden.mel_spec_feature(y), jgolden.mel_spec_feature(y))


@pytest.mark.parametrize("n_fft", [512, 1024])
def test_folded_bases_equal_jax(n_fft):
    for ours, theirs in zip(tdsp._folded_dft_bases(n_fft), jdsp._folded_dft_bases(n_fft, "hann")):
        np.testing.assert_array_equal(ours, theirs)
    np.testing.assert_array_equal(tdsp.dft_bases(n_fft), jdsp.dft_bases(n_fft))
    np.testing.assert_array_equal(tdsp.mel_fb(16000, n_fft, 40), jdsp.mel_fb(16000, n_fft, 40))


def test_stft_re_im_matches_jax(rng):
    y = _clips(rng, 2, 8000 + 37)
    re_t, im_t = tdsp.stft_re_im(torch.from_numpy(y), 512, 160)
    re_j, im_j = jdsp.stft_re_im(jnp.asarray(y), 512, 160)
    scale = float(np.max(np.abs(np.asarray(re_j))))
    # two float32 GEMMs of depth 256 summed in different orders
    assert np.max(np.abs(re_t.numpy() - np.asarray(re_j))) <= 1e-6 * scale
    assert np.max(np.abs(im_t.numpy() - np.asarray(im_j))) <= 1e-6 * scale


def test_log10_precise_matches_jax(rng):
    x = np.concatenate([10.0 ** rng.uniform(-10, 4, 4096), [1e-10, 0.5, 1.0, 2.0, 3.0e3]]).astype(np.float32)
    ours = tdsp.log10_precise(torch.from_numpy(x)).numpy()
    theirs = np.asarray(jdsp.log10_precise(jnp.asarray(x)))
    assert np.max(np.abs(ours - theirs)) <= 2e-6  # a few float32 ulps at |log10 x| <= 10
    assert np.max(np.abs(ours - np.log10(x.astype(np.float64)))) <= 2e-6


@pytest.mark.parametrize("batch,n", [(3, 80000), (1, 32000)], ids=["T501", "T201"])
def test_mel_spec_feature_matches_jax_and_golden(rng, batch, n):
    y = _clips(rng, batch, n)
    ours = mel_kernel.mel_spec_feature(torch.from_numpy(y)).numpy()
    assert ours.shape == (batch, 40, 1 + n // 160)
    theirs = np.asarray(jdsp.mel_spec_feature(jnp.asarray(y)))
    gold = np.stack([tgolden.mel_spec_feature(y[i]) for i in range(batch)])
    assert np.max(np.abs(ours - theirs)) <= TOL
    assert np.max(np.abs(ours - gold)) <= TOL


def test_mel_spec_feature_padded_batch_with_lengths(rng):
    lengths = np.array([16000, 11000, 5123], np.int64)
    y = np.zeros((3, 16000), np.float32)
    clips = [_clips(rng, 1, int(n))[0] for n in lengths]
    for i, c in enumerate(clips):
        y[i, : len(c)] = c
    ours = mel_kernel.mel_spec_feature(torch.from_numpy(y), lengths=torch.from_numpy(lengths)).numpy()
    theirs = np.asarray(jdsp.mel_spec_feature(jnp.asarray(y), lengths=jnp.asarray(lengths.astype(np.int32))))
    for i, c in enumerate(clips):
        t = 1 + len(c) // 160
        gold = tgolden.mel_spec_feature(c)
        assert np.max(np.abs(ours[i, :, :t] - gold)) <= TOL
        assert np.max(np.abs(ours[i, :, :t] - theirs[i, :, :t])) <= TOL


def test_fold_indices_match_stft_re_im_gather():
    """The port's gather indices over T frames equal the ones the JAX
    stft_re_im builds inline (dsp.py: idx_front / idx_rev / starts + half)."""
    n, n_fft, hop = 8000 + 37, 512, 160
    half = n_fft // 2
    T = jdsp.n_frames_for(n, hop)
    starts = np.arange(T) * hop
    front, rev, center, rmask = tdsp.fold_indices(n, n_fft, hop, T)
    np.testing.assert_array_equal(front, starts[:, None] + np.arange(half)[None, :])
    rev_cols = np.concatenate([[n_fft], n_fft - np.arange(1, half)])
    np.testing.assert_array_equal(rev, np.minimum(starts[:, None] + rev_cols[None, :], n + 2 * half - 1))
    np.testing.assert_array_equal(center, starts + half)
    np.testing.assert_array_equal(rmask, np.r_[0.0, np.ones(half - 1)].astype(np.float32))
