"""Port parity: the folded-mel kernel's plain version and wrapper
(audio_edge_ml_pipeline_torch.ops.mel_kernel) against the JAX package's
Pallas kernel in interpret mode. The CUDA kernel itself runs only on a card:
tests/test_torch_cuda.py holds it against this plain version there."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from audio_edge_ml_pipeline_tpu.ops import dsp as jdsp
from audio_edge_ml_pipeline_tpu.ops import pallas_mel
from audio_edge_ml_pipeline_torch.ops import dsp as tdsp
from audio_edge_ml_pipeline_torch.ops import golden as tgolden
from audio_edge_ml_pipeline_torch.ops import mel_kernel

TOL = 1e-5  # the repo's DSP parity gate on the [0, 1] feature


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _tone(n, f=500.0, sr=16000):
    return (0.5 * np.sin(2 * np.pi * f * np.arange(n) / sr)).astype(np.float32)


def test_plain_version_matches_pallas_kernel_t201(rng):
    """T=201 frames: not a multiple of the TPU kernel's 128-frame tile."""
    y = np.stack([_tone(32000), (0.3 * rng.standard_normal(32000)).astype(np.float32)])
    ours = mel_kernel.mel_power_folded(torch.from_numpy(y)).numpy()          # (B, T, M)
    theirs = np.asarray(pallas_mel.mel_power_pallas_folded(jnp.asarray(y), interpret=True))  # (B, M, T)
    assert ours.shape == (2, 201, 40)
    scale = np.max(np.abs(theirs), axis=(1, 2), keepdims=True)
    # float32 GEMMs summed in different orders: ~1e-7 of each clip's peak power
    assert np.max(np.abs(ours.transpose(0, 2, 1) - theirs) / scale) <= 1e-6


def test_feature_matches_pallas_feature_and_golden():
    y = _tone(32000)[None]
    ours = mel_kernel.mel_spec_feature(torch.from_numpy(y)).numpy()
    theirs = np.asarray(pallas_mel.mel_spec_feature_pallas(jnp.asarray(y), interpret=True))
    assert ours.shape == (1, 40, 201)
    assert np.max(np.abs(ours - theirs)) <= TOL
    assert np.max(np.abs(ours[0] - tgolden.mel_spec_feature(y[0]))) <= TOL


def test_feature_with_lengths_matches_jax(rng):
    lengths = np.array([16000, 9000], np.int64)
    y = np.zeros((2, 16000), np.float32)
    y[0] = (0.3 * rng.standard_normal(16000)).astype(np.float32)
    y[1, :9000] = _tone(9000, 300.0) + (0.05 * rng.standard_normal(9000)).astype(np.float32)
    ours = mel_kernel.mel_spec_feature(torch.from_numpy(y), lengths=torch.from_numpy(lengths)).numpy()
    theirs = np.asarray(jdsp.mel_spec_feature(jnp.asarray(y), lengths=jnp.asarray(lengths.astype(np.int32))))
    for i, n in enumerate(lengths):
        t = 1 + n // 160
        assert np.max(np.abs(ours[i, :, :t] - theirs[i, :, :t])) <= TOL
        assert np.max(np.abs(ours[i, :, :t] - tgolden.mel_spec_feature(y[i, :n]))) <= TOL


@pytest.mark.parametrize("n", [32000, 80000, 16077])
def test_gather_indices_equal_pallas_indices(n):
    """fold_indices over the TPU kernel's padded frame count equals the
    idx_front / idx_rev / idx_center / rmask of mel_power_pallas_folded."""
    n_fft, hop, tile = 512, 160, pallas_mel.TILE_T
    half, pad = n_fft // 2, n_fft // 2
    T_pad = -(-(1 + n // hop) // tile) * tile
    # the JAX kernel's index math (pallas_mel.py, mel_power_pallas_folded)
    starts = np.arange(T_pad) * hop
    limit = n + 2 * pad - 1
    idx_front = np.minimum(starts[:, None] + np.arange(half)[None, :], limit)
    rev_cols = np.concatenate([[n_fft], n_fft - np.arange(1, half)])
    idx_rev = np.minimum(starts[:, None] + rev_cols[None, :], limit)
    idx_center = np.minimum(starts + half, limit)
    rmask = np.r_[0.0, np.ones(half - 1)].astype(np.float32)
    for ours, theirs in zip(tdsp.fold_indices(n, n_fft, hop, T_pad), (idx_front, idx_rev, idx_center, rmask)):
        np.testing.assert_array_equal(ours, theirs)


def test_kernel_constants_are_the_pallas_constants():
    A, B, wr, fb = (c.numpy() for c in mel_kernel.constants(16000, 512, 40, torch.device("cpu")))
    A_T, B_T, wr_half = jdsp._folded_dft_bases(512, "hann")
    np.testing.assert_array_equal(A[:, :257], A_T)
    np.testing.assert_array_equal(B[:, :257], B_T)
    np.testing.assert_array_equal(wr[:257], wr_half)
    np.testing.assert_array_equal(fb[:257], jdsp.mel_fb(16000, 512, 40).T)
    for c in (A[:, 257:], B[:, 257:], wr[257:], fb[257:]):
        assert not c.any()
    assert A.shape[1] % mel_kernel.F_ALIGN == 0


def test_wrapper_takes_plain_version_for_cpu_tensors(rng):
    y = torch.from_numpy((0.3 * rng.standard_normal((2, 4000))).astype(np.float32))
    before = mel_kernel.counter.launches
    out = mel_kernel.mel_power_folded(y)
    assert mel_kernel.counter.launches == before  # no kernel launch for a CPU tensor
    plain = mel_kernel.mel_power_folded_plain(y)
    torch.testing.assert_close(out, plain, rtol=0, atol=0)


@pytest.mark.parametrize("bad", ["float64", "odd_nfft", "1d", "noncontig"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    y = torch.zeros((2, 4000))
    kw = {}
    if bad == "float64":
        y = y.double()
    elif bad == "odd_nfft":
        kw["n_fft"] = 511
    elif bad == "1d":
        y = y[0]
    else:
        y = torch.zeros((4000, 2)).T
    with pytest.raises((TypeError, ValueError)):
        mel_kernel.mel_power_folded(y, **kw)
