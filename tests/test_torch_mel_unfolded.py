"""Port parity: the unfolded-mel kernel's plain version, route and wrapper
(audio_edge_ml_pipeline_torch.ops.mel_unfolded) against the JAX package's
``mel_power_pallas`` Pallas kernel in interpret mode, and the FFT kernel's
emulation (``rfft_plan.mel_power_emulated``, what the wrapper launches for
the FFT sizes) against this plain version, both Pallas kernels and the
golden copy. The CUDA kernels themselves run only on a card:
tests/test_torch_cuda.py holds them against this plain version there."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from audio_edge_ml_pipeline_tpu.ops import pallas_mel
from audio_edge_ml_pipeline_tpu.ops.golden import librosa_ref as jref
from audio_edge_ml_pipeline_torch.ops import dsp as tdsp
from audio_edge_ml_pipeline_torch.ops import mel_kernel, mel_unfolded, rfft_plan

REL_TOL = 1e-6  # of each clip's peak power: float32 sums in another order (chip_smoke.KERNEL_REL_TOL)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _clips(rng, batch, n, sr):
    t = np.arange(n) / sr
    out = np.empty((batch, n), np.float32)
    for i in range(batch):
        f0 = rng.uniform(100.0, 0.3 * sr)
        out[i] = 0.5 * np.sin(2 * np.pi * f0 * t) + 0.1 * rng.standard_normal(n)
    return out


SHAPES = {
    # (batch, n, sr, n_fft, hop, n_mels)
    "T501": (2, 80000, 16000, 512, 160, 40),      # the flagship 5 s clip
    "T201": (2, 32000, 16000, 512, 160, 40),      # not a multiple of the TPU kernel's 128-frame tile
    "mfcc_frontend": (1, 66150, 22050, 1024, 512, 128),  # 3 s at 22.05 kHz
}
FFT_SHAPES = {**SHAPES, "n_fft400": (2, 32000, 16000, 400, 160, 40)}  # the 25 ms window at 16 kHz, radices 8 5 5


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_plain_version_matches_pallas_kernel(rng, name):
    batch, n, sr, n_fft, hop, n_mels = SHAPES[name]
    y = _clips(rng, batch, n, sr)
    ours = mel_unfolded.mel_power_unfolded(torch.from_numpy(y), sr, n_mels, n_fft, hop).numpy()  # (B, T, M)
    theirs = np.asarray(pallas_mel.mel_power_pallas(
        jnp.asarray(y), sr=sr, n_mels=n_mels, n_fft=n_fft, hop_length=hop, interpret=True))   # (B, M, T)
    assert ours.shape == (batch, 1 + n // hop, n_mels)
    scale = np.max(np.abs(theirs), axis=(1, 2), keepdims=True)
    # float32 GEMMs summed in different orders: ~1e-7 of each clip's peak power
    assert np.max(np.abs(ours.transpose(0, 2, 1) - theirs) / scale) <= 1e-6


def test_plain_version_agrees_with_the_folded_form(rng):
    """Unfolded and folded DFTs are the same function of the clip."""
    y = torch.from_numpy(_clips(rng, 2, 16077, 16000))
    unfolded = mel_unfolded.mel_power_unfolded_plain(y)
    folded = mel_kernel.mel_power_folded_plain(y)
    scale = folded.abs().amax(dim=(1, 2), keepdim=True)
    assert float(((unfolded - folded).abs() / scale).max()) <= 1e-6


def test_kernel_constants_are_the_pallas_basis():
    C, S, fb = (c.numpy() for c in mel_unfolded.constants(16000, 512, 40, torch.device("cpu")))
    basis = tdsp.dft_bases(512).T  # (n_fft, 2F), the operand mel_power_pallas multiplies by
    np.testing.assert_array_equal(C[:, :257], basis[:, :257])
    np.testing.assert_array_equal(S[:, :257], basis[:, 257:])
    assert C.shape[1] % mel_kernel.F_ALIGN == 0
    for c in (C[:, 257:], S[:, 257:], fb[257:]):
        assert not c.any()


def test_wrapper_takes_plain_version_for_cpu_tensors(rng):
    y = torch.from_numpy((0.3 * rng.standard_normal((2, 4000))).astype(np.float32))
    before = mel_unfolded.counter.launches
    out = mel_unfolded.mel_power_unfolded(y)
    assert mel_unfolded.counter.launches == before  # no kernel launch for a CPU tensor
    torch.testing.assert_close(out, mel_unfolded.mel_power_unfolded_plain(y), rtol=0, atol=0)


@pytest.mark.parametrize("n_fft,kernel", [
    (256, "rfft"), (320, "rfft"), (400, "rfft"), (512, "rfft"), (640, "rfft"), (1024, "rfft"),
    (480, "rfft"), (2048, "rfft"), (482, "czt"), (2050, "czt"), (2, "czt"),
])
def test_route_sends_fft_sizes_to_the_fft_kernel(n_fft, kernel):
    """The same rule as the folded entry's route, by n_fft alone."""
    assert mel_unfolded.route(n_fft) == kernel
    if n_fft >= 4:
        assert mel_kernel.route(n_fft) == kernel


@pytest.mark.parametrize("name", sorted(FFT_SHAPES))
def test_fft_emulation_matches_plain_version(rng, name):
    """The FFT kernel's emulation against this kernel's plain version: the
    margin the card check (KERNEL_REL_TOL) has on the FFT route."""
    batch, n, sr, n_fft, hop, n_mels = FFT_SHAPES[name]
    y = torch.from_numpy(_clips(rng, batch, n, sr))
    ours = rfft_plan.mel_power_emulated(y, sr, n_mels, n_fft, hop)
    plain = mel_unfolded.mel_power_unfolded_plain(y, sr, n_mels, n_fft, hop)
    assert ours.shape == plain.shape == (batch, 1 + n // hop, n_mels)
    scale = plain.abs().amax(dim=(1, 2), keepdim=True)
    assert float(((ours - plain).abs() / scale).max()) <= REL_TOL


@pytest.mark.parametrize("kernel", ["mel_power_pallas", "mel_power_pallas_folded"])
def test_fft_emulation_at_n_fft_400_matches_both_pallas_kernels(rng, kernel):
    y = _clips(rng, 2, 16077, 16000)
    ours = rfft_plan.mel_power_emulated(torch.from_numpy(y), n_fft=400).numpy()                      # (B, T, M)
    theirs = np.asarray(getattr(pallas_mel, kernel)(jnp.asarray(y), n_fft=400, interpret=True))   # (B, M, T)
    scale = np.max(np.abs(theirs), axis=(1, 2), keepdims=True)
    assert np.max(np.abs(ours.transpose(0, 2, 1) - theirs) / scale) <= REL_TOL


def test_fft_emulation_feature_at_n_fft_400_meets_the_golden_gate(fsc22_like_clip):
    y = fsc22_like_clip[:32000]
    mel = rfft_plan.mel_power_emulated(torch.from_numpy(y[None]), n_fft=400)
    feat = tdsp.mel_epilogue(mel.transpose(1, 2), None, 160)[0].numpy()
    assert np.max(np.abs(feat - jref.mel_spec_feature(y.astype(np.float64), n_fft=400))) <= 1e-5


def test_odd_n_fft_raises_like_the_jax_kernel():
    y = np.zeros((1, 4000), np.float32)
    with pytest.raises(ValueError, match="even n_fft"):
        mel_unfolded.mel_power_unfolded(torch.from_numpy(y), n_fft=511)
    with pytest.raises(ValueError, match="even n_fft"):
        mel_unfolded.route(511)
    # the JAX kernel it ports does not take odd n_fft either
    with pytest.raises(Exception, match="[Oo]ut of bound"):
        pallas_mel.mel_power_pallas(jnp.asarray(y), n_fft=511, interpret=True)


@pytest.mark.parametrize("bad", ["float64", "1d", "noncontig"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    y = {"float64": torch.zeros((2, 4000), dtype=torch.float64),
         "1d": torch.zeros(4000),
         "noncontig": torch.zeros((4000, 2)).T}[bad]
    with pytest.raises((TypeError, ValueError)):
        mel_unfolded.mel_power_unfolded(y)
