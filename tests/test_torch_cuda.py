"""The port's hand-written CUDA kernels against their plain PyTorch versions.

These need an NVIDIA card and skip without one: a CUDA kernel has no CPU
mode. This file imports neither jax nor the JAX package, so it also runs
where only the port is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from audio_edge_ml_pipeline_torch.ops import golden, mel_kernel, mel_unfolded


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version's GEMMs in full float32
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("batch,n,sr,n_fft,hop,n_mels", [
    (4, 80000, 16000, 512, 160, 40), (1, 32000, 16000, 512, 160, 40), (3, 16077, 16000, 512, 160, 40),
    (2, 600, 16000, 512, 160, 40), (2, 66150, 22050, 1024, 512, 128), (2, 80000, 16000, 320, 160, 40),
    (3, 16077, 16000, 400, 160, 40), (2, 80000, 16000, 400, 160, 40), (2, 80000, 16000, 640, 160, 40),
    (3, 16077, 16000, 480, 160, 40), (2, 66150, 22050, 2048, 512, 128), (2, 32000, 16000, 2048, 160, 40),
])
def test_mel_folded_matches_plain_version(cuda_device, batch, n, sr, n_fft, hop, n_mels):
    """The FFT sizes go to csrc/mel_rfft.cu (four passes at n_fft 480 and 2048)."""
    rng = np.random.default_rng(batch * 100003 + n)
    y = torch.from_numpy((0.3 * rng.standard_normal((batch, n))).astype(np.float32)).to(cuda_device)
    before, dense_before = mel_kernel.counter.launches, mel_kernel.counter_dense.launches
    out = mel_kernel.mel_power_folded(y, sr, n_mels, n_fft, hop)
    torch.cuda.synchronize()
    assert mel_kernel.counter.launches == before + 1
    assert mel_kernel.counter_dense.launches == dense_before  # the FFT route, not the dense kernel
    assert out.shape == (batch, 1 + n // hop, n_mels) and out.is_contiguous()
    plain = mel_kernel.mel_power_folded_plain(y, sr, n_mels, n_fft, hop)
    scale = plain.abs().amax(dim=(1, 2), keepdim=True)
    # float32 sums in another order: ~1e-7 of each clip's peak power
    assert float(((out - plain).abs() / scale).max()) <= 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("module,entry,plain", [
    (mel_kernel, "mel_power_folded", "mel_power_folded_plain"),
    (mel_unfolded, "mel_power_unfolded", "mel_power_unfolded_plain"),
])
@pytest.mark.parametrize("n_fft", [6, 482, 2050])
def test_dense_route_matches_plain_version(cuda_device, module, entry, plain, n_fft):
    """M = 3, 241 and 1025 have no FFT plan: each entry launches its dense kernel."""
    rng = np.random.default_rng(n_fft)
    y = torch.from_numpy((0.3 * rng.standard_normal((3, 16077))).astype(np.float32)).to(cuda_device)
    before, dense_before = module.counter.launches, module.counter_dense.launches
    out = getattr(module, entry)(y, n_fft=n_fft)
    torch.cuda.synchronize()
    assert module.counter.launches == before + 1 and module.counter_dense.launches == dense_before + 1
    ref = getattr(module, plain)(y, n_fft=n_fft)
    scale = ref.abs().amax(dim=(1, 2), keepdim=True)
    assert out.shape == (3, 1 + 16077 // 160, 40)
    assert float(((out - ref).abs() / scale).max()) <= 1e-6


@pytest.mark.cuda
def test_mel_feature_on_the_card_meets_the_golden_gate(cuda_device):
    rng = np.random.default_rng(5)
    t = np.arange(80000) / 16000
    y = (0.4 * np.sin(2 * np.pi * 440 * t) + 0.05 * rng.standard_normal(80000)).astype(np.float32)
    lengths = torch.tensor([80000, 30001], device=cuda_device)
    batch = np.stack([y, np.r_[y[:30001], np.zeros(80000 - 30001, np.float32)]])
    dense_before = mel_kernel.counter_dense.launches
    feat = mel_kernel.mel_spec_feature(torch.from_numpy(batch).to(cuda_device), lengths=lengths).cpu().numpy()
    assert mel_kernel.counter_dense.launches == dense_before  # through csrc/mel_rfft.cu
    assert np.max(np.abs(feat[0] - golden.mel_spec_feature(y))) <= 1e-5
    assert np.max(np.abs(feat[1, :, : 1 + 30001 // 160] - golden.mel_spec_feature(y[:30001]))) <= 1e-5


@pytest.mark.cuda
def test_wrapper_raises_instead_of_falling_back(cuda_device):
    y = torch.zeros((2, 4000), dtype=torch.float64, device=cuda_device)
    with pytest.raises(TypeError):
        mel_kernel.mel_power_folded(y)
    with pytest.raises(ValueError):
        mel_kernel.mel_power_folded(torch.zeros((4000, 2), device=cuda_device).T)


@pytest.mark.cuda
@pytest.mark.parametrize("batch,n,sr,n_fft,hop,n_mels", [
    (4, 80000, 16000, 512, 160, 40), (1, 32000, 16000, 512, 160, 40),
    (3, 16077, 16000, 512, 160, 40), (2, 66150, 22050, 1024, 512, 128), (2, 80000, 16000, 400, 160, 40),
    (3, 16077, 16000, 480, 160, 40), (2, 66150, 22050, 2048, 512, 128),
])
def test_mel_unfolded_matches_plain_version(cuda_device, batch, n, sr, n_fft, hop, n_mels):
    """The FFT sizes go to csrc/mel_rfft.cu, as for the folded entry."""
    rng = np.random.default_rng(batch * 100003 + n)
    y = torch.from_numpy((0.3 * rng.standard_normal((batch, n))).astype(np.float32)).to(cuda_device)
    before, dense_before = mel_unfolded.counter.launches, mel_unfolded.counter_dense.launches
    out = mel_unfolded.mel_power_unfolded(y, sr, n_mels, n_fft, hop)
    torch.cuda.synchronize()
    assert mel_unfolded.counter.launches == before + 1
    assert mel_unfolded.counter_dense.launches == dense_before  # the FFT route, not the dense kernel
    assert out.shape == (batch, 1 + n // hop, n_mels) and out.is_contiguous()
    plain = mel_unfolded.mel_power_unfolded_plain(y, sr, n_mels, n_fft, hop)
    scale = plain.abs().amax(dim=(1, 2), keepdim=True)
    # float32 sums in another order: ~1e-7 of each clip's peak power
    assert float(((out - plain).abs() / scale).max()) <= 1e-6


@pytest.mark.cuda
def test_mel_unfolded_raises_instead_of_falling_back(cuda_device):
    with pytest.raises(ValueError, match="even n_fft"):
        mel_unfolded.mel_power_unfolded(torch.zeros((2, 4000), device=cuda_device), n_fft=511)
    with pytest.raises(TypeError):
        mel_unfolded.mel_power_unfolded(torch.zeros((2, 4000), dtype=torch.float64, device=cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("batch,n,sr,n_fft,hop,n_mels", [
    (2, 66150, 22050, 1024, 512, 128), (3, 16077, 16000, 512, 160, 40), (2, 80000, 16000, 400, 160, 40),
    (3, 16077, 16000, 480, 160, 40), (2, 66150, 22050, 2048, 512, 128), (2, 66150, 22050, 2048, 1024, 128),
    (3, 16077, 16000, 482, 160, 40), (2, 66150, 22050, 2050, 512, 128), (2, 44100, 22050, 4096, 1024, 128),
])
def test_mel_folded_float64_instantiation_matches_plain_version(cuda_device, batch, n, sr, n_fft, hop, n_mels):
    """precise=True launches the routed kernel's float64 instantiation
    (mel_rfft.cu's on its sizes, mel_folded.cu's elsewhere; at n_fft 2048,
    hop 1024 the FFT kernel's tiles shrink to fit); the plain version's
    products run in float64 too, so the two meet at float32 rounding of the
    result."""
    rng = np.random.default_rng(batch * 7919 + n)
    y = torch.from_numpy((0.3 * rng.standard_normal((batch, n))).astype(np.float32)).to(cuda_device)
    before, f64_before = mel_kernel.counter.launches, mel_kernel.counter_f64.launches
    dense_before = mel_kernel.counter_dense.launches
    out = mel_kernel.mel_power_folded(y, sr, n_mels, n_fft, hop, precise=True)
    torch.cuda.synchronize()
    assert mel_kernel.counter.launches == before + 1 and mel_kernel.counter_f64.launches == f64_before + 1
    assert mel_kernel.counter_dense.launches == dense_before + (mel_kernel.route(n_fft) == "dense")
    plain = mel_kernel.mel_power_folded_plain(y, sr, n_mels, n_fft, hop)
    assert float(((out - plain).abs() / plain.abs().clamp_min(1e-30)).max()) <= 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("n_fft", [511, 401])
def test_mel_feature_at_odd_n_fft_on_the_card(cuda_device, n_fft):
    """Odd n_fft has no fold: the framed basis product (torch ops), one frame
    fewer than n_frames_for, no kernel launch, within 1e-5 of golden."""
    rng = np.random.default_rng(n_fft)
    y = (0.3 * rng.standard_normal((2, 16000))).astype(np.float32)
    before = mel_kernel.counter.launches
    feat = mel_kernel.mel_spec_feature(torch.from_numpy(y).to(cuda_device), n_fft=n_fft).cpu().numpy()
    assert mel_kernel.counter.launches == before and feat.shape == (2, 40, 100)
    for i in range(2):
        assert np.max(np.abs(feat[i] - golden.mel_spec_feature(y[i], n_fft=n_fft))) <= 1e-5


@pytest.mark.cuda
def test_mfcc_and_classical_features_on_the_card_with_tf32_allowed(cuda_device):
    """The MFCC and classical features meet their golden gates on the card
    whatever the TF32 flags say, and leave the flags as they were."""
    from audio_edge_ml_pipeline_torch.ops import audio_features

    rng = np.random.default_rng(11)
    t = np.arange(66150) / 22050
    y = np.stack([(0.5 * np.sin(2 * np.pi * (220 + 97 * i) * t) + 0.05 * rng.standard_normal(66150))
                  for i in range(3)]).astype(np.float32)
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        yd = torch.from_numpy(y).to(cuda_device)
        seq = audio_features.mfcc_seq_feature(yd).cpu().numpy()
        vec = audio_features.classical_feature_vector(yd).cpu().numpy()
        assert (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) == (True, True)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
    for i in range(3):
        assert np.max(np.abs(seq[i] - golden.mfcc_seq_feature(y[i].astype(np.float64)))) <= 1e-5
        gold = golden.classical_feature_vector(y[i].astype(np.float64))
        assert np.max(np.abs(vec[i] - gold) / np.maximum(np.abs(gold), 1.0)) <= 1e-4
