"""Port parity: the FFT-shaped mel kernel's tables, index math and torch
emulation (audio_edge_ml_pipeline_torch.ops.rfft_plan) against float64
``np.fft.rfft``, the JAX package's golden copy and its folded Pallas kernel
in interpret mode, and the wrapper's route by n_fft. The CUDA kernel
(csrc/mel_rfft.cu) runs only on a card: tests/test_torch_cuda.py holds it
against the plain version there."""

import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from audio_edge_ml_pipeline_tpu.ops import dsp as jdsp
from audio_edge_ml_pipeline_tpu.ops import pallas_mel
from audio_edge_ml_pipeline_tpu.ops.golden import librosa_ref as jref
from audio_edge_ml_pipeline_torch.ops import _build, mel_kernel, rfft_plan

REL_TOL = 1e-6  # of each frame's (or clip's) peak power: float32 sums in another order


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _clips(rng, batch, n, sr=16000):
    t = np.arange(n) / sr
    out = np.empty((batch, n), np.float32)
    for i in range(batch):
        f0 = rng.uniform(100.0, 0.3 * sr)
        out[i] = 0.5 * np.sin(2 * np.pi * f0 * t + rng.uniform(0, 2 * np.pi)) + 0.1 * rng.standard_normal(n)
    return out


@pytest.mark.parametrize("sr,n_fft,n_mels", [
    (16000, 512, 40), (22050, 1024, 128), (16000, 256, 40), (16000, 256, 128), (16000, 400, 40),
])
def test_bands_rebuild_the_dense_mel_bank_and_the_window_is_hann(sr, n_fft, n_mels):
    tab = rfft_plan.tables(sr, n_fft, n_mels)
    dense = np.zeros((n_mels, 1 + n_fft // 2), np.float32)
    for j, (lo, length, off) in enumerate(tab.bands):
        dense[j, lo : lo + length] = tab.weights[off : off + length]
    np.testing.assert_array_equal(dense, jdsp.mel_fb(sr, n_fft, n_mels))
    assert tab.bands[:, 2].tolist() == np.r_[0, np.cumsum(tab.bands[:-1, 1])].tolist()
    np.testing.assert_array_equal(tab.window, jref.hann_periodic(n_fft).astype(np.float32))


def test_the_kernels_plans_and_constants_are_rfft_plans():
    """csrc/mel_rfft.cu's radix plans, launch sizes and butterfly constants
    are the ones the emulation runs."""
    source = (_build.CSRC / "mel_rfft.cu").read_text()
    plans = {2 * int(m): tuple(map(int, r.split(", "))) for m, r in
             re.findall(r"case (\d+): return plan\(s, ([\d, ]+)\);", source)}
    assert plans == rfft_plan.RADICES
    launches = {int(n): int(m) for n, m in re.findall(r"case (\d+): return launch<(\d+), T>", source)}
    assert launches == {n_fft: n_fft // 2 for n_fft in rfft_plan.RADICES}
    constants = {name: float(np.float32(float(v))) for name, v in
                 re.findall(r"constexpr float (k\w+) = (-?[\d.]+)f;", source)}
    assert constants == {"kSqrtHalf": rfft_plan.SQRT_HALF, "kCos1": rfft_plan.COS1, "kSin1": rfft_plan.SIN1,
                         "kCos2": rfft_plan.COS2, "kSin2": rfft_plan.SIN2, "kSin3": rfft_plan.SIN3}


@pytest.mark.parametrize("R", sorted(rfft_plan._DFT))
def test_butterfly_matches_numpy_fft(rng, R):
    """Each radix's butterfly in float32 against float64 np.fft.fft on R points."""
    x = rng.standard_normal((R, 2, 64)).astype(np.float32)
    got = rfft_plan._DFT[R]([(torch.from_numpy(a[0]), torch.from_numpy(a[1])) for a in x])
    got = np.stack([re.numpy() + 1j * im.numpy() for re, im in got])
    exact = np.fft.fft(x[:, 0].astype(np.float64) + 1j * x[:, 1], axis=0)
    assert np.max(np.abs(got - exact)) <= 1e-6 * np.max(np.abs(exact))


@pytest.mark.parametrize("n_fft", sorted(rfft_plan.RADICES))
def test_twiddles_are_the_rounded_unit_roots(n_fft):
    M = n_fft // 2
    tab = rfft_plan.tables(16000, n_fft, 40)
    for s, (R, ns) in enumerate(rfft_plan.pass_strides(M)):
        j = np.arange(M // R)[:, None]
        r = np.arange(R)[None, :]
        exact = np.exp(-2j * np.pi * r * (j % ns) / (ns * R)).reshape(-1)
        got = tab.twiddles[s, : M].astype(np.float64)
        np.testing.assert_allclose(got[:, 0], exact.real, rtol=0, atol=6e-8)
        np.testing.assert_allclose(got[:, 1], exact.imag, rtol=0, atol=6e-8)
    k = np.arange(M // 2 + 1)
    exact = np.exp(-2j * np.pi * k / n_fft)
    np.testing.assert_allclose(tab.split[:, 0], exact.real, rtol=0, atol=6e-8)
    np.testing.assert_allclose(tab.split[:, 1], exact.imag, rtol=0, atol=6e-8)
    # the angles on the axes are exact, so DC and Nyquist have no imaginary part
    assert tab.split[0].tolist() == [1.0, 0.0] and tab.split[M // 2].tolist() == [0.0, -1.0]


@pytest.mark.parametrize("n_fft", sorted(rfft_plan.RADICES))
def test_pass_indices_permute_and_scratch_addresses_do_not_collide(n_fft):
    M = n_fft // 2
    for s in range(len(rfft_plan.RADICES[n_fft])):
        read, write = rfft_plan.pass_indices(M, s)
        assert sorted(read.reshape(-1)) == list(range(M))
        assert sorted(write.reshape(-1)) == list(range(M))
    padded = rfft_plan.pad_index(np.arange(M))
    assert len(set(padded.tolist())) == M and padded.max() < rfft_plan.scratch_size(M)
    assert rfft_plan.scratch_size(M) >= M + 1  # the power of bins 0 .. M goes back into it


def _bank_wavefronts(M, pad):
    """(wavefronts, warp accesses) of one scratch array (re or im) in one
    frame, as the kernel addresses it: every pass's writes, the reads of the
    passes after the first, and the split's reads of Z[k] and Z[M - k];
    lane l takes butterfly (or bin) l + 32 b. A warp access costs as many
    wavefronts as the most distinct words any one of the 32 banks holds."""
    def cost(words):
        banks = {}
        for w in words:
            banks.setdefault(w % 32, set()).add(w)
        return max(map(len, banks.values()))
    accesses = []
    for s, (R, _) in enumerate(rfft_plan.pass_strides(M)):
        read, write = rfft_plan.pass_indices(M, s)
        for b in range(0, M // R, 32):
            for r in range(R):
                accesses += [write[b : b + 32, r]] + ([read[b : b + 32, r]] if s else [])
    for b in range(0, M // 2 + 1, 32):
        k = np.arange(b, min(b + 32, M // 2 + 1))
        accesses += [k, (M - k) % M]
    return sum(cost(pad(np.asarray(a)).tolist()) for a in accesses), len(accesses)


def test_scratch_padding_spreads_the_passes_over_the_banks():
    """At n_fft 512: 50 warp accesses an array and frame, which would cost
    50 wavefronts without conflicts; five floats of padding every 32 cost
    62, one float 78, none 130."""
    assert _bank_wavefronts(256, rfft_plan.pad_index) == (62, 50)
    assert _bank_wavefronts(256, lambda i: i + (i >> 5))[0] == 78
    assert _bank_wavefronts(256, lambda i: i)[0] == 130


def test_scratch_padding_at_n_fft_400():
    """At n_fft 400 (radices 8 5 5): 56 warp accesses an array and frame;
    five floats of padding every 32 cost 73 wavefronts, as one float does,
    none 105, and no padding of 1-8 floats every 8, 16, 32 or 64 values
    costs fewer, so M = 200 keeps the padding of the other sizes."""
    assert _bank_wavefronts(200, rfft_plan.pad_index) == (73, 56)
    assert _bank_wavefronts(200, lambda i: i + (i >> 5))[0] == 73
    assert _bank_wavefronts(200, lambda i: i)[0] == 105
    assert min(_bank_wavefronts(200, lambda i, p=p, sh=sh: i + p * (i >> sh))[0]
               for p in range(1, 9) for sh in (3, 4, 5, 6)) == 73


@pytest.mark.parametrize("n_fft", sorted(rfft_plan.RADICES))
def test_emulated_frame_power_matches_float64_rfft(rng, n_fft):
    frames = (0.3 * rng.standard_normal((48, n_fft))).astype(np.float32)
    t = np.arange(n_fft)
    frames[1] = np.sin(2 * np.pi * 37.3 * t / n_fft)          # a tone between bins
    frames[2] = np.cos(2 * np.pi * (n_fft // 4) * t / n_fft)  # on a bin
    frames[3] = 1.0                                            # DC only
    frames[4] = (-1.0) ** t                                    # Nyquist only
    power = rfft_plan.frame_power_emulated(torch.from_numpy(frames), rfft_plan.tables(16000, n_fft, 40)).numpy()
    exact = np.abs(np.fft.rfft(frames.astype(np.float64) * jref.hann_periodic(n_fft), axis=1)) ** 2
    assert power.shape == (48, 1 + n_fft // 2)
    peak = exact.max(axis=1, keepdims=True)
    assert np.max(np.abs(power - exact) / peak) <= REL_TOL


SHAPES = {
    # (batch, n, sr, n_fft, hop, n_mels)
    "T201": (2, 32000, 16000, 512, 160, 40),       # not a multiple of the 32-frame tile
    "T501": (2, 80000, 16000, 512, 160, 40),       # the flagship 5 s clip
    "n16077": (3, 16077, 16000, 512, 160, 40),     # a ragged clip length
    "mfcc_frontend": (1, 66150, 22050, 1024, 512, 128),
    "n_fft480": (2, 16077, 16000, 480, 160, 40),      # radices 4 4 3 5
    "n_fft2048": (1, 44100, 22050, 2048, 512, 128),   # radices 8 8 4 4, librosa's default front end
}


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_emulated_mel_power_matches_pallas_and_plain(rng, name):
    batch, n, sr, n_fft, hop, n_mels = SHAPES[name]
    y = _clips(rng, batch, n, sr)
    ours = rfft_plan.mel_power_emulated(torch.from_numpy(y), sr, n_mels, n_fft, hop)      # (B, T, M)
    assert ours.shape == (batch, 1 + n // hop, n_mels)
    plain = mel_kernel.mel_power_folded_plain(torch.from_numpy(y), sr, n_mels, n_fft, hop)
    scale = plain.abs().amax(dim=(1, 2), keepdim=True)
    assert float(((ours - plain).abs() / scale).max()) <= REL_TOL
    theirs = np.asarray(pallas_mel.mel_power_pallas_folded(
        jnp.asarray(y), sr=sr, n_mels=n_mels, n_fft=n_fft, hop_length=hop, interpret=True))  # (B, M, T)
    scale = np.max(np.abs(theirs), axis=(1, 2), keepdims=True)
    assert np.max(np.abs(ours.numpy().transpose(0, 2, 1) - theirs) / scale) <= REL_TOL


def test_emulated_mel_power_against_golden(fsc22_like_clip):
    y = fsc22_like_clip[:32000]
    ours = rfft_plan.mel_power_emulated(torch.from_numpy(y[None]))[0].numpy().T
    gold = jref.melspectrogram(y.astype(np.float64), sr=16000, n_mels=40, n_fft=512, hop_length=160)
    assert np.max(np.abs(ours - gold)) / np.max(np.abs(gold)) <= REL_TOL


def test_zero_frames_and_zero_padded_tails_give_exact_zeros(rng):
    y = np.zeros((2, 16077), np.float32)
    y[1, :5000] = 0.3 * rng.standard_normal(5000)
    out = rfft_plan.mel_power_emulated(torch.from_numpy(y)).numpy()
    assert not out[0].any()
    # frames whose whole window lies past sample 5000 see only zeros
    first_silent = -(-(5000 + 256) // 160)
    assert not out[1, first_silent:].any() and out[1, : first_silent].any()


@pytest.mark.parametrize("n_fft,kernel", [
    (256, "rfft"), (320, "rfft"), (400, "rfft"), (512, "rfft"), (640, "rfft"), (1024, "rfft"),
    (480, "rfft"), (2048, "rfft"), (482, "dense"), (2050, "dense"),
])
def test_route_sends_fft_sizes_to_the_fft_kernel(n_fft, kernel):
    assert mel_kernel.route(n_fft) == kernel


@pytest.mark.parametrize("n_fft", [511, 401, 2])
def test_route_refuses_odd_or_tiny_n_fft(n_fft):
    with pytest.raises(ValueError, match="even n_fft"):
        mel_kernel.route(n_fft)


def test_rfft_constants_are_what_the_kernel_reads():
    consts = mel_kernel.rfft_constants(16000, 512, 40, torch.device("cpu"))
    tab = rfft_plan.tables(16000, 512, 40)
    for c, a in zip(consts, (tab.window, tab.twiddles, tab.split, tab.weights, tab.chunks, tab.slots)):
        np.testing.assert_array_equal(c.numpy(), a)
    assert consts[4].dtype == torch.int32 and consts[3].numel() == int(np.count_nonzero(jdsp.mel_fb(16000, 512, 40)))


@pytest.mark.parametrize("sr,n_fft,n_mels", [
    (16000, 512, 40), (22050, 1024, 128), (16000, 256, 128), (16000, 1024, 64), (16000, 400, 40), (16000, 640, 64),
])
def test_mel_schedule_covers_every_weight_once_and_balances_the_lanes(sr, n_fft, n_mels):
    tab = rfft_plan.tables(sr, n_fft, n_mels)
    n_weights = len(tab.weights)
    cap = -(-n_weights // rfft_plan.LANES)
    live = tab.chunks[tab.chunks[..., 3] >= 0]                       # (n_chunks, 4)
    assert sorted(live[:, 3].tolist()) == list(range(int(tab.slots[:, 1].sum())))
    covered = np.zeros(n_weights, int)
    for lo, length, off, slot in live.tolist():
        covered[off : off + length] += 1
        j = int(np.searchsorted(tab.slots[:, 0], slot, side="right")) - 1  # the filter that owns the slot
        band_lo, _, band_off = tab.bands[j]
        assert slot < tab.slots[j, 0] + tab.slots[j, 1] and lo - band_lo == off - band_off
        assert length <= cap
    assert (covered == 1).all()
    lane_bins = np.where(tab.chunks[..., 3] >= 0, tab.chunks[..., 1], 0).sum(axis=0)
    assert lane_bins.max() <= 2 * cap and lane_bins.sum() == n_weights


def test_mel_schedule_at_the_flagship_shape():
    """512 / 40 mels: one filter a lane would walk 41 bins; the schedule's
    busiest lane walks 17 (the mean is 15.3)."""
    tab = rfft_plan.tables(16000, 512, 40)
    lane_bins = np.where(tab.chunks[..., 3] >= 0, tab.chunks[..., 1], 0).sum(axis=0)
    assert lane_bins.max() == 17 and tab.chunks.shape == (2, 32, 4)
    assert max(int(tab.bands[lane::32, 1].sum()) for lane in range(32)) == 41
    assert len(tab.weights) / 32 == pytest.approx(15.3, abs=0.05)


def test_fit_tile_takes_the_first_tile_that_fits():
    """The kernels' frames a tile: the first of the preferred sizes whose
    shared memory fits in a Hopper block, else a clear refusal."""
    per_frame = mel_kernel.SMEM_LIMIT // 20
    assert mel_kernel.fit_tile(lambda t: t * per_frame, mel_kernel.RFFT_TILES) == (16, 16 * per_frame)
    assert mel_kernel.fit_tile(lambda t: 1000 * t, mel_kernel.DENSE_TILES) == (32, 32000)
    with pytest.raises(ValueError, match="shared memory"):
        mel_kernel.fit_tile(lambda t: mel_kernel.SMEM_LIMIT + t, mel_kernel.DENSE_TILES)


def _dense_smem(n_fft, tile, t_bytes, hop=None):
    """csrc/mel_folded.cu's smem_bytes (hop None) or csrc/mel_unfolded.cu's
    mel_unfolded_smem_bytes (32 frames a block, float32)."""
    f_pad = -(-(1 + n_fft // 2) // mel_kernel.F_ALIGN) * mel_kernel.F_ALIGN
    if hop is None:
        return t_bytes * ((n_fft // 2) * tile * 2 + tile + tile * (f_pad + 1))
    return 4 * (31 * hop + n_fft + 32 * (f_pad + 1))


def test_dense_kernels_hold_the_n_fft_the_docs_state():
    """The largest even n_fft each dense kernel's shared memory holds, as
    ROADMAP §3 b and the wrappers state them; the folded one at every even
    n_fft up to 4096 in both types."""
    def largest(fits):
        n = 4
        while fits(n + 2):
            n += 2
        return n

    def folded_fits(t_bytes):
        return lambda n: any(_dense_smem(n, t, t_bytes) <= mel_kernel.SMEM_LIMIT for t in mel_kernel.DENSE_TILES)

    assert largest(folded_fits(4)) == 9630 and largest(folded_fits(8)) == 4798
    assert all(folded_fits(8)(n) for n in range(4, 4098, 2))
    assert [largest(lambda n, h=h: _dense_smem(n, 32, 4, h) <= mel_kernel.SMEM_LIMIT) for h in (160, 256, 512)] == \
        [3070, 2878, 2302]
    source = (_build.CSRC / "mel_folded.cu").read_text()
    assert "static_cast<size_t>(n_fft / 2) * tile_t * 2 + tile_t +" in source
