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


# ----------------------------------------------------------------------
# The dB + min-max epilogue: its plain version on the CPU, and what the
# CUDA wrapper takes (csrc/mel_epilogue.cu itself runs only on a card)
# ----------------------------------------------------------------------


def _mels_major_power(monkeypatch):
    """Make mel_power_folded hand mel_spec_feature its (B, T, n_mels) power
    stored (B, n_mels, T), so that the epilogue gets it mels-major."""
    folded = mel_kernel.mel_power_folded
    monkeypatch.setattr(mel_kernel, "mel_power_folded",
                        lambda *a, **k: folded(*a, **k).transpose(1, 2).contiguous().transpose(1, 2))


@pytest.mark.parametrize("n_fft,layout", [(512, "frames"), (512, "mels"), (511, "frames")])
def test_cpu_feature_meets_golden_in_either_layout(rng, monkeypatch, n_fft, layout):
    if layout == "mels":
        _mels_major_power(monkeypatch)
    seen = []
    epilogue = tdsp.mel_epilogue
    monkeypatch.setattr(tdsp, "mel_epilogue", lambda mel, *a: seen.append(mel) or epilogue(mel, *a))
    y = np.stack([_tone(32000, 700.0), (0.3 * rng.standard_normal(32000)).astype(np.float32)])
    before = mel_kernel.counter_epilogue.launches
    ours = mel_kernel.mel_spec_feature(torch.from_numpy(y), n_fft=n_fft).numpy()
    assert mel_kernel.counter_epilogue.launches == before   # the plain version on a CPU tensor
    (mel,) = seen
    assert mel_kernel.epilogue_layout(tuple(mel.shape), mel.stride(), mel.dtype) == layout
    for i in range(2):
        assert np.max(np.abs(ours[i] - tgolden.mel_spec_feature(y[i], n_fft=n_fft))) <= TOL


def _one_pass_epilogue(mel, lengths, hop):
    """csrc/mel_epilogue.cu's arithmetic in torch ops: one masked reduction
    of max S, max L and min L, then the peak, the floor and the range
    derived from them, then the formula on every frame."""
    m3 = None if lengths is None else tdsp.frame_mask(mel.shape[-1], lengths, hop)[:, None, :]
    big = torch.finfo(torch.float32).max
    L = 10.0 * tdsp.log10_precise(torch.clamp_min(mel, 1e-10))

    def reduce(x, fill, op):
        return op(x if m3 is None else torch.where(m3, x, fill), dim=(1, 2), keepdim=True)

    s_max, l_max, l_min = reduce(mel, -big, torch.amax), reduce(L, -big, torch.amax), reduce(L, big, torch.amin)
    ref = 10.0 * tdsp.log10_precise(torch.clamp_min(s_max, 1e-10))
    peak = l_max - ref
    floor = peak - 80.0
    lo, hi = torch.maximum(l_min - ref, floor), torch.maximum(peak, floor)
    return (torch.maximum(L - ref, floor) - lo) / (hi - lo + 1e-8)


def _epilogue_power(rng, batch, n_mels, n_frames, layout):
    p = np.exp(6.0 * rng.standard_normal((batch, n_frames, n_mels))).astype(np.float32)
    p[-1] = 0.0   # a clip all on the 1e-10 floor
    mel = torch.from_numpy(p).transpose(1, 2)
    return mel if layout == "frames" else mel.contiguous()


@pytest.mark.parametrize("layout", ["frames", "mels"])
@pytest.mark.parametrize("n_mels,n_frames,lengths", [
    (40, 501, None), (40, 501, [80000, 30001, 0, 79999]), (64, 216, [1, 34000, 160, 170]),
    (128, 37, [5759, 5760, 100000, -1]),
])
def test_one_pass_reduction_equals_the_plain_epilogue_bit_for_bit(rng, layout, n_mels, n_frames, lengths):
    """The kernel takes the peak and the range from max S, max L and min L
    alone (rounding and max(x, floor) are monotone): the same numbers as
    dsp.mel_epilogue's four reductions, padded frames included."""
    mel = _epilogue_power(rng, 4, n_mels, n_frames, layout)
    lens = None if lengths is None else torch.tensor(lengths)
    assert torch.equal(_one_pass_epilogue(mel, lens, 160), tdsp.mel_epilogue(mel, lens, 160))


def test_padded_frames_reach_no_valid_frame(rng):
    """Padded frames take part in no reduction, but are written with the
    formula of the clip's counted frames (what the kernel must write)."""
    lengths = torch.tensor([80000, 30001, 4000])
    mel = _epilogue_power(rng, 3, 40, 501, "frames")
    out = tdsp.mel_epilogue(mel, lengths, 160)
    valid = 1 + lengths // 160
    pad = torch.arange(501)[None, None, :] >= valid[:, None, None]
    changed = torch.where(pad, mel * torch.from_numpy(rng.uniform(0.0, 1e6, mel.shape).astype(np.float32)), mel)
    out2 = tdsp.mel_epilogue(changed, lengths, 160)
    assert torch.equal(out[~pad.expand_as(out)], out2[~pad.expand_as(out2)])
    assert not torch.equal(out, out2)
    assert torch.equal(out2, _one_pass_epilogue(changed, lengths, 160))
    assert float(out2[1, :, int(valid[1]):].max()) > 1.0   # the formula, unclipped, where padding is louder


@pytest.mark.parametrize("shape,stride,layout", [
    ((2, 40, 501), (20040, 1, 40), "frames"),
    ((2, 40, 501), (20040, 501, 1), "mels"),
    ((1, 40, 501), (0, 1, 40), "frames"),
    ((3, 1, 216), (216, 7, 1), "mels"),
    ((3, 40, 1), (40, 1, 99), "mels"),
    ((256, 128, 2001), (256128, 1, 128), "frames"),
])
def test_epilogue_layout_takes_either_dense_layout(shape, stride, layout):
    assert mel_kernel.epilogue_layout(shape, stride, torch.float32) == layout


@pytest.mark.parametrize("shape,stride,dtype,error", [
    ((2, 40, 501), (20040, 1, 40), torch.float64, TypeError),
    ((2, 40, 501), (20040, 501, 1), torch.float16, TypeError),
    ((2, 40, 501), (20040, 501, 1), torch.bfloat16, TypeError),
    ((40, 501), (501, 1), torch.float32, ValueError),
    ((0, 40, 501), (20040, 501, 1), torch.float32, ValueError),
    ((2, 40, 501), (40080, 1002, 2), torch.float32, ValueError),     # every second frame
    ((2, 40, 501), (1, 2, 80), torch.float32, ValueError),           # clips interleaved
    ((2, 40, 501), (20040, 1, 80), torch.float32, ValueError),       # frames-major with a gap
    ((2, 40, 501), (0, 501, 1), torch.float32, ValueError),          # one clip broadcast
    ((2, 65536, 32768), (2 ** 31, 32768, 1), torch.float32, ValueError),   # 2^31 values a clip
])
def test_epilogue_layout_refuses_what_the_kernel_cannot_take(shape, stride, dtype, error):
    with pytest.raises(error):
        mel_kernel.epilogue_layout(shape, stride, dtype)


def test_epilogue_lengths_as_the_kernel_reads_them():
    cpu = torch.device("cpu")
    same = torch.tensor([80000, 4000], dtype=torch.int64)
    assert mel_kernel.epilogue_lengths(same, 2, cpu) is same   # what features.base passes: untouched
    converted = mel_kernel.epilogue_lengths(torch.tensor([80000, 4000], dtype=torch.int32), 2, cpu)
    assert converted.dtype == torch.int64 and converted.tolist() == [80000, 4000]
    assert mel_kernel.epilogue_lengths(torch.tensor([5, 0, 7, 0])[::2], 2, cpu).is_contiguous()


@pytest.mark.parametrize("lengths,error", [
    (torch.tensor([8000.0, 4000.0]), TypeError),
    (torch.tensor([True, False]), TypeError),
    (torch.tensor([8000, 4000, 100]), ValueError),
    (torch.tensor([[8000, 4000]]), ValueError),
])
def test_epilogue_lengths_refused(lengths, error):
    with pytest.raises(error):
        mel_kernel.epilogue_lengths(lengths, 2, torch.device("cpu"))
