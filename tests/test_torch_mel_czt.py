"""Port parity: the chirp-z mel kernel's plans, tables, index math and torch
emulation (audio_edge_ml_pipeline_torch.ops.czt_plan) against float64
``np.fft.rfft``, the golden mel and the JAX package's two Pallas mel kernels
in interpret mode; the wrappers' launch shapes and size limits. The CUDA
kernel (csrc/mel_czt.cu) runs only on a card: tests/test_torch_cuda.py holds
it against the plain versions there."""

import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from audio_edge_ml_pipeline_tpu.ops import pallas_mel
from audio_edge_ml_pipeline_torch.ops import _build, czt_plan, mel_kernel, mel_unfolded, rfft_plan
from audio_edge_ml_pipeline_torch.ops.golden import librosa_ref as ref

F32_TOL = 1e-6    # float32 instantiation: of each frame's (or clip's) peak power, chip_smoke.KERNEL_REL_TOL
F64_TOL = 1e-13   # float64 instantiation's frame power: of each frame's peak (measured <= 2.1e-15)
F64_BIN_TOL = 1e-6  # float64 mel power rounded to float32, per bin: chip_smoke.F64_ELEMENT_TOL
SMALL = [n for n in range(2, 130, 2) if not rfft_plan.supports(n)]
NAMED = [482, 800, 882, 1102, 2050, 4096]   # M = 241 (prime), 400, 441, 551, 1025, 2048


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


def _is_smooth(n):
    for p in (2, 3, 5):
        while n % p == 0:
            n //= p
    return n == 1


# ---------------------------------------------------------------- plans


def test_plan_takes_a_5_smooth_length_whose_radices_multiply_to_it():
    """Every even n_fft from 2 to 16384: direct exactly where M is 5-smooth,
    else a 5-smooth P >= 2M - 1; the radices multiply to the length."""
    for n_fft in range(2, 16386, 2):
        p = czt_plan.plan(n_fft)
        M = n_fft // 2
        assert p.mode == ("direct" if _is_smooth(M) else "chirp"), n_fft
        if p.mode == "direct":
            assert p.length == M
        else:
            assert p.length >= 2 * M - 1 and _is_smooth(p.length), n_fft
        assert int(np.prod(p.radices)) == p.length and set(p.radices) <= {2, 3, 4, 5, 8}, n_fft
        assert len(p.radices) <= czt_plan.MAX_PASSES and p.radices.count(2) <= 1, n_fft
        L, off = p.length, 0
        for R, Ls, o in zip(p.radices, p.lengths, p.tw_offsets):
            assert (Ls, o) == (L, off)
            off += (Ls // R) * (R - 1)
            L //= R


@pytest.mark.parametrize("M,P,radices", [
    (241, 512, (8, 8, 8)), (1025, 2560, (8, 8, 8, 5)), (441, 960, (8, 8, 5, 3)), (551, 1280, (8, 8, 4, 5)),
    (7, 15, (5, 3)), (2399, 4800, (8, 8, 5, 5, 3)),
])
def test_chirp_length_is_the_cheapest_5_smooth_length(M, P, radices):
    """The least P x passes among 5-smooth P >= 2M - 1 (at M = 241 the
    three-pass 512, not 486 in six passes or 500 in four)."""
    p = czt_plan.plan(2 * M)
    assert (p.mode, p.length, p.radices) == ("chirp", P, radices)
    cost = P * len(radices)
    for n in range(2 * M - 1, 1 << (2 * M - 2).bit_length()):
        r = czt_plan.smooth_radices(n)
        assert r is None or n * len(r) >= cost


@pytest.mark.parametrize("n_fft", sorted(set(SMALL[:12] + NAMED + [1600, 960, 1200, 9630, 4798, 3070])))
def test_positions_permute_and_each_pass_touches_every_slot_once(n_fft):
    p = czt_plan.plan(n_fft)
    pos = czt_plan.positions(p)
    assert sorted(pos.tolist()) == list(range(p.length))
    for s in range(len(p.radices)):
        slots, j = czt_plan.butterfly_slots(p, s)
        assert sorted(slots.ravel().tolist()) == list(range(p.length))
        assert j.max(initial=0) < p.lengths[s] // p.radices[s]
    padded = rfft_plan.pad_index(np.arange(max(p.length, p.M + 1)))
    assert len(set(padded.tolist())) == len(padded) and padded.max() < czt_plan.scratch_size(p)


@pytest.mark.parametrize("n_fft", [30, 160, 800, 4096, 22, 482, 2050])
def test_dif_passes_give_the_fft_in_digit_reversed_order_and_dit_undoes_it(rng, n_fft):
    """In float64: the DIF passes leave X[f] at positions[f]; the DIT passes
    on that order give the FFT in natural order."""
    p = czt_plan.plan(n_fft)
    tw = torch.from_numpy(czt_plan.tables64(16000, n_fft, 40).twiddles)
    x = rng.standard_normal((3, p.length)) + 1j * rng.standard_normal((3, p.length))
    size = czt_plan.scratch_size(p)
    addr = torch.from_numpy(rfft_plan.pad_index(np.arange(p.length)))
    pos = torch.from_numpy(rfft_plan.pad_index(czt_plan.positions(p)))
    exact = np.fft.fft(x, axis=1)

    def scratch(values, where):
        sr, si = torch.zeros((3, size), dtype=torch.float64), torch.zeros((3, size), dtype=torch.float64)
        sr[:, where], si[:, where] = torch.from_numpy(values.real.copy()), torch.from_numpy(values.imag.copy())
        return sr, si

    sr, si = scratch(x, addr)
    czt_plan._passes(sr, si, p, tw, range(len(p.radices)), False, rfft_plan.CONSTANTS64)
    got = (sr[:, pos] + 1j * si[:, pos]).numpy()
    assert np.max(np.abs(got - exact)) <= 1e-12 * np.abs(exact).max()
    sr, si = scratch(x, pos)
    czt_plan._passes(sr, si, p, tw, reversed(range(len(p.radices))), True, rfft_plan.CONSTANTS64)
    got = (sr[:, addr] + 1j * si[:, addr]).numpy()
    assert np.max(np.abs(got - exact)) <= 1e-12 * np.abs(exact).max()


# ---------------------------------------------------------------- tables


@pytest.mark.parametrize("M", [7, 17, 241, 441, 1025, 2399])
def test_integer_chirp_phases_match_the_exact_chirp(M):
    """w[m] from m^2 mod 2M in integers equals exp(-i pi m^2 / M) within
    1e-15 (taken in long double with the whole m^2, whose phase error is
    below 1e-15 up to M = 2399); the float64 formula drifts with m^2."""
    m = np.arange(M)
    pi = np.arccos(np.longdouble(-1))
    ang = pi * (m.astype(np.longdouble) ** 2) / M
    exact = np.stack([np.cos(ang), -np.sin(ang)], axis=1)
    ours = czt_plan.chirp64(M)
    assert np.max(np.abs(ours - exact)) <= 1e-15


@pytest.mark.parametrize("M", [3, 5, 7])
def test_integer_chirp_phases_match_the_float64_formula_where_m_squared_is_small(M):
    m = np.arange(M)
    plain = np.exp(-1j * np.pi * m.astype(np.float64) ** 2 / M)
    assert np.max(np.abs(np.stack([plain.real, plain.imag], 1) - czt_plan.chirp64(M))) <= 1e-15


def test_float_phase_would_drift_at_large_m():
    """Why the phases are reduced in integers: at M = 2399 the float64 angle
    pi m^2 / M puts exp(-i pi m^2 / M) more than 1e-13 off at the largest m."""
    M = 2399
    m = np.arange(M, dtype=np.float64)
    plain = np.exp(-1j * np.pi * m ** 2 / M)
    assert np.max(np.abs(np.stack([plain.real, plain.imag], 1) - czt_plan.chirp64(M))) > 1e-13


@pytest.mark.parametrize("n_fft", [14, 482, 2050, 4096, 800])
def test_tables_are_rounded_once_from_float64(n_fft):
    t64, t32 = czt_plan.tables64(16000, n_fft, 40), czt_plan.tables(16000, n_fft, 40)
    p = czt_plan.plan(n_fft)
    for name in ("window", "chirp", "filt", "twiddles", "split"):
        a, b = getattr(t64, name), getattr(t32, name)
        assert a.dtype == np.float64 and b.dtype == np.float32
        np.testing.assert_array_equal(b, a.astype(np.float32))
    assert t32.positions.dtype == np.int32 and t32.chunks.dtype == np.int32
    np.testing.assert_array_equal(t32.weights, rfft_plan.mel_bands(16000, n_fft, 40)[1])
    k = np.arange(p.M // 2 + 1)
    np.testing.assert_allclose(t64.split[:, 0] + 1j * t64.split[:, 1], np.exp(-2j * np.pi * k / n_fft), atol=1e-15)
    if p.mode == "chirp":
        w = t64.chirp[:, 0] + 1j * t64.chirp[:, 1]
        b = np.zeros(p.length, complex)
        b[: p.M], b[p.length - p.M + 1:] = np.conj(w), np.conj(w[1:])[::-1]
        H = np.fft.fft(b) / p.length
        rows = czt_plan.filter_rows(p)[czt_plan.positions(p)]
        assert sorted(rows.tolist()) == list(range(p.length))
        np.testing.assert_allclose(t64.filt[rows, 0] + 1j * t64.filt[rows, 1], np.conj(H), atol=1e-15)
    else:
        assert t64.chirp.shape == t64.filt.shape == (0, 2)
    for R, Ls, off in zip(p.radices, p.lengths, p.tw_offsets):
        q = np.arange(1, R)[:, None]
        j = np.arange(Ls // R)[None, :]
        rows = t64.twiddles[off : off + (Ls // R) * (R - 1)].reshape(R - 1, Ls // R, 2)
        np.testing.assert_allclose(rows[..., 0] + 1j * rows[..., 1], np.exp(-2j * np.pi * q * j / Ls), atol=1e-15)


def test_czt_constants_are_what_the_kernel_reads():
    for precise in (False, True):
        consts = mel_kernel.czt_constants(16000, 482, 40, torch.device("cpu"), precise)
        tab = (czt_plan.tables64 if precise else czt_plan.tables)(16000, 482, 40)
        for c, a in zip(consts, (tab.window, tab.chirp, tab.filt, tab.positions, tab.twiddles, tab.split,
                                 tab.weights, tab.chunks, tab.slots)):
            np.testing.assert_array_equal(c.numpy(), a)
            assert c.is_contiguous()


# ---------------------------------------------------------------- the emulation


def _frames(rng, n_fft):
    frames = (0.3 * rng.standard_normal((24, n_fft))).astype(np.float32)
    t = np.arange(n_fft)
    frames[1] = np.sin(2 * np.pi * 0.37 * n_fft / 4 * t / n_fft)   # a tone between bins
    frames[2] = 1.0                                                  # DC only
    frames[3] = (-1.0) ** t                                          # Nyquist only
    return frames


@pytest.mark.parametrize("precise", [False, True])
@pytest.mark.parametrize("n_fft", SMALL + NAMED)
def test_emulated_frame_power_matches_float64_rfft(rng, n_fft, precise):
    frames = _frames(rng, n_fft)
    tab = (czt_plan.tables64 if precise else czt_plan.tables)(16000, n_fft, 40)
    power = czt_plan.frame_power_emulated(torch.from_numpy(frames), tab).numpy()
    exact = np.abs(np.fft.rfft(frames.astype(np.float64) * ref.hann_periodic(n_fft), axis=1)) ** 2
    assert power.shape == (24, 1 + n_fft // 2)
    peak = np.maximum(exact.max(axis=1, keepdims=True), 1e-300)
    assert np.max(np.abs(power - exact) / peak) <= (F64_TOL if precise else F32_TOL)


@pytest.mark.parametrize("precise", [False, True])
@pytest.mark.parametrize("n_fft", SMALL + NAMED)
def test_emulated_mel_power_matches_golden(rng, n_fft, precise):
    sr, hop, n_mels = (22050, 512, 128) if n_fft >= 2048 else (16000, 160, 40)
    y = _clips(rng, 2, 6000 if n_fft < 2048 else 11025, sr)
    ours = czt_plan.mel_power_emulated(torch.from_numpy(y), sr, n_mels, n_fft, hop, precise=precise).numpy()
    gold = np.stack([ref.melspectrogram(c.astype(np.float64), sr=sr, n_mels=n_mels, n_fft=n_fft, hop_length=hop).T
                     for c in y])
    assert ours.shape == gold.shape == (2, 1 + y.shape[1] // hop, n_mels)
    err = np.abs(ours - gold)
    live = gold > 0      # at n_fft 2 no filter of the bank has a weight on the two bins
    assert not ours[~live].any()
    if precise:          # rounded to float32 once: per bin
        assert np.max(err[live] / gold[live], initial=0.0) <= F64_BIN_TOL
    else:
        assert np.max(err / np.maximum(gold.max(axis=(1, 2), keepdims=True), 1e-30)) <= F32_TOL


@pytest.mark.parametrize("precise", [False, True])
@pytest.mark.parametrize("n_fft", [482, 2050, 4096])
def test_emulated_mel_power_matches_the_folded_plain_version(rng, n_fft, precise):
    """What the card check holds the kernel to: KERNEL_REL_TOL of a clip's
    peak (float32), F64_ELEMENT_TOL a bin (float64)."""
    sr, hop, n_mels = (16000, 160, 40) if n_fft == 482 else (22050, 512, 128)
    y = torch.from_numpy(_clips(rng, 2, 22050, sr))
    ours = czt_plan.mel_power_emulated(y, sr, n_mels, n_fft, hop, precise=precise)
    plain = mel_kernel.mel_power_folded_plain(y, sr, n_mels, n_fft, hop)
    err = (ours - plain).abs()
    if precise:
        assert float((err / plain.abs().clamp_min(1e-30)).max()) <= F64_BIN_TOL
    else:
        assert float((err / plain.abs().amax(dim=(1, 2), keepdim=True)).max()) <= F32_TOL


@pytest.mark.parametrize("kernel", ["mel_power_pallas", "mel_power_pallas_folded"])
def test_emulation_at_n_fft_482_matches_both_pallas_kernels(rng, kernel):
    y = _clips(rng, 2, 16077)
    ours = czt_plan.mel_power_emulated(torch.from_numpy(y), n_fft=482).numpy()                       # (B, T, M)
    theirs = np.asarray(getattr(pallas_mel, kernel)(jnp.asarray(y), n_fft=482, interpret=True))    # (B, M, T)
    scale = np.max(np.abs(theirs), axis=(1, 2), keepdims=True)
    assert np.max(np.abs(ours.transpose(0, 2, 1) - theirs) / scale) <= F32_TOL


def test_emulation_at_n_fft_482_matches_the_unfolded_plain_version(rng):
    y = torch.from_numpy(_clips(rng, 2, 16077))
    ours = czt_plan.mel_power_emulated(y, n_fft=482)
    plain = mel_unfolded.mel_power_unfolded_plain(y, n_fft=482)
    assert float(((ours - plain).abs() / plain.abs().amax(dim=(1, 2), keepdim=True)).max()) <= F32_TOL


def test_zero_frames_give_exact_zeros(rng):
    y = np.zeros((2, 16077), np.float32)
    y[1, :5000] = 0.3 * rng.standard_normal(5000)
    out = czt_plan.mel_power_emulated(torch.from_numpy(y), n_fft=482).numpy()
    assert not out[0].any()
    first_silent = -(-(5000 + 241) // 160)
    assert not out[1, first_silent:].any() and out[1, :first_silent].any()


# ---------------------------------------------------------------- routes and launch shapes


def test_every_even_n_fft_off_the_plans_routes_to_czt():
    """No route reaches a dense kernel any more (the unfolded entry's n_fft 2 too)."""
    for n_fft in range(4, 4098, 2):
        kernel = "rfft" if rfft_plan.supports(n_fft) else "czt"
        assert mel_kernel.route(n_fft) == mel_unfolded.route(n_fft) == kernel, n_fft
    assert mel_unfolded.route(2) == "czt"


@pytest.mark.parametrize("n_fft,hop,precise,shape", [
    (482, 160, False, (8, 32)), (2050, 512, True, (4, 8)), (4096, 512, False, (8, 16)), (4096, 512, True, (4, 8)),
    (9630, 160, False, (2, 4)), (4798, 160, True, (2, 4)), (3070, 160, False, (4, 8)), (2, 160, False, (8, 32)),
])
def test_czt_shape_takes_the_first_that_fits(n_fft, hop, precise, shape):
    """The dense kernels' largest sizes (folded 9,630 / 4,798, unfolded
    3,070 at hop 160) fit, at the warps and frames a tile stated."""
    n_slots = int(czt_plan.tables(16000, n_fft, 40).slots[:, 1].sum())
    assert mel_kernel.czt_shape(n_fft, hop, n_slots, precise) == shape


def test_czt_shape_holds_every_even_n_fft_the_docs_state_and_raises_by_name_above():
    for precise, largest in ((False, 16384), (True, 10240)):
        n_slots = int(czt_plan.tables(16000, largest, 40).slots[:, 1].sum())
        mel_kernel.czt_shape(largest, 160, n_slots, precise)
        with pytest.raises(ValueError, match=r"mel_czt<(float|double)> at n_fft=\d+"):
            mel_kernel.czt_shape(largest + 2, 160, int(czt_plan.tables(16000, largest + 2, 40).slots[:, 1].sum()),
                                 precise)


def test_smem_formula_matches_the_source():
    source = (_build.CSRC / "mel_czt.cu").read_text()
    assert "sizeof(float) * ((span + 3) & ~static_cast<size_t>(3)) +" in source
    assert "static_cast<size_t>(t_bytes) * warps * (2 * static_cast<size_t>(scratch) + n_slots)" in source
    assert re.search(r"kMaxPasses = (\d+)", source).group(1) == str(czt_plan.MAX_PASSES)
    shapes = re.search(r"of (8 x 32(?:, \d x \d+)*)", source.replace("//", "").replace("\n", " ")).group(1)
    assert [tuple(int(v) for v in s.split(" x ")) for s in shapes.split(", ")] == list(mel_kernel.CZT_SHAPES)


def test_wrappers_take_the_plain_version_for_cpu_tensors(rng):
    y = torch.from_numpy((0.3 * rng.standard_normal((2, 4000))).astype(np.float32))
    before = (mel_kernel.counter_czt.launches, mel_unfolded.counter_czt.launches)
    folded = mel_kernel.mel_power_folded(y, n_fft=482)
    unfolded = mel_unfolded.mel_power_unfolded(y, n_fft=482)
    assert (mel_kernel.counter_czt.launches, mel_unfolded.counter_czt.launches) == before
    torch.testing.assert_close(folded, mel_kernel.mel_power_folded_plain(y, n_fft=482), rtol=0, atol=0)
    torch.testing.assert_close(unfolded, mel_unfolded.mel_power_unfolded_plain(y, n_fft=482), rtol=0, atol=0)


def test_instantiation_names():
    assert mel_kernel.instantiation("mel_czt", 482, False) == "mel_czt<float>"
    assert mel_kernel.instantiation("mel_czt", 2050, True) == "mel_czt<double>"
    assert mel_kernel.instantiation("rfft", 512, False) == "mel_rfft<256, float>"
