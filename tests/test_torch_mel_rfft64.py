"""csrc/mel_rfft.cu's float64 instantiation (the MFCC features' mel power):
its tables, its dispatch and constants in the source, and rfft_plan's
emulation of it against float64 np.fft.rfft and the golden mel power. The
kernel itself runs only on a card (chip_smoke.py phase 3 and 3c)."""

import math
import re

import numpy as np
import pytest
import torch

from audio_edge_ml_pipeline_torch.ops import _build, mel_kernel, rfft_plan
from audio_edge_ml_pipeline_torch.ops.golden import librosa_ref as ref


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def test_the_source_dispatches_every_fft_size_to_a_float64_instantiation():
    source = (_build.CSRC / "mel_rfft.cu").read_text()
    launches = {int(n): int(m) for n, m in re.findall(r"case (\d+): return launch<(\d+), T>", source)}
    assert launches == {n_fft: n_fft // 2 for n_fft in rfft_plan.RADICES}
    assert re.search(r"int mel_rfft_launch_f64\([^{]*\{\s*return dispatch<double>\(", source)
    constants = dict(re.findall(r"constexpr double (k\w+) = (-?[\d.]+);", source))
    names = ("kSqrtHalf64", "kCos1_64", "kSin1_64", "kCos2_64", "kSin2_64", "kSin3_64")
    assert tuple(float(constants[k]) for k in names) == rfft_plan.CONSTANTS64
    exact = (math.sqrt(0.5), *(f(a * math.pi) for a in (0.4, 0.8) for f in (math.cos, math.sin)), math.sqrt(0.75))
    assert rfft_plan.CONSTANTS64 == pytest.approx(exact, abs=2e-16)
    assert "size_t mel_rfft_smem_bytes_f64(" in source


@pytest.mark.parametrize("n_fft", sorted(rfft_plan.RADICES))
def test_float64_tables_are_the_float32_ones_unrounded(n_fft):
    t32, t64 = rfft_plan.tables(22050, n_fft, 64), rfft_plan.tables64(22050, n_fft, 64)
    for name in ("window", "twiddles", "split", "weights"):
        a32, a64 = getattr(t32, name), getattr(t64, name)
        assert a32.dtype == np.float32 and a64.dtype == np.float64 and a32.shape == a64.shape
        np.testing.assert_array_equal(a64.astype(np.float32), a32)
    for name in ("bands", "chunks", "slots"):
        np.testing.assert_array_equal(getattr(t32, name), getattr(t64, name))
    np.testing.assert_array_equal(t64.window, ref.hann_periodic(n_fft))


def test_precise_constants_are_the_float64_tables():
    consts = mel_kernel.rfft_constants(22050, 1024, 128, torch.device("cpu"), True)
    tab = rfft_plan.tables64(22050, 1024, 128)
    for c, a in zip(consts, (tab.window, tab.twiddles, tab.split, tab.weights, tab.chunks, tab.slots)):
        np.testing.assert_array_equal(c.numpy(), a)
    assert consts[0].dtype == torch.float64 and consts[4].dtype == torch.int32


@pytest.mark.parametrize("n_fft", sorted(rfft_plan.RADICES))
def test_emulated_float64_frame_power_matches_float64_rfft(rng, n_fft):
    """The float64 steps leave float64 rounding only: 1e-13 of each frame's
    peak power, where the float32 kernel sits near 1e-7."""
    frames = (0.3 * rng.standard_normal((24, n_fft))).astype(np.float32)
    frames[1] = np.sin(2 * np.pi * 37.3 * np.arange(n_fft) / n_fft)
    power = rfft_plan.frame_power_emulated(torch.from_numpy(frames), rfft_plan.tables64(16000, n_fft, 40))
    assert power.dtype == torch.float64
    exact = np.abs(np.fft.rfft(frames.astype(np.float64) * ref.hann_periodic(n_fft), axis=1)) ** 2
    assert np.max(np.abs(power.numpy() - exact) / exact.max(axis=1, keepdims=True)) <= 1e-13


def test_emulated_float64_mel_power_keeps_the_weak_bins(rng):
    """Mel bins 60 dB and more under the clip's peak: float32 steps leave
    them up to a few 1e-5 off (relative power), float64 steps under 1e-6."""
    sr, n = 22050, 22050
    t = np.arange(n) / sr
    y = (0.5 * np.sin(2 * np.pi * 3000 * t) + 1e-3 * rng.standard_normal(n)).astype(np.float32)
    gold = ref.melspectrogram(y.astype(np.float64), sr, 128, 1024, 512).T           # (T, M)
    rel = {}
    for precise in (False, True):
        ours = rfft_plan.mel_power_emulated(torch.from_numpy(y[None]), sr, 128, 1024, 512, precise=precise)[0]
        assert ours.dtype == torch.float32
        live = gold >= gold.max() * 1e-8                                            # within 80 dB of the peak
        rel[precise] = float(np.max(np.abs(ours.numpy() - gold)[live] / gold[live]))
    assert rel[True] <= 1e-6 < rel[False], rel
