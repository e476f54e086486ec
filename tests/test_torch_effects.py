"""The port's vocoder: its float64 oracle (``ops/golden/effects.py``) bit for
bit against the JAX package's, and its batched time stretch / pitch shift
(``ops/effects_device.py``) on the CPU against both the oracle and JAX's
``ops/effects_jax.py``: per-clip lengths equal, waveforms within 2e-3 (the
gate of ``tests/test_effects_jax.py``: float32 phase cumsum over pre-wrapped
deltas)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from audio_edge_ml_pipeline_tpu.ops import effects_jax
from audio_edge_ml_pipeline_tpu.ops.golden import effects as jgold
from audio_edge_ml_pipeline_torch.ops import effects_device
from audio_edge_ml_pipeline_torch.ops.golden import effects as tgold

WAVE_TOL = 2e-3


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _clips(B: int, n: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000.0
    y = 0.4 * np.sin(2 * np.pi * 440 * t)[None, :] + 0.1 * rng.standard_normal((B, n))
    return y.astype(np.float32)


def _ragged(seed=3):
    """The ragged batch of tests/test_effects_jax.py."""
    rng = np.random.default_rng(seed)
    return [(0.3 * rng.standard_normal(n)).astype(np.float32) for n in (15000, 17777, 24000, 24001)]


@pytest.mark.parametrize("n,rate", [(24000, 0.85), (24000, 1.05), (17777, 1.15), (8000, 0.9), (24001, 1.0)])
def test_golden_time_stretch_is_jaxs_bit_for_bit(n, rate):
    y = _clips(1, n, seed=n)[0].astype(np.float64)
    ours, theirs = tgold.time_stretch(y, rate), jgold.time_stretch(y, rate)
    assert ours.dtype == theirs.dtype and np.array_equal(ours, theirs)


@pytest.mark.parametrize("n,steps,sr", [(24000, -3.0, 16000), (24000, 1.7, 16000), (15000, 4.0, 16000),
                                        (22050, -0.5, 22050)])
def test_golden_pitch_shift_is_jaxs_bit_for_bit(n, steps, sr):
    y = _clips(1, n, seed=n + 1)[0].astype(np.float64)
    ours, theirs = tgold.pitch_shift(y, sr, steps), jgold.pitch_shift(y, sr, steps)
    assert ours.dtype == theirs.dtype and np.array_equal(ours, theirs)


def test_golden_oracle_pieces_and_refusal():
    D = np.fft.rfft(_clips(1, 8192)[0].astype(np.float64).reshape(8, 1024), n=2048, axis=1).T
    assert np.array_equal(tgold.phase_vocoder(D, 1.05), jgold.phase_vocoder(D, 1.05))
    assert np.array_equal(tgold.istft(D, length=3000), jgold.istft(D, length=3000))
    with pytest.raises(ValueError, match="positive"):
        tgold.time_stretch(np.zeros(100), 0.0)


def _held(outs, refs, theirs=None):
    for b, (o, r) in enumerate(zip(outs, refs)):
        assert o.dtype == np.float32 and len(o) == len(r), b
        assert np.max(np.abs(o - r)) < WAVE_TOL, b
        if theirs is not None:
            assert len(theirs[b]) == len(o) and np.max(np.abs(o - theirs[b])) < WAVE_TOL, b


def test_time_stretch_batch_matches_oracle_and_jax():
    y = _clips(6, 24000)
    # 1.05 / 0.85: rates whose float32 step grid lands on the wrong side of frame boundaries
    rates = np.array([0.85, 0.9, 1.0, 1.05, 1.1, 1.15])
    outs = effects_device.time_stretch_batch(y, rates, device="cpu")
    refs = [tgold.time_stretch(c.astype(np.float64), float(r)) for c, r in zip(y, rates)]
    _held(outs, refs, effects_jax.time_stretch_batch(y, rates))
    assert all(np.corrcoef(o, r)[0, 1] > 0.9999 for o, r in zip(outs, refs))


def test_pitch_shift_batch_matches_oracle_and_jax():
    y = _clips(4, 24000, seed=1)
    steps = np.array([-3.0, -0.5, 1.7, 3.0])
    outs = effects_device.pitch_shift_batch(y, 16000, steps, device="cpu")
    assert all(len(o) == y.shape[1] for o in outs)
    refs = [tgold.pitch_shift(c.astype(np.float64), 16000, float(s)) for c, s in zip(y, steps)]
    _held(outs, refs, effects_jax.pitch_shift_batch(y, 16000, steps))


def test_ragged_batch_matches_oracle_and_jax():
    """Clips of differing lengths share one padded pass (4096-sample buckets,
    per-clip frame masks); each matches the oracle at its own length."""
    clips = _ragged()
    rates = np.array([0.9, 1.1, 0.85, 1.05])
    outs = effects_device.time_stretch_batch(clips, rates, device="cpu")
    _held(outs, [tgold.time_stretch(c.astype(np.float64), float(r)) for c, r in zip(clips, rates)],
          effects_jax.time_stretch_batch(clips, rates))
    steps = np.array([2.0, -1.0, 0.7, -2.5])
    ps = effects_device.pitch_shift_batch(clips, 16000, steps, device="cpu")
    assert [len(o) for o in ps] == [len(c) for c in clips]
    _held(ps, [tgold.pitch_shift(c.astype(np.float64), 16000, float(s)) for c, s in zip(clips, steps)],
          effects_jax.pitch_shift_batch(clips, 16000, steps))


def test_host_step_grids_are_the_oracles_arange():
    n_b = np.array([15000, 24001, 80000])
    rates = np.array([1.05, 0.85, 1.15])
    n_pad, lo, frac, valid, t_valid = effects_device.step_grids(n_b, rates)
    assert n_pad == 81920 and n_pad % 4096 == 0 and lo.shape[1] % 32 == 0
    T = 1 + n_pad // 512
    for b in range(3):
        g = np.arange(0.0, float(1 + n_b[b] // 512), rates[b])
        assert t_valid[b] == 1 + n_b[b] // 512 and valid[b].sum() == len(g)
        np.testing.assert_array_equal(lo[b, : len(g)], np.floor(g).astype(np.int64))
        np.testing.assert_array_equal(frac[b, : len(g)], (g - np.floor(g)).astype(np.float32))
        assert (lo[b, len(g):] == T).all() and (frac[b, len(g):] == 0).all()


def test_rounding_is_half_to_even_as_jnp_round():
    import jax.numpy as jnp

    x = np.array([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 3.5, 1e6 + 0.5], np.float32)
    np.testing.assert_array_equal(torch.round(torch.from_numpy(x)).numpy(), np.asarray(jnp.round(x)))


def test_tf32_flags_do_not_reach_the_vocoder():
    y = _clips(2, 12000, seed=5)
    rates = np.array([0.9, 1.1])
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    base = effects_device.time_stretch_batch(y, rates, device="cpu")
    try:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        torch.set_float32_matmul_precision("medium")
        on = effects_device.time_stretch_batch(y, rates, device="cpu")
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
        torch.set_float32_matmul_precision("highest")
    assert all(np.array_equal(a, b) for a, b in zip(base, on))


def test_refusals(monkeypatch):
    with pytest.raises(ValueError, match="positive"):
        effects_device.time_stretch_batch(_clips(2, 8000), np.array([1.0, -0.5]), device="cpu")
    with pytest.raises(ValueError, match="batch"):
        effects_device.time_stretch_batch(np.zeros(100, np.float32), np.array([1.0]), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        effects_device.time_stretch_batch(_clips(2, 8000), np.array([1.0, 1.1]))
