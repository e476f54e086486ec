"""mel_roofline: the mel-power function's least time over the mean device
time of one launch of the kernels that compute it.

The least time (``mel_folded_bound``, kept here so that it cannot move with
the program) is the larger of its bytes (each clip read once, the mel
power written once, float32) over the HBM rate and its operations at their
least over the peak of their type: per frame the Hann window (n_fft
multiplies), a real FFT at the nominal 2.5 n_fft log2(n_fft) FLOP, the
power (3 a bin) and the mel product over the bank's nonzeros (2 each). The
configuration's ``mel_power`` gives the shape each batch's call runs at;
a mix that splits each batch over ``cards`` cards (1 by default) launches
the kernel once a card, on ``batch // cards`` rows.
"""

import numpy as np

from benchmark.harness.peaks import F32_PEAK, F64_PEAK, HBM_RATE
from benchmark.reference import librosa_ref

KERNELS = ("mel_rfft_kernel", "mel_czt_kernel")   # the routed mel kernels' names in the trace


def mel_folded_bound(batch: int, n: int, n_fft: int, mel_nonzeros: int, hop: int, n_mels: int,
                     peak: float = F32_PEAK) -> tuple[float, str, float]:
    """(least ms, "operations" or "bytes", the least operations)."""
    n_freq = 1 + n_fft // 2
    frames = batch * (1 + n // hop)
    flops = frames * (n_fft + 2.5 * n_fft * np.log2(n_fft) + 3 * n_freq + 2 * mel_nonzeros)
    nbytes = 4 * (batch * n + frames * n_mels)
    t_ops, t_bytes = flops / peak, nbytes / HBM_RATE
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes", float(flops)


def bound(config: dict, mix: dict, rows: int | None = None) -> tuple[float, str, float]:
    """``mel_folded_bound`` of ``rows`` clips of the cell, by default one batch."""
    m = config["mel_power"]
    sr = m["sample_rate"]
    nonzeros = int(np.count_nonzero(librosa_ref.mel_filterbank(sr, m["n_fft"], m["n_mels"])))
    peak = F64_PEAK if m["type"] == "float64" else F32_PEAK
    return mel_folded_bound(int(mix["batch"]) if rows is None else rows, int(round(mix["clip_seconds"] * sr)),
                            m["n_fft"], nonzeros, m["hop_length"], m["n_mels"], peak)


def launch_rows(mix: dict) -> int:
    """The clips one launch covers: a batch, or one card's part of it."""
    return int(mix["batch"]) // int(mix.get("cards", 1))


def read(ctx):
    if ctx.trace is None:
        return None
    seconds, launches = ctx.trace.kernels_matching(KERNELS)
    if launches == 0:
        return None
    return 100.0 * bound(ctx.config, ctx.mix, launch_rows(ctx.mix))[0] * 1e-3 / (seconds / launches)
