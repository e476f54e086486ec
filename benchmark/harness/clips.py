"""The clip pool: an fsc22-sized dataset of synthetic clips, made on the
device from the seed in a few large calls.

Each clip has a class pitch (27 classes spread log-evenly over 90-2500 Hz,
+-3 % a clip) with two more harmonics, a slow amplitude swing, a noise
floor and three 0.1 s noise bursts, peak-normalised to 0.8: tones, noise
and transients, as forest recordings have. Every seed draws the same sizes.
"""

from __future__ import annotations

import math

import torch

F0_LOW, F0_HIGH = 90.0, 2500.0   # the third harmonic of the highest stays under 8 kHz
BURSTS, BURST_S = 3, 0.1
CHUNK = 256                      # clips made in one call


def _chunk(gen: torch.Generator, classes: torch.Tensor, n_classes: int, n: int, sr: int) -> torch.Tensor:
    dev = classes.device
    b = classes.numel()

    def rand(*shape):
        return torch.rand(*shape, device=dev, generator=gen)

    t = torch.arange(n, device=dev, dtype=torch.float32) / sr
    f0 = F0_LOW * (F0_HIGH / F0_LOW) ** (classes[:, None] / max(n_classes - 1, 1)) * (1 + 0.06 * (rand(b, 1) - 0.5))
    phase = 2 * math.pi * rand(b, 3)
    y = sum((0.5 / h) * torch.sin(2 * math.pi * h * f0 * t + phase[:, h - 1:h]) for h in (1, 2, 3))
    y = y * (0.5 + 0.5 * torch.sin(2 * math.pi * (0.3 + 2.7 * rand(b, 1)) * t) ** 2)
    y = y + (0.01 + 0.09 * rand(b, 1)) * torch.randn(b, n, device=dev, generator=gen)
    width = int(BURST_S * sr)
    starts = (rand(b, BURSTS) * (n - width)).long()
    idx = (starts[:, :, None] + torch.arange(width, device=dev)).reshape(b, -1)
    y.scatter_add_(1, idx, 0.6 * torch.randn(b, BURSTS * width, device=dev, generator=gen))
    return 0.8 * y / y.abs().amax(dim=1, keepdim=True)


def make_pool(seed: int, n_classes: int, per_class: int, n: int, sr: int, extra: int,
              device: torch.device) -> torch.Tensor:
    """(n_classes * per_class + extra, n) float32 clips on ``device``; clip
    i is of class i % n_classes, and the last ``extra`` rows repeat the
    first, so that a batch that wraps round the pool is a plain slice."""
    total = n_classes * per_class
    gen = torch.Generator(device=device).manual_seed(seed)
    pool = torch.empty((total + extra, n), dtype=torch.float32, device=device)
    classes = torch.arange(total, device=device) % n_classes
    for lo in range(0, total, CHUNK):
        hi = min(lo + CHUNK, total)
        pool[lo:hi] = _chunk(gen, classes[lo:hi].float(), n_classes, n, sr)
    pool[total:] = pool[:extra]
    return pool
