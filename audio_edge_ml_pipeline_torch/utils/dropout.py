"""Dropout at a run-time rate, and where its masks' noise comes from.

``runtime_dropout`` is every module's dropout (``models/deep.py``). Its
uniform noise comes from the ``dropout_noise`` source in effect, else the
global RNG: the data-parallel fit and the sharded step draw the masks of
the whole global batch alike on every rank (``GlobalBatchNoise``), and a
trial group draws each trial's from that trial's own generator
(``train/tune_batched.py``). A leaf module: ``models`` and ``parallel``
both import it.
"""

from __future__ import annotations

import contextvars

import torch

# None draws from the global RNG; else a callable x -> uniform [0, 1) noise of x's shape
_NOISE: contextvars.ContextVar = contextvars.ContextVar("dropout_noise", default=None)


class dropout_noise:
    """Context in which every dropout mask is drawn from ``source(x)``, a
    uniform [0, 1) tensor of x's shape (None: the global RNG)."""

    def __init__(self, source) -> None:
        self.source, self._token = source, None

    def __enter__(self):
        self._token = _NOISE.set(self.source)
        return self.source

    def __exit__(self, *exc) -> None:
        _NOISE.reset(self._token)


class GlobalBatchNoise:
    """Dropout noise of a global batch split into ``parts`` equal parts, of
    which this rank holds part ``index``: every rank draws the whole
    batch's noise from ``generator`` (seeded alike on every rank) and keeps
    its rows, so a data-parallel step masks each row as the one-process step
    does, and model ranks that hold the same rows mask them alike."""

    def __init__(self, generator: torch.Generator, parts: int = 1, index: int = 0) -> None:
        self.generator, self.parts, self.index = generator, parts, index

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        b = x.shape[0]
        u = torch.rand((self.parts * b, *x.shape[1:]), generator=self.generator, device=x.device, dtype=x.dtype)
        return u[self.index * b : (self.index + 1) * b]


def runtime_dropout(x: torch.Tensor, rate, training: bool) -> torch.Tensor:
    """Inverted dropout at a rate given at run time (a float, or a tensor:
    one per trial under ``torch.func.vmap``), as the JAX package's
    ``_dropout``. A float rate of 0 draws nothing, and a float rate stays
    a host scalar (a tensor made of it on a card would be a copy that
    waits for the card). The noise comes from the ``dropout_noise`` source
    in effect, else the global RNG."""
    if not training or (not torch.is_tensor(rate) and rate == 0):
        return x
    keep = 1.0 - rate
    scale = keep.clamp_min(1e-6) if torch.is_tensor(keep) else max(keep, 1e-6)
    source = _NOISE.get()
    u = torch.rand_like(x) if source is None else source(x)
    return torch.where(u < keep, x / scale, 0.0)
