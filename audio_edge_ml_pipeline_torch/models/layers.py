"""Layers with flax semantics that the deep families share.

- ``BatchNorm``: flax ``nn.BatchNorm`` over the channel axis of NCHW. Its
  running statistics are buffers (``mean``, ``var``: the ``batch_stats``
  collection), but a train-mode call never mutates them: it writes the
  updated statistics into the ``stats`` dict it is given, under their
  state_dict names, and the caller threads them (``TorchTrainer.train_step``
  copies them into the buffers; a trial group under ``torch.func.vmap``
  keeps them as stacked state). flax's update differs from
  ``nn.BatchNorm2d``'s: the running variance takes the *biased* batch
  variance, and the momentum is the weight of the old value. With a
  process ``group`` (``sync_batch_norms``: data-parallel training), the
  train-mode moments cover the global batch, as JAX's global-view jit
  computes them: one differentiable all-reduce of the stacked per-channel
  (sum x, sum x^2) and the row count.
- ``LayerNorm``: flax ``nn.LayerNorm`` over the last axis.
- ``SelfAttention``: flax ``nn.MultiHeadDotProductAttention`` applied as
  ``attn(x, x)``, with its parameters in flax's shapes (``query``, ``key``,
  ``value`` kernels (d, heads, head_dim) and biases (heads, head_dim), the
  ``out`` kernel (heads, head_dim, d)), so that qkv features may be fewer
  than d.
- ``same_padding`` / ``conv_same``: flax/TF ``padding="SAME"``.

Both norms compute flax's statistics: the mean, and the variance as
E[x^2] - E[x]^2 clipped at 0 (``use_fast_variance``), then
(x - mean) * (rsqrt(var + eps) * scale) + bias. Everything runs as ordinary
torch ops; no hand kernel is on this path.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def same_padding(size: int, stride: int, kernel: int = 3) -> tuple[int, int]:
    """(before, after) padding of flax/TF ``padding="SAME"``: the output has
    ceil(size / stride) positions and any odd padding goes after, so a
    strided layer can pad 0 before and 1 after."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def conv_same(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """``conv`` (built with padding 0) on NCHW ``x`` padded first as flax
    SAME pads it (asymmetric at stride 2 on an even side)."""
    (kh, kw), stride = conv.kernel_size, conv.stride[0]
    top, bottom = same_padding(x.shape[2], stride, kh)
    left, right = same_padding(x.shape[3], stride, kw)
    return conv(F.pad(x, (left, right, top, bottom)))


def _moments(x: torch.Tensor, dims: tuple[int, ...], group=None) -> tuple[torch.Tensor, torch.Tensor]:
    """flax ``_compute_stats`` with ``use_fast_variance``: (mean, var);
    with a process ``group``, of the rows of every rank in it."""
    if group is None:
        mean = x.mean(dims)
        return mean, torch.clamp_min((x * x).mean(dims) - mean * mean, 0.0)
    from ..parallel.mesh import all_reduce_sum

    s1 = x.sum(dims)
    count = torch.full_like(s1, x.numel() / s1.numel())
    sums = all_reduce_sum(torch.stack([s1, (x * x).sum(dims), count]), group)
    mean = sums[0] / sums[2]
    return mean, torch.clamp_min(sums[1] / sums[2] - mean * mean, 0.0)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum, epsilon)`` on the channel axis 1 of an
    NCHW tensor (module docstring). ``path``: the prefix of its buffers'
    state_dict names, set by ``name_batch_norms`` on the root module."""

    def __init__(self, channels: int, momentum: float = 0.9, eps: float = 1e-5) -> None:
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))
        self.momentum, self.eps = momentum, eps
        self.path = ""
        self.group = None   # a process group: train-mode moments over its ranks' rows

    def forward(self, x: torch.Tensor, train: bool, stats: dict | None = None) -> torch.Tensor:
        """``train``: normalise by the batch's statistics (over N, H, W) and
        put the updated running ones in ``stats``; else by the running ones."""
        if train:
            mean, var = _moments(x, (0, 2, 3), self.group)
            if stats is not None:
                m = self.momentum
                stats[self.path + "mean"] = (m * self.mean + (1.0 - m) * mean).detach()
                stats[self.path + "var"] = (m * self.var + (1.0 - m) * var).detach()
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]


def name_batch_norms(root: nn.Module) -> None:
    """Give each BatchNorm under ``root`` its state_dict prefix."""
    for name, mod in root.named_modules():
        if isinstance(mod, BatchNorm):
            mod.path = f"{name}." if name else ""


def sync_batch_norms(root: nn.Module, group) -> None:
    """Compute the train-mode moments of every BatchNorm under ``root``
    over the ranks of ``group`` (None: this process's rows alone)."""
    for mod in root.modules():
        if isinstance(mod, BatchNorm):
            mod.group = group


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(epsilon)`` over the last axis."""

    def __init__(self, features: int, eps: float = 1e-6) -> None:
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean, var = _moments(x, (-1,))
        mul = torch.rsqrt(var + self.eps)[..., None] * self.weight
        return (x - mean[..., None]) * mul + self.bias


class Projection(nn.Module):
    """flax ``DenseGeneral``'s parameters: ``kernel`` of ``shape`` and
    ``bias`` of ``bias_shape``; ``fan_in`` for its lecun-normal init."""

    def __init__(self, shape: tuple[int, ...], bias_shape: tuple[int, ...], fan_in: int) -> None:
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(shape))
        self.bias = nn.Parameter(torch.zeros(bias_shape))
        self.fan_in = fan_in


class SelfAttention(nn.Module):
    """flax ``nn.MultiHeadDotProductAttention(num_heads, qkv_features=
    heads * head_dim, out_features=d)(x, x)``: no mask, no attention dropout,
    the query scaled by 1/sqrt(head_dim) before the dot product.
    x (B, L, d) -> (B, L, d)."""

    def __init__(self, d: int, heads: int, head_dim: int) -> None:
        super().__init__()
        self.heads, self.head_dim = heads, head_dim
        for name in ("query", "key", "value"):
            setattr(self, name, Projection((d, heads, head_dim), (heads, head_dim), d))
        self.out = Projection((heads, head_dim, d), (d,), heads * head_dim)

    def _project(self, x: torch.Tensor, proj: Projection) -> torch.Tensor:
        qkv = self.heads * self.head_dim
        return (x @ proj.kernel.reshape(-1, qkv) + proj.bias.reshape(qkv)).unflatten(-1, (self.heads, self.head_dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q = self._project(x, self.query) / math.sqrt(self.head_dim)
        k, v = self._project(x, self.key), self._project(x, self.value)
        weights = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k), dim=-1)
        o = torch.einsum("bhqk,bkhd->bqhd", weights, v).flatten(-2)
        return o @ self.out.kernel.reshape(-1, self.out.kernel.shape[-1]) + self.out.bias
