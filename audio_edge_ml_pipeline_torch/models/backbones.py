"""EfficientNet-B0 in PyTorch: the backbone of the ``efficientnet_teacher``.

Counterpart of the JAX package's ``models/backbones.py`` (``_ConvBN``,
``_MBConvSE``, ``EfficientNetB0``, ``load_backbone_weights``), with the same
inference semantics as ``keras.applications.EfficientNetB0``: silu
activations; squeeze-excite reduced to ``in_ch // 4`` of the block *input*
channels with biased 1x1 convolutions; BatchNorm(momentum 0.999, epsilon
1e-3) with its statistics as explicit state (``layers.BatchNorm``); flax SAME
geometry at stride 2. Stochastic depth is not implemented, as in JAX.

Module names follow the flax tree, so ``models/deep.py::params_to_flax``
turns a state_dict into the flax keys one for one: ``convbns.i`` is
``_ConvBN_i``, ``blocks.i`` is ``_MBConvSE_i``, ``convs.i`` / ``bns.i`` are
``Conv_i`` / ``BatchNorm_i``.

No pretrained weights can be fetched: the backbone starts from its random
init, and ``load_backbone_weights`` fills it by name and shape from a local
``.npz`` (``tools/convert_backbone_weights.py``, JAX ``flatten_variables``).
``MobileNetV2`` and its embedder, which serve the image and video
extractors, are still to be ported.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .layers import BatchNorm, conv_same

# (expand, out, repeats, stride, kernel): the EfficientNet-B0 stage table
EFFNET_B0_CONFIG = [
    (1, 16, 1, 1, 3),
    (6, 24, 2, 2, 3),
    (6, 40, 2, 2, 5),
    (6, 80, 3, 2, 3),
    (6, 112, 3, 1, 5),
    (6, 192, 4, 2, 5),
    (6, 320, 1, 1, 3),
]
EMBED_DIM = 1280


class ConvBN(nn.Module):
    """flax ``_ConvBN``: a bias-free SAME conv, BatchNorm(0.999, 1e-3), then
    silu (``act=True``) or nothing."""

    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1, groups: int = 1,
                 act: bool = True) -> None:
        super().__init__()
        self.convs = nn.ModuleList([nn.Conv2d(cin, cout, kernel, stride, groups=groups, bias=False)])
        self.bns = nn.ModuleList([BatchNorm(cout, momentum=0.999, eps=1e-3)])
        self.act = act

    def forward(self, x: torch.Tensor, train: bool, stats: dict | None = None) -> torch.Tensor:
        x = self.bns[0](conv_same(self.convs[0], x), train, stats)
        return F.silu(x) if self.act else x


class MBConvSE(nn.Module):
    """flax ``_MBConvSE``: 1x1 expansion (when ``expand`` > 1), depthwise
    k x k at ``stride``, squeeze-excite, 1x1 projection, and the residual
    when the block keeps stride 1 and width."""

    def __init__(self, in_ch: int, out_ch: int, stride: int, expand: int, kernel: int) -> None:
        super().__init__()
        mid = in_ch * expand
        units = [ConvBN(in_ch, mid, 1)] if expand != 1 else []
        units += [ConvBN(mid, mid, kernel, stride, groups=mid), ConvBN(mid, out_ch, 1, act=False)]
        self.convbns = nn.ModuleList(units)
        self.convs = nn.ModuleList([nn.Conv2d(mid, max(1, in_ch // 4), 1), nn.Conv2d(max(1, in_ch // 4), mid, 1)])
        self.residual = stride == 1 and in_ch == out_ch

    def forward(self, x: torch.Tensor, train: bool, stats: dict | None = None) -> torch.Tensor:
        h = x
        for unit in self.convbns[:-1]:
            h = unit(h, train, stats)
        se = F.silu(self.convs[0](h.mean(dim=(2, 3), keepdim=True)))
        h = h * torch.sigmoid(self.convs[1](se))
        h = self.convbns[-1](h, train, stats)
        return h + x if self.residual else h


class EfficientNetB0(nn.Module):
    """flax ``EfficientNetB0``: NCHW RGB (B, 3, S, S) -> the pooled
    (B, 1280) embedding."""

    def __init__(self) -> None:
        super().__init__()
        blocks, cin = [], 32
        for t, c, n, s, k in EFFNET_B0_CONFIG:
            for i in range(n):
                blocks.append(MBConvSE(cin, c, s if i == 0 else 1, t, k))
                cin = c
        self.convbns = nn.ModuleList([ConvBN(3, 32, 3, 2), ConvBN(cin, EMBED_DIM, 1)])
        self.blocks = nn.ModuleList(blocks)

    def forward(self, x: torch.Tensor, train: bool = False, stats: dict | None = None) -> torch.Tensor:
        x = self.convbns[0](x, train, stats)
        for block in self.blocks:
            x = block(x, train, stats)
        return self.convbns[1](x, train, stats).mean(dim=(2, 3))


def load_backbone_weights(module: nn.Module, path: Path | str) -> tuple[int, int]:
    """Fill ``module`` in place from a named-key ``.npz`` (``p/<path>`` params
    and ``c/batch_stats/<path>`` statistics in the flax layout: a JAX
    ``flatten_variables`` file, or ``tools/convert_backbone_weights.py``'s
    output without ``--prefix``), matching by path NAME and shape, never by
    position. Raises when no tensor matches. Returns (n_loaded, n_skipped).
    A teacher takes a ``--prefix backbone --bundle`` checkpoint through its
    ``pretrained_model`` instead (``deep.transfer_pretrained``)."""
    from .deep import params_from_flax, params_to_flax

    data = np.load(Path(path), allow_pickle=False)
    stored = {k: data[k] for k in data.files}
    template = params_to_flax(module.state_dict())
    merged, n_loaded = {}, 0
    for key, leaf in template.items():
        src = stored.get(key)
        if src is not None and src.shape == leaf.shape:
            merged[key], n_loaded = np.asarray(src, np.float32), n_loaded + 1
        else:
            merged[key] = leaf
    if n_loaded == 0:
        raise ValueError(f"{path}: no tensors matched the backbone by name+shape "
                         f"(expected keys like {next(iter(template))!r})")
    module.load_state_dict(params_from_flax(merged), strict=True)
    return n_loaded, len(template) - n_loaded
