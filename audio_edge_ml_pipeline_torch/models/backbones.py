"""Vision backbones in PyTorch: EfficientNet-B0 (the ``efficientnet_teacher``)
and MobileNetV2 (the frozen embedder of the image and video extractors).

Counterpart of the JAX package's ``models/backbones.py`` (``_ConvBN``,
``_InvertedResidual``, ``MobileNetV2``, ``_MBConvSE``, ``EfficientNetB0``,
``mobilenet_v2_embedder``, ``load_backbone_weights``). EfficientNet-B0 has
the inference semantics of ``keras.applications.EfficientNetB0``: silu
activations; squeeze-excite reduced to ``in_ch // 4`` of the block *input*
channels with biased 1x1 convolutions. MobileNetV2 (width 1.0) has ReLU6
and linear bottlenecks and pools to 1280. Both use BatchNorm(momentum
0.999, epsilon 1e-3) with its statistics as explicit state
(``layers.BatchNorm``) and flax SAME geometry at stride 2 (``conv_same``).
Stochastic depth is not implemented, as in JAX.

Module names follow the flax tree, so ``models/deep.py::params_to_flax``
turns a state_dict into the flax keys one for one: ``convbns.i`` is
``_ConvBN_i``, ``blocks.i`` is ``_MBConvSE_i``, ``invres.i`` is
``_InvertedResidual_i``, ``convs.i`` / ``bns.i`` are ``Conv_i`` /
``BatchNorm_i``.

No pretrained weights can be fetched: a backbone starts from its random
init, and ``load_backbone_weights`` fills it by name and shape from a local
``.npz`` (``tools/convert_backbone_weights.py``, JAX ``flatten_variables``).
"""

from __future__ import annotations

import logging
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .layers import BatchNorm, conv_same

logger = logging.getLogger(__name__)

# (expansion t, out channels c, repeats n, stride s): MobileNetV2 paper, table 2
MBV2_CONFIG = [
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
]

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


def _make_divisible(v: float, divisor: int = 8) -> int:
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


class ConvBN(nn.Module):
    """flax ``_ConvBN``: a bias-free SAME conv, BatchNorm(0.999, 1e-3), then
    ``act``: "silu" (EfficientNet), "relu6" (MobileNetV2) or None (linear)."""

    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1, groups: int = 1,
                 act: str | None = "silu") -> None:
        super().__init__()
        self.convs = nn.ModuleList([nn.Conv2d(cin, cout, kernel, stride, groups=groups, bias=False)])
        self.bns = nn.ModuleList([BatchNorm(cout, momentum=0.999, eps=1e-3)])
        self.act = act

    def forward(self, x: torch.Tensor, train: bool, stats: dict | None = None) -> torch.Tensor:
        x = self.bns[0](conv_same(self.convs[0], x), train, stats)
        if self.act == "silu":
            return F.silu(x)
        return torch.clamp(x, 0.0, 6.0) if self.act == "relu6" else x


class InvertedResidual(nn.Module):
    """flax ``_InvertedResidual``: 1x1 ReLU6 expansion (when ``expand`` > 1),
    3x3 depthwise ReLU6 at ``stride``, linear 1x1 projection, and the
    residual when the block keeps stride 1 and width."""

    def __init__(self, in_ch: int, out_ch: int, stride: int, expand: int) -> None:
        super().__init__()
        mid = in_ch * expand
        units = [ConvBN(in_ch, mid, 1, act="relu6")] if expand != 1 else []
        units += [ConvBN(mid, mid, 3, stride, groups=mid, act="relu6"), ConvBN(mid, out_ch, 1, act=None)]
        self.convbns = nn.ModuleList(units)
        self.residual = stride == 1 and in_ch == out_ch

    def forward(self, x: torch.Tensor, train: bool = False, stats: dict | None = None) -> torch.Tensor:
        h = x
        for unit in self.convbns:
            h = unit(h, train, stats)
        return h + x if self.residual else h


class MobileNetV2(nn.Module):
    """flax ``MobileNetV2``: NCHW RGB (B, 3, S, S) in [-1, 1] -> the pooled
    (B, 1280) embedding (Keras ``include_top=False, pooling="avg"``)."""

    def __init__(self, width: float = 1.0) -> None:
        super().__init__()
        cin = _make_divisible(32 * width)
        stem, blocks = ConvBN(3, cin, 3, 2, act="relu6"), []
        for t, c, n, s in MBV2_CONFIG:
            cout = _make_divisible(c * width)
            for i in range(n):
                blocks.append(InvertedResidual(cin, cout, s if i == 0 else 1, t))
                cin = cout
        self.convbns = nn.ModuleList([stem, ConvBN(cin, _make_divisible(1280 * max(1.0, width)), 1, act="relu6")])
        self.invres = nn.ModuleList(blocks)

    def forward(self, x: torch.Tensor, train: bool = False, stats: dict | None = None) -> torch.Tensor:
        x = self.convbns[0](x, train, stats)
        for block in self.invres:
            x = block(x, train, stats)
        return self.convbns[1](x, train, stats).mean(dim=(2, 3))


class MBConvSE(nn.Module):
    """flax ``_MBConvSE``: 1x1 expansion (when ``expand`` > 1), depthwise
    k x k at ``stride``, squeeze-excite, 1x1 projection, and the residual
    when the block keeps stride 1 and width."""

    def __init__(self, in_ch: int, out_ch: int, stride: int, expand: int, kernel: int) -> None:
        super().__init__()
        mid = in_ch * expand
        units = [ConvBN(in_ch, mid, 1)] if expand != 1 else []
        units += [ConvBN(mid, mid, kernel, stride, groups=mid), ConvBN(mid, out_ch, 1, act=None)]
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


_EMBED_CACHE: dict[tuple, object] = {}


def mobilenet_v2_embedder(input_size: int = 224, weights: str | None = None,
                          device: torch.device | str | None = None):
    """A frozen MobileNetV2 on ``device`` (default: the first CUDA card) as a
    function: (B, S, S, 3) float32 tensor in [-1, 1] on that device -> (B,
    1280) embeddings, BatchNorm at its running statistics. Built once per
    (input_size, weights, device).

    ``weights``: a named-key ``.npz`` (``load_backbone_weights``: a JAX
    ``flatten_variables`` file or ``tools/convert_backbone_weights.py``'s
    output); with JAX's variables carried across this way the embeddings
    are JAX's. Without one (or when the path does not exist) the network
    keeps a random init from ``torch.Generator().manual_seed(0)`` with
    flax's initializers, and a warning says so. That init is not JAX's
    ``PRNGKey(0)`` draw: a random-init embedder differs between the two
    packages. Nothing is downloaded."""
    from ..utils.device import resolve_device
    from .deep import init_weights_

    dev = resolve_device(device)
    key = ("mbv2", input_size, weights, str(dev))
    if key in _EMBED_CACHE:
        return _EMBED_CACHE[key]
    model = MobileNetV2()
    init_weights_(model, torch.Generator().manual_seed(0))
    if weights is not None and Path(weights).exists():
        n_loaded, n_skipped = load_backbone_weights(model, weights)
        logger.info("MobileNetV2 weights from %s: %d tensors loaded, %d left at init", weights, n_loaded, n_skipped)
    else:
        logger.warning(
            "MobileNetV2 embedder running with RANDOM-INIT weights%s — "
            "embeddings are a fixed random projection, NOT ImageNet features. "
            "Convert a checkpoint with tools/convert_backbone_weights.py and "
            "pass weights=<path.npz> for reference semantics.",
            f" (weights path {weights!r} not found)" if weights else "",
        )
    model = model.to(dev).eval().requires_grad_(False)

    def embed(x: torch.Tensor) -> torch.Tensor:
        return model(x.permute(0, 3, 1, 2))

    _EMBED_CACHE[key] = embed
    return embed
