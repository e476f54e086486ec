"""Plain PyTorch forward of the flagship CNN, written from its description.

Conv 3x3 with flax's SAME padding (``ceil(size / stride)`` outputs, the odd
pad after), ReLU, a 2x2 max pool after each block that does not stride,
global average pool, Dense(128) + ReLU, Dense(n_classes). Input (B, n_mels,
T) features; the model sees them as (B, 1, T, n_mels) images. Weights are
the benchmark's own, under the program's state_dict names
(``convs.<i>.weight``, ``denses.<i>.bias``, ...). ``rnd`` rounds every
product's operands first (``lowp.tf32``: the TF32 control).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def same_pad(size: int, stride: int, kernel: int = 3) -> tuple[int, int]:
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def forward(features: torch.Tensor, weights: dict[str, torch.Tensor], strides: tuple[int, ...],
            rnd=lambda t: t) -> torch.Tensor:
    """(B, n_mels, T) -> (B, n_classes) logits in the dtype of ``features``."""
    x = features.transpose(1, 2)[:, None]
    for i, stride in enumerate(strides):
        top, bottom = same_pad(x.shape[2], stride)
        left, right = same_pad(x.shape[3], stride)
        x = F.conv2d(rnd(F.pad(x, (left, right, top, bottom))), rnd(weights[f"convs.{i}.weight"]),
                     weights[f"convs.{i}.bias"], stride=stride)
        x = torch.relu(x)
        if stride == 1:
            x = F.max_pool2d(x, 2, 2)
    x = x.mean(dim=(2, 3))
    x = torch.relu(F.linear(rnd(x), rnd(weights["denses.0.weight"]), weights["denses.0.bias"]))
    return F.linear(rnd(x), rnd(weights["denses.1.weight"]), weights["denses.1.bias"])
