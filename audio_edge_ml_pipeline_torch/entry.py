"""The flagship forward step, as ``__graft_entry__.entry()`` gives it for JAX.

entry() -> (fn, example_args): raw 5 s fsc22-style waveforms through the
folded-mel frontend (the CUDA kernel on a card) into the CNN (filters
[16, 64, 64], first_stride=4, second_stride=2, 27 classes). ``fn(params,
waves)`` takes the CNN's state_dict and (B, n) waveforms and returns logits.
"""

from __future__ import annotations

import torch
from torch.func import functional_call

from .models.deep import CNNModule
from .ops import mel_kernel
from .utils.device import resolve_device


def flagship(n_mels=40, n_fft=512, hop=160, sr=16000, n_classes=27, filters=(16, 64, 64)):
    """(module, forward) of the flagship pipeline; module on the CPU."""
    module = CNNModule(tuple(filters), dropout=0.3, n_classes=n_classes, first_stride=4, second_stride=2).eval()

    def forward(params: dict[str, torch.Tensor], waves: torch.Tensor) -> torch.Tensor:
        mel = mel_kernel.mel_spec_feature(waves, sr=sr, n_mels=n_mels, n_fft=n_fft, hop_length=hop)
        x = mel.transpose(1, 2)[..., None]  # (B, T, n_mels, 1)
        return functional_call(module, params, (x,))

    return module, forward


def entry(device: torch.device | str | None = None, seed: int = 0):
    """(fn, example_args) of one flagship forward step at batch 8."""
    device = resolve_device(device)
    module, forward = flagship()
    g = torch.Generator().manual_seed(seed)
    params = {k: (0.1 * torch.randn(v.shape, generator=g)).to(device) for k, v in module.state_dict().items()}
    batch, n = 8, 80000  # 5 s @ 16 kHz
    waves = torch.zeros((batch, n), dtype=torch.float32, device=device)
    return forward, (params, waves)
