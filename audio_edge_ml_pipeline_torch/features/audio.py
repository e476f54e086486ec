"""Registered audio extractors, batched on one device.

Same names, parameters and numerical contracts as the JAX package's
``features/audio.py``. Ported so far: ``audio_mel_spec``.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops import dsp, mel_kernel
from ..utils.device import resolve_device
from .base import BatchedAudioExtractor
from .registry import register


@register
class AudioMelSpectrogram(BatchedAudioExtractor):
    """Log-mel spectrogram normalized to [0, 1]; shape (n_mels, T)."""

    name = "audio_mel_spec"
    feature_type = "deep"

    def __init__(
        self,
        sample_rate: int = 16000,
        n_mels: int = 40,
        n_fft: int = 512,
        hop_length: int = 160,
        duration: Optional[float] = None,
        backend: str = "xla",
        device: torch.device | str | None = None,
    ) -> None:
        if backend not in ("xla", "pallas"):
            raise ValueError(f"backend must be 'xla' or 'pallas', got {backend!r}")
        self.sample_rate = sample_rate
        self.n_mels = n_mels
        self.n_fft = n_fft
        self.hop_length = hop_length
        self.duration = duration
        # The JAX package's two backends name two TPU formulations of one
        # function. Here both run ops.mel_kernel: the hand-written CUDA
        # kernel on a CUDA tensor, its plain version on a CPU tensor. The
        # argument stays so that existing YAML configs load.
        self.backend = backend
        self.device = resolve_device(device)

    def min_samples(self) -> int:
        return self.n_fft

    def frames_for(self, n_samples: int) -> int:
        return dsp.n_frames_for(n_samples, self.hop_length)

    def batch_feature(self, waves: torch.Tensor, lengths: Optional[torch.Tensor]) -> torch.Tensor:
        return mel_kernel.mel_spec_feature(
            waves, sr=self.sample_rate, n_mels=self.n_mels, n_fft=self.n_fft,
            hop_length=self.hop_length, lengths=lengths,
        )
