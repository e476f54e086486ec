"""Registered audio extractors, batched on the device(s).

Same names, parameters, defaults and numerical contracts as the JAX
package's ``features/audio.py``, plus ``device`` and ``devices`` arguments
(``BatchedAudioExtractor._set_devices``: a batch splits over every visible
card unless the caller pins a device):
``audio_mel_spec``, ``audio_waveform``, ``audio_cqt``, ``audio_mfcc_seq``
and ``audio_classical``.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops import audio_features, dsp, mel_kernel
from ..ops.golden.librosa_ref import _ALL_CLASSICAL
from ..utils.profiling import span
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
        devices: Optional[list] = None,
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
        self._set_devices(device, devices)

    def min_samples(self) -> int:
        return self.n_fft

    def frames_for(self, n_samples: int) -> int:
        return dsp.n_frames_for(n_samples, self.hop_length)

    def batch_feature(self, waves: torch.Tensor, lengths: Optional[torch.Tensor]) -> torch.Tensor:
        with span(self.name):
            return mel_kernel.mel_spec_feature(
                waves, sr=self.sample_rate, n_mels=self.n_mels, n_fft=self.n_fft,
                hop_length=self.hop_length, lengths=lengths,
            )


@register
class AudioWaveform(BatchedAudioExtractor):
    """Raw PCM waveform peak-normalized to [-1, 1]; shape (n_samples,)."""

    name = "audio_waveform"
    feature_type = "deep"

    def __init__(
        self, sample_rate: int = 16000, duration: Optional[float] = 1.0, device: torch.device | str | None = None,
        devices: Optional[list] = None,
    ) -> None:
        self.sample_rate = sample_rate
        self.duration = duration
        self._set_devices(device, devices)

    def batch_feature(self, waves: torch.Tensor, lengths: Optional[torch.Tensor]) -> torch.Tensor:
        return dsp.waveform_feature(waves, lengths)


@register
class AudioCQT(BatchedAudioExtractor):
    """|CQT| in dB, normalized to [0, 1]; shape (n_bins, T)."""

    name = "audio_cqt"
    feature_type = "deep"
    # dsp.cqt_magnitude blocks its float64 partial products by itself, so the
    # batch is not bounded by memory
    batch_size = 512

    def __init__(
        self,
        sample_rate: int = 22050,
        hop_length: int = 512,
        n_bins: int = 84,
        bins_per_octave: int = 12,
        fmin: Optional[float] = None,
        duration: Optional[float] = None,
        device: torch.device | str | None = None,
        devices: Optional[list] = None,
    ) -> None:
        self.sample_rate = sample_rate
        self.hop_length = hop_length
        self.n_bins = n_bins
        self.bins_per_octave = bins_per_octave
        self.fmin = fmin
        self.duration = duration
        self._set_devices(device, devices)

    def min_samples(self) -> int:
        return self.hop_length * 2

    def frames_for(self, n_samples: int) -> int:
        return dsp.n_frames_for(n_samples, self.hop_length)

    def batch_feature(self, waves: torch.Tensor, lengths: Optional[torch.Tensor]) -> torch.Tensor:
        return dsp.cqt_feature(
            waves, sr=self.sample_rate, hop_length=self.hop_length, n_bins=self.n_bins,
            bins_per_octave=self.bins_per_octave, fmin=self.fmin, lengths=lengths,
        )


@register
class AudioMFCCSequence(BatchedAudioExtractor):
    """MFCC sequence, per-coefficient z-scored; shape (n_mfcc, T)."""

    name = "audio_mfcc_seq"
    feature_type = "deep"

    def __init__(
        self,
        sample_rate: int = 22050,
        n_mfcc: int = 40,
        n_fft: int = 1024,
        hop_length: int = 512,
        duration: Optional[float] = None,
        device: torch.device | str | None = None,
        devices: Optional[list] = None,
    ) -> None:
        self.sample_rate = sample_rate
        self.n_mfcc = n_mfcc
        self.n_fft = n_fft
        self.hop_length = hop_length
        self.duration = duration
        self._set_devices(device, devices)

    def min_samples(self) -> int:
        return self.n_fft

    def frames_for(self, n_samples: int) -> int:
        return dsp.n_frames_for(n_samples, self.hop_length)

    def batch_feature(self, waves: torch.Tensor, lengths: Optional[torch.Tensor]) -> torch.Tensor:
        with span(self.name):
            return audio_features.mfcc_seq_feature(
                waves, sr=self.sample_rate, n_mfcc=self.n_mfcc, n_fft=self.n_fft, hop_length=self.hop_length,
                lengths=lengths,
            )


@register
class AudioClassicalExtractor(BatchedAudioExtractor):
    """Flat classical feature vector (302-d default) for sklearn-style
    estimators; per-group mean/std aggregation in canonical order."""

    name = "audio_classical"
    feature_type = "classical"
    exact_length_batching = True  # deltas/contrast are not pad-maskable

    def __init__(
        self,
        sample_rate: int = 22050,
        n_mfcc: int = 40,
        n_mels: int = 128,
        n_fft: int = 1024,
        hop_length: int = 512,
        min_duration: float = 0.1,
        features: Optional[list[str]] = None,
        aggregations: Optional[list[str]] = None,
        device: torch.device | str | None = None,
        devices: Optional[list] = None,
    ) -> None:
        self.sample_rate = sample_rate
        self.n_mfcc = n_mfcc
        self.n_mels = n_mels
        self.n_fft = n_fft
        self.hop_length = hop_length
        self.min_duration = min_duration
        self.duration = None
        if features is None:
            self.features = list(_ALL_CLASSICAL)
        else:
            unknown = set(features) - set(_ALL_CLASSICAL)
            if unknown:
                raise ValueError(f"Unknown feature group(s): {sorted(unknown)}. Valid keys: {_ALL_CLASSICAL}")
            self.features = [k for k in _ALL_CLASSICAL if k in set(features)]
        if aggregations is None:
            self.aggregations = ["mean", "std"]
        else:
            unknown = set(aggregations) - {"mean", "std"}
            if unknown:
                raise ValueError(f"Unknown aggregation(s): {sorted(unknown)}. Valid: ['mean', 'std']")
            if not aggregations:
                raise ValueError("aggregations must contain at least one value.")
            self.aggregations = [a for a in ["mean", "std"] if a in set(aggregations)]
        self._set_devices(device, devices)

    @property
    def feature_dim(self) -> int:
        n_agg = len(self.aggregations)
        raw = {"spectral_contrast": 7, "chroma": 12, "tonnetz": 6}
        total = 0
        for key in self.features:
            if key in ("mfcc", "delta_mfcc", "delta2_mfcc"):
                total += n_agg * self.n_mfcc
            else:
                total += n_agg * raw.get(key, 1)
        return total

    def min_samples(self) -> int:
        # one STFT frame + enough MFCC frames for the width-9 delta filter
        return max(int(self.min_duration * self.sample_rate), self.n_fft, 8 * self.hop_length)

    def batch_feature(self, waves: torch.Tensor, lengths: Optional[torch.Tensor]) -> torch.Tensor:
        with span(self.name):
            return audio_features.classical_feature_vector(
                waves, sr=self.sample_rate, n_mfcc=self.n_mfcc, n_mels=self.n_mels, n_fft=self.n_fft,
                hop_length=self.hop_length, features=tuple(self.features), aggregations=tuple(self.aggregations),
                lengths=lengths,
            )
