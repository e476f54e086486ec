"""Extraction: waveforms in, features out, through one of the program's
registered audio extractors (``features.get(name)(...).batch_feature``),
built at the configuration's parameters with ``device`` set to the card.
The mix names the extractor; the configuration gives its parameters.

The reference is the frozen float64 feature of each sampled clip, with
the STFT magnitudes rounded as the configuration's ``stages`` state. The
control is the reference one precision below the configuration's: TF32
for a float32 configuration (``reference.lowp``), float32 for a float64
one.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.harness import judge
from benchmark.reference import librosa_ref, lowp


def golden(name: str, p: dict, clip: np.ndarray, dtype=np.float64, mag_dtype=None) -> np.ndarray:
    """The reference feature ``name`` of one clip at parameters ``p``,
    computed in ``dtype``, the STFT magnitudes rounded to ``mag_dtype``."""
    if name == "audio_mel_spec":
        return librosa_ref.mel_spec_feature(clip, p["sample_rate"], p["n_mels"], p["n_fft"], p["hop_length"], dtype)
    if name == "audio_mfcc_seq":
        return librosa_ref.mfcc_seq_feature(clip, p["sample_rate"], p["n_mfcc"], p["n_fft"], p["hop_length"], dtype)
    if name == "audio_classical":
        return librosa_ref.classical_feature_vector(clip, p["sample_rate"], p["n_mfcc"], p["n_mels"], p["n_fft"],
                                                    p["hop_length"], dtype=dtype, mag_dtype=mag_dtype)
    raise ValueError(f"no reference for the extractor {name!r}")


class Entry:
    def __init__(self, config: dict, mix: dict, seed: int, device: torch.device) -> None:
        from audio_edge_ml_pipeline_torch.features import get

        self.name = mix["extractor"]
        self.params = config["features"][self.name]
        self.precision = config["precision"]
        stage = config.get("stages", {}).get("stft_magnitude")
        self.mag_dtype = None if stage is None else np.dtype(stage)
        self.extractor = get(self.name)(**self.params, device=device)

    def __call__(self, waves: torch.Tensor) -> torch.Tensor:
        return self.extractor.batch_feature(waves, None)

    def reference(self, clips: np.ndarray) -> np.ndarray:
        return np.stack([golden(self.name, self.params, c, mag_dtype=self.mag_dtype) for c in clips])

    def control(self, clips: np.ndarray, device: torch.device) -> np.ndarray:
        if self.precision == "float64":
            return np.stack([golden(self.name, self.params, c, np.float32) for c in clips])
        if self.precision == "float32" and self.name == "audio_mel_spec":
            p = self.params
            return lowp.mel_feature_tf32(torch.from_numpy(clips).to(device), p["sample_rate"], p["n_mels"],
                                         p["n_fft"], p["hop_length"]).cpu().numpy()
        raise ValueError(f"no control for {self.name} in {self.precision}")

    def numbers(self, out: np.ndarray, ref: np.ndarray) -> dict[str, float]:
        """Absolute gaps for the bounded features; relative ones (over
        max(|reference|, 1)) for the classical vector, whose values run from
        1e-3 (zcr) to 1e3 (the centroid, in Hz)."""
        if self.name == "audio_mel_spec":
            return {"mel_gap": judge.max_abs(out, ref)}
        if self.name == "audio_mfcc_seq":
            return {"mfcc_gap": judge.max_abs(out, ref)}
        return {"classical_gap": judge.max_rel(out, ref)}


def build(config: dict, mix: dict, seed: int, device: torch.device) -> Entry:
    return Entry(config, mix, seed, device)
