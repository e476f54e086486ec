"""Scoring: waveforms in, logits out, through the program's flagship
forward (``entry.flagship()``: the mel feature on the mel kernel, the dB +
min-max epilogue, the CNN), with weights the benchmark makes from the seed.

The reference: the frozen float64 mel feature of each sampled clip, then
the plain float64 CNN on the same weights. The control: the same in TF32
(``reference.lowp``). Compared: ``logit_gap``, the largest gap of a
sampled logit over the largest reference logit.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.harness import judge
from benchmark.reference import cnn, librosa_ref, lowp

WEIGHT_STREAM = 0x9E3779B97F4A7C15   # the weights' generator is seeded apart from the clips'
BIAS_STD = 0.05


def _shapes(model: dict) -> dict[str, tuple[int, ...]]:
    chans = [1, *model["filters"]]
    shapes = {}
    for i in range(len(model["filters"])):
        shapes[f"convs.{i}.weight"] = (chans[i + 1], chans[i], 3, 3)
        shapes[f"convs.{i}.bias"] = (chans[i + 1],)
    shapes["denses.0.weight"] = (model["dense"], chans[-1])
    shapes["denses.0.bias"] = (model["dense"],)
    shapes["denses.1.weight"] = (model["n_classes"], model["dense"])
    shapes["denses.1.bias"] = (model["n_classes"],)
    return shapes


def make_weights(model: dict, seed: int, device: torch.device) -> dict[str, torch.Tensor]:
    """Lecun-normal kernels and small normal biases, float32, from one draw
    on ``device``."""
    shapes = _shapes(model)
    sizes = [int(np.prod(s)) for s in shapes.values()]
    gen = torch.Generator(device=device).manual_seed((seed ^ WEIGHT_STREAM) % (1 << 63))
    flat = torch.randn(sum(sizes), device=device, generator=gen)
    out = {}
    for (name, shape), part in zip(shapes.items(), torch.split(flat, sizes)):
        scale = BIAS_STD if name.endswith("bias") else float(np.prod(shape[1:])) ** -0.5
        out[name] = (scale * part).reshape(shape)
    return out


def strides(model: dict) -> tuple[int, ...]:
    n = len(model["filters"])
    return tuple(model["first_stride"] if i == 0 else model["second_stride"] if i == 1 else 1 for i in range(n))


class Entry:
    def __init__(self, config: dict, mix: dict, seed: int, device: torch.device) -> None:
        from audio_edge_ml_pipeline_torch.entry import flagship

        self.mel = config["features"]["audio_mel_spec"]
        self.model = config["model"]
        module, self.forward = flagship(n_mels=self.mel["n_mels"], n_fft=self.mel["n_fft"],
                                        hop=self.mel["hop_length"], sr=self.mel["sample_rate"],
                                        n_classes=self.model["n_classes"], filters=tuple(self.model["filters"]))
        self.weights = make_weights(self.model, seed, device)
        program = {k: tuple(v.shape) for k, v in module.state_dict().items()}
        if program != {k: tuple(v.shape) for k, v in self.weights.items()} or \
                tuple(module.strides) != strides(self.model):
            raise ValueError(f"the program's flagship is not the configuration's CNN: {program}, {module.strides}")

    def __call__(self, waves: torch.Tensor) -> torch.Tensor:
        return self.forward(self.weights, waves)

    def _features64(self, clips: np.ndarray) -> torch.Tensor:
        m = self.mel
        return torch.from_numpy(np.stack([librosa_ref.mel_spec_feature(c, m["sample_rate"], m["n_mels"], m["n_fft"],
                                                                       m["hop_length"]) for c in clips]))

    def reference(self, clips: np.ndarray) -> np.ndarray:
        w64 = {k: v.detach().to("cpu", torch.float64) for k, v in self.weights.items()}
        return cnn.forward(self._features64(clips), w64, strides(self.model)).numpy()

    def control(self, clips: np.ndarray, device: torch.device) -> np.ndarray:
        m = self.mel
        mel = lowp.mel_feature_tf32(torch.from_numpy(clips).to(device), m["sample_rate"], m["n_mels"], m["n_fft"],
                                    m["hop_length"])
        return cnn.forward(mel, {k: v.to(device) for k, v in self.weights.items()}, strides(self.model),
                           rnd=lowp.tf32).cpu().numpy()

    @staticmethod
    def numbers(out: np.ndarray, ref: np.ndarray) -> dict[str, float]:
        return {"logit_gap": judge.max_over_largest(out, ref)}


def build(config: dict, mix: dict, seed: int, device: torch.device) -> Entry:
    return Entry(config, mix, seed, device)
