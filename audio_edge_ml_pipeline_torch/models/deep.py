"""Deep trainers in PyTorch: the ``cnn`` model, inference and bundle I/O.

Counterpart of the JAX package's ``models/deep.py``. Ported so far: the CNN
module (``CNNModule``, NHWC at its boundary like the flax one), the ``.npz``
bundle format, and ``CNNTrainer`` for inference and ``save``. Training
(``fit``) and the other families are still to be ported.

Bundles keep the flax key layout, so the JAX package and its C codegen read
what the port writes and the other way round: ``p/Conv_i/{kernel,bias}``
with HWIO kernels and ``p/Dense_i/{kernel,bias}`` with (in, out) kernels.
``params_from_flax`` and ``params_to_flax`` convert between that layout and
a torch ``state_dict`` (OIHW conv weights, (out, in) linear weights).
"""

from __future__ import annotations

import json
import logging
import math
from pathlib import Path
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils.device import resolve_device
from .base import BaseTrainer, TrainResult
from .registry import register_model

logger = logging.getLogger(__name__)

# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------


def same_padding(size: int, stride: int, kernel: int = 3) -> tuple[int, int]:
    """(before, after) padding of flax/TF ``padding="SAME"``: the output has
    ceil(size / stride) positions and any odd padding goes after, so a
    strided layer can pad 0 before and 1 after."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class CNNModule(nn.Module):
    """Conv 3x3-SAME blocks (+ 2x2 max pool unless the block strides),
    global average pool, Dense(128), logits. Input and output as the flax
    module: x (B, H, W, C) -> (B, n_classes)."""

    def __init__(self, filters: tuple[int, ...], dropout: float, n_classes: int,
                 first_stride: int = 1, second_stride: int = 1, in_channels: int = 1) -> None:
        super().__init__()
        self.strides = [first_stride if i == 0 else second_stride if i == 1 else 1 for i in range(len(filters))]
        chans = [in_channels, *filters]
        self.convs = nn.ModuleList(nn.Conv2d(chans[i], chans[i + 1], 3, stride=s) for i, s in enumerate(self.strides))
        self.denses = nn.ModuleList([nn.Linear(filters[-1], 128), nn.Linear(128, n_classes)])
        self.dropout = nn.Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW
        for conv, stride in zip(self.convs, self.strides):
            top, bottom = same_padding(x.shape[2], stride)
            left, right = same_padding(x.shape[3], stride)
            x = F.relu(conv(F.pad(x, (left, right, top, bottom))))
            if stride == 1:
                x = F.max_pool2d(x, 2, 2)
            x = self.dropout(x)
        x = x.mean(dim=(2, 3))  # GAP2D
        x = self.dropout(F.relu(self.denses[0](x)))
        return self.denses[1](x)


def _cnn_from_arch(arch: dict) -> CNNModule:
    return CNNModule(
        tuple(arch["filters"]), arch["dropout"], arch["n_classes"],
        first_stride=arch.get("first_stride", 1), second_stride=arch.get("second_stride", 1),
        in_channels=arch["input_shape"][-1],
    )


_MODULE_FACTORY = {"cnn": _cnn_from_arch}

# ---------------------------------------------------------------------------
# Weight carry-over between the flax layout and torch state_dicts
# ---------------------------------------------------------------------------

_FLAX_TO_TORCH = {"Conv": "convs", "Dense": "denses"}
_TORCH_TO_FLAX = {v: k for k, v in _FLAX_TO_TORCH.items()}


def params_from_flax(flat: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
    """Flax ``p/`` params -> torch state_dict: ``p/Conv_i/kernel`` (HWIO) ->
    ``convs.i.weight`` (OIHW), ``p/Dense_i/kernel`` (in, out) ->
    ``denses.i.weight`` (out, in), biases as they are. Keys other than
    ``p/`` (norm stats, ``c/`` collections) are ignored."""
    state = {}
    for key, arr in flat.items():
        if not key.startswith("p/"):
            continue
        layer, kind = key[2:].split("/")
        family, index = layer.rsplit("_", 1)
        if family not in _FLAX_TO_TORCH:
            raise ValueError(f"no torch counterpart for flax layer {layer!r}")
        t = torch.tensor(np.asarray(arr, np.float32))
        if kind == "kernel":
            t = t.permute(3, 2, 0, 1) if t.ndim == 4 else t.T
            kind = "weight"
        state[f"{_FLAX_TO_TORCH[family]}.{index}.{kind}"] = t.contiguous()
    return state


def params_to_flax(state: dict[str, torch.Tensor]) -> dict[str, np.ndarray]:
    """Inverse of ``params_from_flax``: torch state_dict -> flax ``p/`` keys."""
    flat = {}
    for key, t in state.items():
        family, index, kind = key.split(".")
        arr = t.detach().cpu().to(torch.float32)
        if kind == "weight":
            arr = arr.permute(2, 3, 1, 0) if arr.ndim == 4 else arr.T
            kind = "kernel"
        flat[f"p/{_TORCH_TO_FLAX[family]}_{index}/{kind}"] = np.ascontiguousarray(arr.numpy())
    return flat


# ---------------------------------------------------------------------------
# Persistence helpers (.npz bundle)
# ---------------------------------------------------------------------------


def save_model_bundle_flat(path: Path, arch: dict, flat: dict, norm_mean, norm_var) -> None:
    """The .npz bundle layout (meta JSON + norm stats + flattened p/ params
    and c/ collections) that codegen and checkpoints depend on."""
    np.savez(
        path,
        __meta__=np.frombuffer(json.dumps(arch).encode(), dtype=np.uint8),
        norm_mean=np.asarray(norm_mean),
        norm_var=np.asarray(norm_var),
        **flat,
    )


def load_model_bundle(path: Path):
    """Returns (arch, flat, norm_mean, norm_var); flat carries both p/ param
    keys and c/ collection keys."""
    data = np.load(path, allow_pickle=False)
    arch = json.loads(bytes(data["__meta__"].tobytes()).decode())
    flat = {k: data[k] for k in data.files if k.startswith(("p/", "c/"))}
    return arch, flat, data["norm_mean"], data["norm_var"]


# ---------------------------------------------------------------------------
# TorchTrainer base
# ---------------------------------------------------------------------------


def _lecun_normal_(w: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    """flax's default kernel init: truncated normal (+-2 std) with variance
    1 / fan_in after truncation."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(w, std=std, a=-2.0 * std, b=2.0 * std, generator=generator)


class TorchTrainer(BaseTrainer):
    """Shared state of the deep trainers: architecture dict, module,
    normalization stats, device. Inference and persistence are ported;
    training is not yet.

    Subclasses set ``name`` and implement ``_arch(input_shape, n_classes)``
    returning the architecture dict consumed by _MODULE_FACTORY, and may
    override ``_prepare_input``.
    """

    model_type = "deep"

    def __init__(self, epochs: int = 50, batch_size: int = 32, dropout: float = 0.3,
                 learning_rate: float = 1e-3, seed: int = 0,
                 data_parallel: Optional[int] = None, device: torch.device | str | None = None,
                 **kwargs):
        self.epochs = epochs
        self.batch_size = batch_size
        self.dropout = dropout
        self.learning_rate = learning_rate
        self.seed = seed
        self.data_parallel = int(data_parallel) if data_parallel else 0
        self.device = resolve_device(device)
        self._extra = dict(kwargs)
        self._arch_dict: Optional[dict] = None
        self._net: Optional[nn.Module] = None
        self._norm_mean: Optional[torch.Tensor] = None
        self._norm_var: Optional[torch.Tensor] = None

    # -- subclass hooks ---------------------------------------------------
    def _arch(self, input_shape: tuple, n_classes: int) -> dict:
        raise NotImplementedError

    def _architecture_params(self) -> dict:
        return {}

    def _prepare_input(self, X: np.ndarray) -> np.ndarray:
        return X

    # -- internals ----------------------------------------------------------
    def _build(self, arch: dict, norm_mean, norm_var) -> None:
        self._arch_dict = arch
        self._net = _MODULE_FACTORY[arch["type"]](arch).to(self.device).eval()
        self._norm_mean = torch.as_tensor(np.asarray(norm_mean, np.float32)).to(self.device)
        self._norm_var = torch.as_tensor(np.asarray(norm_var, np.float32)).to(self.device)

    def _normalize(self, x: torch.Tensor) -> torch.Tensor:
        return (x - self._norm_mean) / torch.sqrt(self._norm_var + 1e-6)

    def _batched_logits(self, X: np.ndarray) -> np.ndarray:
        outs = []
        with torch.inference_mode():
            for s in range(0, len(X), self.batch_size):
                xb = torch.from_numpy(np.ascontiguousarray(X[s : s + self.batch_size])).to(self.device)
                outs.append(self._net(self._normalize(xb)).cpu().numpy())
        return np.concatenate(outs)

    def initialize(self, input_shape: tuple, n_classes: int, generator: torch.Generator) -> None:
        """Random weights from ``generator`` (flax's default initializers:
        lecun-normal kernels, zero biases) and identity normalization, for
        an untrained model of the architecture ``fit`` would build."""
        self._build(self._arch(tuple(input_shape), n_classes),
                    np.zeros(input_shape[-1], np.float32), np.ones(input_shape[-1], np.float32))
        with torch.no_grad():
            for mod in self._net.modules():
                if isinstance(mod, (nn.Conv2d, nn.Linear)):
                    w = torch.empty(mod.weight.shape, dtype=torch.float32)
                    _lecun_normal_(w, mod.weight[0].numel(), generator)
                    mod.weight.copy_(w)
                    mod.bias.zero_()

    # -- BaseTrainer ---------------------------------------------------------
    def fit(self, X_train, y_train, X_val, y_val, label_names, run_name, output_dir, mlflow_run,
            epoch_callback=None) -> TrainResult:
        raise NotImplementedError(
            f"{type(self).__name__}.fit is not yet ported to audio_edge_ml_pipeline_torch; "
            "train with audio_edge_ml_pipeline_tpu and load its bundle here."
        )

    def predict(self, X: np.ndarray) -> np.ndarray:
        X = self._prepare_input(np.asarray(X)).astype(np.float32)
        return self._batched_logits(X).argmax(-1)

    def predict_proba(self, X: np.ndarray) -> Optional[np.ndarray]:
        X = self._prepare_input(np.asarray(X)).astype(np.float32)
        logits = self._batched_logits(X)
        e = np.exp(logits - logits.max(axis=-1, keepdims=True))
        return (e / e.sum(axis=-1, keepdims=True)).astype(np.float32)

    def save(self, path: Path) -> None:
        save_model_bundle_flat(
            Path(path), self._arch_dict, params_to_flax(self._net.state_dict()),
            self._norm_mean.cpu().numpy(), self._norm_var.cpu().numpy(),
        )

    @classmethod
    def load(cls, path: Path, device: torch.device | str | None = None) -> "TorchTrainer":
        arch, flat, norm_mean, norm_var = load_model_bundle(Path(path))
        inst = cls.__new__(cls)
        TorchTrainer.__init__(inst, device=device)
        inst._build(arch, norm_mean, norm_var)
        state = params_from_flax(flat)
        expected = inst._net.state_dict()
        for key, t in expected.items():
            if key not in state or state[key].shape != t.shape:
                raise ValueError(f"missing/mismatched param {key} in bundle {path}")
        inst._net.load_state_dict(state, strict=True)
        return inst


def load_any_model(path: Path, device: torch.device | str | None = None) -> BaseTrainer:
    """Load a saved deep model bundle and return the right trainer class."""
    from .registry import get_model

    arch, _, _, _ = load_model_bundle(Path(path))
    return get_model(arch["type"]).load(path, device=device)


# ---------------------------------------------------------------------------
# Registered trainers
# ---------------------------------------------------------------------------


@register_model
class CNNTrainer(TorchTrainer):
    name = "cnn"

    def __init__(self, filters=None, n_blocks: Optional[int] = None,
                 first_stride: int = 1, second_stride: int = 1, **kwargs):
        super().__init__(**kwargs)
        if filters is None:
            filters = [32, 64]
        if isinstance(filters, int):
            filters = [filters] * (n_blocks or 2)
        self.filters = list(filters)
        self.first_stride = first_stride
        self.second_stride = second_stride

    def _architecture_params(self) -> dict:
        return {"filters": self.filters, "first_stride": self.first_stride, "second_stride": self.second_stride}

    def _prepare_input(self, X: np.ndarray) -> np.ndarray:
        if X.ndim == 2:
            return X[:, :, np.newaxis]
        if X.ndim == 3:
            return X[:, :, :, np.newaxis]
        return X

    def _arch(self, input_shape, n_classes):
        return {
            "type": "cnn", "filters": list(self.filters), "dropout": self.dropout,
            "n_classes": n_classes, "first_stride": self.first_stride,
            "second_stride": self.second_stride, "input_shape": list(input_shape),
        }
