"""Deep trainers in PyTorch: every deep family of the JAX package
(``mlp``, ``cnn``, ``ds_cnn``, ``rnn``, ``transformer``,
``efficientnet_teacher``, ``distillation_cnn``), inference, bundle I/O and
checkpoint/resume.

Counterpart of the JAX package's ``models/deep.py``: the flax modules
(NHWC at the CNNs' boundary like the flax ones; the EfficientNet-B0 backbone
in ``backbones.py``, the flax-semantics BatchNorm, LayerNorm and attention
in ``layers.py``), the ``.npz`` bundle format, pretrained warm start, and the
trainers: training (``fit``, with the semantics of ``FlaxTrainer.fit``),
inference and ``save``. ``data_parallel=N`` trains on N ranks
(``parallel/mesh.py::run_ranks``: N cards through NCCL, or N gloo
processes on the CPU), DDP over the ranks, with the BatchNorm moments and
the dropout masks of the global batch (``_fit_loop``).

Training semantics carried over: input normalization stats over all axes
but the last, computed in numpy; the weighted masked cross-entropy of
wrap-around padded batches (BatchNorm's batch statistics see the padded
rows, as in JAX); Adam with optax's defaults, its learning rate set per
epoch; EarlyStopping(val_loss, patience=10, restore best);
ReduceLROnPlateau(0.5, patience=5, min_lr=1e-6); per-epoch metrics to the
tracking run; with ``checkpoint_dir``, a ``train_state.npz`` every
``checkpoint_every`` epochs and, unless ``resume`` is false, a resume from
it (``utils/checkpoint.py``). The teacher fine-tunes in two phases (head
only at full lr, then everything at lr x ``fine_tune_lr_factor``), and the
student distils a teacher's soft targets (KL at temperature T, weight
alpha, plus (1 - alpha) cross-entropy). Convolutions, attention and LSTMs
run in cuDNN / cuBLAS and gradients through autograd, as the JAX package
leaves them to XLA; no hand kernel is on this path.

Bundles keep the flax key layout, so the JAX package and its C codegen read
what the port writes and the other way round. ``params_from_flax`` and
``params_to_flax`` convert between it and a torch ``state_dict`` whose
module names mirror the flax tree: a flax ``Family_i`` path segment is the
torch ``<families>.i`` (``Conv`` -> ``convs``, ``Dense`` -> ``denses``,
``BatchNorm`` -> ``bns``, ``LayerNorm`` -> ``lns``,
``MultiHeadDotProductAttention`` -> ``attns``, ``_ConvBN`` -> ``convbns``,
``_MBConvSE`` -> ``blocks``, ``_InvertedResidual`` -> ``invres``) and a named one (``backbone``, ``head``,
``query``) keeps its name, at any depth
(``p/backbone/_MBConvSE_3/_ConvBN_1/Conv_0/kernel`` is
``backbone.blocks.3.convbns.1.convs.0.weight``). The leaves:

- ``Conv`` kernels HWIO <-> OIHW weights (depthwise (kh, kw, 1, C) <->
  (C, 1, kh, kw)); ``Dense`` kernels (in, out) <-> (out, in) weights;
  biases as they are;
- ``BatchNorm_i/{scale,bias}`` <-> ``bns.i.{weight,bias}``, and its running
  statistics ``c/batch_stats/<path>/BatchNorm_i/{mean,var}`` <-> the
  buffers ``bns.i.{mean,var}``;
- ``LayerNorm_i/{scale,bias}`` <-> ``lns.i.{weight,bias}``;
- ``MultiHeadDotProductAttention_i/{query,key,value}/kernel`` (d, heads,
  head_dim) with bias (heads, head_dim), and ``/out/kernel`` (heads,
  head_dim, d) with bias (d,), kept in flax's shapes (3-D kernels are
  never transposed);
- ``p/OptimizedLSTMCell_c/{ii,if,ig,io}/kernel`` (in, units) with
  ``{hi,hf,hg,ho}/{kernel,bias}`` (units, units) for the forward (c = 2 i)
  and backward (c = 2 i + 1) cell of LSTM layer i, stacked into one
  bidirectional ``nn.LSTM`` a layer (gates i, f, g, o). flax's cell has one
  bias a gate, on the recurrent side: ``bias_hh`` carries it, and
  ``bias_ih`` stays zero and out of the optimizer (two trained biases would
  move their sum twice as fast under Adam, and the bundle could not hold
  them).
"""


from __future__ import annotations

import copy
import json
import logging
import math
import re
from pathlib import Path
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..train.evaluate import (
    compute_metrics,
    log_run_to_mlflow,
    save_classification_report,
    save_confusion_matrix_png,
    save_model_info,
)
from ..utils.checkpoint import load_train_state, save_train_state
from ..utils.device import resolve_device
from ..utils.dropout import GlobalBatchNoise, dropout_noise, runtime_dropout
from .backbones import EMBED_DIM, EfficientNetB0
from .base import BaseTrainer, TrainResult
from .layers import BatchNorm, LayerNorm, Projection, SelfAttention, conv_same, name_batch_norms, sync_batch_norms
from .registry import register_model

logger = logging.getLogger(__name__)

_KD_TEMPERATURE = 4.0
_KD_ALPHA = 0.7

# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------


class _RuntimeDropoutModule(nn.Module):
    """``_drop``: ``runtime_dropout`` at the rate a forward call gives, else
    at the module's own rate (its ``nn.Dropout``'s ``p``; the masks' noise
    from the ``dropout_noise`` source in effect). Every family's ``forward(x, dropout_rate=
    None, stats=None)`` takes ``stats``, a dict that its train-mode
    BatchNorm layers fill with their updated running statistics under their
    state_dict names (``layers.BatchNorm``); the families without a
    BatchNorm that updates leave it empty."""

    def _drop(self, x: torch.Tensor, rate) -> torch.Tensor:
        return runtime_dropout(x, self.dropout.p if rate is None else rate, self.training)


class CNNModule(_RuntimeDropoutModule):
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

    def forward(self, x: torch.Tensor, dropout_rate=None, stats: dict | None = None) -> torch.Tensor:
        """``dropout_rate`` (optional) replaces the module's own rate."""
        x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW
        for conv, stride in zip(self.convs, self.strides):
            x = F.relu(conv_same(conv, x))
            if stride == 1:
                x = F.max_pool2d(x, 2, 2)
            x = self._drop(x, dropout_rate)
        x = x.mean(dim=(2, 3))  # GAP2D
        x = self._drop(F.relu(self.denses[0](x)), dropout_rate)
        return self.denses[1](x)


class MLPModule(_RuntimeDropoutModule):
    """Dense + ReLU + dropout for each hidden width, then logits: x (B, D) ->
    (B, n_classes), as the flax module."""

    def __init__(self, hidden_units: tuple[int, ...], dropout: float, n_classes: int, in_features: int) -> None:
        super().__init__()
        widths = [in_features, *hidden_units, n_classes]
        self.denses = nn.ModuleList(nn.Linear(widths[i], widths[i + 1]) for i in range(len(widths) - 1))
        self.dropout = nn.Dropout(dropout)

    def forward(self, x: torch.Tensor, dropout_rate=None, stats: dict | None = None) -> torch.Tensor:
        """``dropout_rate`` (optional) replaces the module's own rate."""
        for dense in self.denses[:-1]:
            x = self._drop(F.relu(dense(x)), dropout_rate)
        return self.denses[-1](x)


class BiLSTMModule(_RuntimeDropoutModule):
    """Stacked bidirectional LSTM layers, each after a dropout of its input
    (the raw input included); the last layer's forward output at the last
    step beside its backward output at the first; Dense(64) + ReLU + dropout;
    logits. x (B, T, F) -> (B, n_classes), as the flax module, which runs
    ``nn.RNN(OptimizedLSTMCell)`` forward and ``reverse=True, keep_order=True``
    backward. One bidirectional ``nn.LSTM`` a layer (cuDNN on a card); its
    ``bias_ih`` is held at zero (see the module docstring)."""

    def __init__(self, units: int, n_layers: int, dropout: float, n_classes: int, in_features: int) -> None:
        super().__init__()
        self.units = units
        self.lstms = nn.ModuleList(
            nn.LSTM(in_features if i == 0 else 2 * units, units, batch_first=True, bidirectional=True)
            for i in range(n_layers))
        for lstm in self.lstms:
            for name in ("bias_ih_l0", "bias_ih_l0_reverse"):
                bias = getattr(lstm, name)
                bias.requires_grad_(False)
                with torch.no_grad():
                    bias.zero_()
        self.denses = nn.ModuleList([nn.Linear(2 * units, 64), nn.Linear(64, n_classes)])
        self.dropout = nn.Dropout(dropout)

    def forward(self, x: torch.Tensor, dropout_rate=None, stats: dict | None = None) -> torch.Tensor:
        """``dropout_rate`` (optional) replaces the module's own rate."""
        for lstm in self.lstms:
            x, _ = lstm(self._drop(x, dropout_rate))
        x = torch.cat([x[:, -1, : self.units], x[:, 0, self.units :]], dim=-1)
        x = self._drop(F.relu(self.denses[0](x)), dropout_rate)
        return self.denses[1](x)


class DSCNNModule(_RuntimeDropoutModule):
    """Depthwise-separable CNN (Hello-Edge DS-CNN): stem conv at
    ``first_stride`` -> optional 2x2 avg or max pool -> for each further
    width, depthwise 3x3 then pointwise 1x1, each + BatchNorm + ReLU, then
    dropout -> GAP -> dropout -> logits. Convolutions are SAME and carry no
    bias when ``batch_norm`` is on (BatchNorm(momentum 0.9, epsilon 1e-5)).
    x (B, H, W, C) -> (B, n_classes), as the flax module."""

    def __init__(self, filters: tuple[int, ...], dropout: float, n_classes: int, first_stride: int = 2,
                 pool: str = "avg", batch_norm: bool = True, in_channels: int = 1) -> None:
        super().__init__()
        convs = [nn.Conv2d(in_channels, filters[0], 3, first_stride, bias=not batch_norm)]
        for c, f in zip(filters[:-1], filters[1:]):
            convs += [nn.Conv2d(c, c, 3, groups=c, bias=not batch_norm), nn.Conv2d(c, f, 1, bias=not batch_norm)]
        self.convs = nn.ModuleList(convs)
        self.bns = nn.ModuleList(BatchNorm(conv.out_channels) for conv in convs) if batch_norm else nn.ModuleList()
        self.denses = nn.ModuleList([nn.Linear(filters[-1], n_classes)])
        self.dropout = nn.Dropout(dropout)
        self.pool = pool
        name_batch_norms(self)

    def _unit(self, i: int, x: torch.Tensor, stats: dict | None) -> torch.Tensor:
        x = conv_same(self.convs[i], x)
        if self.bns:
            x = self.bns[i](x, self.training, stats)
        return F.relu(x)

    def forward(self, x: torch.Tensor, dropout_rate=None, stats: dict | None = None) -> torch.Tensor:
        """``dropout_rate`` (optional) replaces the module's own rate."""
        x = self._unit(0, x.permute(0, 3, 1, 2), stats)   # NHWC -> NCHW
        if self.pool == "avg":
            x = F.avg_pool2d(x, 2, 2)
        elif self.pool == "max":
            x = F.max_pool2d(x, 2, 2)
        for i in range(1, len(self.convs), 2):
            x = self._drop(self._unit(i + 1, self._unit(i, x, stats), stats), dropout_rate)
        x = self._drop(x.mean(dim=(2, 3)), dropout_rate)   # GAP2D
        return self.denses[0](x)


class TransformerModule(_RuntimeDropoutModule):
    """``n_blocks`` x (self-attention + dropout + residual LayerNorm, Dense
    ``ff_dim`` + ReLU + Dense d + dropout + residual LayerNorm), mean over
    the sequence, Dense(64) + ReLU + dropout, logits. Attention has
    ``max(1, d // heads)`` features a head (so qkv features may be fewer
    than d), no positional encoding; LayerNorm epsilon 1e-6. x (B, L, d) ->
    (B, n_classes), as the flax module."""

    def __init__(self, num_heads: int, ff_dim: int, n_blocks: int, dropout: float, n_classes: int,
                 d: int) -> None:
        super().__init__()
        self.attns = nn.ModuleList(SelfAttention(d, num_heads, max(1, d // num_heads)) for _ in range(n_blocks))
        self.lns = nn.ModuleList(LayerNorm(d, eps=1e-6) for _ in range(2 * n_blocks))
        denses = []
        for _ in range(n_blocks):
            denses += [nn.Linear(d, ff_dim), nn.Linear(ff_dim, d)]
        self.denses = nn.ModuleList([*denses, nn.Linear(d, 64), nn.Linear(64, n_classes)])
        self.dropout = nn.Dropout(dropout)

    def forward(self, x: torch.Tensor, dropout_rate=None, stats: dict | None = None) -> torch.Tensor:
        """``dropout_rate`` (optional) replaces the module's own rate."""
        for i, attn in enumerate(self.attns):
            x = self.lns[2 * i](x + self._drop(attn(x), dropout_rate))
            ff = self.denses[2 * i + 1](F.relu(self.denses[2 * i](x)))
            x = self.lns[2 * i + 1](x + self._drop(ff, dropout_rate))
        x = self._drop(F.relu(self.denses[-2](x.mean(dim=1))), dropout_rate)   # GAP1D
        return self.denses[-1](x)


def square_resize(x: torch.Tensor, size: int) -> torch.Tensor:
    """The teacher's input stage: a (B, H, W, 1) spectrogram zero-padded at
    the end to a max(H, W) square, resized bilinearly to ``size`` and
    repeated to RGB: (B, 3, size, size). ``jax.image.resize`` antialiases
    when it shrinks and not when it grows; ``F.interpolate``'s
    ``antialias`` does the same only when asked, so it is asked exactly when
    the side shrinks."""
    x = x.permute(0, 3, 1, 2)
    h, w = x.shape[2:]
    side = max(h, w)
    x = F.pad(x, (0, side - w, 0, side - h))
    x = F.interpolate(x, size=(size, size), mode="bilinear", align_corners=False, antialias=side > size)
    return x.expand(-1, 3, -1, -1)


class EfficientNetTeacherModule(_RuntimeDropoutModule):
    """``square_resize`` + EfficientNet-B0 (``backbones.py``) + dropout + the
    ``head`` Dense. The backbone runs with ``train=False`` in training too,
    as in JAX: its BatchNorm always normalises by its running statistics and
    never updates them. x (B, H, W, 1) -> (B, n_classes)."""

    def __init__(self, n_classes: int, dropout: float, image_size: int = 224) -> None:
        super().__init__()
        self.backbone = EfficientNetB0()
        self.head = nn.Linear(EMBED_DIM, n_classes)
        self.dropout = nn.Dropout(dropout)
        self.image_size = image_size

    def embed(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 1) -> the backbone's (B, 1280) embedding."""
        return self.backbone(square_resize(x, self.image_size), train=False)

    def forward(self, x: torch.Tensor, dropout_rate=None, stats: dict | None = None) -> torch.Tensor:
        """``dropout_rate`` (optional) replaces the module's own rate."""
        return self.head(self._drop(self.embed(x), dropout_rate))


def check_teacher_revision(arch: dict) -> None:
    """The arch revision gate of the JAX package: a teacher bundle saved
    before its silu + squeeze-excite rework loads by name and shape into this
    module but computes through the wrong activation, so it is refused."""
    rev = arch.get("act", "relu6-legacy")
    if rev != "silu":
        raise ValueError(
            f"efficientnet_teacher bundle has arch revision {rev!r}, but this build expects 'silu' "
            "(Keras-faithful EfficientNetB0). Re-train the teacher or re-convert the checkpoint with "
            "tools/convert_backbone_weights.py."
        )


def _cnn_from_arch(arch: dict) -> CNNModule:
    return CNNModule(
        tuple(arch["filters"]), arch["dropout"], arch["n_classes"],
        first_stride=arch.get("first_stride", 1), second_stride=arch.get("second_stride", 1),
        in_channels=arch["input_shape"][-1],
    )


def _mlp_from_arch(arch: dict) -> MLPModule:
    return MLPModule(tuple(arch["hidden_units"]), arch["dropout"], arch["n_classes"], arch["input_shape"][-1])


def _rnn_from_arch(arch: dict) -> BiLSTMModule:
    return BiLSTMModule(arch["units"], arch["n_layers"], arch["dropout"], arch["n_classes"], arch["input_shape"][-1])


def _ds_cnn_from_arch(arch: dict) -> DSCNNModule:
    return DSCNNModule(tuple(arch["filters"]), arch["dropout"], arch["n_classes"], arch.get("first_stride", 2),
                       arch.get("pool", "avg"), arch.get("batch_norm", True), in_channels=arch["input_shape"][-1])


def _transformer_from_arch(arch: dict) -> TransformerModule:
    return TransformerModule(arch["num_heads"], arch["ff_dim"], arch["n_blocks"], arch["dropout"], arch["n_classes"],
                             arch["input_shape"][-1])


def _teacher_from_arch(arch: dict) -> EfficientNetTeacherModule:
    check_teacher_revision(arch)
    return EfficientNetTeacherModule(arch["n_classes"], arch["dropout"], arch.get("image_size", 224))


_MODULE_FACTORY = {"cnn": _cnn_from_arch, "mlp": _mlp_from_arch, "rnn": _rnn_from_arch, "ds_cnn": _ds_cnn_from_arch,
                   "transformer": _transformer_from_arch, "efficientnet_teacher": _teacher_from_arch,
                   "distillation_cnn": _cnn_from_arch}

# ---------------------------------------------------------------------------
# Weight carry-over between the flax layout and torch state_dicts
# ---------------------------------------------------------------------------

_FAMILIES = {"Conv": "convs", "Dense": "denses", "BatchNorm": "bns", "LayerNorm": "lns",
             "MultiHeadDotProductAttention": "attns", "_ConvBN": "convbns", "_MBConvSE": "blocks",
             "_InvertedResidual": "invres"}
_TORCH_FAMILIES = {v: k for k, v in _FAMILIES.items()}
_STATS = "c/batch_stats/"
_LSTM_CELL = "OptimizedLSTMCell"
_GATES = "ifgo"   # nn.LSTM's order of the stacked gates; flax keeps one kernel each
_LSTM_PARAM = re.compile(r"(weight|bias)_(ih|hh)_l0(_reverse)?")


def _lstm_from_flax(cells: dict[int, dict[str, torch.Tensor]]) -> dict[str, torch.Tensor]:
    """flax cells {c: {"ii/kernel": ..., "hi/bias": ...}} -> the state of
    ``lstms.{c // 2}``, direction c % 2, with ``bias_ih`` zero."""
    state = {}
    for c, cell in cells.items():
        prefix, suffix = f"lstms.{c // 2}.", "_l0_reverse" if c % 2 else "_l0"
        state[f"{prefix}weight_ih{suffix}"] = torch.cat([cell[f"i{g}/kernel"].T for g in _GATES]).contiguous()
        state[f"{prefix}weight_hh{suffix}"] = torch.cat([cell[f"h{g}/kernel"].T for g in _GATES]).contiguous()
        state[f"{prefix}bias_hh{suffix}"] = torch.cat([cell[f"h{g}/bias"] for g in _GATES])
        state[f"{prefix}bias_ih{suffix}"] = torch.zeros_like(state[f"{prefix}bias_hh{suffix}"])
    return state


def params_from_flax(flat: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
    """Flax ``p/`` params and ``c/batch_stats/`` statistics -> torch
    state_dict (module docstring): path segments ``Family_i`` ->
    ``<families>.i``, named ones as they are; 4-D kernels (HWIO) -> OIHW
    weights, 2-D kernels (in, out) -> (out, in) weights, 3-D (attention)
    kernels and biases as they are, ``scale`` -> ``weight``; the gates of
    ``p/OptimizedLSTMCell_c`` stacked into ``lstms.{c // 2}``. Other keys
    (norm stats, other collections) are ignored."""
    state = {}
    cells: dict[int, dict[str, torch.Tensor]] = {}
    for key, arr in flat.items():
        if key.startswith("p/"):
            path = key[2:].split("/")
        elif key.startswith(_STATS):
            path = key[len(_STATS):].split("/")
        else:
            continue
        t = torch.tensor(np.asarray(arr, np.float32))
        if path[0].rpartition("_")[0] == _LSTM_CELL:
            cells.setdefault(int(path[0].rpartition("_")[2]), {})["/".join(path[1:])] = t
            continue
        *mods, leaf = path
        names = []
        for seg in mods:
            family, _, index = seg.rpartition("_")
            names += [_FAMILIES[family], index] if family in _FAMILIES and index.isdigit() else [seg]
        if leaf == "kernel" and t.ndim in (2, 4):
            t, leaf = (t.permute(3, 2, 0, 1) if t.ndim == 4 else t.T), "weight"
        elif leaf == "scale":
            leaf = "weight"
        elif leaf not in ("kernel", "bias", "mean", "var") or not names:
            raise ValueError(f"no torch counterpart for flax parameter {key!r}")
        state[".".join([*names, leaf])] = t.contiguous()
    state.update(_lstm_from_flax(cells))
    return state


def params_to_flax(state: dict[str, torch.Tensor | None]) -> dict[str, np.ndarray]:
    """Inverse of ``params_from_flax``: torch state_dict (or the gradients of
    its parameters) -> flax ``p/`` keys, and BatchNorm buffers ->
    ``c/batch_stats/`` keys. ``bias_ih`` has no flax key: it must be zero (a
    gradient of it, None). The arrays are copies, never views of the
    tensors."""
    flat = {}
    for key, t in state.items():
        *mods, leaf = key.split(".")
        if mods[0] == "lstms":
            what, side, reverse = _LSTM_PARAM.fullmatch(leaf).groups()
            if what == "bias" and side == "ih":
                if t is not None and bool(t.detach().ne(0).any()):
                    raise ValueError(f"{key} is not zero: the flax layout has no input-side LSTM bias")
                continue
            c = 2 * int(mods[1]) + bool(reverse)
            for g, part in zip(_GATES, t.detach().cpu().to(torch.float32).chunk(4)):
                name = f"p/{_LSTM_CELL}_{c}/{side[0]}{g}/{'kernel' if what == 'weight' else 'bias'}"
                flat[name] = np.array((part.T if what == "weight" else part).numpy(), order="C")
            continue
        names, i = [], 0
        while i < len(mods):
            if mods[i] in _TORCH_FAMILIES and i + 1 < len(mods) and mods[i + 1].isdigit():
                names.append(f"{_TORCH_FAMILIES[mods[i]]}_{mods[i + 1]}")
                i += 2
            else:
                names.append(mods[i])
                i += 1
        arr = t.detach().cpu().to(torch.float32)
        if leaf == "weight":
            if arr.ndim in (2, 4):
                arr, leaf = (arr.permute(2, 3, 1, 0) if arr.ndim == 4 else arr.T), "kernel"
            else:
                leaf = "scale"
        prefix = _STATS if leaf in ("mean", "var") else "p/"
        flat[prefix + "/".join([*names, leaf])] = np.array(arr.numpy(), order="C")   # a copy: CPU tensors share
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


def transfer_pretrained(flat: dict[str, np.ndarray], path: Path) -> tuple[dict[str, np.ndarray], int]:
    """By-name+shape warm start on the flax-layout flat dict: every key of
    ``flat`` that the bundle at ``path`` holds with the same shape takes the
    bundle's tensor; everything else (a resized head, the normalization
    stats) keeps its init; ``c/batch_stats`` keys follow the same rule.
    Accepts converted backbone checkpoints too
    (``tools/convert_backbone_weights.py --prefix backbone --bundle``). A
    teacher bundle must pass the revision gate (``check_teacher_revision``).
    Returns (flat, n_params_transferred), the count over ``p/`` keys as in
    JAX."""
    donor_arch, donor, _, _ = load_model_bundle(Path(path))
    if donor_arch.get("type") == "efficientnet_teacher":
        check_teacher_revision(donor_arch)
    out = dict(flat)
    transferred = 0
    for k, v in flat.items():
        if k in donor and donor[k].shape == v.shape:
            out[k] = np.asarray(donor[k], np.float32)
            transferred += k.startswith("p/")
    return out, transferred


# ---------------------------------------------------------------------------
# TorchTrainer base
# ---------------------------------------------------------------------------

MODEL_FILENAME = "model.flax.npz"


def _lecun_normal_(w: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    """flax's default kernel init: truncated normal (+-2 std) with variance
    1 / fan_in after truncation."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(w, std=std, a=-2.0 * std, b=2.0 * std, generator=generator)


def init_weights_(net: nn.Module, generator: torch.Generator) -> None:
    """flax's default initializers from ``generator``, in place: lecun-normal
    kernels (an attention projection's on its fan-in over the contracted
    axes), zero biases; an LSTM cell's input kernels lecun-normal and its
    recurrent ones orthogonal, gate by gate. Norm layers keep their
    construction values (scale 1, bias 0, running mean 0 and var 1), as
    flax initialises them."""
    with torch.no_grad():
        for mod in net.modules():
            if isinstance(mod, (nn.Conv2d, nn.Linear)):
                w = torch.empty(mod.weight.shape, dtype=torch.float32)
                _lecun_normal_(w, mod.weight[0].numel(), generator)
                mod.weight.copy_(w)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, Projection):
                w = torch.empty(mod.kernel.shape, dtype=torch.float32)
                _lecun_normal_(w, mod.fan_in, generator)
                mod.kernel.copy_(w)
                mod.bias.zero_()
            elif isinstance(mod, nn.LSTM):
                for name, p in mod.named_parameters():
                    w = torch.zeros(p.shape, dtype=torch.float32)
                    if name.startswith("weight"):
                        for gate in w.chunk(4):
                            if name.startswith("weight_ih"):
                                _lecun_normal_(gate, p.shape[1], generator)
                            else:
                                nn.init.orthogonal_(gate, generator=generator)
                    p.copy_(w)


class TorchTrainer(BaseTrainer):
    """Shared training loop and state of the deep trainers: architecture
    dict, module, normalization stats, device.

    Subclasses set ``name`` and implement ``_arch(input_shape, n_classes)``
    returning the architecture dict consumed by _MODULE_FACTORY, and may
    override ``_prepare_input``. ``dtype`` is a verification hook that no
    CLI or config sets: float64 holds a data-parallel fit to the
    one-process fit over many steps.
    """

    model_type = "deep"

    def __init__(self, epochs: int = 50, batch_size: int = 32, dropout: float = 0.3,
                 learning_rate: float = 1e-3, seed: int = 0,
                 data_parallel: Optional[int] = None, device: torch.device | str | None = None,
                 data_parallel_devices: Optional[list] = None, data_parallel_backend: Optional[str] = None,
                 dtype: torch.dtype | str = torch.float32, **kwargs):
        self.epochs = epochs
        self.batch_size = batch_size
        self.dropout = dropout
        self.learning_rate = learning_rate
        self.seed = seed
        # data_parallel=N trains on N ranks (N cards, or N gloo processes when
        # device is the CPU); the CLI's --param data_parallel=N.
        # data_parallel_devices / _backend name the ranks' devices and the
        # backend outright (e.g. two gloo ranks sharing one card)
        self.data_parallel = int(data_parallel) if data_parallel else 0
        self.data_parallel_devices = data_parallel_devices
        self.data_parallel_backend = data_parallel_backend
        # a verification hook, set by no CLI or config: what the module, its inputs and Adam compute in.
        # float32, as JAX trains; float64 holds two runs that sum in other orders (a data-parallel fit and
        # the one-process one) to each other over many steps, as TrialGroup's dtype does (in float32 Adam
        # lifts roundoff on near-zero gradients to fractions of a step)
        self.dtype = getattr(torch, dtype) if isinstance(dtype, str) else dtype
        self.device = resolve_device(device)
        self._ddp: Optional[nn.Module] = None
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
        self._net = _MODULE_FACTORY[arch["type"]](arch).to(self.device, self.dtype).eval()
        self._norm_mean = torch.as_tensor(np.asarray(norm_mean, np.float32)).to(self.device, self.dtype)
        self._norm_var = torch.as_tensor(np.asarray(norm_var, np.float32)).to(self.device, self.dtype)

    def _normalize(self, x: torch.Tensor) -> torch.Tensor:
        return (x - self._norm_mean) / torch.sqrt(self._norm_var + 1e-6)

    def _batched_logits(self, X: np.ndarray) -> np.ndarray:
        outs = []
        with torch.inference_mode():
            for s in range(0, len(X), self.batch_size):
                xb = torch.from_numpy(np.ascontiguousarray(X[s : s + self.batch_size])).to(self.device, self.dtype)
                outs.append(self._net(self._normalize(xb)).cpu().numpy())
        return np.concatenate(outs)

    def initialize(self, input_shape: tuple, n_classes: int, generator: torch.Generator) -> None:
        """Random weights from ``generator`` and identity normalization, for
        an untrained model of the architecture ``fit`` would build."""
        self._build(self._arch(tuple(input_shape), n_classes),
                    np.zeros(input_shape[-1], np.float32), np.ones(input_shape[-1], np.float32))
        init_weights_(self._net, generator)

    def prepare_fit(self, X_train: np.ndarray, n_classes: int) -> None:
        """What ``fit`` does before its first step, on prepared float32 input:
        build the module, adapt the normalization, initialize from ``seed``,
        and warm-start from ``pretrained_model`` when one was given."""
        # Keras Normalization(axis=-1): per-last-axis mean/variance over every
        # other axis, in numpy as the JAX package computes them
        axes = tuple(range(X_train.ndim - 1))
        self._build(self._arch(X_train.shape[1:], n_classes),
                    X_train.mean(axis=axes).astype(np.float32), X_train.var(axis=axes).astype(np.float32))
        init_weights_(self._net, torch.Generator().manual_seed(self.seed))

        # pretrained warm-start: copy matching name+shape tensors, keep the
        # norm stats. Consumed once (pop): a refit trains from its own state.
        pretrained_path = self._extra.pop("pretrained_model", None)
        if pretrained_path:
            try:
                flat, transferred = transfer_pretrained(params_to_flax(self._net.state_dict()), Path(pretrained_path))
                self._net.load_state_dict(params_from_flax(flat))
                logger.info("Pretrained weights: %d tensors transferred from %s", transferred, pretrained_path)
            except (OSError, ValueError, KeyError) as exc:
                logger.warning("Pretrained weight transfer failed (%s); training from scratch", exc)

    def _row_losses(self, logits: torch.Tensor, y: torch.Tensor, idx: torch.Tensor | None) -> torch.Tensor:
        """Per-row training loss of the batch's rows ``idx``: cross-entropy."""
        return F.cross_entropy(logits, y, reduction="none")

    def _batch_loss(self, x: torch.Tensor, y: torch.Tensor, w: torch.Tensor, idx: torch.Tensor | None = None,
                    stats: dict | None = None, wsum: torch.Tensor | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
        """(loss, accuracy) of one padded batch (rows ``idx`` of the training
        set): ``_row_losses`` and hits weighted by ``w`` (0 on wrap-around
        padding rows) over max(sum w, 1), ``wsum`` when given (the global
        batch's sum of a data-parallel rank's rows). BatchNorm sees every
        row, padded or not, and puts its updated statistics in ``stats``."""
        logits = (self._ddp or self._net)(self._normalize(x), stats=stats)
        wsum = torch.clamp_min(w.sum() if wsum is None else wsum, 1.0)
        loss = (self._row_losses(logits, y, idx) * w).sum() / wsum
        acc = ((logits.detach().argmax(-1) == y).to(w.dtype) * w).sum() / wsum
        return loss, acc

    def train_step(self, optimizer: torch.optim.Optimizer, X: torch.Tensor, y: torch.Tensor,
                   idx: torch.Tensor, w: torch.Tensor, wsum: torch.Tensor | None = None,
                   noise=None, ranks: int = 1) -> tuple[torch.Tensor, torch.Tensor]:
        """One optimizer step on rows ``idx`` of the device-resident (X, y),
        weighted by ``w``; then the BatchNorm statistics of the step's forward
        pass replace the running ones (flax's mutable ``batch_stats``).
        Returns the batch's (loss, accuracy) on the device. The step is a
        ``train_step`` range in an ``AEP_PROFILE_DIR`` trace. In ``fit``:
        ``noise`` draws the dropout masks (``GlobalBatchNoise``), and on one
        of ``ranks`` data-parallel ranks ``wsum`` is the global batch's
        weight and the loss is scaled by ``ranks`` before DDP averages the
        gradients, so that they are the global loss's."""
        with torch.profiler.record_function("train_step"):
            optimizer.zero_grad(set_to_none=True)
            stats: dict[str, torch.Tensor] = {}
            with dropout_noise(noise):
                loss, acc = self._batch_loss(X.index_select(0, idx), y.index_select(0, idx), w, idx, stats, wsum)
            (loss * ranks if ranks > 1 else loss).backward()
            optimizer.step()
            if stats:
                buffers = dict(self._net.named_buffers())
                with torch.no_grad():
                    for name, value in stats.items():
                        buffers[name].copy_(value)
        return loss.detach(), acc

    @staticmethod
    def _epoch_batches(perm: np.ndarray, steps: int, bs: int) -> tuple[np.ndarray, np.ndarray]:
        """(steps, bs) index and weight matrices of one epoch: the short last
        batch is padded with WRAP-AROUND rows of this epoch's permutation
        (not repeats of one row) that carry weight 0."""
        idx_mat = np.resize(perm, (steps, bs)).astype(np.int32)  # cycles perm
        w_mat = np.zeros((steps, bs), np.float32)
        for s in range(steps):
            sl = perm[s * bs : (s + 1) * bs]
            idx_mat[s, : len(sl)] = sl
            w_mat[s, : len(sl)] = 1.0
        return idx_mat, w_mat

    # -- BaseTrainer ---------------------------------------------------------
    def fit(
        self,
        X_train: np.ndarray,
        y_train: np.ndarray,
        X_val: np.ndarray,
        y_val: np.ndarray,
        label_names: list[str],
        run_name: str,
        output_dir: Path,
        mlflow_run,
        epoch_callback=None,
    ) -> TrainResult:
        ranks = None
        if self.data_parallel > 1:
            from ..parallel.mesh import data_parallel_devices

            # N cards (or explicit devices) are required before any work: no CPU fallback
            ranks = data_parallel_devices(self.data_parallel, self.device, self.data_parallel_devices,
                                          self.data_parallel_backend)
        X_train = self._prepare_input(np.asarray(X_train)).astype(np.float32)
        X_val = self._prepare_input(np.asarray(X_val)).astype(np.float32)
        y_train = np.asarray(y_train).astype(np.int32)
        y_val = np.asarray(y_val).astype(np.int32)
        if ranks is None:
            return self._fit_loop(X_train, y_train, X_val, y_val, label_names, run_name, output_dir, mlflow_run,
                                  epoch_callback)
        from ..parallel.mesh import run_ranks

        devices, backend = ranks
        logger.info("[%s] data-parallel training over %d devices", self.name, self.data_parallel)
        peer = self._peer_copy()
        return run_ranks(
            _fit_peer, (peer, X_train, y_train, label_names), devices, backend,
            root=lambda rank: self._fit_loop(X_train, y_train, X_val, y_val, label_names, run_name, output_dir,
                                             mlflow_run, epoch_callback, rank))

    def _peer_copy(self) -> "TorchTrainer":
        """What a data-parallel peer rank needs of this trainer, picklable:
        its settings (a shallow copy) without the built module, the teacher's
        logits on the host."""
        peer = copy.copy(self)
        peer._extra = dict(self._extra)
        peer._net = peer._ddp = peer._norm_mean = peer._norm_var = None
        if getattr(self, "_teacher_logits", None) is not None:
            peer._teacher_logits = self._teacher_logits.cpu()
        return peer

    def _fit_loop(self, X_train, y_train, X_val, y_val, label_names, run_name, output_dir, mlflow_run,
                  epoch_callback, rank=None) -> Optional[TrainResult]:
        """The training loop on prepared arrays: one process (``rank``
        None), or one rank of a data-parallel group. Every rank builds the
        same epoch batches and takes its contiguous rows of each step; DDP
        reduces the gradients, the BatchNorm moments and the dropout masks
        are the global batch's. Validation, early stopping, the LR plateau,
        checkpoints, tracking, ``epoch_callback`` and the bundle are rank 0's;
        its decisions reach the other ranks by broadcast, and they return
        None."""
        world = rank.world if rank is not None else 1
        root = rank is None or rank.rank == 0
        if rank is not None:
            self.device = rank.device
            if getattr(self, "_teacher_logits", None) is not None:
                self._teacher_logits = self._teacher_logits.to(self.device)
        self.prepare_fit(X_train, len(label_names))
        net = self._net
        trained = [(k, p) for k, p in net.named_parameters() if p.requires_grad]
        optimizer = torch.optim.Adam([p for _, p in trained], lr=self.learning_rate, betas=(0.9, 0.999), eps=1e-8)

        n = len(X_train)
        bs = min(self.batch_size, max(n, 1))
        # minibatches split evenly over the ranks
        bs = -(-bs // world) * world
        steps = max(1, -(-n // bs))
        local = slice(rank.rank * (bs // world), (rank.rank + 1) * (bs // world)) if rank is not None else slice(None)
        best_val_loss = float("inf")
        best_state = {k: v.detach().clone() for k, v in net.state_dict().items()}
        patience_es, patience_lr = 10, 5
        es_wait = lr_wait = 0
        current_lr = self.learning_rate
        prev_lr = current_lr
        np_rng = np.random.default_rng(self.seed)
        stopped_epoch = self.epochs
        start_epoch = 0

        # mid-training checkpoint/resume: opt-in with checkpoint_dir; resume
        # (default on) restores the state of the last checkpointed epoch
        checkpoint_dir = self._extra.get("checkpoint_dir")
        checkpoint_every = int(self._extra.get("checkpoint_every", 1))
        resume = bool(self._extra.get("resume", True))
        ckpt_path = Path(checkpoint_dir) / "train_state.npz" if checkpoint_dir else None
        if ckpt_path is not None and resume:
            restored = load_train_state(ckpt_path, {"params": net.state_dict(), "best": best_state}, optimizer,
                                        dict(net.named_parameters()))
            if restored is not None:
                states, meta = restored
                net.load_state_dict(states["params"])
                best_state = states["best"]
                start_epoch = int(meta["epoch"]) + 1
                current_lr = float(meta["lr"])
                best_val_loss = float(meta["best_val_loss"])
                es_wait, lr_wait = int(meta["es_wait"]), int(meta["lr_wait"])
                np_rng = np.random.default_rng(self.seed + start_epoch)
                logger.info("[%s] resumed from %s at epoch %d", self.name, ckpt_path, start_epoch)

        # the training set moves to the device once; steps gather on device
        X_train_d = torch.from_numpy(X_train).to(self.device, self.dtype)
        y_train_d = torch.from_numpy(y_train.astype(np.int64)).to(self.device)
        # the dropout masks of each global batch, drawn alike on every rank
        noise = GlobalBatchNoise(torch.Generator(self.device).manual_seed(self.seed + start_epoch), world,
                                 rank.rank if rank is not None else 0)
        if world > 1:
            import torch.distributed as dist

            from ..parallel.mesh import ddp

            sync_batch_norms(net, dist.group.WORLD)
            self._ddp = ddp(net, self.device)
        try:
            for epoch in range(start_epoch, self.epochs):
                perm = np_rng.permutation(n)
                for group in optimizer.param_groups:
                    group["lr"] = current_lr
                idx_mat, w_mat = self._epoch_batches(perm, steps, bs)
                idx_d = torch.from_numpy(idx_mat[:, local].astype(np.int64)).to(self.device)
                w_d = torch.from_numpy(w_mat[:, local]).to(self.device, self.dtype)
                wsum = torch.from_numpy(w_mat.sum(axis=1)).to(self.device, self.dtype) if world > 1 else [None] * steps
                net.train()
                stats = torch.stack([torch.stack(self.train_step(optimizer, X_train_d, y_train_d, idx_d[s], w_d[s],
                                                                 wsum[s], noise, world))
                                     for s in range(steps)])
                net.eval()
                if world > 1:   # a rank's (loss, acc) is its rows' share of the global batch's
                    dist.all_reduce(stats)
                ep_loss, ep_acc = (float(v) for v in stats.mean(dim=0).cpu())

                stop = False
                if root:
                    val_logits = self._batched_logits(X_val)
                    shifted = val_logits - val_logits.max(axis=-1, keepdims=True)
                    log_probs = shifted - np.log(np.exp(shifted).sum(axis=-1, keepdims=True))
                    val_loss = float(np.mean(-np.take_along_axis(log_probs, y_val[:, None], axis=1)))
                    val_acc = float((val_logits.argmax(-1) == y_val).mean())

                    log_epoch = epoch + getattr(self, "_log_epoch_offset", 0)
                    logs = {"loss": ep_loss, "accuracy": ep_acc, "val_loss": val_loss, "val_accuracy": val_acc}
                    if mlflow_run is not None:
                        for k, v in logs.items():
                            mlflow_run.log_metric(k, v, step=log_epoch)
                    lr_tag = f"  lr={current_lr:.2e}v" if current_lr < prev_lr - 1e-12 else ""
                    prev_lr = current_lr
                    logger.info(
                        "[%s] Epoch %3d/%d  loss=%.4f  acc=%.4f  val_loss=%.4f  val_acc=%.4f%s",
                        self.name, epoch + 1, self.epochs, ep_loss, ep_acc, val_loss, val_acc, lr_tag,
                    )

                    # EarlyStopping(restore_best) + ReduceLROnPlateau, host-side. The
                    # best state is a copy: Adam updates the live tensors in place.
                    if val_loss < best_val_loss - 1e-12:
                        best_val_loss = val_loss
                        best_state = {k: v.detach().clone() for k, v in net.state_dict().items()}
                        es_wait = lr_wait = 0
                    else:
                        es_wait += 1
                        lr_wait += 1
                        if lr_wait >= patience_lr and current_lr > 1e-6:
                            current_lr = max(current_lr * 0.5, 1e-6)
                            lr_wait = 0
                        if es_wait >= patience_es:
                            stopped_epoch, stop = epoch + 1, True
                            logger.info("[%s] Early stopped at epoch %d/%d", self.name, epoch + 1, self.epochs)
                    if not stop and ckpt_path is not None and (epoch + 1) % checkpoint_every == 0:
                        save_train_state(ckpt_path, {"params": net.state_dict(), "best": best_state}, optimizer,
                                         dict(net.named_parameters()),
                                         {"epoch": epoch, "lr": current_lr, "best_val_loss": best_val_loss,
                                          "es_wait": es_wait, "lr_wait": lr_wait})
                    if not stop and epoch_callback is not None and epoch_callback(log_epoch, logs):
                        stopped_epoch, stop = epoch + 1, True
                        logger.info("[%s] Pruned at epoch %d/%d", self.name, epoch + 1, self.epochs)
                if world > 1:   # rank 0's decisions: stop, and the next epoch's learning rate
                    flags = torch.tensor([float(stop), current_lr], dtype=torch.float64, device=self.device)
                    dist.broadcast(flags, 0)
                    stop, current_lr = bool(flags[0]), float(flags[1])
                if stop:
                    break
        finally:
            if world > 1:
                sync_batch_norms(net, None)
                self._ddp = None
        if not root:
            return None

        net.load_state_dict(best_state)
        net.eval()

        y_pred_val = self._batched_logits(X_val).argmax(-1)
        val_metrics = compute_metrics(y_val, y_pred_val, label_names=label_names)

        output_dir = Path(output_dir)
        output_dir.mkdir(parents=True, exist_ok=True)
        model_path = output_dir / MODEL_FILENAME
        self.save(model_path)
        model_size_kb = model_path.stat().st_size / 1024

        params_d = {
            "model": self.name,
            "stopped_epoch": stopped_epoch,
            "epochs": self.epochs,
            "batch_size": self.batch_size,
            "dropout": self.dropout,
            "learning_rate": self.learning_rate,
        }
        params_d.update({k: str(v) for k, v in self._architecture_params().items()})
        params_d.update({k: str(v) for k, v in self._extra.items()})

        save_classification_report(y_val, y_pred_val, label_names, output_dir / "classification_report.txt")
        save_confusion_matrix_png(val_metrics.get("confusion_matrix", []), label_names, output_dir / "confusion_matrix.png")
        save_model_info(output_dir, self.name, run_name, val_metrics, params_d, model_size_kb)
        val_metrics["model_size_kb"] = model_size_kb
        log_run_to_mlflow(mlflow_run, params_d, val_metrics, output_dir)
        if mlflow_run is not None:
            mlflow_run.log_artifact(model_path)

        return TrainResult(
            model_name=self.name,
            run_id=mlflow_run.info.run_id if mlflow_run else "",
            output_dir=output_dir,
            metrics=val_metrics,
            model_size_kb=model_size_kb,
            params=params_d,
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


def _fit_peer(rank, trainer: TorchTrainer, X_train: np.ndarray, y_train: np.ndarray, label_names: list[str]) -> None:
    """A data-parallel peer rank (``TorchTrainer.fit`` runs rank 0 in the
    calling process): the training loop on this rank's rows, no validation
    and nothing written."""
    trainer._fit_loop(X_train, y_train, None, None, label_names, None, None, None, None, rank)


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


@register_model
class MLPTrainer(TorchTrainer):
    name = "mlp"

    def __init__(self, hidden_units: Optional[list[int]] = None, **kwargs):
        super().__init__(**kwargs)
        self.hidden_units = hidden_units or [256, 128]

    def _architecture_params(self) -> dict:
        return {"hidden_units": self.hidden_units}

    def _prepare_input(self, X: np.ndarray) -> np.ndarray:
        # a dense stack takes flat vectors: ND features are flattened
        return self.flatten(X)

    def _arch(self, input_shape, n_classes):
        return {
            "type": "mlp", "hidden_units": list(self.hidden_units), "dropout": self.dropout,
            "n_classes": n_classes, "input_shape": list(input_shape),
        }


@register_model
class RNNTrainer(TorchTrainer):
    name = "rnn"

    def __init__(self, units: int = 128, n_layers: int = 1, **kwargs):
        super().__init__(**kwargs)
        self.units = units
        self.n_layers = n_layers

    def _architecture_params(self) -> dict:
        return {"units": self.units, "n_layers": self.n_layers}

    def _prepare_input(self, X: np.ndarray) -> np.ndarray:
        # axis 1 is time, the last axis features: an (n_mfcc, T) MFCC sequence is n_mfcc steps of T values
        if X.ndim == 2:
            return X[:, :, np.newaxis]
        return X

    def _arch(self, input_shape, n_classes):
        return {
            "type": "rnn", "units": self.units, "n_layers": self.n_layers,
            "dropout": self.dropout, "n_classes": n_classes, "input_shape": list(input_shape),
        }


@register_model
class DSCNNTrainer(TorchTrainer):
    """Depthwise-separable CNN with BatchNorm: the keyword-spotting edge
    architecture, whose bundle exercises every generated C kernel (dwconv,
    avgpool, batchnorm, 1x1 conv)."""

    name = "ds_cnn"

    def __init__(self, filters=None, first_stride: int = 2, pool: str = "avg", batch_norm: bool = True, **kwargs):
        super().__init__(**kwargs)
        self.filters = list(filters) if filters else [32, 32, 64]
        self.first_stride = first_stride
        self.pool = pool
        self.batch_norm = batch_norm

    def _architecture_params(self) -> dict:
        return {"filters": self.filters, "first_stride": self.first_stride, "pool": self.pool,
                "batch_norm": self.batch_norm}

    def _prepare_input(self, X: np.ndarray) -> np.ndarray:
        if X.ndim == 2:
            return X[:, :, np.newaxis]
        if X.ndim == 3:
            return X[:, :, :, np.newaxis]
        return X

    def _arch(self, input_shape, n_classes):
        return {
            "type": "ds_cnn", "filters": list(self.filters), "dropout": self.dropout,
            "n_classes": n_classes, "first_stride": self.first_stride,
            "pool": self.pool, "batch_norm": self.batch_norm,
            "input_shape": list(input_shape),
        }


@register_model
class TransformerTrainer(TorchTrainer):
    name = "transformer"

    def __init__(self, num_heads: int = 4, ff_dim: int = 128, n_blocks: int = 2, **kwargs):
        super().__init__(**kwargs)
        self.num_heads = num_heads
        self.ff_dim = ff_dim
        self.n_blocks = n_blocks

    def _architecture_params(self) -> dict:
        return {"num_heads": self.num_heads, "ff_dim": self.ff_dim, "n_blocks": self.n_blocks}

    def _prepare_input(self, X: np.ndarray) -> np.ndarray:
        # axis 1 is the sequence, the last axis the features (as the rnn)
        if X.ndim == 2:
            return X[:, :, np.newaxis]
        return X

    def _arch(self, input_shape, n_classes):
        return {
            "type": "transformer", "num_heads": self.num_heads, "ff_dim": self.ff_dim,
            "n_blocks": self.n_blocks, "dropout": self.dropout,
            "n_classes": n_classes, "input_shape": list(input_shape),
        }


@register_model
class EfficientNetTeacherTrainer(TorchTrainer):
    """EfficientNet-B0 teacher on spectrograms, fine-tuned in two phases:
    phase 1 trains the head alone (every other parameter frozen, which
    leaves them as JAX's zeroed gradients do under Adam: bit for bit) at the
    full lr for ``warmup_epochs``; phase 2 trains everything at lr x
    ``fine_tune_lr_factor``, warm-started from phase 1's bundle, its metric
    steps after phase 1's and its checkpoints in ``<checkpoint_dir>/phase2``
    (phase 1's in ``phase1``). ImageNet weights cannot be fetched: the
    backbone starts random unless ``pretrained_model`` names a converted
    checkpoint. ``unfreeze_layers`` is advisory (phase 2 unfreezes the whole
    backbone); ``target_w`` is accepted for configs (the image is square,
    ``image_size`` or ``target_h``)."""

    name = "efficientnet_teacher"

    def __init__(self, warmup_epochs: int = 5, image_size: Optional[int] = None,
                 unfreeze_layers: Optional[int] = None, fine_tune_lr_factor: float = 0.1,
                 target_h: Optional[int] = None, target_w: Optional[int] = None, **kwargs):
        super().__init__(**kwargs)
        self.warmup_epochs = warmup_epochs
        self.image_size = int(image_size if image_size is not None else (target_h or 224))
        self.unfreeze_layers = unfreeze_layers
        self.fine_tune_lr_factor = float(fine_tune_lr_factor)
        self._head_only = False

    def _architecture_params(self) -> dict:
        return {"warmup_epochs": self.warmup_epochs, "image_size": self.image_size,
                "fine_tune_lr_factor": self.fine_tune_lr_factor}

    def _prepare_input(self, X: np.ndarray) -> np.ndarray:
        if X.ndim == 3:
            return X[:, :, :, np.newaxis]
        return X

    def _arch(self, input_shape, n_classes):
        return {
            "type": "efficientnet_teacher", "dropout": self.dropout, "n_classes": n_classes,
            "image_size": self.image_size, "input_shape": list(input_shape),
            "act": "silu",  # arch revision marker (check_teacher_revision)
        }

    def prepare_fit(self, X_train: np.ndarray, n_classes: int) -> None:
        super().prepare_fit(X_train, n_classes)
        if getattr(self, "_head_only", False):
            for name, p in self._net.named_parameters():
                p.requires_grad_(name.startswith("head."))

    def fit(self, X_train, y_train, X_val, y_val, label_names, run_name, output_dir, mlflow_run, epoch_callback=None):
        total, base_lr = self.epochs, self.learning_rate
        base_ckpt = self._extra.get("checkpoint_dir")
        if not self._extra.get("pretrained_model"):
            logger.warning(
                "efficientnet_teacher: backbone starts RANDOM-INIT: ImageNet weights are unavailable offline, "
                "while the reference warm-starts from ImageNet (models/backbones.py). Convert a real checkpoint "
                "(tools/convert_backbone_weights.py --arch efficientnet_b0 --prefix backbone --bundle) and pass "
                "--param pretrained_model=<bundle.npz> to warm-start."
            )
        self.epochs = min(self.warmup_epochs, total)
        self._head_only = True
        self._log_epoch_offset = 0
        if base_ckpt:
            self._extra["checkpoint_dir"] = str(Path(base_ckpt) / "phase1")
        try:
            result = super().fit(X_train, y_train, X_val, y_val, label_names, run_name, output_dir, mlflow_run,
                                 epoch_callback)
            if total > self.warmup_epochs:
                self._head_only = False
                self.epochs = total - self.warmup_epochs
                self.learning_rate = base_lr * self.fine_tune_lr_factor
                self._log_epoch_offset = self.warmup_epochs
                if base_ckpt:
                    self._extra["checkpoint_dir"] = str(Path(base_ckpt) / "phase2")
                self._extra["pretrained_model"] = str(Path(output_dir) / MODEL_FILENAME)
                result = super().fit(X_train, y_train, X_val, y_val, label_names, run_name, output_dir, mlflow_run,
                                     epoch_callback)
        finally:
            self.epochs, self.learning_rate = total, base_lr
            self._head_only, self._log_epoch_offset = False, 0
            if base_ckpt:
                self._extra["checkpoint_dir"] = base_ckpt
        return result


def kd_row_losses(logits: torch.Tensor, y: torch.Tensor, teacher_logits: torch.Tensor, temperature: float,
                  alpha: float) -> torch.Tensor:
    """Per-row distillation loss: alpha T^2 KL(softmax(t / T) || the
    student's log_softmax(s / T)), with log(t_soft + 1e-12), plus
    (1 - alpha) cross-entropy."""
    t_soft = torch.softmax(teacher_logits / temperature, dim=-1)
    s_logsoft = torch.log_softmax(logits / temperature, dim=-1)
    kl = (t_soft * (torch.log(t_soft + 1e-12) - s_logsoft)).sum(-1)
    return alpha * temperature ** 2 * kl + (1 - alpha) * F.cross_entropy(logits, y, reduction="none")


@register_model
class DistillationCNNTrainer(TorchTrainer):
    """Tiny CNN student (``CNNModule``) distilled from a teacher's soft
    targets: the teacher (any bundle ``load_any_model`` reads, a JAX-trained
    one too) predicts the training rows once, its probabilities become
    pseudo-logits log(p + 1e-8), and each step gathers them by the batch's
    row indices (``kd_row_losses``; T 4.0, alpha 0.7). Without a teacher it
    trains with plain cross-entropy, and says so."""

    name = "distillation_cnn"

    def __init__(self, filters=None, teacher_model: Optional[str] = None, temperature: float = _KD_TEMPERATURE,
                 alpha: float = _KD_ALPHA, teacher_model_path: Optional[str] = None, **kwargs):
        super().__init__(**kwargs)
        self.filters = list(filters) if filters else [16, 16, 16]
        self.teacher_model = teacher_model or teacher_model_path
        self.temperature = temperature
        self.alpha = alpha
        self._teacher_logits: Optional[torch.Tensor] = None

    def _architecture_params(self) -> dict:
        return {"filters": self.filters, "temperature": self.temperature, "alpha": self.alpha,
                "teacher_model": self.teacher_model}

    def _prepare_input(self, X: np.ndarray) -> np.ndarray:
        if X.ndim == 3:
            return X[:, :, :, np.newaxis]
        return X

    def _arch(self, input_shape, n_classes):
        return {
            "type": "distillation_cnn", "filters": list(self.filters), "dropout": self.dropout,
            "n_classes": n_classes, "input_shape": list(input_shape),
        }

    def set_teacher_logits(self, teacher_logits: Optional[np.ndarray]) -> None:
        """The teacher's pseudo-logits of the training rows (None: plain CE)."""
        self._teacher_logits = (None if teacher_logits is None else
                                torch.from_numpy(np.asarray(teacher_logits, np.float32)).to(self.device))

    def _row_losses(self, logits, y, idx):
        if getattr(self, "_teacher_logits", None) is None or idx is None:
            return super()._row_losses(logits, y, idx)
        return kd_row_losses(logits, y, self._teacher_logits.index_select(0, idx), self.temperature, self.alpha)

    def fit(self, X_train, y_train, X_val, y_val, label_names, run_name, output_dir, mlflow_run, epoch_callback=None):
        if self.teacher_model:
            teacher = load_any_model(Path(self.teacher_model), device=self.device)
            self.set_teacher_logits(np.log(teacher.predict_proba(X_train) + 1e-8))
        else:
            logger.warning("distillation_cnn without teacher_model: training with plain CE")
            self.set_teacher_logits(None)
        return super().fit(X_train, y_train, X_val, y_val, label_names, run_name, output_dir, mlflow_run,
                           epoch_callback)
