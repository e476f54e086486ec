"""Deep trainers in PyTorch: the ``cnn``, ``mlp`` and ``rnn`` models,
inference and bundle I/O.

Counterpart of the JAX package's ``models/deep.py``. Ported so far: the CNN
module (``CNNModule``, NHWC at its boundary like the flax one), the dense
stack (``MLPModule``), the stacked bidirectional LSTM (``BiLSTMModule``),
the ``.npz`` bundle format, pretrained warm start, and ``CNNTrainer``,
``MLPTrainer`` and ``RNNTrainer``: training (``fit``, with the semantics of
``FlaxTrainer.fit``), inference and ``save``. The other families,
data-parallel training and checkpoint/resume are still to be ported.

Training semantics carried over: input normalization stats over all axes
but the last, computed in numpy; the weighted masked cross-entropy of
wrap-around padded batches; Adam with optax's defaults, its learning rate
set per epoch; EarlyStopping(val_loss, patience=10, restore best);
ReduceLROnPlateau(0.5, patience=5, min_lr=1e-6); per-epoch metrics to the
tracking run. Convolutions and LSTMs run in cuDNN and gradients through
autograd, as the JAX package leaves them to XLA; no hand kernel is on this
path.

Bundles keep the flax key layout, so the JAX package and its C codegen read
what the port writes and the other way round: ``p/Conv_i/{kernel,bias}``
with HWIO kernels, ``p/Dense_i/{kernel,bias}`` with (in, out) kernels, and
``p/OptimizedLSTMCell_c/{ii,if,ig,io}/kernel`` (in, units) with
``{hi,hf,hg,ho}/{kernel,bias}`` (units, units) for the forward (c = 2 i)
and backward (c = 2 i + 1) cell of LSTM layer i. ``params_from_flax`` and
``params_to_flax`` convert between that layout and a torch ``state_dict``
(OIHW conv weights, (out, in) linear weights, one bidirectional
``nn.LSTM`` a layer with its gates stacked i, f, g, o). flax's cell has one
bias a gate, on the recurrent side: ``bias_hh`` carries it, and ``bias_ih``
stays zero and out of the optimizer (two trained biases would move their sum
twice as fast under Adam, and the bundle could not hold them).
"""

from __future__ import annotations

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
from ..utils.device import resolve_device
from .base import BaseTrainer, TrainResult
from .registry import register_model

logger = logging.getLogger(__name__)

# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------


def runtime_dropout(x: torch.Tensor, rate, training: bool) -> torch.Tensor:
    """Inverted dropout at a rate given at run time (a float or a tensor; one
    per trial under ``torch.func.vmap``), as the JAX package's ``_dropout``:
    ``nn.Dropout``'s rate is fixed module state, and the batched trial
    trainer (``train/tune_batched.py``) trains trials of different rates as
    one program."""
    if not training:
        return x
    keep = 1.0 - rate if torch.is_tensor(rate) else torch.tensor(1.0 - rate, dtype=x.dtype, device=x.device)
    return torch.where(torch.rand_like(x) < keep, x / keep.clamp_min(1e-6), 0.0)


def same_padding(size: int, stride: int, kernel: int = 3) -> tuple[int, int]:
    """(before, after) padding of flax/TF ``padding="SAME"``: the output has
    ceil(size / stride) positions and any odd padding goes after, so a
    strided layer can pad 0 before and 1 after."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class _RuntimeDropoutModule(nn.Module):
    """``_drop``: the module's own ``nn.Dropout``, or ``runtime_dropout`` at
    the rate a forward call gives."""

    def _drop(self, x: torch.Tensor, rate) -> torch.Tensor:
        return self.dropout(x) if rate is None else runtime_dropout(x, rate, self.training)


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

    def forward(self, x: torch.Tensor, dropout_rate=None) -> torch.Tensor:
        """``dropout_rate`` (optional) replaces the module's own rate."""
        x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW
        for conv, stride in zip(self.convs, self.strides):
            top, bottom = same_padding(x.shape[2], stride)
            left, right = same_padding(x.shape[3], stride)
            x = F.relu(conv(F.pad(x, (left, right, top, bottom))))
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

    def forward(self, x: torch.Tensor, dropout_rate=None) -> torch.Tensor:
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

    def forward(self, x: torch.Tensor, dropout_rate=None) -> torch.Tensor:
        """``dropout_rate`` (optional) replaces the module's own rate."""
        for lstm in self.lstms:
            x, _ = lstm(self._drop(x, dropout_rate))
        x = torch.cat([x[:, -1, : self.units], x[:, 0, self.units :]], dim=-1)
        x = self._drop(F.relu(self.denses[0](x)), dropout_rate)
        return self.denses[1](x)


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


_MODULE_FACTORY = {"cnn": _cnn_from_arch, "mlp": _mlp_from_arch, "rnn": _rnn_from_arch}

# ---------------------------------------------------------------------------
# Weight carry-over between the flax layout and torch state_dicts
# ---------------------------------------------------------------------------

_FLAX_TO_TORCH = {"Conv": "convs", "Dense": "denses"}
_TORCH_TO_FLAX = {v: k for k, v in _FLAX_TO_TORCH.items()}
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
    """Flax ``p/`` params -> torch state_dict: ``p/Conv_i/kernel`` (HWIO) ->
    ``convs.i.weight`` (OIHW), ``p/Dense_i/kernel`` (in, out) ->
    ``denses.i.weight`` (out, in), biases as they are, and the gates of
    ``p/OptimizedLSTMCell_c`` stacked into ``lstms.{c // 2}`` (module
    docstring). Keys other than ``p/`` (norm stats, ``c/`` collections) are
    ignored."""
    state = {}
    cells: dict[int, dict[str, torch.Tensor]] = {}
    for key, arr in flat.items():
        if not key.startswith("p/"):
            continue
        layer, *path = key[2:].split("/")
        family, index = layer.rsplit("_", 1)
        t = torch.tensor(np.asarray(arr, np.float32))
        if family == _LSTM_CELL:
            cells.setdefault(int(index), {})["/".join(path)] = t
            continue
        if family not in _FLAX_TO_TORCH or len(path) != 1:
            raise ValueError(f"no torch counterpart for flax parameter {key!r}")
        (kind,) = path
        if kind == "kernel":
            t = t.permute(3, 2, 0, 1) if t.ndim == 4 else t.T
            kind = "weight"
        state[f"{_FLAX_TO_TORCH[family]}.{index}.{kind}"] = t.contiguous()
    state.update(_lstm_from_flax(cells))
    return state


def params_to_flax(state: dict[str, torch.Tensor | None]) -> dict[str, np.ndarray]:
    """Inverse of ``params_from_flax``: torch state_dict (or the gradients of
    its parameters) -> flax ``p/`` keys. ``bias_ih`` has no flax key: it must
    be zero (a gradient of it, None)."""
    flat = {}
    for key, t in state.items():
        family, index, kind = key.split(".")
        if family == "lstms":
            what, side, reverse = _LSTM_PARAM.fullmatch(kind).groups()
            if what == "bias" and side == "ih":
                if t is not None and bool(t.detach().ne(0).any()):
                    raise ValueError(f"{key} is not zero: the flax layout has no input-side LSTM bias")
                continue
            c = 2 * int(index) + bool(reverse)
            for g, part in zip(_GATES, t.detach().cpu().to(torch.float32).chunk(4)):
                name = f"p/{_LSTM_CELL}_{c}/{side[0]}{g}/{'kernel' if what == 'weight' else 'bias'}"
                flat[name] = np.ascontiguousarray((part.T if what == "weight" else part).numpy())
            continue
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


def transfer_pretrained(flat: dict[str, np.ndarray], path: Path) -> tuple[dict[str, np.ndarray], int]:
    """By-name+shape warm start on the flax-layout flat dict: every key of
    ``flat`` that the bundle at ``path`` holds with the same shape takes the
    bundle's tensor; everything else (a resized head, the normalization
    stats) keeps its init. Returns (flat, n_params_transferred)."""
    _, donor, _, _ = load_model_bundle(Path(path))
    out = dict(flat)
    transferred = 0
    for k, v in flat.items():
        if k in donor and donor[k].shape == v.shape:
            out[k] = np.asarray(donor[k], np.float32)
            transferred += 1
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
    kernels, zero biases; an LSTM cell's input kernels lecun-normal and its
    recurrent ones orthogonal, gate by gate."""
    with torch.no_grad():
        for mod in net.modules():
            if isinstance(mod, (nn.Conv2d, nn.Linear)):
                w = torch.empty(mod.weight.shape, dtype=torch.float32)
                _lecun_normal_(w, mod.weight[0].numel(), generator)
                mod.weight.copy_(w)
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

    def _batch_loss(self, x: torch.Tensor, y: torch.Tensor, w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(loss, accuracy) of one padded batch: cross-entropy and hits
        weighted by ``w`` (0 on wrap-around padding rows) over max(sum w, 1)."""
        logits = self._net(self._normalize(x))
        wsum = torch.clamp_min(w.sum(), 1.0)
        loss = (F.cross_entropy(logits, y, reduction="none") * w).sum() / wsum
        acc = ((logits.detach().argmax(-1) == y).to(w.dtype) * w).sum() / wsum
        return loss, acc

    def train_step(self, optimizer: torch.optim.Optimizer, X: torch.Tensor, y: torch.Tensor,
                   idx: torch.Tensor, w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """One optimizer step on rows ``idx`` of the device-resident (X, y),
        weighted by ``w``; returns the batch's (loss, accuracy) on the device."""
        optimizer.zero_grad(set_to_none=True)
        loss, acc = self._batch_loss(X.index_select(0, idx), y.index_select(0, idx), w)
        loss.backward()
        optimizer.step()
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
        if self.data_parallel > 1:
            raise NotImplementedError(
                "data_parallel > 1 is not yet ported to audio_edge_ml_pipeline_torch (multi-GPU DDP)")
        if self._extra.get("checkpoint_dir"):
            raise NotImplementedError(
                "checkpoint_dir (mid-training checkpoint/resume) is not yet ported to audio_edge_ml_pipeline_torch")
        X_train = self._prepare_input(np.asarray(X_train)).astype(np.float32)
        X_val = self._prepare_input(np.asarray(X_val)).astype(np.float32)
        y_train = np.asarray(y_train).astype(np.int32)
        y_val = np.asarray(y_val).astype(np.int32)
        self.prepare_fit(X_train, len(label_names))
        net = self._net
        optimizer = torch.optim.Adam([p for p in net.parameters() if p.requires_grad], lr=self.learning_rate,
                                     betas=(0.9, 0.999), eps=1e-8)

        n = len(X_train)
        bs = min(self.batch_size, max(n, 1))
        steps = max(1, -(-n // bs))
        best_val_loss = float("inf")
        best_state = {k: v.detach().clone() for k, v in net.state_dict().items()}
        patience_es, patience_lr = 10, 5
        es_wait = lr_wait = 0
        current_lr = self.learning_rate
        prev_lr = current_lr
        np_rng = np.random.default_rng(self.seed)
        stopped_epoch = self.epochs

        # the training set moves to the device once; steps gather on device
        X_train_d = torch.from_numpy(X_train).to(self.device)
        y_train_d = torch.from_numpy(y_train.astype(np.int64)).to(self.device)

        for epoch in range(self.epochs):
            perm = np_rng.permutation(n)
            for group in optimizer.param_groups:
                group["lr"] = current_lr
            idx_mat, w_mat = self._epoch_batches(perm, steps, bs)
            idx_d = torch.from_numpy(idx_mat.astype(np.int64)).to(self.device)
            w_d = torch.from_numpy(w_mat).to(self.device)
            net.train()
            stats = torch.stack([torch.stack(self.train_step(optimizer, X_train_d, y_train_d, idx_d[s], w_d[s]))
                                 for s in range(steps)])
            net.eval()
            ep_loss, ep_acc = (float(v) for v in stats.mean(dim=0).cpu())

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
                    stopped_epoch = epoch + 1
                    logger.info("[%s] Early stopped at epoch %d/%d", self.name, epoch + 1, self.epochs)
                    break
            if epoch_callback is not None and epoch_callback(log_epoch, logs):
                stopped_epoch = epoch + 1
                logger.info("[%s] Pruned at epoch %d/%d", self.name, epoch + 1, self.epochs)
                break

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
