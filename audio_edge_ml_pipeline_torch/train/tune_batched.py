"""Batched deep-trial tuning: TPE trials trained together on the device.

Counterpart of the JAX package's ``train/tune_batched.py``:

- the Study runs ask-tell in rounds of ``tune_parallel`` trials: k parameter
  sets are drawn from the current TPE posterior (running trials are
  invisible to the sampler: standard batch TPE);
- drawn trials are grouped by SHAPE SIGNATURE (filters / strides /
  batch_size / every knob that changes the module or the batches). Within a
  group, learning_rate and dropout are tensors with one value a trial: the
  k trials' parameters are stacked on a leading trial axis and trained as
  one program (``TrialGroup``). The cnn, mlp, ds_cnn and transformer run
  the k trials through ``torch.func.vmap`` over ``functional_call``, with
  dropout at each trial's rate (``models/deep.py::runtime_dropout``) and
  different masks a trial; cuDNN's LSTM has no vmap batching rule, so the
  rnn runs its k trials one after another inside each step. Either way one
  backward pass and one Adam update (optax's ``scale_by_adam``, then
  ``-lr * update``, written over the stacked tensors) serve the whole
  group. The ds_cnn's BatchNorm statistics are stacked state like the
  parameters: each step's forward pass returns the updated ones
  (``models/layers.py::BatchNorm``) and they replace the old, as JAX
  threads its ``batch_stats`` through ``vmap``;
- per-epoch validation accuracy is reported to the pruner per trial (pruned
  trials stop counting; the group keeps its wall clock);
- the best trial is REFIT through the normal trainer's ``fit`` by the tune
  CLI, so its artifacts are those of the sequential path.

Initial weights come from one ``torch.Generator`` a trial, seeded ``seed +
i`` (flax's initializers, ``models/deep.py::init_weights_``); JAX's
``jax.random`` init is not reproduced. Every trial trains on one card: JAX
shards the trial axis over several devices when asked; here that raises
where more than one card is visible (multi-card sharding is not ported
yet).

Divergence from the sequential path (as in JAX): trial VALUES come from the
final sweep epoch without early stopping; the winner's metrics come from
the full refit.
"""

from __future__ import annotations

import json
import logging
import warnings
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import functional_call, vmap

from ..models.deep import _MODULE_FACTORY, init_weights_
from ..utils.device import resolve_device
from .evaluate import f1_macro
from .search_cv import check_single_card

logger = logging.getLogger(__name__)

# knobs trained as tensors with one value a trial inside one program
VMAPPED = ("learning_rate", "dropout")
# model families whose modules take a runtime dropout_rate
BATCHABLE_MODELS = {"cnn", "mlp", "ds_cnn", "rnn", "transformer"}
# families whose group runs its trials one after another inside each step
# (aten::lstm has no vmap batching rule)
_LOOPED = {"rnn"}
_ADAM_B1, _ADAM_B2, _ADAM_EPS = 0.9, 0.999, 1e-8   # optax.scale_by_adam's defaults
_EVAL_ROWS = 512   # validation rows a forward call


def shape_key(params: dict) -> tuple:
    """Hashable signature of every shape-affecting knob. `epochs` is
    excluded like the vmapped knobs: every sweep trial trains sweep_epochs
    regardless (a sampled epochs applies only after the study), so it must
    not split otherwise-identical trials into separate groups."""
    return tuple(sorted((k, json.dumps(v, sort_keys=True))
                        for k, v in params.items() if k not in VMAPPED and k != "epochs"))


def _group_norm_stats(X: np.ndarray):
    axes = tuple(range(X.ndim - 1))
    mean = X.mean(axis=axes).astype(np.float32)
    std = np.sqrt(X.var(axis=axes) + 1e-6).astype(np.float32)
    return mean, std


class _Runner:
    """One architecture's group forward: a skeleton module on ``device``,
    called through ``functional_call`` on stacked parameters (k, ...)."""

    def __init__(self, arch: dict, device: torch.device):
        self.module = _MODULE_FACTORY[arch["type"]](arch).to(device)
        self.trainable = {n for n, p in self.module.named_parameters() if p.requires_grad}
        self.looped = arch["type"] in _LOOPED
        self._batched = vmap(self._one, in_dims=(0, 0, None), randomness="different")

    def _one(self, params: dict, rate: torch.Tensor, x: torch.Tensor) -> tuple[torch.Tensor, dict]:
        stats: dict[str, torch.Tensor] = {}
        logits = functional_call(self.module, params, (x,), {"dropout_rate": rate, "stats": stats})
        return logits, stats

    def forward(self, params: dict, rates: torch.Tensor, x: torch.Tensor,
                train: bool) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
        """(k, B, n_classes) logits of every trial on the shared batch x, and
        in train mode the trials' updated BatchNorm statistics, (k, ...) a
        buffer (none for the families without BatchNorm)."""
        self.module.train(train)
        if not self.looped:
            return self._batched(params, rates, x)
        with warnings.catch_warnings():   # cuDNN: the sliced weights are not one flattened buffer
            warnings.simplefilter("ignore", UserWarning)
            outs = [self._one({n: p[i] for n, p in params.items()}, rates[i], x) for i in range(len(rates))]
        return torch.stack([o[0] for o in outs]), {k: torch.stack([o[1][k] for o in outs]) for k in outs[0][1]}

    def logits(self, params: dict, rates: torch.Tensor, x: torch.Tensor, train: bool) -> torch.Tensor:
        """(k, B, n_classes) logits of every trial on the shared batch x."""
        return self.forward(params, rates, x, train)[0]


# runners cached by architecture and device: a shape group seen in a later
# ask-tell round (or a second study) reuses its skeleton module
_RUNNER_CACHE: dict = {}


def _get_runner(arch_json: str, device: torch.device) -> _Runner:
    key = (arch_json, str(device))
    if key not in _RUNNER_CACHE:
        _RUNNER_CACHE[key] = _Runner(json.loads(arch_json), device)
    return _RUNNER_CACHE[key]


def init_states(arch: dict, k: int, seed: int) -> list[dict[str, torch.Tensor]]:
    """k initial state_dicts of ``arch``: flax's initializers, trial i from
    ``torch.Generator().manual_seed(seed + i)``."""
    states = []
    for i in range(k):
        net = _MODULE_FACTORY[arch["type"]](arch)
        init_weights_(net, torch.Generator().manual_seed(seed + i))
        states.append({n: t.detach().clone() for n, t in net.state_dict().items()})
    return states


class TrialGroup:
    """k trials of one architecture trained as one program: their stacked
    parameters, Adam moments, learning rates and dropout rates, a trial a
    row. ``states``: one state_dict a trial (``init_states``, or weights
    carried in with ``models/deep.py::params_from_flax``). ``dtype``:
    float32, as the trainers train; float64 holds two devices to each other
    over many steps (in float32 Adam lifts roundoff on near-zero gradients
    to whole steps, and an epoch diverges from itself under a 1e-7 change
    of its input)."""

    def __init__(self, arch: dict, states: list[dict[str, torch.Tensor]], lrs, rates, device=None,
                 dtype: torch.dtype = torch.float32):
        self.device = resolve_device(device)
        self.runner = _get_runner(json.dumps(arch, sort_keys=True), self.device)
        self.k = len(states)
        self.params = {n: torch.stack([st[n] for st in states]).to(self.device, dtype)
                       .requires_grad_(n in self.runner.trainable) for n in states[0]}
        self.lrs = torch.as_tensor(np.asarray(lrs)).to(self.device, dtype)
        self.rates = torch.as_tensor(np.asarray(rates)).to(self.device, dtype)
        self._mu = {n: torch.zeros_like(p) for n, p in self.params.items() if p.requires_grad}
        self._nu = {n: torch.zeros_like(mu) for n, mu in self._mu.items()}
        self._count = 0

    def _adam(self) -> None:
        """optax ``scale_by_adam()`` (bias-corrected moments) followed by
        ``-lr * update``, each trial at its own lr."""
        self._count += 1
        c1, c2 = 1.0 - _ADAM_B1 ** self._count, 1.0 - _ADAM_B2 ** self._count
        with torch.no_grad():
            for n, mu in self._mu.items():
                p, g, nu = self.params[n], self.params[n].grad, self._nu[n]
                mu.mul_(_ADAM_B1).add_((1.0 - _ADAM_B1) * g)
                nu.mul_(_ADAM_B2).add_((1.0 - _ADAM_B2) * (g * g))
                update = (mu / c1) / (torch.sqrt(nu / c2) + _ADAM_EPS)
                p.sub_(self.lrs.view(-1, *[1] * (p.dim() - 1)) * update)
                p.grad = None

    def step(self, xb: torch.Tensor, yb: torch.Tensor) -> torch.Tensor:
        """One Adam step of every trial on the shared batch; (k,) losses, the
        mean cross-entropy of each trial's batch, left on the device."""
        logits, stats = self.runner.forward(self.params, self.rates, xb, train=True)   # (k, B, C)
        losses = F.cross_entropy(logits.flatten(0, 1), yb.repeat(self.k), reduction="none").view(self.k, -1).mean(1)
        losses.sum().backward()   # each trial's loss reaches only its own slice
        self._adam()
        self.params.update(stats)
        return losses.detach()

    def epoch(self, X: torch.Tensor, y: torch.Tensor, idx_mat: np.ndarray) -> torch.Tensor:
        """A step for each row of ``idx_mat`` (steps, bs) over the
        device-resident (X, y); (k,) mean losses, left on the device."""
        idx_d = torch.from_numpy(np.asarray(idx_mat, np.int64)).to(self.device)
        return torch.stack([self.step(X.index_select(0, idx), y.index_select(0, idx)) for idx in idx_d]).mean(0)

    def logits(self, X: torch.Tensor) -> np.ndarray:
        """(k, N, n_classes) evaluation logits (no dropout) on the host."""
        with torch.no_grad():
            return torch.cat([self.runner.logits(self.params, self.rates, X[s : s + _EVAL_ROWS], train=False)
                              for s in range(0, len(X), _EVAL_ROWS)], dim=1).cpu().numpy()


def train_trial_group(
    model_name: str,
    draws: list[dict],
    X_train: np.ndarray,
    y_train: np.ndarray,
    X_val: np.ndarray,
    y_val: np.ndarray,
    n_classes: int,
    sweep_epochs: int,
    seed: int = 42,
    devices: int = 1,
    epoch_cb: Optional[Callable[[int, int, float], bool]] = None,
    device=None,
) -> list[dict]:
    """Train all ``draws`` (same shape signature) as one TrialGroup on
    ``device`` (the first CUDA card unless the caller passes
    ``device="cpu"``).

    epoch_cb(trial_index, epoch, val_accuracy) is a pure observation hook
    (its return value is ignored): the group always trains to sweep_epochs,
    so callers track pruning decisions themselves; run_study_batched
    records should_prune() verdicts in a set and tells the study afterwards.

    Returns one dict per trial: {val_accuracy, val_f1_macro, history}.
    """
    from ..models import get_model

    device = resolve_device(device)
    check_single_card("trial-batched tuning (tune_parallel)", devices, device)
    k = len(draws)
    proto = get_model(model_name)(
        epochs=sweep_epochs, device=device, **{kk: v for kk, v in draws[0].items() if kk != "epochs"}
    )
    X = proto._prepare_input(np.asarray(X_train)).astype(np.float32)
    Xv = proto._prepare_input(np.asarray(X_val)).astype(np.float32)
    y = np.asarray(y_train).astype(np.int64)
    yv = np.asarray(y_val).astype(np.int32)
    mean, std = _group_norm_stats(X)
    X = (X - mean) / std
    Xv = (Xv - mean) / std

    # the module's own dropout is never used (every call passes a runtime
    # rate): pin it, so draws that differ only in dropout share one runner
    arch = {**proto._arch(X.shape[1:], n_classes), "dropout": 0.0}
    group = TrialGroup(
        arch, init_states(arch, k, seed),
        [float(d.get("learning_rate", proto.learning_rate)) for d in draws],
        [float(d.get("dropout", proto.dropout)) for d in draws], device,
    )

    n = len(X)
    bs = min(proto.batch_size, n)
    steps = max(1, n // bs)
    Xd, yd = torch.from_numpy(X).to(device), torch.from_numpy(y).to(device)
    Xvd = torch.from_numpy(Xv).to(device)
    np_rng = np.random.default_rng(seed)
    history: list[np.ndarray] = []
    for epoch in range(sweep_epochs):
        perm = np_rng.permutation(n)
        group.epoch(Xd, yd, perm[: steps * bs].reshape(steps, bs))
        accs = (group.logits(Xvd).argmax(-1) == yv[None, :]).mean(axis=1)
        history.append(accs)
        if epoch_cb is not None:
            for i in range(k):
                epoch_cb(i, epoch, float(accs[i]))

    preds = group.logits(Xvd).argmax(-1)   # (k, Nv); the untrained init when sweep_epochs == 0
    hist = np.stack(history) if history else np.zeros((0, k))  # (epochs, k)
    return [{
        "val_accuracy": float((preds[i] == yv).mean()),
        "val_f1_macro": f1_macro(yv, preds[i]),
        "history": hist[:, i].tolist(),
    } for i in range(k)]


def run_study_batched(
    study,
    search_space: dict,
    fixed: dict,
    sample_fn: Callable,
    model_name: str,
    X_train, y_train, X_val, y_val,
    n_classes: int,
    n_trials: int,
    sweep_epochs: int,
    batch_k: int,
    seed: int = 42,
    devices: int = 1,
    device=None,
) -> dict[int, dict]:
    """Drive the Study with ask-tell rounds of ``batch_k`` trials. Returns
    {trial_number: {params, val_accuracy, val_f1_macro, history}} for
    completed trials; the study's states (COMPLETE / PRUNED / FAIL, values)
    are updated in place. A group that raises is logged and its trials are
    marked FAIL, as in JAX."""
    from . import search

    results: dict[int, dict] = {}
    done = 0
    while done < n_trials:
        k = min(batch_k, n_trials - done)
        trials = [study.ask() for _ in range(k)]
        draws = [{**fixed, **(sample_fn(t, search_space) if search_space else {})}
                 for t in trials]
        groups: dict[tuple, list[int]] = {}
        for i, d in enumerate(draws):
            groups.setdefault(shape_key(d), []).append(i)
        logger.info("batch of %d trial(s) in %d shape group(s)", k, len(groups))
        for members in groups.values():
            pruned = set()

            def epoch_cb(local_i, epoch, acc, members=members, trials=trials, pruned=pruned):
                t = trials[members[local_i]]
                t.report(acc, step=epoch)
                if t.should_prune():
                    pruned.add(members[local_i])
                return False

            group_draws = [draws[i] for i in members]
            try:
                metrics = train_trial_group(
                    model_name, group_draws, X_train, y_train, X_val, y_val,
                    n_classes, sweep_epochs, seed=seed, devices=devices,
                    epoch_cb=epoch_cb, device=device,
                )
            except Exception as exc:
                logger.warning("trial group failed: %s", exc)
                for i in members:
                    study.tell(trials[i], state=search.TrialState.FAIL)
                continue
            for local_i, i in enumerate(members):
                if i in pruned:
                    study.tell(trials[i], state=search.TrialState.PRUNED)
                else:
                    study.tell(trials[i], value=metrics[local_i]["val_f1_macro"])
                    results[trials[i].number] = {"params": draws[i], **metrics[local_i]}
        done += k
    return results
