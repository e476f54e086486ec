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
  dropout at each trial's rate (``utils/dropout.py::runtime_dropout``) and
  each trial's masks from its own generator; cuDNN's LSTM has no vmap batching rule, so the
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
i`` (flax's initializers, ``models/deep.py::init_weights_``), and so do
the dropout masks (``train_trial_group`` seeds trial i's generator seed + 1
+ i, on the trial's device); JAX's ``jax.random`` streams are not reproduced. With
``devices`` > 1 the trials split over min(devices, cards, k) cards, as JAX
shards its trial axis (``parallel/mesh.py::part_devices``; a list of
devices names them outright): each part is a ``TrialGroup`` on its card,
every part's epoch issued before any is fetched. A trial's weights and
masks follow the trial, not the card, so a split group trains each trial
as the whole group does.

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
from ..utils.dropout import dropout_noise
from ..utils.device import resolve_device
from .evaluate import f1_macro

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
        self._batched = vmap(self._one, in_dims=(0, 0, None, 0))
        self._shapes: dict[tuple, list[torch.Size]] = {}   # input shape -> the shapes its dropout masks take

    def _one(self, params: dict, rate: torch.Tensor, x: torch.Tensor, noise: list) -> tuple[torch.Tensor, dict]:
        stats: dict[str, torch.Tensor] = {}
        pending = iter(noise)
        with dropout_noise(lambda t: next(pending)):
            logits = functional_call(self.module, params, (x,), {"dropout_rate": rate, "stats": stats})
        return logits, stats

    def noise_shapes(self, params: dict, rates: torch.Tensor, x: torch.Tensor) -> list[torch.Size]:
        """The shapes of one trial's dropout masks, in the order its forward
        draws them, on a train-mode batch shaped like x: recorded once per
        input shape by a forward of the first trial."""
        key = tuple(x.shape)
        if key not in self._shapes:
            seen: list[torch.Size] = []

            def record(t: torch.Tensor) -> torch.Tensor:
                seen.append(t.shape)
                return torch.zeros_like(t)

            self.module.train(True)
            with torch.no_grad(), dropout_noise(record):
                functional_call(self.module, {n: p[0] for n, p in params.items()}, (x,),
                                {"dropout_rate": rates[0], "stats": {}})
            self._shapes[key] = seen
        return self._shapes[key]

    def forward(self, params: dict, rates: torch.Tensor, x: torch.Tensor, noise: list[torch.Tensor] | None
                ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
        """(k, B, n_classes) logits of every trial on the shared batch x. In
        train mode ``noise`` is the trials' dropout noise, (k, *shape) a mask
        in ``noise_shapes``' order (``TrialGroup._noise``), and the trials'
        updated BatchNorm statistics come back too, (k, ...) a buffer (none
        for the families without BatchNorm); None is evaluation (no
        dropout)."""
        self.module.train(noise is not None)
        noise = [] if noise is None else noise
        if not self.looped:
            return self._batched(params, rates, x, noise)
        with warnings.catch_warnings():   # cuDNN: the sliced weights are not one flattened buffer
            warnings.simplefilter("ignore", UserWarning)
            outs = [self._one({n: p[i] for n, p in params.items()}, rates[i], x, [u[i] for u in noise])
                    for i in range(len(rates))]
        return torch.stack([o[0] for o in outs]), {k: torch.stack([o[1][k] for o in outs]) for k in outs[0][1]}

    def logits(self, params: dict, rates: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """(k, B, n_classes) evaluation logits of every trial on the shared batch x."""
        return self.forward(params, rates, x, None)[0]


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
    of its input). ``noise_seeds``: one a trial, the seed of the generator
    its dropout masks come from (a trial at rate 0 draws none)."""

    def __init__(self, arch: dict, states: list[dict[str, torch.Tensor]], lrs, rates, device=None,
                 dtype: torch.dtype = torch.float32, *, noise_seeds):
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
        if len(noise_seeds) != self.k:
            raise ValueError(f"{len(noise_seeds)} noise seeds for {self.k} trials")
        self._gens = [torch.Generator(self.device).manual_seed(int(sd)) if float(r) > 0 else None
                      for sd, r in zip(noise_seeds, np.asarray(rates))]

    def _noise(self, x: torch.Tensor) -> list[torch.Tensor]:
        """Each trial's dropout noise for a step on batch x, from its own
        generator (zeros, which mask nothing, for a trial at rate 0):
        (k, *shape) a mask."""
        shapes = self.runner.noise_shapes(self.params, self.rates, x)
        sizes = [s.numel() for s in shapes]
        if not sizes:
            return []
        if not any(self._gens):
            return [x.new_zeros((self.k, *shape)) for shape in shapes]
        per_trial = [(torch.rand(sum(sizes), generator=g, device=self.device, dtype=x.dtype) if g is not None
                      else x.new_zeros(sum(sizes))).split(sizes) for g in self._gens]
        return [torch.stack([parts[j] for parts in per_trial]).view(self.k, *shape) for j, shape in enumerate(shapes)]

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
        logits, stats = self.runner.forward(self.params, self.rates, xb, self._noise(xb))  # (k, B, C)
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

    def device_logits(self, X: torch.Tensor) -> torch.Tensor:
        """(k, N, n_classes) evaluation logits (no dropout), left on the device."""
        with torch.no_grad():
            return torch.cat([self.runner.logits(self.params, self.rates, X[s : s + _EVAL_ROWS])
                              for s in range(0, len(X), _EVAL_ROWS)], dim=1)

    def logits(self, X: torch.Tensor) -> np.ndarray:
        """(k, N, n_classes) evaluation logits (no dropout) on the host."""
        return self.device_logits(X).cpu().numpy()


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
    devices=1,
    epoch_cb: Optional[Callable[[int, int, float], bool]] = None,
    device=None,
) -> list[dict]:
    """Train all ``draws`` (same shape signature) as one TrialGroup on
    ``device`` (the first CUDA card unless the caller passes
    ``device="cpu"``), or split over ``devices`` (a count or a list; module
    docstring), one TrialGroup a part.

    epoch_cb(trial_index, epoch, val_accuracy) is a pure observation hook
    (its return value is ignored): the group always trains to sweep_epochs,
    so callers track pruning decisions themselves; run_study_batched
    records should_prune() verdicts in a set and tells the study afterwards.

    Returns one dict per trial: {val_accuracy, val_f1_macro, history}.
    """
    from ..models import get_model

    from ..parallel.mesh import part_devices, split_parts

    device = resolve_device(device)
    k = len(draws)
    parts = part_devices(devices, device, k)
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
    states = init_states(arch, k, seed)
    lrs = np.array([float(d.get("learning_rate", proto.learning_rate)) for d in draws])
    rates = np.array([float(d.get("dropout", proto.dropout)) for d in draws])
    members = split_parts(k, len(parts))
    if len(members) > 1:
        logger.info("trial batch of %d (%d real) sharded over %d devices", k, k, len(members))
    groups = [TrialGroup(arch, [states[i] for i in m], lrs[m], rates[m], d, noise_seeds=[seed + 1 + i for i in m])
              for m, d in zip(members, parts)]
    # the data once a device
    data = {str(g.device): tuple(torch.from_numpy(a).to(g.device) for a in (X, y, Xv)) for g in groups}

    def logits() -> np.ndarray:
        """(k, Nv, n_classes): every part issued before the first fetch."""
        outs = [g.device_logits(data[str(g.device)][2]) for g in groups]
        return np.concatenate([o.cpu().numpy() for o in outs])

    n = len(X)
    bs = min(proto.batch_size, n)
    steps = max(1, n // bs)
    np_rng = np.random.default_rng(seed)
    history: list[np.ndarray] = []
    for epoch in range(sweep_epochs):
        perm = np_rng.permutation(n)
        for g in groups:
            g.epoch(*data[str(g.device)][:2], perm[: steps * bs].reshape(steps, bs))
        accs = (logits().argmax(-1) == yv[None, :]).mean(axis=1)
        history.append(accs)
        if epoch_cb is not None:
            for i in range(k):
                epoch_cb(i, epoch, float(accs[i]))

    preds = logits().argmax(-1)   # (k, Nv); the untrained init when sweep_epochs == 0
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
    devices=1,
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
