"""Mid-training checkpoint/resume for the port's deep train loop.

Counterpart of the JAX package's ``utils/checkpoint.py``: a per-epoch
``train_state.npz`` (parameters, statistics, Adam state and loop counters)
written atomically, readable by numpy alone, and restored on resume. It holds
the JAX package's keys, so a file written by either package resumes in the
other:

- ``p/params/<flax path>`` and ``p/best/<flax path>``: the live and the
  early-stopping parameters, and ``p/cols/batch_stats/<flax path>`` and
  ``p/best_cols/batch_stats/<flax path>`` their BatchNorm statistics (none
  for a model without BatchNorm), through ``params_to_flax`` /
  ``params_from_flax`` (``models/deep.py``);
- the state of optax's ``inject_hyperparams(adam)``: ``o/.count`` and
  ``o/.inner_state/0/.count`` (int32, the steps taken: torch Adam's ``step``),
  ``o/.hyperparams/{b1,b2,eps,eps_root,learning_rate}`` (float32, the lr the
  last epoch ran at), and ``o/.inner_state/0/.mu/<flax path>`` and
  ``.nu/<flax path>`` (torch Adam's ``exp_avg`` and ``exp_avg_sq``, laid out
  as ``params_to_flax`` lays out the parameters) for EVERY parameter: optax
  keeps moments for the parameters JAX freezes by zeroing their gradients
  (the teacher's phase 1), so a parameter the port's optimizer does not hold
  is written with zero moments, and on reading must have zero moments;
- ``__meta__``: JSON of the loop counters (``epoch``, ``lr``,
  ``best_val_loss``, ``es_wait``, ``lr_wait``).

No field keeps a port-only key: torch's per-parameter ``step`` is one count
for every parameter of this loop, and the resumed lr is ``__meta__``'s in
both packages.
"""

from __future__ import annotations

import json
import logging
from pathlib import Path
from typing import Optional

import numpy as np
import torch

logger = logging.getLogger(__name__)

_COLS = {"params": "cols", "best": "best_cols"}   # the statistics' set of each parameter set
_STATS = "c/batch_stats/"                         # params_to_flax's prefix of the statistics
_INNER = "o/.inner_state/0/"
_EPS_ROOT = 0.0                                   # optax.adam's default; torch's Adam has no such term


def _flax_sets(flat: dict[str, np.ndarray], group: str) -> dict[str, np.ndarray]:
    """A ``params_to_flax`` dict -> the checkpoint's keys of set ``group``."""
    return {(f"p/{_COLS[group]}/batch_stats/{k[len(_STATS):]}" if k.startswith(_STATS) else f"p/{group}/{k[2:]}"): v
            for k, v in flat.items()}


def _set_from_file(data, group: str) -> dict[str, np.ndarray]:
    """The checkpoint's keys of set ``group`` -> a ``params_from_flax`` dict."""
    p, c = f"p/{group}/", f"p/{_COLS[group]}/batch_stats/"
    flat = {"p/" + k[len(p):]: data[k] for k in data.files if k.startswith(p)}
    flat.update({_STATS + k[len(c):]: data[k] for k in data.files if k.startswith(c)})
    return flat


def save_train_state(path: Path, states: dict[str, dict[str, torch.Tensor]], optimizer: torch.optim.Optimizer,
                     params: dict[str, torch.nn.Parameter], meta: dict) -> None:
    """Atomic save of ``states`` ({"params": state_dict, "best": state_dict}),
    the Adam state of ``optimizer`` over the module's ``params`` (all its
    named parameters, trained or not) and the loop metadata, in the JAX
    package's layout (module docstring)."""
    from ..models.deep import params_to_flax

    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    payload = {}
    for group, state in states.items():
        payload.update(_flax_sets(params_to_flax(state), group))
    moments: dict[str, dict[str, torch.Tensor]] = {"exp_avg": {}, "exp_avg_sq": {}}
    steps = set()
    for name, p in params.items():
        st = optimizer.state.get(p, {})   # nothing for a parameter the optimizer does not train
        if "step" in st:
            steps.add(float(st["step"]))
        for field, into in moments.items():
            into[name] = st[field] if field in st else torch.zeros_like(p)
    if len(steps) > 1:
        raise ValueError(f"Adam's parameters took different step counts {sorted(steps)}: optax keeps one")
    count = np.int32(steps.pop() if steps else 0)
    for field, leaf in (("exp_avg", ".mu"), ("exp_avg_sq", ".nu")):
        payload.update({f"{_INNER}{leaf}/{k[2:]}": v for k, v in params_to_flax(moments[field]).items()})
    group0 = optimizer.param_groups[0]
    b1, b2 = group0["betas"]
    payload["o/.count"] = payload[f"{_INNER}.count"] = count
    payload.update({f"o/.hyperparams/{k}": np.float32(v) for k, v in
                    (("b1", b1), ("b2", b2), ("eps", group0["eps"]), ("eps_root", _EPS_ROOT),
                     ("learning_rate", group0["lr"]))})
    payload["__meta__"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    tmp = path.with_suffix(".tmp.npz")
    np.savez(tmp, **payload)
    tmp.replace(path)


def load_train_state(path: Path, templates: dict[str, dict[str, torch.Tensor]], optimizer: torch.optim.Optimizer,
                     params: dict[str, torch.nn.Parameter]) -> Optional[tuple[dict[str, dict[str, torch.Tensor]], dict]]:
    """Restore a ``train_state.npz`` of either package: the Adam state of
    ``optimizer`` in place (``params`` as for ``save_train_state``), and
    ({set: state_dict} on each template tensor's device and dtype, meta).
    None, with a warning, when there is no checkpoint or it does not match:
    another architecture, other Adam hyperparameters, differing counts, or
    nonzero moments of a parameter the optimizer does not train."""
    from ..models.deep import params_from_flax

    path = Path(path)
    if not path.exists():
        return None
    try:
        data = np.load(path, allow_pickle=False)
        meta = json.loads(bytes(data["__meta__"].tobytes()).decode())
        states = {}
        for group, template in templates.items():
            restored = params_from_flax(_set_from_file(data, group))
            if sorted(restored) != sorted(template):
                raise ValueError(f"{group}: the checkpoint's tensors {sorted(set(restored) ^ set(template))[:4]} "
                                 "differ from the model's")
            states[group] = {}
            for k, t in template.items():
                if tuple(restored[k].shape) != tuple(t.shape):
                    raise ValueError(f"{group}/{k}: checkpoint shape {tuple(restored[k].shape)} != {tuple(t.shape)}")
                states[group][k] = restored[k].to(t.device, t.dtype)
        count = int(data["o/.count"])
        if int(data[f"{_INNER}.count"]) != count:
            raise ValueError(f"the counts differ: {count} and {int(data[f'{_INNER}.count'])}")
        group0 = optimizer.param_groups[0]
        want = {"b1": group0["betas"][0], "b2": group0["betas"][1], "eps": group0["eps"], "eps_root": _EPS_ROOT}
        for k, v in want.items():
            if np.float32(data[f"o/.hyperparams/{k}"]) != np.float32(v):
                raise ValueError(f"Adam's {k} {float(data[f'o/.hyperparams/{k}'])} != {v}")
        moments = {field: params_from_flax({"p/" + k[len(prefix):]: data[k] for k in data.files
                                            if k.startswith(prefix)})
                   for field, prefix in (("exp_avg", f"{_INNER}.mu/"), ("exp_avg_sq", f"{_INNER}.nu/"))}
        order = {id(p): i for i, p in enumerate(p for g in optimizer.param_groups for p in g["params"])}
        opt = optimizer.state_dict()
        opt["state"] = {}
        for name, p in params.items():
            fields = {field: moments[field].get(name) for field in moments}
            for field, m in fields.items():
                if m is None or tuple(m.shape) != tuple(p.shape):
                    raise ValueError(f"{name} {field}: checkpoint shape {None if m is None else tuple(m.shape)}")
            if id(p) in order:
                opt["state"][order[id(p)]] = {"step": torch.tensor(float(count), dtype=torch.float32), **fields}
            elif any(bool(m.ne(0).any()) for m in fields.values()):
                raise ValueError(f"{name} is not trained here, but its moments in the checkpoint are not zero")
        optimizer.load_state_dict(opt)
        return states, meta
    except (KeyError, ValueError, OSError) as exc:
        logger.warning("checkpoint %s unusable (%s); starting fresh", path, exc)
        return None
