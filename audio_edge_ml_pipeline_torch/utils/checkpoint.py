"""Mid-training checkpoint/resume for the port's deep train loop.

Counterpart of the JAX package's ``utils/checkpoint.py``: a per-epoch
``train_state.npz`` (state_dicts, Adam state and loop counters) written
atomically, readable by numpy alone, and restored on resume. Its keys:

- ``s/<set>/<state_dict key>``: each named state_dict (``params``, the live
  module with its BatchNorm statistics; ``best``, the early-stopping copy);
- ``o/<parameter name>/<field>``: torch Adam's ``step``, ``exp_avg`` and
  ``exp_avg_sq`` of each trained parameter;
- ``__meta__``: JSON of the loop counters (``epoch``, ``lr``,
  ``best_val_loss``, ``es_wait``, ``lr_wait``).

The layout is the port's own (torch names, torch's Adam fields): a
checkpoint written by one package does not resume in the other, and each
package starts fresh from the other's file (with a warning).
"""

from __future__ import annotations

import json
import logging
from pathlib import Path
from typing import Optional

import numpy as np
import torch

logger = logging.getLogger(__name__)


def save_train_state(path: Path, states: dict[str, dict[str, torch.Tensor]], optimizer: torch.optim.Optimizer,
                     names: list[str], meta: dict) -> None:
    """Atomic save of ``states`` ({set: state_dict}), the state of
    ``optimizer`` (whose parameters are named ``names``, in its order) and
    the loop metadata."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    payload = {f"s/{group}/{k}": t.detach().cpu().numpy() for group, state in states.items() for k, t in state.items()}
    opt_state = optimizer.state_dict()["state"]
    for i, name in enumerate(names):
        for field, value in opt_state.get(i, {}).items():
            payload[f"o/{name}/{field}"] = torch.as_tensor(value).detach().cpu().numpy()
    payload["__meta__"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    tmp = path.with_suffix(".tmp.npz")
    np.savez(tmp, **payload)
    tmp.replace(path)


def load_train_state(path: Path, templates: dict[str, dict[str, torch.Tensor]], optimizer: torch.optim.Optimizer,
                     names: list[str]) -> Optional[tuple[dict[str, dict[str, torch.Tensor]], dict]]:
    """Restore a ``save_train_state`` file: the optimizer's state in place,
    and ({set: state_dict} on each template tensor's device and dtype,
    meta). None when there is no checkpoint, or when it does not match the
    templates (another architecture, or a file of the JAX package)."""
    path = Path(path)
    if not path.exists():
        return None
    try:
        data = np.load(path, allow_pickle=False)
        meta = json.loads(bytes(data["__meta__"].tobytes()).decode())
        states = {}
        for group, template in templates.items():
            states[group] = {}
            for k, t in template.items():
                arr = data[f"s/{group}/{k}"]
                if arr.shape != tuple(t.shape):
                    raise ValueError(f"{group}/{k}: checkpoint shape {arr.shape} != {tuple(t.shape)}")
                states[group][k] = torch.from_numpy(arr).to(t.device, t.dtype)
        params = templates["params"]
        opt = optimizer.state_dict()
        opt["state"] = {}
        for i, name in enumerate(names):
            prefix = f"o/{name}/"
            fields = {key[len(prefix):]: torch.from_numpy(np.array(data[key])) for key in data.files
                      if key.startswith(prefix)}
            for field in ("exp_avg", "exp_avg_sq"):
                if field in fields and tuple(fields[field].shape) != tuple(params[name].shape):
                    raise ValueError(f"{name} {field}: checkpoint shape {tuple(fields[field].shape)}")
            if fields:
                opt["state"][i] = fields
        optimizer.load_state_dict(opt)
        return states, meta
    except (KeyError, ValueError, OSError) as exc:
        logger.warning("checkpoint %s unusable (%s); starting fresh", path, exc)
        return None
