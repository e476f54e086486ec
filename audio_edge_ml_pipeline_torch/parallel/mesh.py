"""Mesh, shardings and process groups: the collective layer of the port.

Counterpart of the JAX package's ``parallel/mesh.py``, with its public
names. JAX runs one controller that sees every device, and XLA inserts the
collectives. Here each rank of a mesh is a process (SPMD):

- ``run_ranks`` runs a function on N ranks: the calling process is rank 0,
  the other N - 1 are started with ``torch.multiprocessing`` (``spawn``) and
  meet through a ``file://`` rendezvous in a temporary directory. Cards
  reduce through ``nccl``, the CPU (``device="cpu"``) through ``gloo``
  processes. Every group has a timeout; a rank that raises makes the call
  raise with that rank's traceback, and the children are killed if they
  outlive a deadline, so no call hangs;
- ``get_mesh`` builds a ``DeviceMesh`` over the ranks with dims
  ``("data", "model")``, or ``("replica", "data", "model")``;
  ``batch_sharding`` / ``replicated`` / ``param_shardings`` give DTensor
  placements; ``shard_batch`` gives a rank its contiguous rows of a batch;
- ``place_train_state`` shards each Conv2d / Linear whose flax kernel's
  last axis (the torch weight's output dim 0) divides by the model axis:
  the layer becomes a ``ColumnParallel`` that computes its rank's output
  channels and all-gathers them; biases and all else stay replicated;
- ``make_sharded_train_step`` is one step of that module: DDP over the
  data (x replica) ranks reduces the gradients of every tensor, sharded or
  replicated, over data x replica only: the model ranks compute identical
  gradients for the replicated tensors (``ColumnParallel``'s collectives
  make them so), so they are not summed a second time.

Rows, folds and trials that need no collective are split from one process
instead (``part_devices``, ``split_parts``): each part runs on its card and
every part is issued before any is fetched.
"""

from __future__ import annotations

import os
import tempfile
import threading
import time
from dataclasses import dataclass
from datetime import timedelta
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..utils.dropout import GlobalBatchNoise, dropout_noise

DEFAULT_TIMEOUT_S = 600.0   # a collective's timeout, and the deadline of the children after rank 0 returns

# the rank this process runs in a group of run_ranks (None outside one)
_RANK: Optional["Rank"] = None


@dataclass(frozen=True)
class Rank:
    """One rank of a ``run_ranks`` group: its index, the group's size, the
    device it computes on, and the devices of every rank."""

    rank: int
    world: int
    device: torch.device
    devices: tuple[torch.device, ...]


# -- devices and parts ---------------------------------------------------------


def cards(n: Optional[int] = None) -> list[torch.device]:
    """The first ``n`` visible CUDA cards (all when None)."""
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return [torch.device("cuda", i) for i in range(count if n is None else min(n, count))]


def part_devices(devices, device, limit: Optional[int] = None) -> list[torch.device]:
    """The devices a split runs its parts on. ``devices``: a list of
    devices (taken as given, repeats allowed), or a count: min(count,
    visible cards) cards from ``device``'s index on when ``device`` is a
    card, else ``[device]`` (the CPU is one device). At most ``limit``."""
    if isinstance(devices, (list, tuple)):
        out = [torch.device(d) for d in devices]
    else:
        n, device = int(devices or 1), torch.device(device)
        out = [device]
        if n > 1 and device.type == "cuda":
            count = torch.cuda.device_count()
            first = device.index or 0
            out = [torch.device("cuda", (first + i) % count) for i in range(min(n, count))]
    if not out:
        raise ValueError("a split needs at least one device")
    return out[: max(1, limit)] if limit is not None else out


def split_parts(n: int, parts: int) -> list[np.ndarray]:
    """Contiguous index parts of range(n), as even as they go (the first
    parts one longer), none empty."""
    return [p for p in np.array_split(np.arange(n), max(1, min(parts, n))) if len(p)]


def default_backend(devices: Sequence[torch.device]) -> str:
    return "nccl" if all(d.type == "cuda" for d in devices) else "gloo"


def data_parallel_devices(n: int, device, devices=None, backend: Optional[str] = None
                          ) -> tuple[list[torch.device], str]:
    """(the ranks' devices, backend) of an n-way data-parallel run on
    ``device``: n distinct cards through NCCL, or n gloo processes on the
    CPU when ``device`` is the CPU. ``devices`` / ``backend`` override both
    (e.g. two gloo ranks on one card). Too few cards raises: there is no
    CPU fallback."""
    device = torch.device(device)
    if devices is not None:
        out = [torch.device(d) for d in devices]
        if len(out) != n:
            raise ValueError(f"data_parallel={n} but {len(out)} device(s) were given")
    elif device.type == "cpu":
        out = [device] * n
    else:
        count = torch.cuda.device_count()
        if count < n:
            raise ValueError(
                f"data_parallel={n} needs {n} CUDA cards but {count} are visible; build the trainer with "
                f"device='cpu' to run {n} gloo processes on the CPU instead")
        first = device.index or 0
        out = [torch.device("cuda", (first + i) % count) for i in range(n)]
    backend = backend or default_backend(out)
    if backend == "nccl" and len({str(d) for d in out}) != len(out):
        raise ValueError("NCCL refuses two ranks on one card: give each rank its own card, or backend='gloo'")
    return out, backend


# -- process groups ------------------------------------------------------------


def _init_group(rank: int, init: str, devices: tuple[torch.device, ...], backend: str, timeout: float) -> None:
    global _RANK
    device = devices[rank]
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init, rank=rank, world_size=len(devices),
                            timeout=timedelta(seconds=timeout))
    _RANK = Rank(rank, len(devices), device, devices)


def _end_group() -> None:
    global _RANK
    _RANK = None
    if dist.is_initialized():
        dist.destroy_process_group()


def _numerics() -> tuple:
    """This process's float32 settings: cuBLAS's and cuDNN's TF32 flags and
    cuDNN's determinism and autotuning (the flags the port itself sets)."""
    cudnn = torch.backends.cudnn
    return torch.backends.cuda.matmul.allow_tf32, cudnn.allow_tf32, cudnn.deterministic, cudnn.benchmark


def _set_numerics(numerics: tuple) -> None:
    cudnn = torch.backends.cudnn
    torch.backends.cuda.matmul.allow_tf32 = numerics[0]
    cudnn.allow_tf32, cudnn.deterministic, cudnn.benchmark = numerics[1:]


def _child_main(i: int, init: str, devices, backend: str, timeout: float, numerics: tuple, fn: Callable,
                args: tuple) -> None:
    """Rank i + 1 of a ``run_ranks`` group (a spawned process): it computes
    with the caller's float32 settings (a fresh process would take torch's
    defaults, cuDNN's TF32 convolutions among them), one torch thread a CPU
    rank."""
    if devices[i + 1].type == "cpu":
        torch.set_num_threads(1)
    _set_numerics(numerics)
    _init_group(i + 1, init, devices, backend, timeout)
    try:
        fn(_RANK, *args)
    finally:
        _end_group()


class _Watch(threading.Thread):
    """Watches the children of a group from the parent: when one exits
    with an error, aborts the parent's process group so that a collective
    it waits in raises instead of waiting out its timeout."""

    def __init__(self, procs) -> None:
        super().__init__(daemon=True)
        self.procs, self._halt = procs, threading.Event()

    def run(self) -> None:
        while not self._halt.wait(0.2):
            bad = [i + 1 for i, p in enumerate(self.procs) if p.exitcode not in (None, 0)]
            if bad:
                abort = getattr(dist.distributed_c10d, "_abort_process_group", None)
                if abort is not None and dist.is_initialized() and dist.get_backend() == "nccl":
                    try:
                        abort()
                    except Exception:   # the group may be gone already
                        pass
                return

    def stop(self) -> None:
        self._halt.set()


def _child_error(ctx, grace: float) -> Optional[str]:
    """The traceback of a child that failed, joining for up to ``grace`` s."""
    end = time.monotonic() + grace
    while time.monotonic() < end:
        try:
            if ctx.join(timeout=0.2):
                return None
        except Exception as exc:   # ProcessRaisedException / ProcessExitedException, with the child's traceback
            return str(exc)
    return None


def _kill(procs) -> None:
    for p in procs:
        if p.is_alive():
            p.terminate()
    for p in procs:
        p.join(5)
        if p.is_alive():
            p.kill()
            p.join(5)


def run_ranks(fn: Callable, args: tuple = (), devices: Sequence = ("cpu",), backend: Optional[str] = None,
              timeout: float = DEFAULT_TIMEOUT_S, root: Optional[Callable] = None):
    """Run ``fn(rank, *args)`` on ``len(devices)`` ranks, rank i computing
    on ``devices[i]``, and return rank 0's result. The caller is rank 0
    (it runs ``root(rank)`` instead when given, which may hold what cannot
    be pickled: tracking runs, callbacks); ranks 1.. are spawned
    processes, so ``fn`` and ``args`` must pickle and ``fn`` must live in
    an importable module; they compute with the caller's float32 settings
    (TF32 or not). ``backend``: ``nccl`` when every device is a card, else
    ``gloo`` (gloo also takes CUDA tensors, staging them through the
    host). ``timeout`` bounds every collective and the wait for the
    children after rank 0 returns. A CPU rank runs one torch thread. A
    failed rank raises here with its traceback."""
    if dist.is_initialized():
        raise RuntimeError("run_ranks inside a running process group: groups do not nest")
    devices = tuple(torch.device(d) for d in devices)
    backend = backend or default_backend(devices)
    prev_threads = torch.get_num_threads()
    prev_card = torch.cuda.current_device() if devices[0].type == "cuda" else None
    procs, ctx, watch = [], None, None
    with tempfile.TemporaryDirectory(prefix="aep-ranks-") as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        try:
            if len(devices) > 1:
                import torch.multiprocessing as mp

                ctx = mp.start_processes(_child_main, args=(init, devices, backend, timeout, _numerics(), fn, args),
                                         nprocs=len(devices) - 1, join=False, start_method="spawn")
                procs = ctx.processes
                watch = _Watch(procs)
                watch.start()
            if devices[0].type == "cpu":
                torch.set_num_threads(1)
            try:
                _init_group(0, init, devices, backend, timeout)
                out = root(_RANK) if root is not None else fn(_RANK, *args)
            except BaseException as exc:
                err = _child_error(ctx, 10.0) if ctx is not None else None
                if err is not None:
                    raise RuntimeError(f"a rank of the group failed:\n{err}") from exc
                raise
            finally:
                _end_group()
            if ctx is not None:
                end = time.monotonic() + timeout
                while not ctx.join(timeout=0.5):   # raises with the traceback of a child that failed
                    if time.monotonic() > end:
                        late = [i + 1 for i, p in enumerate(procs) if p.is_alive()]
                        raise TimeoutError(f"rank(s) {late} did not end within {timeout:g} s of rank 0")
            return out
        finally:
            if watch is not None:
                watch.stop()
            _kill(procs)
            torch.set_num_threads(prev_threads)
            if prev_card is not None:
                torch.cuda.set_device(prev_card)


def rank_numerics(rank: Rank) -> list[tuple]:
    """Every rank's float32 settings, gathered on each (``run_ranks``
    target: what each rank computes with)."""
    out: list = [None] * rank.world
    dist.all_gather_object(out, _numerics())
    return out


# -- the mesh --------------------------------------------------------------------


def get_mesh(n_devices: Optional[int] = None, model_parallel: int = 1, devices=None, dcn_replicas: int = 1):
    """A ``DeviceMesh`` over the ranks of the running group, dims
    ``("data", "model")``, or ``("replica", "data", "model")`` when
    ``dcn_replicas > 1`` (the batch then splits over replica x data).
    ``devices``: the devices the mesh may use (default: the group's ranks'
    devices, or the visible cards outside a group). Asking for more than
    there are, or a count that model_parallel x dcn_replicas does not
    divide, raises ValueError, as in JAX. Every rank of the group calls
    it, with the same arguments."""
    from torch.distributed.device_mesh import DeviceMesh

    if devices is None:
        devices = list(_RANK.devices) if _RANK is not None else cards()
    devices = [torch.device(d) for d in devices]
    if n_devices is not None:
        if n_devices > len(devices):
            kind = devices[0].type if devices else "cuda"
            raise ValueError(
                f"requested a {n_devices}-device mesh but only {len(devices)} {kind} device(s) are visible. "
                f"For a run on the CPU pass device='cpu', which runs {n_devices} gloo processes "
                f"(run_ranks(..., devices=['cpu'] * {n_devices})).")
        devices = devices[:n_devices]
    n = len(devices)
    if n == 0 or n % (model_parallel * dcn_replicas) != 0:
        raise ValueError(f"{n} devices not divisible by model_parallel={model_parallel} x dcn_replicas={dcn_replicas}")
    if _RANK is None or _RANK.world != n:
        raise RuntimeError(f"get_mesh({n}) runs in each rank of an {n}-rank group: start the ranks with run_ranks")
    data = n // (model_parallel * dcn_replicas)
    if dcn_replicas == 1:
        shape, names = (data, model_parallel), ("data", "model")
    else:
        shape, names = (dcn_replicas, data, model_parallel), ("replica", "data", "model")
    return DeviceMesh(devices[0].type, torch.arange(n).reshape(shape), mesh_dim_names=names)


def batch_group(mesh):
    """The process group of the ranks that share this rank's model index:
    the batch's data x replica ranks. Collective (``new_group``): every
    rank of the mesh calls it, and every rank creates every group, in the
    same order."""
    ranks = mesh.mesh
    mine = None
    for m in range(ranks.shape[-1]):
        members = ranks[..., m].flatten().tolist()
        group = dist.new_group(members) if len(members) < ranks.numel() else dist.group.WORLD
        if dist.get_rank() in members:
            mine = group
    return mine


def batch_sharding(mesh) -> tuple:
    """The batch's placements: its leading axis sharded over data (and
    replica, when the mesh has one); replicated over model."""
    from torch.distributed.tensor import Replicate, Shard

    return tuple(Replicate() if name == "model" else Shard(0) for name in mesh.mesh_dim_names)


def data_axis_size(mesh) -> int:
    """How many ways batch_sharding splits the batch: replica x data."""
    return int(np.prod([mesh.size(i) for i, name in enumerate(mesh.mesh_dim_names) if name != "model"]))


def replicated(mesh) -> tuple:
    from torch.distributed.tensor import Replicate

    return tuple(Replicate() for _ in mesh.mesh_dim_names)


def _batch_index(mesh) -> int:
    """This rank's part of the batch: replica-major over replica x data."""
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    return coord.get("replica", 0) * mesh.size(mesh.mesh_dim_names.index("data")) + coord["data"]


def shard_batch(x, mesh) -> torch.Tensor:
    """This rank's contiguous rows of the global batch ``x`` (its part over
    replica x data), on the rank's device."""
    n = data_axis_size(mesh)
    if len(x) % n:
        raise ValueError(f"a batch of {len(x)} rows does not split over {n} data ranks")
    b = len(x) // n
    i = _batch_index(mesh)
    rows = x[i * b : (i + 1) * b]
    rows = rows if torch.is_tensor(rows) else torch.from_numpy(np.ascontiguousarray(rows))
    return rows.to(_RANK.device if _RANK is not None else "cpu")


def _flax_last_dim(name: str, t: torch.Tensor) -> int:
    """The torch dim of a tensor that is the last axis of its flax
    counterpart: a Conv2d / Linear ``weight`` (4-D OIHW, 2-D (out, in))
    keeps the output features in dim 0, flax's HWIO / (in, out) last;
    tensors kept in flax's shapes (3-D attention kernels) have it last."""
    return 0 if name.rsplit(".", 1)[-1] == "weight" and t.dim() in (2, 4) else t.dim() - 1


def param_shardings(params, mesh) -> dict[str, tuple]:
    """name -> placements of each tensor of ``params`` (a module or a
    name -> tensor dict): JAX's rule on the flax layout: a tensor of 2 or
    more dims whose flax-last axis divides over the model axis is sharded
    on that axis; everything else is replicated."""
    from torch.distributed.tensor import Replicate, Shard

    named = dict(params.named_parameters()) if isinstance(params, nn.Module) else dict(params)
    m = mesh.size(mesh.mesh_dim_names.index("model"))
    out = {}
    for name, t in named.items():
        dim = _flax_last_dim(name, t)
        sharded = t.dim() >= 2 and t.shape[dim] % m == 0 and t.shape[dim] >= m
        out[name] = tuple(Shard(dim) if axis == "model" and sharded else Replicate() for axis in mesh.mesh_dim_names)
    return out


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks of ``group``; the backward sums the gradient the
    same way (each rank's loss reaches every rank's input)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable sum of ``x`` over the ranks of ``group``."""
    return _AllReduceSum.apply(x, group)


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the backward sums the input's gradient over the
    model ranks (each computed its own channels' part of it)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _GatherFromModel(torch.autograd.Function):
    """All-gathers each model rank's channels along ``dim``; the backward
    keeps this rank's slice of the gradient. Every model rank computes the
    same thing downstream of the gather, so its gradient there is already
    whole: the sum that ``torch.distributed.nn.functional.all_gather``'s
    backward takes would count it once a model rank."""

    @staticmethod
    def forward(ctx, y, dim, group, index, parts):
        ctx.dim, ctx.index, ctx.width = dim, index, y.shape[dim]
        pieces = [torch.empty_like(y) for _ in range(parts)]
        dist.all_gather(pieces, y.contiguous(), group=group)
        return torch.cat(pieces, dim)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.index * ctx.width, ctx.width).contiguous(), None, None, None, None


class ColumnParallel(nn.Module):
    """A Conv2d or Linear split over the model axis by output channels:
    ``weight`` holds this rank's rows, ``bias`` stays whole (replicated)
    and is added after the gather. Keeps the layer's ``kernel_size`` /
    ``stride`` so that ``layers.conv_same`` pads it as it padded the
    layer."""

    def __init__(self, layer: nn.Module, mesh) -> None:
        super().__init__()
        if isinstance(layer, nn.Conv2d) and layer.groups != 1:
            raise NotImplementedError("a grouped (depthwise) convolution has no column split over the model axis")
        if not isinstance(layer, (nn.Conv2d, nn.Linear)):
            raise NotImplementedError(f"no column split of a {type(layer).__name__} over the model axis")
        axis = mesh.mesh_dim_names.index("model")
        self.parts, self.index = mesh.size(axis), mesh.get_local_rank("model")
        self.group = mesh.get_group("model")
        width = layer.weight.shape[0] // self.parts
        self.conv = isinstance(layer, nn.Conv2d)
        if self.conv:
            self.kernel_size, self.stride = layer.kernel_size, layer.stride
            self.padding, self.dilation = layer.padding, layer.dilation
        w = layer.weight.detach()[self.index * width : (self.index + 1) * width]
        self.weight = nn.Parameter(w.clone())
        self.bias = None if layer.bias is None else nn.Parameter(layer.bias.detach().clone())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.requires_grad:
            x = _CopyToModel.apply(x, self.group)
        if self.conv:
            y = F.conv2d(x, self.weight, None, self.stride, self.padding, self.dilation)
            y = _GatherFromModel.apply(y, 1, self.group, self.index, self.parts)
            return y if self.bias is None else y + self.bias[:, None, None]
        y = _GatherFromModel.apply(F.linear(x, self.weight), -1, self.group, self.index, self.parts)
        return y if self.bias is None else y + self.bias

    def full_weight(self) -> torch.Tensor:
        """The whole weight, gathered from the model ranks (collective)."""
        pieces = [torch.empty_like(self.weight) for _ in range(self.parts)]
        dist.all_gather(pieces, self.weight.detach().contiguous(), group=self.group)
        return torch.cat(pieces, 0)


def place_train_state(module: nn.Module, optimizer: torch.optim.Optimizer, mesh):
    """Shard ``module`` onto the mesh per ``param_shardings`` and move it to
    this rank's device: each Conv2d / Linear whose weight is sharded
    becomes a ``ColumnParallel``. Returns (module, an optimizer of
    ``optimizer``'s class and settings over the placed parameters; its
    moments start empty, as optax's init state). A sharded tensor of any
    other layer raises."""
    if any(optimizer.state.values()):
        raise ValueError("place_train_state takes an optimizer that has not stepped yet")
    rules = param_shardings(module, mesh)
    # a split over a model axis of one rank is the whole layer: it stays as it is
    one = mesh.size(mesh.mesh_dim_names.index("model")) == 1
    sharded = set() if one else {name.rsplit(".", 1)[0] for name, pl in rules.items() if any(p.is_shard() for p in pl)}
    for path in sorted(sharded):
        parent_path, _, leaf = path.rpartition(".")
        parent = module.get_submodule(parent_path) if parent_path else module
        setattr(parent, leaf, ColumnParallel(getattr(parent, leaf), mesh))
    module.to(_RANK.device if _RANK is not None else "cpu")
    return module, type(optimizer)(module.parameters(), **optimizer.defaults)


def ddp(module: nn.Module, device: torch.device, group=None) -> nn.Module:
    """``DistributedDataParallel`` over ``group`` (the world by default),
    buffers left alone: the port's BatchNorm statistics are computed alike
    on every rank and never need a broadcast."""
    import warnings

    from torch.nn.parallel import DistributedDataParallel

    # a size-1 dim's stride (a one-channel conv's weight) differs between a gradient and its bucket view:
    # harmless, and said once a step
    warnings.filterwarnings("ignore", message="Grad strides do not match bucket view strides")
    with warnings.catch_warnings():   # newer torch renames broadcast_buffers; the old name keeps its meaning
        warnings.simplefilter("ignore", FutureWarning)
        return DistributedDataParallel(module, device_ids=[device] if device.type == "cuda" else None,
                                       process_group=group, broadcast_buffers=False)


def make_sharded_train_step(apply_fn: nn.Module, optimizer: torch.optim.Optimizer, mesh):
    """One train step of the placed module ``apply_fn`` (x -> logits of
    this rank's rows): mean cross-entropy of the rank's rows, DDP over the
    mesh's data x replica ranks (which averages the gradients: the global
    batch's mean loss, its shards being equal), then the optimizer. Dropout
    masks are the global batch's, from a generator seeded 0 on every rank
    (the model ranks that share rows must mask them alike). Returns
    ``step(x, y) -> (loss, accuracy)`` of the global batch, for the rank's
    rows of it (``shard_batch``)."""
    device = _RANK.device
    group = batch_group(mesh)
    wrapped = ddp(apply_fn, device, group)
    n = data_axis_size(mesh)
    noise = GlobalBatchNoise(torch.Generator(device).manual_seed(0), n, _batch_index(mesh))

    def step(x: torch.Tensor, y: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        optimizer.zero_grad(set_to_none=True)
        with dropout_noise(noise):
            logits = wrapped(x)
        loss = F.cross_entropy(logits, y)
        loss.backward()
        optimizer.step()
        stats = torch.stack([loss.detach(), (logits.detach().argmax(-1) == y).float().mean()])
        dist.all_reduce(stats, group=group)
        return stats[0] / n, stats[1] / n

    return step


def gathered_state(module: nn.Module) -> dict[str, torch.Tensor]:
    """The module's whole state_dict on every rank: a ``ColumnParallel``'s
    weight gathered from the model ranks (collective: every rank calls it)."""
    state = {}
    for name, t in module.state_dict().items():
        owner = module.get_submodule(name.rsplit(".", 1)[0]) if "." in name else module
        if isinstance(owner, ColumnParallel) and name.endswith(".weight"):
            t = owner.full_weight()
        state[name] = t.detach().clone()
    return state
