"""The flagship forward step and the multi-card dry run, as
``__graft_entry__`` gives them for JAX.

entry() -> (fn, example_args): raw 5 s fsc22-style waveforms through the
folded-mel frontend (the CUDA kernel on a card) into the CNN (filters
[16, 64, 64], first_stride=4, second_stride=2, 27 classes). ``fn(params,
waves)`` takes the CNN's state_dict and (B, n) waveforms and returns logits.

dryrun_multichip(n, device=None): on an n-rank mesh, one training step of
waveform -> mel (the CUDA kernel on each card) -> CNN [8, 16, 16] -> loss
-> Adam on a (data, model=2) mesh, and on the (2, n/4, 2) replica mesh when
4 divides n; then a CV cell's folds, 4 tuning trials and an extraction
batch split over the n devices. Too few cards raises unless
``device="cpu"``, which runs n gloo processes on the CPU.
"""

from __future__ import annotations

import time

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from .models.deep import _MODULE_FACTORY, CNNModule
from .ops import mel_kernel
from .utils.device import resolve_device
from .utils.profiling import span

_DRY_SR, _DRY_N, _DRY_CLASSES = 16000, 1600, 8   # 0.1 s clips, as JAX's dry run


def flagship(n_mels=40, n_fft=512, hop=160, sr=16000, n_classes=27, filters=(16, 64, 64)):
    """(module, forward) of the flagship pipeline; module on the CPU."""
    module = CNNModule(tuple(filters), dropout=0.3, n_classes=n_classes, first_stride=4, second_stride=2).eval()

    def forward(params: dict[str, torch.Tensor], waves: torch.Tensor) -> torch.Tensor:
        with span("score"):
            mel = mel_kernel.mel_spec_feature(waves, sr=sr, n_mels=n_mels, n_fft=n_fft, hop_length=hop)
            x = mel.transpose(1, 2)[..., None]  # (B, T, n_mels, 1)
            return functional_call(module, params, (x,))

    return module, forward


def entry(device: torch.device | str | None = None, seed: int = 0):
    """(fn, example_args) of one flagship forward step at batch 8."""
    device = resolve_device(device)
    module, forward = flagship()
    g = torch.Generator().manual_seed(seed)
    params = {k: (0.1 * torch.randn(v.shape, generator=g)).to(device) for k, v in module.state_dict().items()}
    batch, n = 8, 80000  # 5 s @ 16 kHz
    waves = torch.zeros((batch, n), dtype=torch.float32, device=device)
    return forward, (params, waves)


class MelFront(nn.Module):
    """Waveforms (B, n) -> the folded-mel feature (n_fft 512, hop 160, 40
    mels; the mel kernel on a card) -> ``net`` on (B, T, 40, 1)."""

    def __init__(self, net: nn.Module, sr: int = _DRY_SR) -> None:
        super().__init__()
        self.net, self.sr = net, sr

    def forward(self, waves: torch.Tensor) -> torch.Tensor:
        mel = mel_kernel.mel_spec_feature(waves, sr=self.sr, n_mels=40, n_fft=512, hop_length=160)
        return self.net(mel.transpose(1, 2)[..., None])


def _placed_step(rank, arch: dict, state: dict, model_parallel: int, dcn_replicas: int, optimizer: str, lr: float,
                 mel: bool, dtype: str):
    """(mesh, the module as built, step) of ``sharded_step``'s placed module."""
    from .parallel import mesh as pm

    mesh = pm.get_mesh(rank.world, model_parallel=model_parallel, dcn_replicas=dcn_replicas)
    net = _MODULE_FACTORY[arch["type"]](arch).to(getattr(torch, dtype))
    net.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in state.items()})
    module = MelFront(net) if mel else net
    opt = (torch.optim.SGD(module.parameters(), lr=lr) if optimizer == "sgd"
           else torch.optim.Adam(module.parameters(), lr=lr))
    module, opt = pm.place_train_state(module, opt, mesh)
    module.train()
    return mesh, net, pm.make_sharded_train_step(module, opt, mesh)


def sharded_step(rank, arch: dict, state: dict, X: np.ndarray, y: np.ndarray, model_parallel: int = 1,
                 dcn_replicas: int = 1, optimizer: str = "sgd", lr: float = 0.1, mel: bool = False,
                 dtype: str = "float32"):
    """A rank of ``run_ranks``: one ``make_sharded_train_step`` step of the
    module ``arch`` (``models.deep``'s factory; behind ``MelFront`` when
    ``mel``) from the numpy state_dict ``state``, on the global batch (X, y)
    over an n-rank mesh (model_parallel, dcn_replicas), in ``dtype``. Rank 0
    returns (loss, accuracy, the whole new state as numpy, the mesh's
    dims)."""
    from .parallel import mesh as pm

    mesh, net, step = _placed_step(rank, arch, state, model_parallel, dcn_replicas, optimizer, lr, mel, dtype)
    loss, acc = step(pm.shard_batch(X, mesh).to(getattr(torch, dtype)),
                     pm.shard_batch(torch.from_numpy(np.asarray(y, np.int64)), mesh))
    new = pm.gathered_state(net)
    dims = dict(zip(mesh.mesh_dim_names, mesh.shape))
    return float(loss), float(acc), {k: v.cpu().numpy() for k, v in new.items()}, dims


def timed_sharded_step(rank, arch: dict, state: dict, X: np.ndarray, y: np.ndarray, model_parallel: int,
                       dtype: str = "float32", repeats: int = 5):
    """``sharded_step`` (SGD 0.1), then ``repeats`` more steps timed one by
    one on the rank's device clock. Rank 0 returns (loss, the state after
    the first step as numpy, the mesh's dims, [ms a step])."""
    from .parallel import mesh as pm

    mesh, net, step = _placed_step(rank, arch, state, model_parallel, 1, "sgd", 0.1, False, dtype)
    x = pm.shard_batch(X, mesh).to(getattr(torch, dtype))
    y = pm.shard_batch(torch.from_numpy(np.asarray(y, np.int64)), mesh)
    loss, _ = step(x, y)
    new = {k: v.cpu().numpy() for k, v in pm.gathered_state(net).items()}
    cuda = rank.device.type == "cuda"
    times = []
    for _ in range(repeats):
        if cuda:
            torch.cuda.synchronize(rank.device)
        t0 = time.perf_counter()
        step(x, y)
        if cuda:
            torch.cuda.synchronize(rank.device)
        times.append((time.perf_counter() - t0) * 1e3)
    return float(loss), new, dict(zip(mesh.mesh_dim_names, mesh.shape)), times


def _dry_devices(n_devices: int, device) -> list[torch.device]:
    if device is not None and torch.device(device).type == "cpu":
        return [torch.device("cpu")] * n_devices
    from .parallel.mesh import cards

    found = cards(n_devices)
    if len(found) < n_devices:
        raise ValueError(f"dryrun_multichip({n_devices}) needs {n_devices} CUDA cards but {len(found)} are visible; "
                         f"pass device='cpu' to run {n_devices} gloo processes on the CPU instead")
    return found


def dryrun_multichip(n_devices: int, device: torch.device | str | None = None) -> str:
    """One sharded end-to-end training step on an n-rank mesh, and the three
    surfaces split over n devices (module docstring). Prints and returns
    the ``dryrun_multichip OK: ...`` line; raises on a non-finite loss or a
    parity failure."""
    from .features import get as get_extractor
    from .parallel.mesh import run_ranks
    from .train import search_cv, tune_batched

    devices = _dry_devices(n_devices, device)
    model_parallel = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    rng = np.random.default_rng(0)
    arch = {"type": "cnn", "filters": [8, 16, 16], "dropout": 0.3, "n_classes": _DRY_CLASSES, "first_stride": 4,
            "second_stride": 2, "input_shape": [1 + _DRY_N // 160, 40, 1]}
    net = _MODULE_FACTORY["cnn"](arch)
    from .models.deep import init_weights_

    init_weights_(net, torch.Generator().manual_seed(0))
    state = {k: v.numpy() for k, v in net.state_dict().items()}

    data = n_devices // model_parallel
    batch = data * 2
    waves = rng.standard_normal((batch, _DRY_N)).astype(np.float32)
    labels = np.arange(batch) % _DRY_CLASSES
    loss, _, _, dims = run_ranks(sharded_step, (arch, state, waves, labels, model_parallel, 1, "adam", 1e-3, True),
                                 devices)
    if not np.isfinite(loss):
        raise RuntimeError(f"non-finite loss from the sharded step: {loss}")
    hybrid_loss = None
    if n_devices % 4 == 0:
        hb = (n_devices // 2) * 2   # replica x data rows, 2 a rank
        hw = rng.standard_normal((hb, _DRY_N)).astype(np.float32)
        hybrid_loss, *_ = run_ranks(sharded_step, (arch, state, hw, np.arange(hb) % _DRY_CLASSES, 2, 2, "adam",
                                                   1e-3, True), devices)
        if not np.isfinite(hybrid_loss):
            raise RuntimeError(f"non-finite loss from the replica-mesh step: {hybrid_loss}")

    # CV folds, tuning trials and an extraction batch, split over the devices from this process
    Xc = rng.standard_normal((96, 12)).astype(np.float32)
    yc = (np.arange(96) % 4).astype(np.int64)
    fold_of = search_cv.stratified_fold_ids(yc, 4, seed=0)
    engine = search_cv._CVEngine(Xc, yc.astype(np.int32), fold_of, 4, device=devices[0], devices=devices)
    fold_scores = engine.eval_cell("svm", {"C": 1.0}, "accuracy")
    if len(fold_scores) != 4 or not all(np.isfinite(fold_scores)):
        raise RuntimeError(f"fold scores of the split CV cell: {fold_scores}")
    draws = [{"filters": [4], "batch_size": 16, "learning_rate": 10 ** -(2 + 0.3 * i), "dropout": 0.1}
             for i in range(4)]
    Xd = rng.standard_normal((64, 16, 8)).astype(np.float32)
    yd = (np.arange(64) % 4).astype(np.int32)
    trials = tune_batched.train_trial_group("cnn", draws, Xd, yd, Xd[:16], yd[:16], 4, sweep_epochs=1, seed=0,
                                            devices=devices, device=devices[0])
    if len(trials) != 4:
        raise RuntimeError(f"{len(trials)} trial results of 4")
    ex = get_extractor("audio_mel_spec")(duration=0.1, devices=devices)
    xb = rng.standard_normal((n_devices * 2, _DRY_SR // 10)).astype(np.float32)
    feats = ex._device_batch(xb, None)
    single = get_extractor("audio_mel_spec")(duration=0.1, device=devices[0])._device_batch(xb[:1], None)[0]
    if feats.shape[0] != len(xb) or np.max(np.abs(feats[0] - single)) > 1e-5:
        raise RuntimeError("the split extraction does not give the one-device features")

    hybrid_note = f"; replica mesh (2 replica x {n_devices // 4} data x 2 model) loss={hybrid_loss:.4f}" \
        if hybrid_loss is not None else ""
    line = (f"dryrun_multichip OK: mesh=({dims['data']} data x {dims['model']} model) on "
            f"{devices[0].type} ({'nccl' if devices[0].type == 'cuda' else 'gloo'}), batch={batch}, loss={loss:.4f}; "
            f"cv-folds split over {len(engine.parts)} devices (svm acc={np.mean(fold_scores):.3f}), 4 tuning trials "
            f"split over {min(len(devices), 4)} devices; extraction split ({len(xb)} rows -> "
            f"{-(-len(xb) // len(devices))} per device)" + hybrid_note)
    print(line)
    return line
