"""The port's collective layer (audio_edge_ml_pipeline_torch/parallel/mesh.py)
and its data-parallel surfaces, on the CPU through gloo processes, against
the JAX package's parallel/mesh.py on conftest's virtual devices and
against the port's one-process paths.

Each group is at most 4 processes of one torch thread each (run_ranks'
default on the CPU). The rank functions live in the port's package
(``entry.sharded_step``, ``models.deep._fit_peer``): spawn imports them by
reference, and a test module would pull jax into every child.

Tolerances:
- the sharded step against JAX's sharded step and the one-process step:
  loss and parameters 1e-5 (tests/test_infra.py's hybrid-mesh test);
- a data-parallel fit against the one-process fit at dropout 0: the loss
  history 1e-5 relative, parameters and BatchNorm statistics 1e-4 of each
  tensor's largest; with dropout on, at least JAX's own gates (validation
  accuracy within 0.1, probabilities 5e-3);
- the data-parallel fit against JAX's data_parallel=2 fit from the same
  carried-over weights: test_torch_train.py's two-epoch gates (losses 1e-5
  relative, weights 5e-6).
"""

import json
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from audio_edge_ml_pipeline_tpu.models import deep as jdeep
from audio_edge_ml_pipeline_tpu.parallel import mesh as jpm
from audio_edge_ml_pipeline_torch import entry
from audio_edge_ml_pipeline_torch.models import deep as tdeep
from audio_edge_ml_pipeline_torch.models import get_model
from audio_edge_ml_pipeline_torch.parallel import mesh as pm

CPU = "cpu"
MLP = {"type": "mlp", "hidden_units": [16], "dropout": 0.0, "n_classes": 4, "input_shape": [12]}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _rel(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(float(np.abs(b).max()), 1e-30))


# -- the mesh ---------------------------------------------------------------


def test_get_mesh_refuses_as_jax_refuses():
    with pytest.raises(ValueError, match="device='cpu'"):
        pm.get_mesh(16, devices=[CPU] * 8)
    with pytest.raises(ValueError, match="not divisible"):
        pm.get_mesh(8, model_parallel=2, dcn_replicas=3, devices=[CPU] * 8)
    with pytest.raises(RuntimeError, match="run_ranks"):   # outside a group of 8 ranks
        pm.get_mesh(8, model_parallel=2, devices=[CPU] * 8)


@pytest.mark.parametrize("model_parallel", [1, 2, 4])
def test_param_shardings_follow_jax_rule(model_parallel):
    """The same tensors are sharded as JAX shards their flax counterparts:
    a Linear / Conv2d weight on its output dim 0 (the kernel's last axis),
    3-D attention kernels on their last axis, vectors never."""
    from torch.distributed.tensor import Replicate, Shard

    net = torch.nn.ModuleDict({"conv": torch.nn.Conv2d(3, 8, 3), "dense": torch.nn.Linear(16, 6),
                               "head": torch.nn.Linear(6, 7)})
    attn = {"attn.query.kernel": torch.zeros(16, 4, 2), "attn.out.bias": torch.zeros(16)}
    named = {**dict(net.named_parameters()), **attn}
    flax_shapes = {"conv.weight": (3, 3, 3, 8), "conv.bias": (8,), "dense.weight": (16, 6), "dense.bias": (6,),
                   "head.weight": (6, 7), "head.bias": (7,), "attn.query.kernel": (16, 4, 2),
                   "attn.out.bias": (16,)}
    jmesh = jpm.get_mesh(4, model_parallel=model_parallel)
    jrules = jpm.param_shardings({k: np.zeros(s, np.float32) for k, s in flax_shapes.items()}, jmesh)
    mesh = SimpleNamespace(mesh_dim_names=("data", "model"), size=lambda i: (4 // model_parallel, model_parallel)[i])
    ours = pm.param_shardings(named, mesh)
    assert pm.batch_sharding(mesh) == (Shard(0), Replicate()) and pm.replicated(mesh) == (Replicate(),) * 2
    assert pm.data_axis_size(mesh) == 4 // model_parallel
    for name, placements in ours.items():
        jax_sharded = "model" in tuple(jrules[name].spec)
        assert any(p.is_shard() for p in placements) == jax_sharded, name
        assert placements[0] == Replicate()
        if jax_sharded:
            assert placements[1] == Shard(0 if name.endswith("weight") else 2), name


def _mlp_state(seed=0):
    r = np.random.default_rng(seed)
    return {"denses.0.weight": (0.3 * r.standard_normal((16, 12))).astype(np.float32),
            "denses.0.bias": (0.1 * r.standard_normal(16)).astype(np.float32),
            "denses.1.weight": (0.3 * r.standard_normal((4, 16))).astype(np.float32),
            "denses.1.bias": (0.1 * r.standard_normal(4)).astype(np.float32)}


def _jax_sharded_step(state, X, y, model_parallel, dcn_replicas):
    """JAX's make_sharded_train_step (sgd 0.1) on the same parameters."""
    params = {"w1": state["denses.0.weight"].T.copy(), "b1": state["denses.0.bias"],
              "w2": state["denses.1.weight"].T.copy(), "b2": state["denses.1.bias"]}
    mesh = jpm.get_mesh(4, model_parallel=model_parallel, dcn_replicas=dcn_replicas)
    opt = optax.sgd(0.1)

    def apply_fn(p, x, _rng):
        return jnp.maximum(x @ p["w1"] + p["b1"], 0.0) @ p["w2"] + p["b2"]

    p, s = jpm.place_train_state(params, opt.init(params), mesh)
    step = jpm.make_sharded_train_step(apply_fn, opt, mesh)
    with mesh:
        p, _, loss, _ = step(p, s, jpm.shard_batch(X, mesh), jpm.shard_batch(y, mesh), jax.random.PRNGKey(0))
    return float(loss), {"denses.0.weight": np.asarray(p["w1"]).T, "denses.0.bias": np.asarray(p["b1"]),
                         "denses.1.weight": np.asarray(p["w2"]).T, "denses.1.bias": np.asarray(p["b2"])}


def _one_process_step(arch, state, X, y, lr=0.1):
    net = tdeep._MODULE_FACTORY[arch["type"]](arch)
    net.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    net.train()
    opt = torch.optim.SGD(net.parameters(), lr=lr)
    loss = torch.nn.functional.cross_entropy(net(torch.from_numpy(X)), torch.from_numpy(y.astype(np.int64)))
    loss.backward()
    opt.step()
    return float(loss.detach()), {k: v.detach().numpy() for k, v in net.state_dict().items()}


@pytest.mark.parametrize("model_parallel,dcn_replicas", [(2, 1), (2, 2)])
def test_sharded_step_matches_jax_and_one_process(model_parallel, dcn_replicas):
    """One step on (data 2 x model 2) and (replica 2 x data 1 x model 2), 4
    gloo ranks, against JAX's sharded step and the port's one-process step."""
    rng = np.random.default_rng(1)
    state = _mlp_state()
    X = rng.standard_normal((16, 12)).astype(np.float32)
    y = (np.arange(16) % 4).astype(np.int32)
    loss, acc, new, dims = pm.run_ranks(entry.sharded_step, (MLP, state, X, y, model_parallel, dcn_replicas),
                                        [CPU] * 4, timeout=120)
    assert dims == ({"data": 2, "model": 2} if dcn_replicas == 1 else {"replica": 2, "data": 1, "model": 2})
    assert 0.0 <= acc <= 1.0
    for ref_loss, ref in (_jax_sharded_step(state, X, y, model_parallel, dcn_replicas),
                          _one_process_step(MLP, state, X, y)):
        assert abs(loss - ref_loss) <= 1e-5
        for k, v in ref.items():
            np.testing.assert_allclose(new[k], v, rtol=0, atol=1e-5, err_msg=k)
    assert _rel(new["denses.0.weight"], state["denses.0.weight"]) > 1e-4   # the step moved the weights


def test_column_parallel_cnn_step_matches_one_process():
    """The conv and dense layers of a CNN split over 2 model ranks x 2 data
    ranks: the same step as one process."""
    arch = {"type": "cnn", "filters": [4, 8], "dropout": 0.0, "n_classes": 4, "first_stride": 2,
            "second_stride": 1, "input_shape": [12, 16, 1]}
    net = tdeep._MODULE_FACTORY["cnn"](arch)
    tdeep.init_weights_(net, torch.Generator().manual_seed(3))
    for p in net.parameters():   # biases off zero, so their gradients are checked too
        p.data += 0.05 * torch.randn(p.shape, generator=torch.Generator().manual_seed(p.numel()))
    state = {k: v.detach().numpy() for k, v in net.state_dict().items()}
    rng = np.random.default_rng(2)
    X = rng.standard_normal((8, 12, 16, 1)).astype(np.float32)
    y = (np.arange(8) % 4).astype(np.int32)
    loss, _, new, _ = pm.run_ranks(entry.sharded_step, (arch, state, X, y, 2, 1), [CPU] * 4, timeout=120)
    ref_loss, ref = _one_process_step(arch, state, X, y)
    assert abs(loss - ref_loss) <= 1e-5 * abs(ref_loss)
    for k, v in ref.items():
        assert _rel(new[k], v) <= 1e-5, k


# -- data-parallel training ---------------------------------------------------


def _set(seed, shape, n=52, classes=3):
    r = np.random.default_rng(seed)
    y = (np.arange(n) % classes).astype(np.int32)
    X = r.uniform(0, 0.4, (n, *shape)).astype(np.float32)
    for c in range(classes):
        X[y == c, c * 2 : c * 2 + 2] += 0.5
    return X, y


FITS = {"mlp": ({"hidden_units": [16]}, (12,)), "cnn": ({"filters": [4, 8], "first_stride": 2}, (12, 16)),
        "ds_cnn": ({"filters": [4, 8]}, (12, 16))}


def _fit(name, tmp_path, tag, dropout=0.0, epochs=3, **kw):
    params, shape = FITS[name]
    X, y = _set(3, shape)
    trainer = get_model(name)(device=CPU, epochs=epochs, batch_size=10, seed=3, dropout=dropout, **params, **kw)
    logs = []
    trainer.fit(X[:40], y[:40], X[40:], y[40:], ["a", "b", "c"], tag, tmp_path / tag, None,
                epoch_callback=lambda e, lg: logs.append(lg) and False)
    return trainer, logs, X[40:]


@pytest.mark.parametrize("name", sorted(FITS))
def test_data_parallel_fit_equals_one_process(name, tmp_path, caplog):
    caplog.set_level("INFO")
    one, logs1, _ = _fit(name, tmp_path, "one")
    two, logs2, _ = _fit(name, tmp_path, "two", data_parallel=2)
    assert "data-parallel training over 2 devices" in caplog.text
    assert len(logs1) == len(logs2) == 3
    for a, b in zip(logs1, logs2):
        for key in ("loss", "val_loss"):
            assert b[key] == pytest.approx(a[key], rel=1e-5), key
    s1, s2 = one._net.state_dict(), two._net.state_dict()
    assert sorted(s1) == sorted(s2)
    for k in s1:
        assert float((s2[k] - s1[k]).abs().max()) <= 1e-4 * max(float(s1[k].abs().max()), 1e-30), k
    if name == "ds_cnn":   # the statistics moved: a batch's moments are the global batch's on both ranks
        assert not torch.equal(s2["bns.1.var"], torch.ones_like(s2["bns.1.var"]))
    assert (tmp_path / "two" / tdeep.MODEL_FILENAME).exists()


def test_float64_data_parallel_fit_equals_one_process_to_roundoff(tmp_path):
    """In float64 the two fits part only by the order of their sums: the
    ds_cnn's state within 1e-10 of each tensor's largest (float32's floor,
    a fit against itself under a 1e-7 input change, is ~1e-5-1e-3)."""
    one, logs1, _ = _fit("ds_cnn", tmp_path, "one", dtype="float64")
    two, logs2, _ = _fit("ds_cnn", tmp_path, "two", dtype=torch.float64, data_parallel=2)
    assert one._net.denses[0].weight.dtype == torch.float64
    for a, b in zip(logs1, logs2):
        assert b["loss"] == pytest.approx(a["loss"], rel=1e-12)
    s1, s2 = one._net.state_dict(), two._net.state_dict()
    for k in s1:
        assert float((s2[k] - s1[k]).abs().max()) <= 1e-10 * max(float(s1[k].abs().max()), 1e-30), k


def test_data_parallel_fit_with_dropout_meets_jax_gates(tmp_path):
    """JAX's own gates for its data_parallel fit (tests/test_infra.py): the
    masks here are the global batch's, so the two fits agree far closer."""
    one, _, Xv = _fit("mlp", tmp_path, "one", dropout=0.3)
    two, _, _ = _fit("mlp", tmp_path, "two", dropout=0.3, data_parallel=2)
    np.testing.assert_allclose(two.predict_proba(Xv), one.predict_proba(Xv), atol=5e-3)
    assert abs(float((two.predict(Xv) == one.predict(Xv)).mean()) - 1.0) <= 0.1


def test_data_parallel_fit_matches_jax_data_parallel_fit(tmp_path):
    """The port's data_parallel=2 cnn fit and JAX's, from the same JAX-made
    weights (test_torch_train.py's two-epoch gates)."""
    shape, classes = (16, 32), 4
    module = jdeep.CNNModule((4, 8), 0.0, classes, 2, 1)
    params = module.init(jax.random.PRNGKey(7), jnp.zeros((1, *shape, 1)), train=False)["params"]
    arch = {"type": "cnn", "dropout": 0.0, "n_classes": classes, "input_shape": [*shape, 1], "filters": [4, 8],
            "first_stride": 2, "second_stride": 1}
    bundle = tmp_path / "init.flax.npz"
    jdeep.save_model_bundle(bundle, arch, params, np.zeros(1, np.float32), np.ones(1, np.float32))
    r = np.random.default_rng(1)
    y = np.repeat(np.arange(classes), 10).astype(np.int32)
    X = r.uniform(0, 0.4, (len(y), *shape)).astype(np.float32)
    for c in range(classes):
        X[y == c, c * 4 : c * 4 + 4, :] += 0.5
    perm = r.permutation(len(y))
    X, y = X[perm], y[perm]
    kw = dict(dropout=0.0, batch_size=8, epochs=2, seed=5, filters=[4, 8], first_stride=2, second_stride=1,
              data_parallel=2, pretrained_model=str(bundle))
    names = [f"c{i}" for i in range(classes)]
    logs = {"jax": [], "torch": []}
    jdeep.CNNTrainer(**kw).fit(X[:32], y[:32], X[32:], y[32:], names, "j", tmp_path / "jax", None,
                               epoch_callback=lambda e, lg: logs["jax"].append(lg) and False)
    tdeep.CNNTrainer(device=CPU, **kw).fit(X[:32], y[:32], X[32:], y[32:], names, "t", tmp_path / "torch", None,
                                           epoch_callback=lambda e, lg: logs["torch"].append(lg) and False)
    assert len(logs["jax"]) == len(logs["torch"]) == 2
    for lj, lt in zip(logs["jax"], logs["torch"]):
        for key in ("loss", "val_loss"):
            assert lt[key] == pytest.approx(lj[key], rel=1e-5), key
    _, flat_j, _, _ = jdeep.load_model_bundle(tmp_path / "jax" / jdeep.MODEL_FILENAME)
    _, flat_t, _, _ = jdeep.load_model_bundle(tmp_path / "torch" / tdeep.MODEL_FILENAME)
    assert sorted(flat_t) == sorted(flat_j)
    for k in flat_j:
        np.testing.assert_allclose(flat_t[k], flat_j[k], rtol=0, atol=5e-6, err_msg=k)


def test_data_parallel_without_enough_cards_raises(monkeypatch):
    """No CPU fallback: a trainer on a card asks for 2 cards and sees 1."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    X, y = _set(0, (12,))
    trainer = get_model("mlp")(data_parallel=2, hidden_units=[4], epochs=1)
    assert trainer.device.type == "cuda"
    with pytest.raises(ValueError, match="needs 2 CUDA cards but 1 are visible"):
        trainer.fit(X, y, X, y, ["a", "b", "c"], "r", "/nonexistent", None)
    with pytest.raises(ValueError, match="NCCL refuses two ranks on one card"):
        pm.data_parallel_devices(2, "cuda:0", ["cuda:0", "cuda:0"])
    assert pm.data_parallel_devices(2, "cuda:0", ["cuda:0", "cuda:0"], "gloo")[1] == "gloo"


def test_spawned_ranks_compute_with_the_callers_float32_settings():
    """A fresh process takes torch's defaults (cuDNN's TF32 convolutions on):
    every rank must compute as the caller does, or a data-parallel fit on a
    card parts from the one-process fit."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = matmul.allow_tf32, cudnn.allow_tf32, cudnn.benchmark
    try:
        matmul.allow_tf32, cudnn.allow_tf32, cudnn.benchmark = True, False, True
        got = pm.run_ranks(pm.rank_numerics, (), [CPU] * 2, timeout=120)
    finally:
        matmul.allow_tf32, cudnn.allow_tf32, cudnn.benchmark = saved
    assert got == [(True, False, cudnn.deterministic, True)] * 2


def test_a_failing_rank_fails_the_fit_with_its_traceback(tmp_path, monkeypatch):
    """Rank 1 raises inside its loop while rank 0 waits in a collective: the
    fit raises with rank 1's traceback, long before the group's timeout."""
    real = tdeep.TorchTrainer._peer_copy

    def broken(self):
        peer = real(self)
        peer.batch_size = "not a size"
        return peer

    monkeypatch.setattr(tdeep.TorchTrainer, "_peer_copy", broken)
    X, y = _set(0, (12,))
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="a rank of the group failed") as err:
        get_model("mlp")(device=CPU, data_parallel=2, hidden_units=[4], epochs=1).fit(
            X, y, X, y, ["a", "b", "c"], "r", tmp_path, None)
    assert "TypeError" in str(err.value)
    assert time.monotonic() - t0 < 120


# -- the dry run --------------------------------------------------------------


def test_dryrun_multichip_on_four_gloo_processes(capsys):
    line = entry.dryrun_multichip(4, device=CPU)
    assert line.startswith("dryrun_multichip OK: mesh=(2 data x 2 model) on cpu (gloo)")
    assert "replica mesh (2 replica x 1 data x 2 model)" in line
    assert "cv-folds split over 4 devices" in line and "4 tuning trials split over 4 devices" in line
    assert line in capsys.readouterr().out


def test_dryrun_multichip_refuses_missing_cards():
    with pytest.raises(ValueError, match="needs 2 CUDA cards"):
        entry.dryrun_multichip(2)


def test_split_extraction_equals_one_device_and_golden(tmp_path):
    """tests/test_infra.py's sharded extraction, split over 3 CPU devices:
    10 clips in parts of 4, 3 and 3 rows, bit for bit the one-device
    FeatureSet, within 1e-5 of golden."""
    from audio_edge_ml_pipeline_torch.data.audio_io import load_audio, write_wav
    from audio_edge_ml_pipeline_torch.data.loaders import AudioFolderLoader
    from audio_edge_ml_pipeline_torch.features import get
    from audio_edge_ml_pipeline_torch.ops import golden as g

    root = tmp_path / "audio"
    rng = np.random.default_rng(2)
    for c in range(2):
        d = root / f"c{c}"
        d.mkdir(parents=True)
        for i in range(5):
            t = np.arange(16000) / 16000
            w = (0.4 * np.sin(2 * np.pi * (300 + 200 * c + 10 * i) * t)
                 + 0.03 * rng.standard_normal(16000)).astype(np.float32)
            write_wav(d / f"{i}.wav", w, 16000)
    split = get("audio_mel_spec")(duration=1.0, devices=[CPU] * 3)
    assert [d.type for d in split.devices] == [CPU] * 3
    fs = split.extract_dataset(AudioFolderLoader(root))
    one = get("audio_mel_spec")(duration=1.0, device=CPU).extract_dataset(AudioFolderLoader(root))
    assert fs.features.shape == (10, 40, 101)
    np.testing.assert_array_equal(fs.features, one.features)
    y0, _ = load_audio(sorted((root / "c0").glob("*.wav"))[0], sr=16000)
    assert np.max(np.abs(fs.features[0] - g.mel_spec_feature(y0[:16000], sr=16000))) <= 1e-5


def test_extractor_devices_default_to_every_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    from audio_edge_ml_pipeline_torch.features import get

    assert [str(d) for d in get("audio_mel_spec")().devices] == ["cuda:0", "cuda:1", "cuda:2"]
    assert [str(d) for d in get("audio_mel_spec")(device="cuda:1").devices] == ["cuda:1"]
    assert json.dumps([len(p) for p in pm.split_parts(10, 3)]) == "[4, 3, 3]"
    assert [str(d) for d in pm.part_devices(4, "cuda:0", limit=2)] == ["cuda:0", "cuda:1"]
    assert [str(d) for d in pm.part_devices(4, CPU)] == [CPU]
