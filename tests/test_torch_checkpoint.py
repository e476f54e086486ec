"""Checkpoint/resume of the port's deep train loop (``utils/checkpoint.py``
and ``TorchTrainer.fit``'s ``checkpoint_dir`` / ``checkpoint_every`` /
``resume``) against the JAX package's semantics (``FlaxTrainer.fit``): a run
stopped after epoch k restores every saved field bit for bit and draws its
next permutations from ``default_rng(seed + k)``; the teacher checkpoints
each phase in its own subdirectory; a file of the other package is refused."""

import json
import logging

import numpy as np
import pytest
import torch

from audio_edge_ml_pipeline_torch.models import deep as tdeep
from audio_edge_ml_pipeline_torch.models import get_model
from audio_edge_ml_pipeline_torch.utils import checkpoint as tckpt

N_CLASSES = 4
NAMES = [f"c{i}" for i in range(N_CLASSES)]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _dataset(seed, shape=(16, 20), per_class=10):
    r = np.random.default_rng(seed)
    y = np.repeat(np.arange(N_CLASSES), per_class).astype(np.int32)
    X = r.normal(0, 0.5, size=(len(y), *shape)).astype(np.float32)
    for c in range(N_CLASSES):
        X[y == c, c * 3 : c * 3 + 3] += 1.0
    perm = r.permutation(len(y))
    return X[perm], y[perm]


class _Recorder:
    """Records what a fit does at the end of each epoch (after its
    checkpoint): the module's state_dict, Adam's state by parameter name,
    and the permutation each epoch drew."""

    def __init__(self, monkeypatch):
        self.adams, self.perms, self.states, self.moments = [], [], [], []
        recorder = self

        class RecordingAdam(torch.optim.Adam):
            def __init__(self, params, **kw):
                super().__init__(params, **kw)
                recorder.adams.append(self)

        batches = tdeep.TorchTrainer._epoch_batches

        def recording_batches(perm, steps, bs):
            recorder.perms.append(np.array(perm))
            return batches(perm, steps, bs)

        monkeypatch.setattr(torch.optim, "Adam", RecordingAdam)
        monkeypatch.setattr(tdeep.TorchTrainer, "_epoch_batches", staticmethod(recording_batches))

    def callback(self, trainer):
        def cb(epoch, logs):
            self.states.append({k: v.detach().clone() for k, v in trainer._net.state_dict().items()})
            opt = self.adams[-1]
            names = {id(p): k for k, p in trainer._net.named_parameters()}
            self.moments.append({names[id(p)]: {f: torch.as_tensor(v).clone() for f, v in st.items()}
                                 for p, st in opt.state.items()})
            return False
        return cb


def _trainer(model, **kw):
    arch = {"ds_cnn": dict(filters=[4, 8]), "cnn": dict(filters=[4, 8], first_stride=2),
            "transformer": dict(num_heads=2, ff_dim=8, n_blocks=1)}[model]
    return get_model(model)(dropout=0.0, batch_size=8, learning_rate=3e-3, seed=5, device="cpu", **arch, **kw)


@pytest.mark.parametrize("model", ["ds_cnn", "cnn", "transformer"])
def test_resume_restores_every_field_and_reseeds(tmp_path, monkeypatch, model):
    X, y = _dataset(0)
    ckpt = tmp_path / "ckpt"
    rec = _Recorder(monkeypatch)
    first = _trainer(model, epochs=2, checkpoint_dir=str(ckpt))
    first.fit(X[:32], y[:32], X[32:], y[32:], NAMES, "r", tmp_path / "first", None, epoch_callback=rec.callback(first))
    path = ckpt / "train_state.npz"
    data = np.load(path)
    meta = json.loads(bytes(data["__meta__"].tobytes()).decode())
    assert meta["epoch"] == 1 and set(meta) == {"epoch", "lr", "best_val_loss", "es_wait", "lr_wait"}
    # the file holds the end of epoch 2: the live state (BatchNorm statistics too) and Adam's moments and step
    for k, v in rec.states[-1].items():
        np.testing.assert_array_equal(data[f"s/params/{k}"], v.numpy(), err_msg=k)
    for name, fields in rec.moments[-1].items():
        assert set(fields) == {"step", "exp_avg", "exp_avg_sq"}
        for f, v in fields.items():
            np.testing.assert_array_equal(data[f"o/{name}/{f}"], v.numpy(), err_msg=(name, f))
    best = tdeep.load_model_bundle(tmp_path / "first" / tdeep.MODEL_FILENAME)[1]
    saved_best = tdeep.params_to_flax({k[len("s/best/"):]: torch.from_numpy(data[k]) for k in data.files
                                       if k.startswith("s/best/")})
    assert sorted(saved_best) == sorted(best)
    for k in best:
        np.testing.assert_array_equal(saved_best[k], best[k], err_msg=k)

    # resume: restored bit for bit, then epoch 3 from default_rng(seed + 2)
    restored = {}
    loader = tckpt.load_train_state

    def spying_load(p, templates, optimizer, names):
        out = loader(p, templates, optimizer, names)
        restored.update(states=out[0], meta=out[1],
                        opt={n: {f: torch.as_tensor(v).clone() for f, v in optimizer.state[prm].items()}
                             for n, prm in zip(names, optimizer.param_groups[0]["params"])})
        return out

    monkeypatch.setattr(tdeep, "load_train_state", spying_load)
    n_perms = len(rec.perms)
    second = _trainer(model, epochs=4, checkpoint_dir=str(ckpt))
    second.fit(X[:32], y[:32], X[32:], y[32:], NAMES, "r", tmp_path / "second", None)
    assert restored["meta"] == meta
    for k, v in rec.states[-1].items():
        assert torch.equal(restored["states"]["params"][k], v), k
    for name, fields in rec.moments[-1].items():
        for f, v in fields.items():
            assert torch.equal(restored["opt"][name][f], v), (name, f)
    for k in best:
        assert np.array_equal(tdeep.params_to_flax(restored["states"]["best"])[k], best[k]), k
    rng = np.random.default_rng(5 + 2)
    assert len(rec.perms) == n_perms + 2
    for perm in rec.perms[n_perms:]:
        np.testing.assert_array_equal(perm, rng.permutation(32))
    assert json.loads(bytes(np.load(path)["__meta__"].tobytes()).decode())["epoch"] == 3


def test_checkpoint_every_and_resume_false(tmp_path, monkeypatch):
    X, y = _dataset(1)
    rec = _Recorder(monkeypatch)
    ckpt = tmp_path / "ckpt"
    _trainer("cnn", epochs=3, checkpoint_dir=str(ckpt), checkpoint_every=2).fit(
        X[:32], y[:32], X[32:], y[32:], NAMES, "r", tmp_path / "a", None)
    meta = json.loads(bytes(np.load(ckpt / "train_state.npz")["__meta__"].tobytes()).decode())
    assert meta["epoch"] == 1                        # epochs 2 only: 3 is not a multiple of 2
    n_perms = len(rec.perms)
    _trainer("cnn", epochs=3, checkpoint_dir=str(ckpt), resume=False).fit(
        X[:32], y[:32], X[32:], y[32:], NAMES, "r", tmp_path / "b", None)
    assert len(rec.perms) == n_perms + 3             # trained from epoch 1
    np.testing.assert_array_equal(rec.perms[n_perms], np.random.default_rng(5).permutation(32))


def test_a_foreign_or_mismatched_checkpoint_starts_fresh(tmp_path, caplog):
    """A JAX-package file (its p/ and o/ layout) or another architecture's
    train state is unusable: a warning, then a fresh run."""
    X, y = _dataset(2)
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    np.savez(ckpt / "train_state.npz", **{"p/params/Conv_0/kernel": np.zeros((3, 3, 1, 4), np.float32),
                                          "o/0/count": np.zeros((), np.int32),
                                          "__meta__": np.frombuffer(json.dumps({"epoch": 5}).encode(), np.uint8)})
    with caplog.at_level(logging.WARNING):
        tr = _trainer("cnn", epochs=1, checkpoint_dir=str(ckpt))
        tr.fit(X[:32], y[:32], X[32:], y[32:], NAMES, "r", tmp_path / "a", None)
    assert "unusable" in caplog.text
    assert json.loads(bytes(np.load(ckpt / "train_state.npz")["__meta__"].tobytes()).decode())["epoch"] == 0
    caplog.clear()
    with caplog.at_level(logging.WARNING):
        _trainer("ds_cnn", epochs=1, checkpoint_dir=str(ckpt)).fit(
            X[:32], y[:32], X[32:], y[32:], NAMES, "r", tmp_path / "b", None)
    assert "unusable" in caplog.text


def test_save_and_load_round_trip_bit_for_bit(tmp_path):
    net = tdeep._MODULE_FACTORY["ds_cnn"]({"type": "ds_cnn", "filters": [4, 8], "dropout": 0.0, "n_classes": 3,
                                           "input_shape": [12, 12, 1]})
    tdeep.init_weights_(net, torch.Generator().manual_seed(0))
    named = list(net.named_parameters())
    opt = torch.optim.Adam([p for _, p in named], lr=1e-3)
    net(torch.randn(4, 12, 12, 1)).sum().backward()
    opt.step()
    best = {k: v.clone() + 1.0 for k, v in net.state_dict().items()}
    meta = {"epoch": 7, "lr": 2.5e-4, "best_val_loss": 0.125, "es_wait": 2, "lr_wait": 1}
    tckpt.save_train_state(tmp_path / "s.npz", {"params": net.state_dict(), "best": best}, opt,
                           [k for k, _ in named], meta)
    assert not list(tmp_path.glob("*.tmp.npz"))
    fresh = tdeep._MODULE_FACTORY["ds_cnn"]({"type": "ds_cnn", "filters": [4, 8], "dropout": 0.0, "n_classes": 3,
                                             "input_shape": [12, 12, 1]})
    fresh_named = list(fresh.named_parameters())
    fresh_opt = torch.optim.Adam([p for _, p in fresh_named], lr=1e-3)
    states, got_meta = tckpt.load_train_state(tmp_path / "s.npz", {"params": fresh.state_dict(), "best": best},
                                              fresh_opt, [k for k, _ in fresh_named])
    assert got_meta == meta
    for k, v in net.state_dict().items():
        assert torch.equal(states["params"][k], v) and torch.equal(states["best"][k], best[k])
    for (_, p), (_, q) in zip(named, fresh_named):
        for f in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(torch.as_tensor(fresh_opt.state[q][f]), torch.as_tensor(opt.state[p][f]))
    assert tckpt.load_train_state(tmp_path / "absent.npz", {}, fresh_opt, []) is None


def test_teacher_checkpoints_each_phase(tmp_path):
    r = np.random.default_rng(3)
    y = np.repeat(np.arange(N_CLASSES), 4).astype(np.int32)
    X = r.normal(size=(len(y), 16, 20)).astype(np.float32)
    ckpt = tmp_path / "ckpt"
    tr = get_model("efficientnet_teacher")(epochs=3, warmup_epochs=1, image_size=32, batch_size=8, seed=1,
                                           dropout=0.0, checkpoint_dir=str(ckpt), device="cpu")
    tr.fit(X[:12], y[:12], X[12:], y[12:], NAMES, "t", tmp_path / "run", None)
    assert tr._extra["checkpoint_dir"] == str(ckpt)
    metas = {phase: json.loads(bytes(np.load(ckpt / phase / "train_state.npz")["__meta__"].tobytes()).decode())
             for phase in ("phase1", "phase2")}
    assert metas["phase1"]["epoch"] == 0 and metas["phase2"]["epoch"] == 1
    assert metas["phase2"]["lr"] == pytest.approx(1e-4)          # lr x fine_tune_lr_factor
    p1 = np.load(ckpt / "phase1" / "train_state.npz")
    assert {k.split("/")[1] for k in p1.files if k.startswith("o/")} == {"head.weight", "head.bias"}
    p2 = np.load(ckpt / "phase2" / "train_state.npz")
    assert len({k.split("/")[1] for k in p2.files if k.startswith("o/")}) == 213
