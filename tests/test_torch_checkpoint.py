"""Checkpoint/resume of the port's deep train loop (``utils/checkpoint.py``
and ``TorchTrainer.fit``'s ``checkpoint_dir`` / ``checkpoint_every`` /
``resume``) against the JAX package's semantics (``FlaxTrainer.fit``) and
file: ``train_state.npz`` holds JAX's keys (``p/<set>/<flax path>``, optax's
``o/`` state, ``__meta__``); a run stopped after epoch k restores every saved
field bit for bit and draws its next permutations from
``default_rng(seed + k)``; the teacher checkpoints each phase in its own
subdirectory; a file written by either package resumes in the other, and the
first step after the resume agrees with the other package's within the gates
of ``tests/test_torch_ds_cnn.py`` (loss 1e-5 relative, gradients 1e-4 of each
tensor's largest, BatchNorm statistics 5e-6 of their largest)."""

import json
import logging
import shutil

import numpy as np
import pytest
import torch

from audio_edge_ml_pipeline_tpu.models import get_model as jget_model
from audio_edge_ml_pipeline_tpu.utils import checkpoint as jckpt
from audio_edge_ml_pipeline_torch.models import deep as tdeep
from audio_edge_ml_pipeline_torch.models import get_model
from audio_edge_ml_pipeline_torch.utils import checkpoint as tckpt

N_CLASSES = 4
NAMES = [f"c{i}" for i in range(N_CLASSES)]
LOSS_REL = 1e-5    # the first step's loss after resume, port vs JAX
GRAD_REL = 1e-4    # its gradients, relative to each tensor's largest
STATS_REL = 5e-6   # its new BatchNorm statistics, relative to their largest (flax's float32 batch moments)
B1 = 0.9           # optax's and torch's Adam b1: mu' = b1 mu + (1 - b1) g
INNER = "o/.inner_state/0/"


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _meta(path):
    return json.loads(bytes(np.load(path)["__meta__"].tobytes()).decode())


def _dataset(seed, shape=(16, 20), per_class=10):
    r = np.random.default_rng(seed)
    y = np.repeat(np.arange(N_CLASSES), per_class).astype(np.int32)
    X = r.normal(0, 0.5, size=(len(y), *shape)).astype(np.float32)
    for c in range(N_CLASSES):
        X[y == c, c * 3 : c * 3 + 3] += 1.0
    perm = r.permutation(len(y))
    return X[perm], y[perm]


def _flax_moments(data, leaf):
    return {k[len(f"{INNER}{leaf}/"):]: data[k] for k in data if k.startswith(f"{INNER}{leaf}/")}


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


def _assert_file_holds(data, state, moments, step, tag):
    """The file's parameters and statistics are ``state`` and its moments
    ``moments`` ({name: {"exp_avg", "exp_avg_sq"}}, in flax layout), its
    counts ``step``, bit for bit."""
    flat = tdeep.params_to_flax(state)
    for k, v in flat.items():
        key = f"p/params/{k[2:]}" if k.startswith("p/") else f"p/cols/{k[2:]}"
        np.testing.assert_array_equal(data[key], v, err_msg=(tag, k))
    for field, leaf in (("exp_avg", ".mu"), ("exp_avg_sq", ".nu")):
        want = tdeep.params_to_flax({n: f[field] for n, f in moments.items()})
        got = _flax_moments(data, leaf)
        for k, v in want.items():
            np.testing.assert_array_equal(got[k[2:]], v, err_msg=(tag, field, k))
    assert int(data["o/.count"]) == int(data[f"{INNER}.count"]) == step


@pytest.mark.parametrize("model", ["ds_cnn", "cnn", "transformer"])
def test_resume_restores_every_field_and_reseeds(tmp_path, monkeypatch, model):
    X, y = _dataset(0)
    ckpt = tmp_path / "ckpt"
    rec = _Recorder(monkeypatch)
    first = _trainer(model, epochs=2, checkpoint_dir=str(ckpt))
    first.fit(X[:32], y[:32], X[32:], y[32:], NAMES, "r", tmp_path / "first", None, epoch_callback=rec.callback(first))
    path = ckpt / "train_state.npz"
    data = np.load(path)
    meta = _meta(path)
    assert meta["epoch"] == 1 and set(meta) == {"epoch", "lr", "best_val_loss", "es_wait", "lr_wait"}
    # the file holds the end of epoch 2: the live state (BatchNorm statistics too) and Adam's moments and count
    for fields in rec.moments[-1].values():
        assert set(fields) == {"step", "exp_avg", "exp_avg_sq"} and float(fields["step"]) == 8
    _assert_file_holds(data, rec.states[-1], rec.moments[-1], 8, "saved")
    assert float(data["o/.hyperparams/learning_rate"]) == np.float32(3e-3)
    best = tdeep.load_model_bundle(tmp_path / "first" / tdeep.MODEL_FILENAME)[1]
    saved_best = {("p/" + k[len("p/best/"):]) if k.startswith("p/best/") else "c/" + k[len("p/best_cols/"):]: data[k]
                  for k in data.files if k.startswith(("p/best/", "p/best_cols/"))}
    assert sorted(saved_best) == sorted(best)
    for k in best:
        np.testing.assert_array_equal(saved_best[k], best[k], err_msg=k)

    # resume: restored bit for bit, then epoch 3 from default_rng(seed + 2)
    restored = {}
    loader = tckpt.load_train_state

    def spying_load(p, templates, optimizer, params):
        out = loader(p, templates, optimizer, params)
        restored.update(states=out[0], meta=out[1],
                        opt={n: {f: torch.as_tensor(v).clone() for f, v in optimizer.state[prm].items()}
                             for n, prm in params.items()})
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
    assert _meta(path)["epoch"] == 3


def test_checkpoint_every_and_resume_false(tmp_path, monkeypatch):
    X, y = _dataset(1)
    rec = _Recorder(monkeypatch)
    ckpt = tmp_path / "ckpt"
    _trainer("cnn", epochs=3, checkpoint_dir=str(ckpt), checkpoint_every=2).fit(
        X[:32], y[:32], X[32:], y[32:], NAMES, "r", tmp_path / "a", None)
    assert _meta(ckpt / "train_state.npz")["epoch"] == 1   # epochs 2 only: 3 is not a multiple of 2
    n_perms = len(rec.perms)
    _trainer("cnn", epochs=3, checkpoint_dir=str(ckpt), resume=False).fit(
        X[:32], y[:32], X[32:], y[32:], NAMES, "r", tmp_path / "b", None)
    assert len(rec.perms) == n_perms + 3             # trained from epoch 1
    np.testing.assert_array_equal(rec.perms[n_perms], np.random.default_rng(5).permutation(32))


def test_a_foreign_or_mismatched_checkpoint_starts_fresh(tmp_path, caplog):
    """A truncated file (one tensor of the layout), another architecture's
    train state, or one whose frozen parameters carry moments is unusable: a
    warning, then a fresh run."""
    X, y = _dataset(2)
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    np.savez(ckpt / "train_state.npz", **{"p/params/Conv_0/kernel": np.zeros((3, 3, 1, 4), np.float32),
                                          "o/.count": np.zeros((), np.int32),
                                          "__meta__": np.frombuffer(json.dumps({"epoch": 5}).encode(), np.uint8)})
    with caplog.at_level(logging.WARNING):
        tr = _trainer("cnn", epochs=1, checkpoint_dir=str(ckpt))
        tr.fit(X[:32], y[:32], X[32:], y[32:], NAMES, "r", tmp_path / "a", None)
    assert "unusable" in caplog.text
    assert _meta(ckpt / "train_state.npz")["epoch"] == 0
    caplog.clear()
    with caplog.at_level(logging.WARNING):
        _trainer("ds_cnn", epochs=1, checkpoint_dir=str(ckpt)).fit(
            X[:32], y[:32], X[32:], y[32:], NAMES, "r", tmp_path / "b", None)
    assert "unusable" in caplog.text and "differ from the model's" in caplog.text

    # the cnn's own file, with a moment given to a parameter a run then freezes
    caplog.clear()
    net, opt, params = _stepped("cnn")
    tckpt.save_train_state(tmp_path / "s.npz", {"params": net.state_dict()}, opt, params, {"epoch": 0})
    frozen = torch.optim.Adam([params["denses.1.weight"]], lr=1e-3)
    with caplog.at_level(logging.WARNING):
        assert tckpt.load_train_state(tmp_path / "s.npz", {"params": net.state_dict()}, frozen, params) is None
    assert "not trained here, but its moments" in caplog.text


def _stepped(model):
    """A seeded module after one Adam step, its optimizer and named
    parameters."""
    arch = {"ds_cnn": {"type": "ds_cnn", "filters": [4, 8]},
            "cnn": {"type": "cnn", "filters": [4, 8], "first_stride": 2}}[model]
    net = tdeep._MODULE_FACTORY[model]({**arch, "dropout": 0.0, "n_classes": 3, "input_shape": [12, 12, 1]})
    tdeep.init_weights_(net, torch.Generator().manual_seed(0))
    params = dict(net.named_parameters())
    opt = torch.optim.Adam(list(params.values()), lr=1e-3)
    net(torch.randn(4, 12, 12, 1, generator=torch.Generator().manual_seed(1))).sum().backward()
    opt.step()
    return net, opt, params


def test_save_and_load_round_trip_bit_for_bit(tmp_path):
    net, opt, named = _stepped("ds_cnn")
    best = {k: v.clone() + 1.0 for k, v in net.state_dict().items()}
    meta = {"epoch": 7, "lr": 2.5e-4, "best_val_loss": 0.125, "es_wait": 2, "lr_wait": 1}
    tckpt.save_train_state(tmp_path / "s.npz", {"params": net.state_dict(), "best": best}, opt, named, meta)
    assert not list(tmp_path.glob("*.tmp.npz"))
    fresh = tdeep._MODULE_FACTORY["ds_cnn"]({"type": "ds_cnn", "filters": [4, 8], "dropout": 0.0, "n_classes": 3,
                                             "input_shape": [12, 12, 1]})
    fresh_named = dict(fresh.named_parameters())
    fresh_opt = torch.optim.Adam(list(fresh_named.values()), lr=1e-3)
    states, got_meta = tckpt.load_train_state(tmp_path / "s.npz", {"params": fresh.state_dict(), "best": best},
                                              fresh_opt, fresh_named)
    assert got_meta == meta
    for k, v in net.state_dict().items():
        assert torch.equal(states["params"][k], v) and torch.equal(states["best"][k], best[k])
    for k, p in named.items():
        q = fresh_named[k]
        for f in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(torch.as_tensor(fresh_opt.state[q][f]), torch.as_tensor(opt.state[p][f]))
    assert tckpt.load_train_state(tmp_path / "absent.npz", {}, fresh_opt, {}) is None


def test_teacher_checkpoints_each_phase(tmp_path):
    r = np.random.default_rng(3)
    y = np.repeat(np.arange(N_CLASSES), 4).astype(np.int32)
    X = r.normal(size=(len(y), 16, 20)).astype(np.float32)
    ckpt = tmp_path / "ckpt"
    tr = get_model("efficientnet_teacher")(epochs=3, warmup_epochs=1, image_size=32, batch_size=8, seed=1,
                                           dropout=0.0, checkpoint_dir=str(ckpt), device="cpu")
    tr.fit(X[:12], y[:12], X[12:], y[12:], NAMES, "t", tmp_path / "run", None)
    assert tr._extra["checkpoint_dir"] == str(ckpt)
    metas = {phase: _meta(ckpt / phase / "train_state.npz") for phase in ("phase1", "phase2")}
    assert metas["phase1"]["epoch"] == 0 and metas["phase2"]["epoch"] == 1
    assert metas["phase2"]["lr"] == pytest.approx(1e-4)          # lr x fine_tune_lr_factor
    # every parameter has moments, as in optax; phase 1's frozen ones are zero
    p1 = np.load(ckpt / "phase1" / "train_state.npz")
    mu1 = _flax_moments(p1, ".mu")
    assert len(mu1) == 213 and int(p1["o/.count"]) == 2
    assert {k for k, v in mu1.items() if v.any()} == {"head/kernel", "head/bias"}
    p2 = np.load(ckpt / "phase2" / "train_state.npz")
    mu2 = _flax_moments(p2, ".mu")
    assert len(mu2) == 213 and int(p2["o/.count"]) == 4
    assert sum(bool(v.any()) for v in mu2.values()) > 200


# -- across the two packages -------------------------------------------------

CROSS = {  # model -> (params of both trainers, input shape)
    "cnn": (dict(filters=[4, 8], first_stride=2), (16, 20)),
    "ds_cnn": (dict(filters=[4, 8], first_stride=2), (16, 20)),
    "efficientnet_teacher": (dict(image_size=32), (16, 20)),
}


def _moved_init(model, params, shape, path):
    """A seeded bundle for ``model`` with every BatchNorm moved off its init
    (scale 1, bias 0, mean 0, var 1), so that no gradient of the resumed
    step is zero in exact arithmetic (ROADMAP §3 g); both packages warm-start
    from it."""
    tr = get_model(model)(device="cpu", **params)
    Xp = tr._prepare_input(np.zeros((1, *shape), np.float32))
    arch = tr._arch(Xp.shape[1:], N_CLASSES)
    net = tdeep._MODULE_FACTORY[model](arch)
    tdeep.init_weights_(net, torch.Generator().manual_seed(4))
    r = np.random.default_rng(4)
    draw = {"mean": lambda n: r.normal(0, 0.3, n), "var": lambda n: r.uniform(0.5, 2.0, n),
            "weight": lambda n: r.uniform(0.5, 1.5, n), "bias": lambda n: r.normal(0, 0.2, n)}
    state = {k: (torch.tensor(draw[k.rsplit(".", 1)[1]](v.shape), dtype=torch.float32) if ".bns." in f".{k}" else v)
             for k, v in net.state_dict().items()}
    tdeep.save_model_bundle_flat(path, arch, tdeep.params_to_flax(state), np.zeros(1, np.float32),
                                 np.ones(1, np.float32))


def _cross_fit(pkg, model, ckpt, epochs, extra, X, y, out):
    """One fit of ``model`` by package ``pkg`` ("jax" or "torch"): 16 rows at
    batch 16, so an epoch is one step; dropout 0; the teacher in phase 1
    throughout. Returns the loss of each epoch it ran."""
    params, _ = CROSS[model]
    kw = dict(epochs=epochs, batch_size=16, dropout=0.0, learning_rate=3e-3, seed=5, checkpoint_dir=str(ckpt),
              **params, **extra)
    if model == "efficientnet_teacher":
        kw["warmup_epochs"] = epochs
    tr = get_model(model)(device="cpu", **kw) if pkg == "torch" else jget_model(model)(**kw)
    losses = {}
    tr.fit(X[:16], y[:16], X[16:24], y[16:24], NAMES, "x", out, None,
           epoch_callback=lambda e, logs: losses.__setitem__(e, logs["loss"]) and False)
    return losses


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(float(np.max(np.abs(b))), 1e-30))


@pytest.fixture(scope="module", params=list(CROSS))
def crossed(request, tmp_path_factory):
    """For one model: each package trains one epoch into a checkpoint; then
    each package resumes a copy of each file for a second epoch. Returns
    {writer: {"file", "restored": {reader: ...}, "after": {reader: (file, loss)}}}."""
    model = request.param
    params, shape = CROSS[model]
    tmp = tmp_path_factory.mktemp(f"cross_{model}")
    X, y = _dataset(6, shape=shape, per_class=6)
    extra = {}
    if model != "efficientnet_teacher":
        _moved_init(model, params, shape, tmp / "init.npz")
        extra["pretrained_model"] = str(tmp / "init.npz")
    sub = "phase1/" if model == "efficientnet_teacher" else ""
    out = {}
    tload, jload = tckpt.load_train_state, jckpt.load_train_state
    for writer in ("jax", "torch"):
        src = tmp / f"{writer}_wrote"
        _cross_fit(writer, model, src, 1, extra, X, y, tmp / f"{writer}_run")
        entry = {"file": dict(np.load(src / f"{sub}train_state.npz")), "restored": {}, "after": {}}
        for reader in ("jax", "torch"):
            dst = tmp / f"{writer}_to_{reader}"
            shutil.copytree(src, dst)
            got = {}
            if reader == "torch":
                def spy(p, templates, optimizer, named, got=got):
                    res = tload(p, templates, optimizer, named)
                    if res is not None:
                        got["flat"] = {**{k: v for g, st in res[0].items()
                                          for k, v in tckpt._flax_sets(tdeep.params_to_flax(st), g).items()},
                                       **{f"{INNER}{leaf}/{k[2:]}": v for field, leaf in
                                          (("exp_avg", ".mu"), ("exp_avg_sq", ".nu")) for k, v in tdeep.params_to_flax(
                                              {n: optimizer.state[q][field] if q in optimizer.state
                                               else torch.zeros_like(q) for n, q in named.items()}).items()}}
                        got["steps"] = {float(s["step"]) for s in optimizer.state.values()}
                        got["meta"] = res[1]
                    return res

                tdeep.load_train_state = spy
            else:
                def spy(p, params_t, opt_t, got=got):
                    res = jload(p, params_t, opt_t)
                    if res is not None:
                        got["flat"] = {**{f"p/{k}": v for k, v in jckpt._flatten(res[0]).items()},
                                       **{f"o/{k}": v for k, v in jckpt._flatten(res[1]).items()}}
                        got["meta"] = res[2]
                    return res

                jckpt.load_train_state = spy
            try:
                losses = _cross_fit(reader, model, dst, 2, extra, X, y, tmp / f"{writer}_to_{reader}_run")
            finally:
                tdeep.load_train_state, jckpt.load_train_state = tload, jload
            entry["restored"][reader] = got
            entry["after"][reader] = (dict(np.load(dst / f"{sub}train_state.npz")), losses)
        out[writer] = entry
    return model, out


def test_both_packages_write_the_same_keys(crossed):
    model, out = crossed
    jf, tf = out["jax"]["file"], out["torch"]["file"]
    assert sorted(jf) == sorted(tf)
    for k in jf:
        assert jf[k].shape == tf[k].shape and jf[k].dtype == tf[k].dtype, k
    assert int(tf["o/.count"]) == int(jf["o/.count"]) == 1
    assert set(_meta_of(tf)) == set(_meta_of(jf))
    if model == "efficientnet_teacher":   # phase 1: the frozen backbone's moments are zero in both
        for f in (jf, tf):
            assert {k for k, v in _flax_moments(f, ".mu").items() if v.any()} == {"head/kernel", "head/bias"}


def _meta_of(flat):
    return json.loads(bytes(flat["__meta__"].tobytes()).decode())


@pytest.mark.parametrize("writer", ["jax", "torch"])
@pytest.mark.parametrize("reader", ["jax", "torch"])
def test_resume_restores_the_other_packages_file(crossed, writer, reader):
    """Epoch, lr, parameters, statistics and moments restored equal, bit for
    bit, whichever package wrote the file and whichever resumes it."""
    model, out = crossed
    f, got = out[writer]["file"], out[writer]["restored"][reader]
    assert got, f"{reader} did not resume {writer}'s {model} checkpoint"
    assert got["meta"] == _meta_of(f)
    keys = [k for k in f if k != "__meta__" and not k.startswith(("o/.count", "o/.hyperparams", f"{INNER}.count"))]
    assert sorted(keys) == sorted(k for k in got["flat"] if k in keys or reader == "torch")
    for k in keys:
        np.testing.assert_array_equal(got["flat"][k], f[k], err_msg=k)
    if reader == "torch":
        assert got["steps"] == {float(f["o/.count"])}
    else:
        for k in ("o/.count", f"{INNER}.count", "o/.hyperparams/learning_rate", "o/.hyperparams/b1"):
            np.testing.assert_array_equal(got["flat"][k], f[k], err_msg=k)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_first_step_after_resume_matches_across_packages(crossed, writer):
    """From one file, the port's and JAX's resumed epoch (one step): its loss,
    its gradients (from the moments, g = (mu' - b1 mu) / (1 - b1)) and the
    new BatchNorm statistics agree within the step gates; frozen parameters
    keep zero moments."""
    model, out = crossed
    f1 = out[writer]["file"]
    (fj, lj), (ft, lt) = out[writer]["after"]["jax"], out[writer]["after"]["torch"]
    assert sorted(lj) == sorted(lt) == [1]
    assert abs(lt[1] - lj[1]) <= LOSS_REL * abs(lj[1])
    mu1 = _flax_moments(f1, ".mu")
    gj = {k: (v - B1 * mu1[k]) / (1 - B1) for k, v in _flax_moments(fj, ".mu").items()}
    gt = {k: (v - B1 * mu1[k]) / (1 - B1) for k, v in _flax_moments(ft, ".mu").items()}
    assert sorted(gj) == sorted(gt) and int(fj["o/.count"]) == int(ft["o/.count"]) == 2
    for k in gj:
        if not gj[k].any():
            assert not gt[k].any(), k
            continue
        assert _rel(gt[k], gj[k]) <= GRAD_REL, k
    stats = [k for k in fj if k.startswith("p/cols/")]
    assert len(stats) == {"cnn": 0, "ds_cnn": 6, "efficientnet_teacher": 98}[model]
    for k in stats:
        assert _rel(ft[k], fj[k]) <= STATS_REL, k
