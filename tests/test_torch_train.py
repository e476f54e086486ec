"""Port parity: the CNN training path of audio_edge_ml_pipeline_torch
(``CNNTrainer.fit``, Adam, the splits, evaluation, tracking, the bundle it
writes) against the JAX package's ``FlaxTrainer`` and its helpers, on the
CPU at a small size: 4 classes, (16, 32) features, filters [4, 8] with one
strided block."""

import json
import subprocess
import zlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from audio_edge_ml_pipeline_tpu.models import deep as jdeep
from audio_edge_ml_pipeline_tpu.train import evaluate as jev
from audio_edge_ml_pipeline_tpu.utils import tracking as jtracking
from audio_edge_ml_pipeline_torch.models import deep as tdeep
from audio_edge_ml_pipeline_torch.train import evaluate as tev
from audio_edge_ml_pipeline_torch.train import split as tsplit
from audio_edge_ml_pipeline_torch.utils import profiling as tprofiling
from audio_edge_ml_pipeline_torch.utils import tracking as ttracking

N_CLASSES, SHAPE = 4, (16, 32)
ARCH = dict(filters=[4, 8], first_stride=2, second_stride=1)
REL = 1e-5  # first-step loss and gradients: float32 convolutions summed in other orders


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _dataset(seed, per_class=10):
    """Mel-like [0, 1] rows with a class-dependent band."""
    r = np.random.default_rng(seed)
    y = np.repeat(np.arange(N_CLASSES), per_class).astype(np.int32)
    X = r.uniform(0, 0.4, size=(len(y), *SHAPE)).astype(np.float32)
    for c in range(N_CLASSES):
        X[y == c, c * 4 : c * 4 + 4, :] += 0.5
    perm = r.permutation(len(y))
    return X[perm], y[perm]


@pytest.fixture(scope="module")
def jax_bundle(tmp_path_factory):
    """A JAX-initialised CNN bundle (flax init, seed 7) to warm-start from."""
    path = tmp_path_factory.mktemp("init") / "init.flax.npz"
    module = jdeep.CNNModule(tuple(ARCH["filters"]), 0.0, N_CLASSES, ARCH["first_stride"], ARCH["second_stride"])
    params = module.init(jax.random.PRNGKey(7), jnp.zeros((1, *SHAPE, 1)), train=False)["params"]
    arch = {"type": "cnn", "dropout": 0.0, "n_classes": N_CLASSES, "input_shape": [*SHAPE, 1], **ARCH}
    jdeep.save_model_bundle(path, arch, params, np.zeros(1, np.float32), np.ones(1, np.float32))
    return path


def _rel(a, b):
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))) / max(float(np.max(np.abs(b))), 1e-30))


# -- the first step -------------------------------------------------------


def _grad_capture():
    """An optax transformation whose new state is the gradient and whose
    update is zero: one train step of the JAX trainer then hands back its
    loss and its exact gradients."""
    return optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g),
    )


@pytest.mark.parametrize("step", ["first", "last_padded"])
def test_first_step_loss_and_gradients_match_flax_trainer(jax_bundle, step):
    X, y = _dataset(0, per_class=9)  # 36 rows, batch 8: the last batch has 4 weighted rows
    bs, seed = 8, 3
    Xp = X[..., None]
    steps = -(-len(X) // bs)
    idx_mat, w_mat = tdeep.TorchTrainer._epoch_batches(np.random.default_rng(seed).permutation(len(X)), steps, bs)
    s = 0 if step == "first" else steps - 1

    jt = jdeep.CNNTrainer(dropout=0.0, batch_size=bs, seed=seed, **ARCH)
    jt._arch_dict = jt._arch(Xp.shape[1:], N_CLASSES)
    jt._adapt_normalization(Xp)
    module = jt._module()
    params = module.init(jax.random.PRNGKey(0), jnp.zeros((1, *Xp.shape[1:])), train=False)["params"]
    params, _, transferred = jdeep.transfer_pretrained(params, {}, jax_bundle)
    assert transferred == 8
    capture = _grad_capture()
    train_step = jt._make_train_step(module, capture, ())
    _, _, j_grads, j_loss, j_acc = train_step(params, {}, capture.init(params), jnp.asarray(Xp), jnp.asarray(y),
                                              jnp.asarray(idx_mat[s]), jnp.asarray(w_mat[s]), jax.random.PRNGKey(1))
    j_grads = jdeep._flatten_params(j_grads)

    tt = tdeep.CNNTrainer(dropout=0.0, batch_size=bs, seed=seed, pretrained_model=str(jax_bundle),
                          device="cpu", **ARCH)
    tt.prepare_fit(Xp, N_CLASSES)
    np.testing.assert_array_equal(tt._norm_mean.numpy(), np.asarray(jt._norm_mean))
    np.testing.assert_array_equal(tt._norm_var.numpy(), np.asarray(jt._norm_var))
    tt._net.train()
    sgd = torch.optim.SGD(tt._net.parameters(), lr=0.0)  # leaves the weights; keeps .grad
    t_loss, t_acc = tt.train_step(sgd, torch.from_numpy(Xp), torch.from_numpy(y.astype(np.int64)),
                                  torch.from_numpy(idx_mat[s].astype(np.int64)), torch.from_numpy(w_mat[s]))
    t_grads = tdeep.params_to_flax({k: p.grad for k, p in tt._net.named_parameters()})

    assert abs(float(t_loss) - float(j_loss)) <= REL * abs(float(j_loss))
    assert float(t_acc) == pytest.approx(float(j_acc), abs=1e-7)
    assert sorted(t_grads) == sorted(j_grads)
    for k in j_grads:
        assert _rel(t_grads[k], j_grads[k]) <= REL, k


@pytest.mark.parametrize("n_steps", [1, 5])
def test_torch_adam_is_optax_adam(n_steps):
    """optax.adam and torch.optim.Adam put eps outside the sqrt of the
    bias-corrected second moment alike: the same steps on the same
    gradients, including near-zero ones where a step is +-lr whatever their
    size."""
    r = np.random.default_rng(n_steps)
    p0 = r.normal(size=(64,)).astype(np.float32)
    grads = [(r.normal(size=64) * np.logspace(-9, 0, 64)).astype(np.float32) for _ in range(n_steps)]
    opt = optax.adam(1e-3)
    jp, state = jnp.asarray(p0), opt.init(jnp.asarray(p0))
    tp = torch.tensor(p0, requires_grad=True)
    topt = torch.optim.Adam([tp], lr=1e-3, betas=(0.9, 0.999), eps=1e-8)
    for g in grads:
        upd, state = opt.update(jnp.asarray(g), state, jp)
        jp = optax.apply_updates(jp, upd)
        tp.grad = torch.from_numpy(g)
        topt.step()
    # the two round each update in another order: a float32 ulp of |p| <= 2
    # (2.4e-7) per step at most, against steps of about lr = 1e-3
    np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp), rtol=0, atol=2.4e-7 * n_steps)
    assert np.max(np.abs(tp.detach().numpy() - p0)) > 0.5e-3 * n_steps  # the steps did happen


# -- a whole fit -------------------------------------------------------


def _fit_both(jax_bundle, tmp_path, epochs=2):
    X, y = _dataset(1)
    Xtr, ytr, Xva, yva = X[:32], y[:32], X[32:], y[32:]
    names = [f"c{i}" for i in range(N_CLASSES)]
    kw = dict(dropout=0.0, batch_size=8, epochs=epochs, seed=5, **ARCH)
    logs = {"jax": [], "torch": []}

    jt = jdeep.CNNTrainer(pretrained_model=str(jax_bundle), **kw)
    jt.fit(Xtr, ytr, Xva, yva, names, "j", tmp_path / "jax", None,
           epoch_callback=lambda e, lg: logs["jax"].append(lg) and False)
    tt = tdeep.CNNTrainer(pretrained_model=str(jax_bundle), device="cpu", **kw)
    result = tt.fit(Xtr, ytr, Xva, yva, names, "t", tmp_path / "torch", None,
                    epoch_callback=lambda e, lg: logs["torch"].append(lg) and False)
    return jt, tt, result, logs, Xva


def test_two_epoch_fit_matches_flax_trainer(jax_bundle, tmp_path):
    """Per-epoch losses within 1e-5 relative and final weights within 5e-6
    absolute. 2 epochs are 8 Adam steps at lr 1e-3; each step moves a weight
    by about lr whatever its gradient's size, so a gradient element that
    differs by its 1e-6 relative rounding moves the weights by lr * 1e-6 at
    most per step, far inside 5e-6. The bound would fail only if a gradient
    element sat so near zero that rounding flipped its sign (a step of 2 lr);
    the test data keeps every weight's gradient away from that."""
    jt, tt, result, logs, _ = _fit_both(jax_bundle, tmp_path)
    assert len(logs["jax"]) == len(logs["torch"]) == 2
    for lj, lt in zip(logs["jax"], logs["torch"]):
        for key in ("loss", "val_loss"):
            assert lt[key] == pytest.approx(lj[key], rel=1e-5), key
        for key in ("accuracy", "val_accuracy"):
            assert lt[key] == pytest.approx(lj[key], abs=1e-6), key
    _, flat_j, mean_j, var_j = jdeep.load_model_bundle(tmp_path / "jax" / jdeep.MODEL_FILENAME)
    arch_t, flat_t, mean_t, var_t = jdeep.load_model_bundle(tmp_path / "torch" / tdeep.MODEL_FILENAME)
    assert sorted(flat_t) == sorted(flat_j)
    for k in flat_j:
        np.testing.assert_allclose(flat_t[k], flat_j[k], rtol=0, atol=5e-6, err_msg=k)
    np.testing.assert_array_equal(mean_t, mean_j)
    np.testing.assert_array_equal(var_t, var_j)
    assert arch_t["type"] == "cnn" and arch_t["input_shape"] == [*SHAPE, 1]
    info_t = json.loads((tmp_path / "torch" / "model_info.json").read_text())
    info_j = json.loads((tmp_path / "jax" / "model_info.json").read_text())
    assert set(info_t) == set(info_j) and info_t["params"] == info_j["params"]
    assert info_t["val_accuracy"] == info_j["val_accuracy"]
    assert result.metrics["val_accuracy"] == info_t["val_accuracy"]
    for name in ("classification_report.txt", "confusion_matrix.png"):
        assert (tmp_path / "torch" / name).stat().st_size > 0


def test_port_bundle_reads_in_jax_with_the_same_logits(jax_bundle, tmp_path):
    _, tt, _, _, Xva = _fit_both(jax_bundle, tmp_path, epochs=1)
    jm = jdeep.load_any_model(tmp_path / "torch" / tdeep.MODEL_FILENAME)
    ours = tt._batched_logits(tt._prepare_input(Xva))
    theirs = np.asarray(jm._batched_logits(jm._prepare_input(Xva)))
    assert np.max(np.abs(ours - theirs)) <= 1e-5
    np.testing.assert_array_equal(tt.predict(Xva), jm.predict(Xva))


def test_best_weights_are_restored_not_aliased(tmp_path):
    """EarlyStopping keeps a copy of the best epoch's weights: Adam's in-place
    updates after that epoch must not reach them."""
    X, y = _dataset(2)
    tt = tdeep.CNNTrainer(dropout=0.0, batch_size=8, epochs=3, seed=0, learning_rate=0.5, device="cpu", **ARCH)
    vals = []
    tt.fit(X[:32], y[:32], X[32:], y[32:], [f"c{i}" for i in range(N_CLASSES)], "r", tmp_path, None,
           epoch_callback=lambda e, lg: vals.append(lg["val_loss"]) and False)
    best = int(np.argmin(vals))
    logits = tt._batched_logits(tt._prepare_input(X[32:]))
    shifted = logits - logits.max(-1, keepdims=True)
    loss = float(np.mean(-(shifted - np.log(np.exp(shifted).sum(-1, keepdims=True)))[np.arange(8), y[32:]]))
    assert loss == pytest.approx(vals[best], rel=1e-6)


def test_unported_training_options_raise(tmp_path):
    """checkpoint_dir trains and writes its train state
    (tests/test_torch_checkpoint.py holds it to JAX's resume); data_parallel
    is ported (tests/test_torch_parallel.py)."""
    X, y = _dataset(0)
    tdeep.CNNTrainer(device="cpu", epochs=1, checkpoint_dir=str(tmp_path / "ckpt"), **ARCH).fit(
        X, y, X, y, list("abcd"), "r", tmp_path / "run", None)
    assert (tmp_path / "ckpt" / "train_state.npz").exists()


# -- splits, evaluation, tracking, timing ---------------------------------


@pytest.mark.parametrize("case", range(6))
def test_splits_pick_the_rows_sklearn_picks(case):
    from sklearn.model_selection import StratifiedKFold, train_test_split

    r = np.random.default_rng(case)
    n_cls = int(r.integers(2, 8))
    y = r.integers(0, n_cls, int(r.integers(4 * n_cls, 150)))
    X = np.arange(len(y))
    for stratify in (y, None):
        tr, te = train_test_split(X, test_size=0.2, random_state=42, stratify=stratify)
        ours = tsplit.split_indices(len(y), 0.2, 42, stratify)
        np.testing.assert_array_equal(ours[0], tr)
        np.testing.assert_array_equal(ours[1], te)
    k = int(min(3, np.bincount(y)[np.bincount(y) > 0].min()))
    for (a, b), (c, d) in zip(StratifiedKFold(k, shuffle=True, random_state=42).split(X, y),
                              tsplit.stratified_kfold(y, k, 42)):
        np.testing.assert_array_equal(c, a)
        np.testing.assert_array_equal(d, b)


def test_stratified_split_refuses_what_sklearn_refuses():
    from sklearn.model_selection import train_test_split

    y = np.repeat(np.arange(27), 4)  # 22 val rows for 27 classes
    with pytest.raises(ValueError):
        train_test_split(np.arange(len(y)), test_size=0.2, random_state=42, stratify=y)
    with pytest.raises(ValueError):
        tsplit.split_indices(len(y), 0.2, 42, y)


def test_evaluation_matches_jax(rng, tmp_path):
    y_true = rng.integers(0, 5, 60)
    y_pred = np.where(rng.random(60) < 0.6, y_true, rng.integers(0, 5, 60))
    proba = rng.dirichlet(np.ones(5), 60)
    names = [f"class_{i}" for i in range(5)]
    assert tev.compute_metrics(y_true, y_pred, proba, names) == jev.compute_metrics(y_true, y_pred, proba, names)
    assert tev.classification_report_text(y_true, y_pred, names) == jev.classification_report_text(y_true, y_pred, names)
    png = tev.heatmap_png([[3, 1], [0, 5]], cell=4)
    assert png.startswith(b"\x89PNG\r\n\x1a\n")
    idat = png[png.index(b"IDAT") + 4 : png.index(b"IEND") - 8]
    assert len(zlib.decompress(idat)) == 8 * (1 + 8 * 3)  # 8 rows of filter byte + 8 RGB pixels


def test_confusion_png_without_matplotlib(tmp_path, monkeypatch):
    """The card's machine has no matplotlib: the plain heatmap stands in."""
    import sys

    monkeypatch.setitem(sys.modules, "matplotlib", None)  # import matplotlib -> ImportError
    tev.save_confusion_matrix_png([[2, 0], [1, 3]], ["a", "b"], tmp_path / "cm.png")
    assert (tmp_path / "cm.png").read_bytes() == tev.heatmap_png([[2, 0], [1, 3]])


def test_shortlist_helpers_match_jax(tmp_path, capsys):
    from audio_edge_ml_pipeline_tpu.train import select as jselect
    from audio_edge_ml_pipeline_torch.train import select as tselect

    uri = str(tmp_path / "mlruns")
    ttracking.set_tracking_uri(uri)
    ttracking.set_experiment("sl")
    for name, acc in (("a", 0.5), ("b", 0.9), ("c", 0.7)):
        with ttracking.start_run(run_name=name) as run:
            run.log_param("model", "cnn")
            run.log_param("features_dir", str(tmp_path / "x_train"))
            run.log_metric("val_accuracy", acc)
            run.log_metric("val_f1_macro", acc - 0.1)
    ours = tselect.select_preopt("sl", uri, min_accuracy=0.6, top_n=5)
    theirs = jselect.select_preopt("sl", uri, min_accuracy=0.6, top_n=5)
    assert [r["run_name"] for r in ours] == [r["run_name"] for r in theirs] == ["b", "c"]
    assert ours == theirs
    tselect.print_preopt_table(ours, "val_f1_macro", 5)
    printed = capsys.readouterr().out
    jselect.print_preopt_table(theirs, "val_f1_macro", 5)
    assert printed == capsys.readouterr().out and "Shortlist #1" in printed
    tselect.write_shortlist(ours, tmp_path / "sl.json", "sl")
    doc = json.loads((tmp_path / "sl.json").read_text())
    assert [c["run_name"] for c in doc["candidates"]] == ["b", "c"] and doc["n_candidates"] == 2
    ttracking.set_tracking_uri(None)


def test_port_runs_are_read_by_the_jax_tracking_store(tmp_path):
    ttracking.set_tracking_uri(str(tmp_path / "mlruns"))
    ttracking.set_experiment("crossing")
    with ttracking.start_run(run_name="port-run") as run:
        run.log_param("model", "cnn")
        run.log_metric("val_accuracy", 0.75)
    jtracking.set_tracking_uri(str(tmp_path / "mlruns"))
    (rec,) = jtracking.search_runs("crossing")
    assert (rec.run_id, rec.run_name, rec.status) == (run.info.run_id, "port-run", "FINISHED")
    assert rec.params["model"] == "cnn" and rec.metrics["val_accuracy"] == 0.75
    assert ttracking.get_run(run.info.run_id).metrics == rec.metrics
    # an http(s) URI takes the REST backend (tests/test_torch_tracking_rest.py); nothing listens on port 1
    ttracking.set_tracking_uri("http://127.0.0.1:1")
    with pytest.raises(ttracking.TrackingServerError, match="unreachable"):
        ttracking.set_experiment("crossing")
    ttracking.set_tracking_uri(None)


def test_stage_timer_counts_and_refuses_the_unported_trace(monkeypatch, caplog, tmp_path):
    """Stages are timed; with AEP_PROFILE_DIR set each stage writes its
    torch.profiler trace under $AEP_PROFILE_DIR/<name>/ (the trace was
    ported, so it is no longer refused), a stage nested in a traced one
    writes none, and both are timed."""
    tprofiling.reset()
    for _ in range(2):
        with tprofiling.stage_timer("fit:cnn"):
            pass
    assert tprofiling.timing_report()["fit:cnn"]["calls"] == 2
    with caplog.at_level("INFO", logger=tprofiling.logger.name):
        tprofiling.log_timing_report()
    assert '"fit:cnn": {"calls": 2' in caplog.text
    assert not list(tmp_path.iterdir())
    monkeypatch.setenv("AEP_PROFILE_DIR", str(tmp_path))
    with tprofiling.stage_timer("fit:cnn"):
        x = torch.randn(64, 64)
        with tprofiling.stage_timer("extract:audio_mel_spec"):
            (x @ x).sum()
    assert sorted(p.name for p in tmp_path.iterdir()) == ["fit:cnn"]
    (trace,) = (tmp_path / "fit:cnn").glob("*.pt.trace.json")
    events = json.loads(trace.read_text())["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)
    report = tprofiling.timing_report()
    assert report["fit:cnn"]["calls"] == 3 and report["extract:audio_mel_spec"]["calls"] == 1
    # an unwritable trace directory raises: the trace was asked for
    monkeypatch.setenv("AEP_PROFILE_DIR", str(trace))
    with pytest.raises(OSError):
        with tprofiling.stage_timer("fit:cnn"):
            pass
    tprofiling.reset()


# -- the port-trained bundle through the port's C codegen -------------------


def test_port_trained_bundle_compiles_to_c_with_the_same_forward(tmp_path):
    """tests/test_codegen.py's recipe on a bundle the port trained: C
    forward within that test's 1e-4 of the port's probabilities."""
    from audio_edge_ml_pipeline_torch.deploy.codegen import ModelToC

    r = np.random.default_rng(5)
    X = r.uniform(0, 0.3, size=(90, 16, 51)).astype(np.float32)
    y = np.repeat(np.arange(3), 30).astype(np.int32)
    for c in range(3):
        X[y == c, c * 5 : c * 5 + 4, :] += 0.6
    X = np.clip(X, 0, 1)
    idx = r.permutation(len(X))
    X, y = X[idx], y[idx]
    trainer = tdeep.CNNTrainer(epochs=10, batch_size=16, filters=[8, 8], first_stride=2, learning_rate=5e-3,
                               device="cpu")
    trainer.fit(X[:70], y[:70], X[70:], y[70:], ["a", "b", "c"], "cg", tmp_path / "run", None)
    gen = ModelToC(tmp_path / "run" / tdeep.MODEL_FILENAME, ["a", "b", "c"], sample_rate=16000, n_mels=16,
                   n_fft=512, hop_length=160, duration=50 * 160 / 16000, board="nicla_vision", max_ram_kb=180)
    out = tmp_path / "cproj"
    gen.generate(out)
    exe = out / "host_runner"
    srcs = [out / "host_main.c"] + sorted((out / "src").glob("*.c"))
    r_cc = subprocess.run(["gcc", "-O2", "-std=c99", f"-I{out / 'src'}", "-o", str(exe), *map(str, srcs), "-lm"],
                          capture_output=True, text=True)
    assert r_cc.returncode == 0, r_cc.stderr
    for feat in X[70:73]:
        (out / "feat.f32").write_bytes(feat.astype(np.float32).tobytes())
        run = subprocess.run([str(exe), "--predict-feat", str(out / "feat.f32")], capture_output=True, text=True)
        assert run.returncode == 0, run.stderr
        c_scores = np.array([float(v) for v in run.stdout.split()])
        ours = trainer.predict_proba(feat[None])[0]
        assert c_scores.shape == ours.shape == (3,)
        assert np.max(np.abs(c_scores - ours)) <= 1e-4
        assert c_scores.argmax() == ours.argmax()
