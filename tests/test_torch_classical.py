"""Port parity: the classical core (audio_edge_ml_pipeline_torch.models.classical_core)
and the classical trainers against the JAX package's ``models/classical_jax.py``
and ``models/classical.py``, on the CPU, on the same seeded numpy inputs: the
``make_blobs`` shapes of tests/test_classical_jax.py (6 classes x 40 rows of
32 dims, and 27 x 30 of 64 dims), at most 400 APG iterations.

Tolerances, each with its reason:
- svm ``alpha``: max|d| <= 1e-4 * max(u); ``b`` and the training decisions
  f + b: <= 1e-4 * max|f + b|. Float32 sums in other orders, carried
  through 400 projected-gradient steps that have not fully converged.
- Platt A and B: 1e-3 relative (a Newton fit on those decisions).
- predictions: equal; predict_proba: 1e-4.
- linear_ovo_coef: 1e-4 relative in the Frobenius norm. Each coefficient
  sums some hundred support vectors' alpha * x, and at 400 iterations the
  largest one moves by 1.05e-4 of the largest in JAX itself when the inputs
  move by one ulp (5.3e-5 in the norm).
- PCA: the transformed Z to 1e-4 * max|Z| where the spectrum has clear
  gaps, else the projector onto the kept components (a rotation inside a
  near-degenerate subspace is not a difference).
- LDA coef and decisions: 1e-4 relative.
- kNN counts: equal, also on exact ties (duplicated rows).
- k-means centres: 1e-4; inertia: 1e-5 relative.
"""

import json
import sys

import numpy as np
import pytest
import torch

from audio_edge_ml_pipeline_tpu.models import classical as jcl
from audio_edge_ml_pipeline_tpu.models import classical_jax as cj
from audio_edge_ml_pipeline_tpu.models import get_model as jget_model
from audio_edge_ml_pipeline_tpu.models import list_models as jlist_models
from audio_edge_ml_pipeline_torch.models import classical as tcl
from audio_edge_ml_pipeline_torch.models import classical_core as cc
from audio_edge_ml_pipeline_torch.models import get_model as tget_model
from audio_edge_ml_pipeline_torch.models import registry as tregistry

CPU = torch.device("cpu")
ITERS = 400
CLASSICAL = ("svm", "lda", "knn", "kmeans", "pca_svm", "pca_lda", "pca_knn", "decision_tree", "random_forest")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def make_blobs(n_classes, per_class, dim, spread=1.2, seed=0, val_per_class=12):
    """tests/test_classical_jax.py's blobs: class means plus unit noise."""
    rng = np.random.default_rng(seed)
    means = rng.standard_normal((n_classes, dim)) * spread
    Xtr = np.concatenate([means[k] + rng.standard_normal((per_class, dim)) for k in range(n_classes)]).astype(np.float32)
    ytr = np.repeat(np.arange(n_classes), per_class).astype(np.int32)
    Xv = np.concatenate([means[k] + rng.standard_normal((val_per_class, dim)) for k in range(n_classes)]).astype(np.float32)
    yv = np.repeat(np.arange(n_classes), val_per_class).astype(np.int32)
    perm = rng.permutation(len(Xtr))
    return Xtr[perm], ytr[perm], Xv, yv


BLOBS = {"6x40x32": lambda: make_blobs(6, 40, 32, seed=3),
         "27x30x64": lambda: make_blobs(27, 30, 64, spread=0.55, seed=11, val_per_class=10)}


@pytest.fixture(scope="module")
def blobs6():
    return BLOBS["6x40x32"]()


def rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(np.asarray(b)).max())


# -- SVM -----------------------------------------------------------------------


@pytest.mark.parametrize("data,kernel,C", [
    ("6x40x32", "rbf", 1.0), ("6x40x32", "linear", 1.0), ("6x40x32", "rbf", 10.0), ("6x40x32", "linear", 10.0),
    ("27x30x64", "rbf", 1.0),
])
def test_svm_matches_jax(monkeypatch, data, kernel, C):
    """One fit_svm_np in each package: the solver's (alpha, b, f) seen on the
    way, then the state (Platt sigmoids, support vectors), the predictions
    and probabilities, and for the linear kernel the collapsed OvO
    coefficients."""
    Xtr, ytr, Xv, _ = BLOBS[data]()
    n_classes = int(ytr.max()) + 1
    seen = {}

    def spy(side, fit):
        def call(*a, **kw):
            out = fit(*a, **kw)
            seen[side] = [np.asarray(v) for v in out]
            return out
        return call

    k = cj.kernels()
    monkeypatch.setattr(k, "svm_fit", spy("jax", k.svm_fit))
    monkeypatch.setattr(cc, "svm_fit", spy("port", cc.svm_fit))
    js = cj.fit_svm_np(Xtr, ytr, n_classes, C=C, kernel=kernel, iters=ITERS)
    ts = cc.fit_svm_np(Xtr, ytr, n_classes, C=C, kernel=kernel, iters=ITERS, device="cpu")
    (ja, jb, jf), (ta, tb, tf) = seen["jax"], seen["port"]
    _, _, _, _, u = cc.svm_problem(Xtr, ytr, n_classes, C)
    assert np.abs(ta - ja).max() <= 1e-4 * u.max()
    dec_scale = np.abs(jf + jb[:, None]).max()
    assert np.abs(tb - jb).max() <= 1e-4 * dec_scale
    assert np.abs((tf + tb[:, None]) - (jf + jb[:, None])).max() <= 1e-4 * dec_scale
    assert rel(ts["svm_platt_a"], js["svm_platt_a"]) <= 1e-3 and rel(ts["svm_platt_b"], js["svm_platt_b"]) <= 1e-3
    assert set(ts) == set(js) and ts["svm_sv"].shape == js["svm_sv"].shape
    for key in ("svm_pairs", "svm_gamma", "svm_kernel", "svm_n_classes"):
        np.testing.assert_array_equal(ts[key], js[key])
    np.testing.assert_array_equal(cc.predict_svm_np(Xv, ts, CPU), cj.predict_svm_np(Xv, js))
    np.testing.assert_allclose(cc.predict_proba_svm_np(Xv, ts, CPU), cj.predict_proba_svm_np(Xv, js), atol=1e-4, rtol=0)
    # the port's decision function on JAX's fitted state is JAX's
    np.testing.assert_allclose(cc.svm_decision_np(Xv, js, CPU), cj.svm_decision_np(Xv, js), atol=1e-5, rtol=0)
    if kernel == "linear":
        (tc, _), (jc, _) = cc.linear_ovo_coef(ts), cj.linear_ovo_coef(js)   # its b is svm_b, held above
        assert np.linalg.norm(tc - jc) <= 1e-4 * np.linalg.norm(jc)
        for a, b in zip(cc.linear_ovo_coef(js), cj.linear_ovo_coef(js)):
            np.testing.assert_array_equal(a, b)


def test_svm_host_helpers_are_jax_copies(blobs6):
    """_ovo_layout, _resolve_gamma, _platt_fit, ovo_vote, pairwise_coupling and
    softmax_np: the port keeps its own copies, equal on the same inputs."""
    Xtr, ytr, _, _ = blobs6
    for a, b in zip(cc._ovo_layout(ytr, 6), cj._ovo_layout(ytr, 6)):
        np.testing.assert_array_equal(a, b)
    for g in ("scale", "auto", 0.25):
        assert cc._resolve_gamma(g, Xtr) == cj._resolve_gamma(g, Xtr)
    r = np.random.default_rng(5)
    pairs, _, ypm = cj._ovo_layout(ytr, 6)
    f = r.normal(0, 1.5, ypm.shape) * ypm
    for a, b in zip(cc._platt_fit(f, ypm), cj._platt_fit(f, ypm)):
        np.testing.assert_array_equal(a, b)
    dec = r.normal(size=(9, len(pairs)))
    np.testing.assert_array_equal(cc.ovo_vote(dec, pairs, 6), cj.ovo_vote(dec, pairs, 6))
    r_pos = r.uniform(0.01, 0.99, size=(9, len(pairs)))
    np.testing.assert_array_equal(cc.pairwise_coupling(r_pos, pairs, 6), cj.pairwise_coupling(r_pos, pairs, 6))
    np.testing.assert_array_equal(cc.softmax_np(dec), cj.softmax_np(dec))


def test_svm_rejects_other_kernels(blobs6):
    Xtr, ytr, _, _ = blobs6
    with pytest.raises(ValueError, match="rbf or linear"):
        cc.fit_svm_np(Xtr, ytr, 6, kernel="poly", device="cpu")
    with pytest.raises(ValueError, match="linear"):
        cc.linear_ovo_coef({"svm_kernel": np.array("rbf")})


# -- PCA and LDA -----------------------------------------------------------------


@pytest.mark.parametrize("data,n_components,compare", [
    ("6x40x32", 8, "Z"), ("27x30x64", 12, "Z"), ("6x40x32", 24, "projector"), ("27x30x64", 50, "projector"),
])
def test_scaler_pca_matches_jax(data, n_components, compare):
    Xtr, _, Xv, _ = BLOBS[data]()
    ts, js = cc.fit_scaler_pca_np(Xtr, n_components, CPU), cj.fit_scaler_pca_np(Xtr, n_components)
    for key in ("scaler_mean", "scaler_scale", "pca_mean"):
        np.testing.assert_allclose(ts[key], js[key], rtol=1e-5, atol=1e-6)
    tZ, jZ = cc.transform_scaler_pca_np(Xv, ts, CPU), cj.transform_scaler_pca_np(Xv, js)
    assert tZ.shape == jZ.shape == (len(Xv), n_components)
    if compare == "Z":
        assert np.abs(tZ - jZ).max() <= 1e-4 * np.abs(jZ).max()
    else:
        tc, jc = ts["pca_components"], js["pca_components"]
        assert rel(tc @ tc.T, jc @ jc.T) <= 1e-4


def _full_rank():
    Xtr, ytr, Xv, _ = BLOBS["6x40x32"]()
    return Xtr, ytr, Xv, 6


def _rank_deficient():
    """8 duplicated columns: the within-class scatter has 8 null directions."""
    Xtr, ytr, Xv, _ = BLOBS["6x40x32"]()
    return np.concatenate([Xtr, Xtr[:, :8]], 1), ytr, np.concatenate([Xv, Xv[:, :8]], 1), 6


def _wide():
    """D = 256 > N - 1 = 59: the fit runs in the span of the data."""
    Xtr, ytr, Xv, _ = make_blobs(4, 15, 256, seed=9, val_per_class=8)
    return Xtr, ytr, Xv, 4


def _absent_class():
    """Class 3 is in the label space but has no rows (test_lda_survives_absent_class's data),
    queried also far out of the distribution."""
    rng = np.random.default_rng(7)
    means = rng.standard_normal((5, 12)) * 2.0
    X = np.concatenate([means[k] + rng.standard_normal((30, 12)) for k in range(5)]).astype(np.float32)
    y = np.repeat(np.arange(5), 30).astype(np.int32)
    keep = y != 3
    X_ood = np.full((4, 12), 1e4, np.float32) * np.array([[1], [-1], [2], [-3]], np.float32)
    return X[keep], y[keep], np.concatenate([X, X_ood]), 5


LDA_CASES = {"full_rank": _full_rank, "rank_deficient": _rank_deficient, "wide": _wide,
             "absent_class": _absent_class}


@pytest.mark.parametrize("case", sorted(LDA_CASES))
def test_lda_matches_jax(case):
    X, y, Xq, n_classes = LDA_CASES[case]()
    ts, js = cc.fit_lda_np(X, y, n_classes, CPU), cj.fit_lda_np(X, y, n_classes)
    assert set(ts) == set(js)
    np.testing.assert_array_equal(ts["lda_present"], js["lda_present"])
    assert rel(ts["lda_coef"], js["lda_coef"]) <= 1e-4
    assert rel(ts["lda_intercept"], js["lda_intercept"]) <= 1e-4
    tdec, jdec = cc.lda_decision_np(Xq, ts, CPU), cj.lda_decision_np(Xq, js)
    assert rel(tdec, jdec) <= 1e-4
    np.testing.assert_array_equal(tdec.argmax(1), jdec.argmax(1))
    if case == "absent_class":
        assert not np.any(tdec.argmax(1) == 3) and np.isfinite(ts["lda_intercept"]).all()
    if case == "rank_deficient":
        assert np.abs(ts["lda_coef"]).max() < 1e4   # the null directions were dropped, not inverted


# -- kNN and k-means ---------------------------------------------------------------


@pytest.mark.parametrize("metric", ["minkowski", "cosine"])
@pytest.mark.parametrize("k", [1, 2, 5])
def test_knn_counts_match_jax_on_ties(blobs6, metric, k):
    """Rows 0-19 appear three times with three labels: a query equal to one
    of them has three neighbours at one distance, and k cuts through them.
    The port takes the lower index first among equals, as lax.top_k."""
    Xtr, ytr, Xv, _ = blobs6
    Xr = np.concatenate([Xtr, Xtr[:20], Xtr[:20]])
    yr = np.concatenate([ytr, (ytr[:20] + 1) % 6, (ytr[:20] + 2) % 6]).astype(np.int32)
    q = np.concatenate([Xv, Xtr[:20], 3.0 * Xtr[:5]])   # the scaled rows: cosine ties too
    ours = tcl._knn_counts(q, Xr, yr, k, 6, metric, CPU)
    theirs = np.asarray(jcl._knn_counts(q, Xr, yr, k, 6, metric))
    np.testing.assert_array_equal(ours, theirs)


def test_kmeans_matches_jax():
    """All 10 restarts at once against JAX's vmapped ones, from the same
    host-drawn initial centres."""
    Xtr, _, _, _ = BLOBS["27x30x64"]()
    jc, ji = jcl.KMeansTrainer()._lloyd(Xtr, 27)
    tc, ti = tcl.KMeansTrainer(device="cpu")._lloyd(Xtr, 27)
    assert np.abs(tc - jc).max() <= 1e-4
    assert abs(ti - ji) <= 1e-5 * ji


# -- trainers and bundles, both ways -------------------------------------------------


TRAINER_KW = {
    "svm": {"iters": 100},
    "lda": {},
    "knn": {"n_neighbors": 3},
    "kmeans": {"n_init": 3, "max_iter": 20},
    "pca_svm": {"n_components": 8, "iters": 100, "kernel": "linear"},
    "pca_lda": {"n_components": 8},
    "pca_knn": {"n_components": 8, "n_neighbors": 3, "metric": "cosine"},
}


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
@pytest.mark.parametrize("name", sorted(TRAINER_KW))
def test_trainer_bundle_loads_in_the_other_package(blobs6, tmp_path, name, direction):
    """Each trainer fits and saves in one package; the other loads the bundle
    and predicts the same (probabilities within 1e-4)."""
    Xtr, ytr, Xv, yv = blobs6
    names = list("abcdef")
    if direction == "port_to_jax":
        fitted = tget_model(name)(**TRAINER_KW[name], device="cpu")
        load = lambda p: jget_model(name).load(p)   # noqa: E731
    else:
        fitted = jget_model(name)(**TRAINER_KW[name])
        load = lambda p: tget_model(name).load(p, device="cpu")   # noqa: E731
    res = fitted.fit(Xtr, ytr, Xv, yv, names, name, tmp_path / name, None)
    assert res.model_size_kb > 0 and (tmp_path / name / "model_info.json").exists()
    params = json.loads((tmp_path / name / "model_info.json").read_text())["params"]
    assert params["backend"] == ("torch" if direction == "port_to_jax" else "jax")
    loaded = load(tmp_path / name / f"{name}.npz")
    np.testing.assert_array_equal(loaded.predict(Xv), fitted.predict(Xv))
    if name != "kmeans":
        np.testing.assert_allclose(loaded.predict_proba(Xv), fitted.predict_proba(Xv), atol=1e-4, rtol=0)


@pytest.mark.parametrize("name", sorted(TRAINER_KW))
def test_trainer_fits_like_jax(blobs6, tmp_path, name):
    """The same fit in both packages: the same validation predictions and
    metrics, and params that differ only in the backend."""
    Xtr, ytr, Xv, yv = blobs6
    names = list("abcdef")
    ours = tget_model(name)(**TRAINER_KW[name], device="cpu").fit(Xtr, ytr, Xv, yv, names, "r", tmp_path / "t", None)
    theirs = jget_model(name)(**TRAINER_KW[name]).fit(Xtr, ytr, Xv, yv, names, "r", tmp_path / "j", None)
    assert {**ours.params, "backend": "jax"} == theirs.params
    for key in ("val_accuracy", "val_f1_macro", "confusion_matrix"):
        assert ours.metrics.get(key) == theirs.metrics.get(key)
    if name == "kmeans":
        assert ours.metrics["inertia"] == pytest.approx(theirs.metrics["inertia"], rel=1e-5)
    elif "val_roc_auc_macro" in theirs.metrics:   # the trainers with probabilities
        assert ours.metrics["val_roc_auc_macro"] == pytest.approx(theirs.metrics["val_roc_auc_macro"], abs=1e-4)


@pytest.mark.parametrize("name", ["decision_tree", "random_forest"])
def test_sklearn_trees_run_on_the_host_and_name_sklearn_when_it_is_missing(blobs6, tmp_path, monkeypatch, name):
    Xtr, ytr, Xv, yv = blobs6
    kw = {"n_estimators": 5} if name == "random_forest" else {"max_depth": 4}
    trainer = tget_model(name)(**kw, device="cpu")
    trainer.fit(Xtr, ytr, Xv, yv, list("abcdef"), name, tmp_path, None)
    loaded = jget_model(name).load(tmp_path / f"{name}.joblib")
    np.testing.assert_array_equal(loaded.predict(Xv), trainer.predict(Xv))
    for module in ("sklearn", "sklearn.tree", "sklearn.ensemble"):
        monkeypatch.setitem(sys.modules, module, None)   # import raises ModuleNotFoundError
    with pytest.raises(ImportError, match=f"trainer '{name}' needs scikit-learn"):
        tget_model(name)(**kw)


def test_state_trainers_read_legacy_joblib_bundles(blobs6, tmp_path):
    """The ``.joblib`` fallback: an sklearn estimator saved by an earlier
    version loads through the state-bundle trainer's ``load``."""
    import joblib
    from sklearn.discriminant_analysis import LinearDiscriminantAnalysis

    Xtr, ytr, Xv, _ = blobs6
    est = LinearDiscriminantAnalysis().fit(Xtr, ytr)
    joblib.dump(est, tmp_path / "lda.joblib")
    loaded = tget_model("lda").load(tmp_path / "lda.joblib", device="cpu")
    assert loaded.name == "lda"
    np.testing.assert_array_equal(loaded.predict(Xv), est.predict(Xv))


# -- registry, devices, precision ---------------------------------------------------------


def test_registry_holds_every_classical_name_and_only_deep_families_wait():
    """Every name of the JAX registry resolves in the port: no family waits."""
    assert set(CLASSICAL) <= set(tregistry.list_models())
    assert not getattr(tregistry, "NOT_YET_PORTED", None)
    assert set(jlist_models()) == set(tregistry.list_models()) and len(tregistry.list_models()) == 16
    assert tget_model("ds_cnn").name == "ds_cnn"
    with pytest.raises(KeyError, match=r"Available: .*knn.*svm"):
        tget_model("no_such_trainer")


def test_classical_entry_points_without_device_raise_when_cuda_is_absent(monkeypatch, blobs6):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    Xtr, ytr, _, _ = blobs6
    for call in (lambda: tget_model("svm")(), lambda: tget_model("knn")(), lambda: tget_model("kmeans")(),
                 lambda: cc.fit_lda_np(Xtr, ytr, 6), lambda: cc.fit_scaler_pca_np(Xtr, 4)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


@pytest.mark.parametrize("allow", ["allow_tf32", "set_float32_matmul_precision"])
def test_products_run_in_full_float32_and_the_callers_setting_returns(blobs6, monkeypatch, allow):
    """Whichever way a caller allows TF32, the core's products run with it
    off, and the caller's setting is back afterwards."""
    Xtr, ytr, _, _ = blobs6
    seen = []
    real = torch.linalg.eigh

    def spy(a):
        seen.append(torch.backends.cuda.matmul.allow_tf32)
        return real(a)

    monkeypatch.setattr(torch.linalg, "eigh", spy)
    prev = torch.backends.cuda.matmul.allow_tf32
    try:
        if allow == "allow_tf32":
            torch.backends.cuda.matmul.allow_tf32 = True
        else:
            torch.set_float32_matmul_precision("high")
        cc.fit_lda_np(Xtr, ytr, 6, CPU)
        assert seen == [False] and torch.backends.cuda.matmul.allow_tf32
        if allow != "allow_tf32":
            assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def test_apg_capture_is_refused_without_a_card():
    """The captured loop is a CUDA graph; the CPU runs the eager loop (the
    default there), and asking for capture on CPU tensors fails loudly."""
    X = torch.zeros((4, 3))
    idx = torch.tensor([[0, 1, 2, 3]])
    ypm = torch.tensor([[1.0, 1.0, -1.0, -1.0]])
    u = torch.ones((1, 4))
    alpha, b, f = cc.svm_fit(X, idx, ypm, u, 1.0, "linear", iters=3)
    assert alpha.shape == (1, 4) and bool(torch.isfinite(b).all())
    with pytest.raises((RuntimeError, AssertionError)):
        cc.svm_fit(X, idx, ypm, u, 1.0, "linear", iters=3, capture=True)
