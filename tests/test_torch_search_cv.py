"""The port's fold-batched grid search (audio_edge_ml_pipeline_torch/train/
search_cv.py) and the CV programs of its classical core against the JAX
package's train/search_jax.py and classical_jax.kernels(), on the CPU.

Tolerances:
- svm_cv decision values: 1e-4 of the largest. The linear kernel on the raw
  rows runs 2000 iterations: at the default 400 its dual is far from
  converged there, and the decisions move 1.4e-4 of the largest when the
  input moves 1e-7 relative (6e-6 after 2000; rbf after 400, 4e-6;
  scripts/torch_tune_sensitivity.py), so 400 iterations hold no two
  implementations to 1e-4;
- pca_cv: Z up to the sign of each column (neither package fixes the signs
  of its fold bases), 1e-4 of the largest;
- lda_cv: 1e-4 of the largest decision value; knn_cv counts: equal.
"""

import numpy as np
import pytest
import torch

from audio_edge_ml_pipeline_tpu.models import get_model as jget_model
from audio_edge_ml_pipeline_tpu.train import search_jax as sj
from audio_edge_ml_pipeline_torch.models import classical_core as cc
from audio_edge_ml_pipeline_torch.train import search_cv as sc

CPU = "cpu"


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def data():
    """The data fixture of tests/test_search_jax.py."""
    K, per, D = 6, 40, 32
    rng = np.random.default_rng(5)
    means = rng.standard_normal((K, D)) * 0.8
    X = np.concatenate([means[k] + rng.standard_normal((per, D)) for k in range(K)]).astype(np.float32)
    y = np.repeat(np.arange(K), per).astype(np.int64)
    perm = rng.permutation(len(X))
    return X[perm], y[perm]


@pytest.fixture(scope="module")
def engines(data):
    X, y = data
    fold_of = sj.stratified_fold_ids(y, 4, seed=0)
    je = sj._CVEngine(X, y.astype(np.int32), fold_of, 6)
    te = sc._CVEngine(X, y.astype(np.int32), fold_of, 6, device=CPU)
    return je, te, fold_of


def rel(a, b) -> float:
    return float(np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(np.asarray(b)).max())


@pytest.mark.parametrize("cv,seed", [(3, 0), (4, 0), (5, 42), (5, 7)])
def test_fold_ids_and_ovo_layouts_equal_jax(data, cv, seed):
    _, y = data
    fold_of = sc.stratified_fold_ids(y, cv, seed)
    np.testing.assert_array_equal(fold_of, sj.stratified_fold_ids(y, cv, seed))
    for t, j in zip(sc._fold_ovo_arrays(y, fold_of, 6), sj._fold_ovo_arrays(y, fold_of, 6)):
        np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("kernel,gamma,iters,C", [
    ("rbf", "scale", 400, 1.0), ("rbf", "scale", 400, 10.0), ("rbf", "auto", 400, 1.0), ("rbf", 0.05, 400, 10.0),
    ("linear", "scale", 2000, 1.0),
])
def test_svm_cv_matches_jax(engines, data, kernel, gamma, iters, C):
    X, _ = data
    je, te, _ = engines
    _, idx, ypm, cw = je._ovo_cached()
    gamma_mode, gval = (gamma, 0.0) if gamma in ("scale", "auto") else ("value", gamma)
    theirs = np.asarray(je.k.svm_cv(True, kernel, gamma_mode, iters)(
        X, je._w_dev(), idx, ypm, (C * cw).astype(np.float32), np.float32(gval)))
    ours = te.svm_decisions({"C": C, "kernel": kernel, "gamma": gamma, "iters": iters})
    assert ours.shape == theirs.shape == (4, len(X), 15)   # (folds, rows, pairs)
    assert rel(ours, theirs) <= 1e-4


def test_svm_cv_on_per_fold_features_matches_jax(engines):
    """pca_svm's path: a per-fold X (F, N, k), here JAX's own fold bases."""
    je, te, _ = engines
    Z = np.asarray(je.k.pca_cv(8)(je.X, je._w_dev()))
    _, idx, ypm, cw = je._ovo_cached()
    theirs = np.asarray(je.k.svm_cv(False, "rbf", "scale", 400)(Z, je._w_dev(), idx, ypm, cw, np.float32(0)))
    ours = te.svm_decisions({"C": 1.0}, torch.from_numpy(Z.copy()))
    assert rel(ours, theirs) <= 1e-4


@pytest.mark.parametrize("ncomp", [4, 8, 16])
def test_pca_cv_matches_jax_up_to_column_sign(engines, ncomp):
    je, te, _ = engines
    theirs = np.asarray(je.k.pca_cv(ncomp)(je.X, je._w_dev()))
    ours = cc._np(te.pca_features({"n_components": ncomp}))
    sign = np.sign((ours * theirs).sum(1, keepdims=True))
    assert ours.shape == theirs.shape and (sign != 0).all()
    assert rel(ours * sign, theirs) <= 1e-4
    assert te.pca_features({"n_components_pca": ncomp}) is te.pca_features({"n_components": ncomp})  # cached


@pytest.mark.parametrize("per_fold", [False, True])
def test_lda_cv_matches_jax(engines, per_fold):
    je, te, _ = engines
    if per_fold:
        Z = np.asarray(je.k.pca_cv(8)(je.X, je._w_dev()))
        theirs = np.asarray(je.k.lda_cv(False)(Z, je.onehot, je._w_dev()))
        ours = cc._np(cc.lda_cv(torch.from_numpy(Z.copy()), te.parts[0].onehot, te.parts[0].W))
    else:
        theirs = np.asarray(je.k.lda_cv(True)(je.X, je.onehot, je._w_dev()))
        ours = cc._np(cc.lda_cv(te.parts[0].X, te.parts[0].onehot, te.parts[0].W))
    assert rel(ours, theirs) <= 1e-4


@pytest.mark.parametrize("metric", ["minkowski", "euclidean", "cosine"])
@pytest.mark.parametrize("k", [1, 5])
@pytest.mark.parametrize("duplicates", [False, True])
def test_knn_cv_counts_equal_jax(data, metric, k, duplicates):
    """With duplicate rows the neighbour sets tie exactly: the lower row
    index comes first, as lax.top_k orders them."""
    X, y = data
    if duplicates:
        X = np.concatenate([X[:60], X[:60], X[:60] * 2.0]).astype(np.float32)   # equal rows, equal cosines
        y = np.concatenate([y[:60], np.roll(y[:60], 1), np.roll(y[:60], 2)])
    fold_of = sj.stratified_fold_ids(y, 3, seed=1)
    W = np.stack([fold_of != f for f in range(3)]).astype(np.float32)
    onehot = np.eye(6, dtype=np.float32)[y]
    theirs = np.asarray(sj.kernels().knn_cv(True, k, metric)(X, W, onehot))
    ours = cc._np(cc.knn_cv(torch.from_numpy(X), torch.from_numpy(W), torch.from_numpy(onehot), k, metric))
    np.testing.assert_array_equal(ours, theirs)


@pytest.mark.parametrize("model,cell", [
    ("svm", {"C": 1.0}), ("svm", {"C": 10.0, "gamma": "auto"}), ("lda", {}), ("knn", {"n_neighbors": 3}),
    ("pca_svm", {"n_components": 8, "C": 1.0}), ("pca_lda", {"n_components_pca": 8}),
    ("pca_knn", {"n_components": 8, "n_neighbors": 5, "metric": "cosine"}),
])
def test_cell_scores_equal_jax(engines, model, cell):
    je, te, _ = engines
    np.testing.assert_allclose(te.eval_cell(model, cell, "f1_macro"), je.eval_cell(model, cell, "f1_macro"),
                               rtol=0, atol=1e-12)


@pytest.mark.parametrize("C", [10.0])
def test_fold_batched_scores_equal_sequential_fits(engines, data, C):
    """The fold-batched program reproduces the port's own per-fold sequential
    fit_svm_np fits (same split, same solver, same iteration count): the same
    decision values on each fold's validation rows, so the same scores."""
    X, y = data
    _, te, fold_of = engines
    dec = te.svm_decisions({"C": C})
    sequential = []
    for f in range(4):
        tr = fold_of != f
        state = cc.fit_svm_np(X[tr], y[tr].astype(np.int32), 6, C=C, iters=sc._DEFAULT_ITERS, device=CPU)
        np.testing.assert_allclose(dec[f, ~tr], cc.svm_decision_np(X[~tr], state, CPU), rtol=0, atol=1e-6)
        sequential.append(sc._score(y[~tr], cc.predict_svm_np(X[~tr], state, CPU), "f1_macro"))
    assert te.eval_svm({"C": C}, "f1_macro") == sequential


@pytest.mark.parametrize("case", range(4))
def test_score_equals_sklearn_on_absent_classes(case):
    from sklearn.metrics import accuracy_score, f1_score

    rng = np.random.default_rng(case)
    y_true = rng.choice([0, 2, 3, 7], size=40)
    y_pred = np.where(rng.random(40) < 0.6, y_true, rng.choice([1, 2, 5], size=40))   # 1, 5 never true; 0, 7 maybe never predicted
    assert sc._score(y_true, y_pred, "f1_macro") == pytest.approx(
        f1_score(y_true, y_pred, average="macro", zero_division=0), abs=1e-12)
    assert sc._score(y_true, y_pred, "accuracy") == pytest.approx(accuracy_score(y_true, y_pred), abs=1e-12)
    with pytest.raises(ValueError, match="unsupported scoring"):
        sc._score(y_true, y_pred, "roc_auc")


@pytest.mark.parametrize("model,grid,match", [
    ("pca_lda", {"n_components_lda_typo": [5]}, "unknown grid key"),
    ("svm", {"kernel": ["poly"]}, "kernel"),
    ("knn", {"metric": ["chebyshev"]}, "metric"),
    ("lda", {"shrinkage": [0.1]}, "shrinkage"),
    ("svm", {"gamma": ["wide"]}, "gamma"),
])
def test_validate_grid_refuses_what_jax_refuses(data, model, grid, match):
    X, y = data
    with pytest.raises(ValueError, match=match):
        sj.grid_search_cv_jax(model, grid, X, y, cv=3)
    with pytest.raises(ValueError, match=match):
        sc.grid_search_cv_device(model, grid, X, y, cv=3, device=CPU)
    sc.validate_grid("pca_svm", {"n_components": [8], "C": [1.0], "gamma": ["scale", 0.1], "iters": [5]})


def test_grid_search_picks_jax_cell_and_its_refit_loads_in_jax(data, tmp_path):
    X, y = data
    grid = {"n_components": [8, 16], "C": [1.0, 10.0], "kernel": ["rbf"], "iters": [200]}
    jt, jbest, jscore = sj.grid_search_cv_jax("pca_svm", grid, X, y, cv=4)
    tt, tbest, tscore = sc.grid_search_cv_device("pca_svm", grid, X, y, cv=4, device=CPU)
    assert tbest == jbest and tscore == pytest.approx(jscore, abs=1e-12)
    assert tt.device.type == "cpu"
    tt.save(tmp_path / "pca_svm.npz")
    loaded = jget_model("pca_svm").load(tmp_path / "pca_svm.npz")
    np.testing.assert_array_equal(loaded.predict(X[:40]), tt.predict(X[:40]))
    np.testing.assert_allclose(loaded.predict_proba(X[:40]), tt.predict_proba(X[:40]), atol=1e-4, rtol=0)
    with pytest.raises(ValueError, match="not tunable on the device"):
        sc.grid_search_cv_device("decision_tree", {}, X, y, device=CPU)


@pytest.mark.parametrize("model,cell", [("svm", {"C": 1.0, "iters": 200}), ("pca_svm", {"n_components": 8}),
                                        ("pca_lda", {"n_components": 8}), ("knn", {"n_neighbors": 3})])
def test_folds_split_over_devices_equal_the_unsplit_cell(engines, data, model, cell):
    """The 4 folds split over 3 devices (parts of 2, 1 and 1 folds): each
    part's program on its device gives the unsplit cell's decisions (within
    1e-4 of their largest, float32 sums in batches of another size) and its
    fold scores."""
    X, y = data
    _, te, fold_of = engines
    split = sc._CVEngine(X, y.astype(np.int32), fold_of, 6, device=CPU, devices=[CPU] * 3)
    assert [len(p.folds) for p in split.parts] == [2, 1, 1]
    if model.endswith("svm"):
        Zs, Zt = (e.pca_features(cell) if model.startswith("pca_") else None for e in (split, te))
        assert rel(split.svm_decisions(cell, Zs), te.svm_decisions(cell, Zt)) <= 1e-4
    assert split.eval_cell(model, cell, "accuracy") == pytest.approx(te.eval_cell(model, cell, "accuracy"), abs=1e-12)


def test_grid_search_splits_folds_over_the_devices_it_is_given(data, caplog):
    X, y = data
    caplog.set_level("INFO")
    one = sc.grid_search_cv_device("lda", {}, X, y, cv=4, device=CPU)
    split = sc.grid_search_cv_device("lda", {}, X, y, cv=4, device=CPU, devices=[CPU] * 2)
    assert "4 folds split over 2 devices" in caplog.text
    assert split[1] == one[1] and split[2] == pytest.approx(one[2], abs=1e-12)
    assert len(sc._CVEngine(X, y.astype(np.int32), sc.stratified_fold_ids(y, 4), 6, device=CPU, devices=4).parts) == 1


def test_no_card_and_no_device_raises(data, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X, y = data
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sc.grid_search_cv_device("lda", {}, X, y, cv=3)
