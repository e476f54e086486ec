"""Port parity: the quantization emulation of audio_edge_ml_pipeline_torch
(``optimize/quantize.py``) against the JAX package's on the CPU, at a small
size: the primitives bit for bit, the deep artifacts of all five modes for
cnn, mlp and rnn bundles (one of each trained by each package) bit for bit
with the same file sizes, their views' probabilities within each family's
parity tolerance, ``load_any_bundle`` both ways, and the classical modes of
every trainer the port has: equal ``size_kb`` and labels, decisions within
the classical parity gates."""

import json

import ml_dtypes
import numpy as np
import pytest
import torch

from audio_edge_ml_pipeline_tpu.models import classical_jax as cj
from audio_edge_ml_pipeline_tpu.models import get_model as jget
from audio_edge_ml_pipeline_tpu.optimize import quantize as jq
from audio_edge_ml_pipeline_torch.models import classical_core as cc
from audio_edge_ml_pipeline_torch.models import get_model as tget
from audio_edge_ml_pipeline_torch.optimize import quantize as tq

CPU = torch.device("cpu")
N_CLASSES = 3
NAMES = ["a", "b", "c"]
PROBA_TOL = {"cnn": 1e-6, "mlp": 1e-5, "rnn": 1e-5}   # test_torch_cnn.py, test_torch_mlp_rnn.py
MODES = ("fp32", "dynamic_int8", "static_int8", "float16", "bfloat16")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _special_values() -> np.ndarray:
    """Zeros of both signs, halfway bfloat16 ties rounding up and down, values
    beyond float16's 65504 and bfloat16's largest, float32 subnormals."""
    ties = np.array([0x3F808000, 0x3F818000, 0xBF808000, 0x40490000 | 0x8000, 0x00018000, 0x7F7F8000],
                    np.uint32).view(np.float32)
    return np.concatenate([
        np.array([0.0, -0.0, 1.0, -1.0, 65504.0, 65520.0, 7e4, -1e5, 3.4e38, -3.4e38], np.float32),
        ties, np.array([1e-40, -3e-42, 1.4e-45, 1.1754942e-38], np.float32),
        np.array([6e-8, 3e-5, 1e-8], np.float32),
    ])


def test_bfloat16_rounding_matches_ml_dtypes_bit_for_bit():
    """torch's host cast against ml_dtypes over the whole float32 exponent
    range, exact halfway ties included, from float32 and from float64."""
    rng = np.random.default_rng(11)
    bits = rng.integers(0, 2**32, 100_000, dtype=np.uint64).astype(np.uint32)
    bits = bits[(bits & 0x7F800000) != 0x7F800000]                     # no inf / nan
    ties = (bits & 0xFFFF0000) | 0x8000
    x32 = np.concatenate([bits, ties]).view(np.float32)
    for x in (x32, x32.astype(np.float64), _special_values()):
        np.testing.assert_array_equal(tq.bfloat16_bits(x), x.astype(ml_dtypes.bfloat16).view(np.uint16))
    np.testing.assert_array_equal(tq.bfloat16_values(tq.bfloat16_bits(x32)),
                                  x32.astype(ml_dtypes.bfloat16).astype(np.float32))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("case", ["special", "normal", "zeros", "tiny"])
def test_fake_quant_int8_matches_jax(case, dtype):
    rng = np.random.default_rng(3)
    arr = {"special": _special_values()[:-4], "normal": rng.standard_normal((7, 5)),
           "zeros": np.zeros((4, 3)), "tiny": np.array([1e-40, -2e-40, 3e-42, 0.0])}[case].astype(dtype)
    ours, theirs = tq.fake_quant_int8(arr), jq.fake_quant_int8(arr)
    for a, b in zip(ours, theirs):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("src", [np.float32, np.float64])
@pytest.mark.parametrize("dtype", ["float16", "bfloat16"])
def test_fake_cast_matches_jax(dtype, src):
    rng = np.random.default_rng(5)
    arr = np.concatenate([_special_values(), rng.standard_normal(257) * 10.0 ** rng.uniform(-30, 30, 257)]).astype(src)
    cast = np.float16 if dtype == "float16" else "bfloat16"
    ours, theirs = tq.fake_cast(arr, cast), jq.fake_cast(arr, cast)
    assert ours[0].dtype == theirs[0].dtype == src and ours[1] == theirs[1]
    np.testing.assert_array_equal(ours[0], theirs[0])


# -- deep bundles -------------------------------------------------------------


def _deep_data(family, seed=0, per_class=12):
    shape = {"cnn": (12, 20), "mlp": (24,), "rnn": (6, 5)}[family]
    r = np.random.default_rng(seed)
    y = np.repeat(np.arange(N_CLASSES), per_class).astype(np.int32)
    X = r.normal(0, 0.3, size=(len(y), *shape)).astype(np.float32)
    for c in range(N_CLASSES):
        if family == "cnn":
            X[y == c, c * 4 : c * 4 + 3, :] += 2.0
        else:
            X[y == c, ..., c] += 1.5
    perm = r.permutation(len(y))
    return X[perm], y[perm]


WIDTHS = {"cnn": dict(filters=[4, 8]), "mlp": dict(hidden_units=[16, 8]), "rnn": dict(units=8)}


@pytest.fixture(scope="module")
def deep_cases(tmp_path_factory):
    """(family, origin) -> (bundle, eval rows, {mode: (jax artifact, jax view,
    port artifact, port view)}), built on first use."""
    root = tmp_path_factory.mktemp("deepq")
    cache = {}

    def get(family, origin):
        if (family, origin) not in cache:
            X, y = _deep_data(family)
            d = root / f"{family}_{origin}"
            kw = dict(epochs=2, batch_size=12, learning_rate=5e-3, **WIDTHS[family])
            trainer = jget(family)(**kw) if origin == "jax" else tget(family)(**kw, device="cpu")
            trainer.fit(X[:27], y[:27], X[27:], y[27:], NAMES, origin, d / "run", None)
            bundle = d / "run" / "model.flax.npz"
            modes = {}
            for mode in MODES:
                (d / "jax").mkdir(exist_ok=True)
                (d / "port").mkdir(exist_ok=True)
                aj, at = d / "jax" / f"model_{mode}.npz", d / "port" / f"model_{mode}.npz"
                modes[mode] = (aj, jq._quantize_deep_bundle(bundle, mode, aj, X[:27]),
                               at, tq._quantize_deep_bundle(bundle, mode, at, X[:27], device="cpu"))
            cache[family, origin] = (bundle, X[27:], modes)
        return cache[family, origin]

    return get


def _assert_same_npz(a, b):
    assert a.stat().st_size == b.stat().st_size
    da, db = np.load(a), np.load(b)
    assert sorted(da.files) == sorted(db.files)
    for k in da.files:
        assert da[k].dtype == db[k].dtype and da[k].shape == db[k].shape, k
        np.testing.assert_array_equal(da[k], db[k], err_msg=k)
    assert json.loads(da["__meta__"].tobytes()) == json.loads(db["__meta__"].tobytes())


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("origin", ["jax", "port"])
@pytest.mark.parametrize("family", ["cnn", "mlp", "rnn"])
def test_deep_artifact_and_view_match_jax(deep_cases, family, origin, mode):
    _, Xv, modes = deep_cases(family, origin)
    aj, vj, at, vt = modes[mode]
    _assert_same_npz(at, aj)
    ours, theirs = vt.predict_proba(Xv), np.asarray(vj.predict_proba(Xv))
    assert ours.shape == theirs.shape == (len(Xv), N_CLASSES)
    assert np.max(np.abs(ours - theirs)) <= PROBA_TOL[family]
    if mode == "static_int8":
        assert type(vt).__name__ == "_InputQuantWrapper" and (vt._lo, vt._hi) == (vj._lo, vj._hi)


@pytest.mark.parametrize("mode", MODES)
def test_load_any_bundle_reads_both_ways(deep_cases, mode):
    """The port reads JAX's artifacts and JAX reads the port's, to the same
    flat weights and int8 store."""
    _, _, modes = deep_cases("cnn", "port")
    aj, _, at, _ = modes[mode]
    for path in (aj, at):
        ours, theirs = tq.load_any_bundle(path), jq.load_any_bundle(path)
        assert ours[0] == theirs[0] and ours[4] == theirs[4] == mode
        assert sorted(ours[1]) == sorted(theirs[1]) and sorted(ours[5]) == sorted(theirs[5])
        for k in theirs[1]:
            assert ours[1][k].dtype == theirs[1][k].dtype == np.float32
            np.testing.assert_array_equal(ours[1][k], theirs[1][k], err_msg=k)
        for k, (q, s) in theirs[5].items():
            np.testing.assert_array_equal(ours[5][k][0], q)
            assert ours[5][k][1] == s
        np.testing.assert_array_equal(ours[2], theirs[2])
        np.testing.assert_array_equal(ours[3], theirs[3])


def test_bfloat16_artifact_holds_the_evaluated_values(deep_cases):
    bundle, _, modes = deep_cases("rnn", "port")
    _, flat_q, _, _, mode, _ = tq.load_any_bundle(modes["bfloat16"][2])
    assert mode == "bfloat16"
    for k, arr in jq.load_any_bundle(bundle)[1].items():
        np.testing.assert_array_equal(flat_q[k], arr.astype(ml_dtypes.bfloat16).astype(np.float32), err_msg=k)


def test_build_mode_puts_the_view_on_the_trainer_device(deep_cases, tmp_path):
    bundle, Xv, _ = deep_cases("mlp", "port")
    trainer = tq.load_trainer_any(bundle, "mlp", device="cpu")
    for mode in ("fp32", "dynamic_int8"):
        view, out, size_kb = tq.build_mode(trainer, bundle, mode, tmp_path, Xv)
        assert view.device.type == "cpu" and out == tmp_path / f"model_{mode}.npz"
        assert size_kb == out.stat().st_size / 1024


# -- classical trainers -------------------------------------------------------

CLASSICAL = {   # name -> trainer kwargs (small, quick)
    "svm": dict(iters=200), "pca_svm": dict(n_components=6, iters=200), "lda": {},
    "pca_lda": dict(n_components_pca=6), "knn": dict(n_neighbors=3), "pca_knn": dict(n_components=6, n_neighbors=3),
    "kmeans": dict(n_init=2, max_iter=20),
}


@pytest.fixture(scope="module")
def classical_bundles(tmp_path_factory):
    """Each classical trainer fitted by the port on the CPU and saved; rows
    whose columns span decades (as the 302-d classical vector's do)."""
    root = tmp_path_factory.mktemp("clq")
    r = np.random.default_rng(4)
    D, per = 16, 15
    y = np.repeat(np.arange(N_CLASSES), per).astype(np.int32)
    X = ((r.standard_normal((N_CLASSES, D))[y] * 2.0 + r.standard_normal((len(y), D)))
         * np.logspace(-2, 2, D)).astype(np.float32)
    out = {}
    for name, kw in CLASSICAL.items():
        trainer = tget(name)(**kw, device="cpu")
        trainer.fit(X, y, X[:9], y[:9], NAMES, name, root / name, None)
        out[name] = root / name / f"{name}.npz"
        assert out[name].exists()
    return out, X


def _decisions(name, view, X, jax_side):
    """What the classical parity tests hold (test_torch_classical.py): svm
    decision values within 1e-5, class probabilities within 1e-4, kNN
    neighbour fractions exactly; k-means has labels only."""
    if name == "kmeans":
        return None, 0.0
    if name.endswith("svm"):
        rows = X if name == "svm" else (view._transform(X) if jax_side else view._features(X))
        return (cj.svm_decision_np(rows, view._state) if jax_side else cc.svm_decision_np(rows, view._state, CPU)), 1e-5
    return np.asarray(view.predict_proba(X)), (0.0 if name.endswith("knn") else 1e-4)


@pytest.mark.parametrize("mode", ["fp32", "dynamic_int8", "float16"])
@pytest.mark.parametrize("name", sorted(CLASSICAL))
def test_classical_quantization_matches_jax(classical_bundles, tmp_path, name, mode):
    bundles, X = classical_bundles
    path = bundles[name]
    ours_tr = tq.load_trainer_any(path, name, device="cpu")
    theirs_tr = jget(name).load(path)
    view_t, size_t = tq._quantize_classical(ours_tr, mode, path, tmp_path / f"t_{mode}.npz")
    view_j, size_j = jq._quantize_classical(theirs_tr, mode, path, tmp_path / f"j_{mode}.npz")
    assert size_t == size_j
    np.testing.assert_array_equal(view_t.predict(X), np.asarray(view_j.predict(X)))
    ours, tol = _decisions(name, view_t, X, jax_side=False)
    theirs, _ = _decisions(name, view_j, X, jax_side=True)
    if ours is not None:
        np.testing.assert_allclose(ours, np.asarray(theirs), atol=tol, rtol=0)
    if mode != "fp32":
        # the views were quantized, the trainers they were copied from not
        changed = [k for k, v in vars(ours_tr).items() if isinstance(v, np.ndarray) and v.ndim >= 2
                   and v.dtype.kind == "f" and not np.array_equal(v, getattr(view_t, k))]
        state_changed = [k for k, v in getattr(ours_tr, "_state", {}).items()
                         if np.asarray(v).dtype.kind == "f" and not np.array_equal(v, view_t._state[k])]
        assert changed or state_changed, f"{name} {mode}: nothing was quantized"
    # the saved quantized view loads back to the same labels
    reloaded = tq.load_trainer_any(tmp_path / f"t_{mode}.npz", name, device="cpu")
    np.testing.assert_array_equal(reloaded.predict(X), view_t.predict(X))


def test_a_tree_raises_jax_s_error(tmp_path):
    """A tree keeps its weights in sklearn's Cython objects: nothing to walk."""
    pytest.importorskip("sklearn")
    rng = np.random.default_rng(0)
    X, y = rng.standard_normal((30, 4)).astype(np.float32), np.repeat(np.arange(3), 10).astype(np.int32)
    path = tmp_path / "tree.joblib"
    messages = []
    for get, q in ((tget, tq), (jget, jq)):
        tree = get("decision_tree")(max_depth=3)
        tree.fit(X, y, X, y, NAMES, "t", tmp_path / "run", None)
        tree.save(path)
        with pytest.raises(ValueError, match="no quantizable float arrays") as exc:
            q._quantize_classical(tree, "dynamic_int8", path, tmp_path / "q.joblib")
        messages.append(str(exc.value))
    assert messages[0] == messages[1]


def test_a_torch_tensor_in_the_trainer_refuses_to_walk(classical_bundles):
    bundles, _ = classical_bundles
    trainer = tq.load_trainer_any(bundles["knn"], "knn", device="cpu")
    trainer._cache = {"gram": torch.ones(3, 3)}
    with pytest.raises(TypeError, match="torch tensor"):
        tq._walk_float_arrays(trainer, lambda a: a)
    trainer._cache = {"index": torch.arange(3)}   # an integer tensor holds no weight
    tq._walk_float_arrays(trainer, lambda a: a)
