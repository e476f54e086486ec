"""Port parity: the optimize CLI (``optimize/optimize.py``) and the select
CLI (``train/select.py``, both checkpoints) of audio_edge_ml_pipeline_torch
against the JAX package's, on the CPU, on one shortlist of bundles the port
trained (a small cnn, an svm and a knn): the reports equal but for
``latency_ms``, ``timestamp`` and paths, the artifacts equal array for
array, ``shortlist.json`` and ``best_model.json`` equal but for
``generated_at``, ``latency_ms`` and paths."""

import json

import numpy as np
import pytest
import torch

from audio_edge_ml_pipeline_tpu.features.base import FeatureSet as JFeatureSet
from audio_edge_ml_pipeline_tpu.features.pipeline import FeaturePipeline as JFeaturePipeline
from audio_edge_ml_pipeline_tpu.optimize import optimize as jopt
from audio_edge_ml_pipeline_tpu.train import select as jsel
from audio_edge_ml_pipeline_torch.features.base import FeatureSet
from audio_edge_ml_pipeline_torch.features.pipeline import FeaturePipeline
from audio_edge_ml_pipeline_torch.models import get_model
from audio_edge_ml_pipeline_torch.optimize import optimize as topt
from audio_edge_ml_pipeline_torch.train import select as tsel
from audio_edge_ml_pipeline_torch.utils import tracking

NAMES = ["a", "b", "c"]
CANDIDATES = ("cnn", "svm", "knn")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _blobs(r, n):
    X, y = [], []
    for c in range(3):
        for _ in range(n):
            img = r.normal(0, 0.3, size=(12, 20))
            img[c * 4 : c * 4 + 3, :] += 2.0
            X.append(img)
            y.append(c)
    X, y = np.stack(X).astype(np.float32), np.array(y, np.int32)
    idx = r.permutation(len(X))
    return X[idx], y[idx]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The calibration and eval FeatureSets, the three bundles the port
    trained on the CPU, and a shortlist pointing at them."""
    root = tmp_path_factory.mktemp("topt")
    r = np.random.default_rng(7)
    (Xtr, ytr), (Xev, yev) = _blobs(r, 20), _blobs(r, 6)
    for nm, (X, y) in (("calib", (Xtr, ytr)), ("eval", (Xev, yev))):
        FeaturePipeline.save(FeatureSet(features=X, feature_type="deep", modality="audio",
                                        metadata=[{} for _ in X], labels=y, label_names=NAMES), root / nm)
    trainers = {"cnn": get_model("cnn")(epochs=6, batch_size=16, filters=[4, 8], learning_rate=5e-3, device="cpu"),
                "svm": get_model("svm")(iters=200, device="cpu"),
                "knn": get_model("knn")(n_neighbors=3, device="cpu")}
    for name, tr in trainers.items():
        tr.fit(Xtr, ytr, Xev, yev, NAMES, name, root / f"{name}_run", None)
    shortlist = {
        "experiment": "opt-test", "metric": "val_f1_macro", "n_candidates": 3, "generated_at": "now",
        "candidates": [
            {"rank": i + 1, "run_id": f"r{i}", "run_name": name, "model": name, "val_accuracy": 0.9,
             "val_f1_macro": 0.9 - 0.1 * i, "model_size_kb": 10, "params": {"model": name},
             "artifact_uri": str(root / f"{name}_run"), "features_dir": str(root / "calib"),
             "features_eval_dir": str(root / "eval"), "class_filter": None,
             "feature_params": {"sample_rate": 16000, "n_mels": 12}}
            for i, name in enumerate(CANDIDATES)],
    }
    (root / "shortlist.json").write_text(json.dumps(shortlist))
    return root


@pytest.fixture(scope="module")
def optimized(trained):
    """Both optimize CLIs over the shortlist: (jax dir, port dir)."""
    out = {}
    for key, main, extra in (("jax", jopt.main, []), ("port", topt.main, ["--device", "cpu"])):
        out[key] = trained / f"opt_{key}"
        main(["--shortlist", str(trained / "shortlist.json"), "--output", str(out[key]),
              "--max-accuracy-drop", "0.05", "--no-tracking", *extra])
    return out["jax"], out["port"]


def _comparable_report(report: dict) -> dict:
    r = {k: v for k, v in report.items() if k not in ("latency_ms", "timestamp")}
    r["optimized_model_path"] = report["optimized_model_path"].rsplit("/", 1)[-1]
    r["benchmark_results"] = {m: {k: v for k, v in b.items() if k != "latency_ms"}
                              for m, b in report["benchmark_results"].items()}
    return r


def _assert_same_npz(a, b):
    assert a.stat().st_size == b.stat().st_size, (a, b)
    da, db = np.load(a), np.load(b)
    assert sorted(da.files) == sorted(db.files)
    for k in da.files:
        assert da[k].dtype == db[k].dtype and da[k].shape == db[k].shape, k
        np.testing.assert_array_equal(da[k], db[k], err_msg=k)


@pytest.mark.parametrize("name", CANDIDATES)
def test_optimize_cli_report_matches_jax(optimized, name):
    jdir, tdir = optimized
    theirs = json.loads((jdir / name / "optimization_report.json").read_text())
    ours = json.loads((tdir / name / "optimization_report.json").read_text())
    assert sorted(ours) == sorted(theirs)
    assert _comparable_report(ours) == _comparable_report(theirs)
    modes = {"cnn": ["bfloat16", "dynamic_int8", "float16", "fp32", "static_int8"]}.get(
        name, ["dynamic_int8", "float16", "fp32"])
    assert sorted(ours["benchmark_results"]) == modes
    assert all(b["latency_ms"] > 0 for b in ours["benchmark_results"].values())
    assert ours["accuracy_drop"] <= 0.05 + 1e-9
    assert ours["feature_params"] == {"sample_rate": 16000, "n_mels": 12}


@pytest.mark.parametrize("name", CANDIDATES)
def test_optimize_cli_artifacts_match_jax(optimized, name):
    jdir, tdir = optimized
    files = sorted(p.name for p in (jdir / name).glob("model_*.npz"))
    assert files == sorted(p.name for p in (tdir / name).glob("model_*.npz")) and files
    for f in files:
        _assert_same_npz(tdir / name / f, jdir / name / f)


def test_single_model_mode_matches_jax(trained, tmp_path):
    bundle = trained / "cnn_run" / "model.flax.npz"
    args = ["--model-path", str(bundle), "--model-name", "cnn", "--run-name", "solo",
            "--features", str(trained / "calib"), "--features-eval", str(trained / "eval"), "--no-tracking"]
    jopt.main([*args, "--output", str(tmp_path / "jax")])
    topt.main([*args, "--output", str(tmp_path / "port"), "--device", "cpu"])
    theirs = json.loads((tmp_path / "jax" / "solo" / "optimization_report.json").read_text())
    ours = json.loads((tmp_path / "port" / "solo" / "optimization_report.json").read_text())
    assert ours["model_name"] == "cnn" and ours["run_name"] == "solo"
    assert _comparable_report(ours) == _comparable_report(theirs)


def test_optimize_cli_logs_its_tracking_run(trained, tmp_path):
    uri = str(tmp_path / "mlruns")
    topt.main(["--model-path", str(trained / "knn_run" / "knn.npz"), "--model-name", "knn",
               "--features", str(trained / "calib"), "--output", str(tmp_path / "out"),
               "--mlflow-uri", uri, "--experiment", "opt-track", "--device", "cpu"])
    tracking.set_tracking_uri(uri)
    (run,) = tracking.search_runs("opt-track")
    assert run.run_name == "opt_knn" and run.params["model"] == "knn"
    report = json.loads((tmp_path / "out" / "knn" / "optimization_report.json").read_text())
    assert run.params["best_mode"] == report["quantization_method"]
    assert run.metrics["fp32_size_kb"] == pytest.approx(report["benchmark_results"]["fp32"]["size_kb"])


def test_eval_set_by_name_reencoding(tmp_path):
    """tests/test_optimize.py's case through both packages: an eval set whose
    loader ordered the classes otherwise and grew one."""
    rng = np.random.default_rng(3)
    X = rng.normal(size=(8, 4)).astype(np.float32)
    y = np.array([0, 1, 2, 3, 0, 1, 2, 3], np.int32)
    JFeaturePipeline.save(JFeatureSet(features=X, feature_type="classical", modality="audio",
                                      metadata=[{} for _ in X], labels=y, label_names=["c", "a", "d", "b"]),
                          tmp_path / "eval_shuffled")
    X_eval, y_eval = topt._load_eval_set(str(tmp_path / "eval_shuffled"), ["a", "b", "c"], None, "test")
    assert len(X_eval) == 6 and y_eval.tolist() == [2, 0, 1, 2, 0, 1]
    Xj, yj = jopt._load_eval_set(str(tmp_path / "eval_shuffled"), ["a", "b", "c"], None, "test")
    np.testing.assert_array_equal(X_eval, Xj)
    np.testing.assert_array_equal(y_eval, yj)


def test_optimize_cli_without_a_card_raises(monkeypatch, trained, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        topt.main(["--shortlist", str(trained / "shortlist.json"), "--output", str(tmp_path), "--no-tracking"])
    assert not any(tmp_path.iterdir())


# -- the select CLI -------------------------------------------------------------


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    """A tracking store of five FINISHED runs (one under the accuracy floor,
    one with a `_train` features dir whose `_val` sibling exists) and one
    FAILED run."""
    root = tmp_path_factory.mktemp("sel")
    (root / "mel_train").mkdir()
    (root / "mel_val").mkdir()
    tracking.set_tracking_uri(str(root / "mlruns"))
    tracking.set_experiment("sel-exp")
    for i, (model, acc, f1) in enumerate([("cnn", 0.91, 0.90), ("svm", 0.88, 0.93), ("knn", 0.55, 0.95),
                                          ("mlp", 0.80, 0.70), ("rnn", 0.85, 0.85)]):
        with tracking.start_run(run_name=f"{model}_run") as run:
            run.log_param("model", model)
            run.log_param("features_dir", str(root / ("mel_train" if i == 0 else "classical")))
            if i == 0:
                run.log_param("class_filter", json.dumps(["a", "b"]))
            run.log_metric("val_accuracy", acc)
            run.log_metric("val_f1_macro", f1)
            run.log_metric("model_size_kb", 10.0 * (i + 1))
    try:
        with tracking.start_run(run_name="broken") as run:
            run.log_param("model", "cnn")
            run.log_metric("val_accuracy", 0.99)
            raise KeyError("the run fails")
    except KeyError:
        pass
    return root


@pytest.mark.parametrize("args", [[], ["--min-accuracy", "0.7", "--top-n", "3"],
                                  ["--metric", "val_accuracy", "--features-eval-dir", "/data/eval"]],
                         ids=["default", "floor-top3", "metric-override"])
def test_preopt_shortlist_matches_jax(store, tmp_path, capsys, args):
    docs = {}
    for key, main in (("jax", jsel.main), ("port", tsel.main)):
        out = tmp_path / f"{key}.json"
        main(["--experiment", "sel-exp", "--mlflow-uri", str(store / "mlruns"), "--output", str(out), *args])
        docs[key] = json.loads(out.read_text())
        printed = capsys.readouterr().out
        assert "Shortlist #1" in printed
    for d in docs.values():
        d.pop("generated_at")
    assert docs["port"] == docs["jax"]
    assert docs["port"]["n_candidates"] == (3 if "--top-n" in args else 5)
    if not args:
        first = next(c for c in docs["port"]["candidates"] if c["model"] == "cnn")
        assert first["features_eval_dir"] == str(store / "mel_val")


@pytest.fixture(scope="module")
def postopt(trained, optimized, tmp_path_factory):
    """best_model.json of both select CLIs over each package's optimize
    output, by options: {options: (jax doc or None, port doc or None,
    jax stdout, port stdout)}."""
    import contextlib
    import io

    jdir, tdir = optimized
    root = tmp_path_factory.mktemp("post")
    cases = {"default": [], "size-gate": ["--max-size-kb", "0.001"],
             "ascending": ["--metric", "optimized_size_kb", "--ascending"],
             "compression": ["--metric", "compression_ratio"]}
    out = {}
    for case, args in cases.items():
        row = []
        for key, main, opt_dir in (("jax", jsel.main, jdir), ("port", tsel.main, tdir)):
            best = root / case / f"{key}_best.json"
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                main(["--post-opt", "--shortlist", str(trained / "shortlist.json"), "--opt-dir", str(opt_dir),
                      "--output", str(best), *args])
            row.append((json.loads(best.read_text()) if best.exists() else None, buf.getvalue()))
        out[case] = (row[0][0], row[1][0], row[0][1], row[1][1])
    return out


def _comparable_best(doc):
    return {**{k: v for k, v in doc.items() if k != "latency_ms"},
            "optimized_model_path": doc["optimized_model_path"].rsplit("/", 2)[-2:]}


@pytest.mark.parametrize("case", ["default", "ascending", "compression"])
def test_postopt_best_model_matches_jax(postopt, case):
    theirs, ours, _, printed = postopt[case]
    assert ours is not None and theirs is not None
    assert _comparable_best(ours) == _comparable_best(theirs)
    assert "Best post-optimisation model" in printed
    assert ours["experiment"] == "opt-test"


def test_postopt_ascending_picks_the_smallest(postopt, optimized):
    _, ours, _, _ = postopt["ascending"]
    sizes = {n: json.loads((optimized[1] / n / "optimization_report.json").read_text())["optimized_size_kb"]
             for n in CANDIDATES}
    assert ours["optimized_size_kb"] == min(sizes.values())
    assert "asc" in postopt["ascending"][3]


def test_postopt_size_gate_writes_nothing(postopt):
    theirs, ours, printed_j, printed = postopt["size-gate"]
    assert ours is None and theirs is None
    assert "No model qualified" in printed and "No model qualified" in printed_j
