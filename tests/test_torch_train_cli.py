"""The port's train CLI (audio_edge_ml_pipeline_torch.train.train) end to end,
in-process on the CPU (``--device cpu``) on a small mel-shaped FeatureSet,
against what the JAX package's train CLI writes and reads."""

import json

import numpy as np
import pytest
import torch

from audio_edge_ml_pipeline_tpu.models import deep as jdeep
from audio_edge_ml_pipeline_tpu.utils import tracking as jtracking
from audio_edge_ml_pipeline_torch.features.base import FeatureSet
from audio_edge_ml_pipeline_torch.features.pipeline import FeaturePipeline
from audio_edge_ml_pipeline_torch.train import train as ttrain
from audio_edge_ml_pipeline_torch.utils import tracking as ttracking

NAMES = ["rain", "wind", "bird", "insect"]
CNN = ["--param", "filters=[4,8]", "--param", "first_stride=2", "--param", "epochs=3", "--param", "batch_size=8"]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)
    yield
    ttracking.set_tracking_uri(None)


def _featureset(path, seed, per_class):
    r = np.random.default_rng(seed)
    y = np.repeat(np.arange(len(NAMES)), per_class).astype(np.int32)
    X = r.uniform(0, 0.4, size=(len(y), 16, 32)).astype(np.float32)
    for c in range(len(NAMES)):
        X[y == c, c * 4 : c * 4 + 4, :] += 0.5
    FeaturePipeline.save(FeatureSet(features=X, feature_type="audio_mel_spec", modality="audio",
                                    metadata=[{} for _ in y], labels=y, label_names=NAMES), path)
    return path


@pytest.fixture()
def workdir(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    _featureset(tmp_path / "feats_train", 0, per_class=10)
    _featureset(tmp_path / "feats_test", 1, per_class=3)
    return tmp_path


def test_single_run_writes_bundle_info_and_test_evaluation(workdir, capsys):
    ttrain.main(["--features", "feats_train", "--features-test", "feats_test", "--model", "cnn",
                 "--output", "models", "--experiment", "port-cli", "--device", "cpu", *CNN])
    run_dir = workdir / "models" / "cnn"
    info = json.loads((run_dir / "model_info.json").read_text())
    assert info["model_name"] == "cnn" and np.isfinite(info["val_accuracy"])
    assert info["params"]["filters"] == "[4, 8]" and info["params"]["epochs"] == "3"
    assert "Test accuracy" in capsys.readouterr().err  # the CLI logs to stderr
    arch, flat, _, _ = jdeep.load_model_bundle(run_dir / "model.flax.npz")
    assert arch["type"] == "cnn" and "p/Conv_1/kernel" in flat and "p/Dense_1/kernel" in flat
    # the JAX package's tracking store reads the port's run, test metrics included
    jtracking.set_tracking_uri(str(workdir / "mlruns"))
    (rec,) = jtracking.search_runs("port-cli")
    assert rec.params["model"] == "cnn" and rec.params["features_eval_dir"] == "feats_test"
    assert rec.metrics["val_accuracy"] == info["val_accuracy"]
    assert "test_val_accuracy" in rec.metrics
    assert (workdir / "mlruns" / rec.experiment_id / rec.run_id / "artifacts" / "model.flax.npz").exists()


def test_data_parallel_run_logs_jax_line_and_writes_one_bundle_jax_reads(workdir, capsys):
    """``--param data_parallel=2 --device cpu``: two gloo processes train the
    run; one bundle and one tracking run come out (rank 0's), and the JAX
    package loads the bundle with the port's logits (as
    tests/test_train_cli.py's data-parallel run)."""
    ttrain.main(["--features", "feats_train", "--model", "cnn", "--output", "models", "--experiment", "port-dp",
                 "--device", "cpu", *CNN, "--param", "data_parallel=2"])
    assert "[cnn] data-parallel training over 2 devices" in capsys.readouterr().err
    run_dir = workdir / "models" / "cnn"
    assert sorted(p.name for p in run_dir.glob("*.npz")) == ["model.flax.npz"]
    info = json.loads((run_dir / "model_info.json").read_text())
    assert info["model_name"] == "cnn" and np.isfinite(info["val_accuracy"])
    jtracking.set_tracking_uri(str(workdir / "mlruns"))
    assert len(jtracking.search_runs("port-dp")) == 1
    from audio_edge_ml_pipeline_torch.models.deep import load_any_model

    X = np.random.default_rng(3).uniform(0, 1, (6, 16, 32)).astype(np.float32)
    ours = load_any_model(run_dir / "model.flax.npz", device="cpu")
    theirs = jdeep.load_any_model(run_dir / "model.flax.npz")
    np.testing.assert_allclose(np.asarray(theirs._batched_logits(theirs._prepare_input(X))),
                               ours._batched_logits(ours._prepare_input(X)), rtol=0, atol=1e-5)


def test_yaml_sweep_with_cv_writes_shortlist(workdir, capsys):
    cfg = workdir / "training.yaml"
    cfg.write_text(
        f"""
features_dir: {workdir / 'feats_train'}
output_dir: {workdir / 'models'}
experiment: port-sweep
val_split: 0.2
auto_select_top_n: 3
runs:
  - model: cnn
    name: cnn_small
    cv_folds: 2
    params: {{filters: [4, 8], first_stride: 2, epochs: 2, batch_size: 8}}
  - model: cnn
    name: cnn_wide
    params: {{filters: [8, 8], first_stride: 2, epochs: 2, batch_size: 8}}
  - model: transformer
    params: {{num_heads: 0}}
"""
    )
    ttrain.main(["--config", str(cfg), "--device", "cpu"])
    log = capsys.readouterr().err
    assert "CV fold 2/2" in log
    assert "Run 'transformer' failed" in log  # no heads, no module: logged, the sweep goes on
    shortlist = json.loads((workdir / "models" / "shortlist.json").read_text())
    assert shortlist["experiment"] == "port-sweep" and shortlist["n_candidates"] == 2
    assert {c["run_name"].rsplit("_", 2)[0] for c in shortlist["candidates"]} == {"cnn_small", "cnn_wide"}
    assert [c["rank"] for c in shortlist["candidates"]] == [1, 2]
    assert (workdir / "models" / "shortlists" / "shortlist_port-sweep.json").exists()
    assert (workdir / "config" / "experiments" / "port-sweep.yaml").exists()
    runs = {r.run_name.rsplit("_", 2)[0]: r for r in ttracking.search_runs("port-sweep")}
    assert "cv_val_accuracy_mean" in runs["cnn_small"].metrics


def test_stratified_branch_and_fallback_split(workdir):
    X = np.arange(40)
    y = np.repeat(np.arange(4), 10)
    *_, y_tr, y_va = ttrain.stratified_train_val_split(X, y, 0.2)
    assert np.bincount(y_va).tolist() == [2, 2, 2, 2]  # stratified
    y_small = np.repeat(np.arange(27), 4)  # 22 val rows for 27 classes: sklearn refuses to stratify
    X_tr, X_va, _, _ = ttrain.stratified_train_val_split(np.arange(108), y_small, 0.2)
    assert len(X_va) == 22 and len(X_tr) == 86


def test_parse_param_coerces_like_the_jax_cli():
    from audio_edge_ml_pipeline_tpu.train import train as jtrain

    for text in ("filters=[16,64,64]", "epochs=3", "learning_rate=1e-3", "augment=yes", "name=x"):
        assert ttrain.parse_param(text) == jtrain.parse_param(text)


def test_yaml_runs_cnn_mlp_rnn_and_writes_the_shortlist_the_jax_cli_writes(tmp_path, monkeypatch, capsys):
    """All five runs of configs/training.yaml's schema through both CLIs: the
    cnn on mel features, the mlp on classical vectors, the rnn on MFCC
    sequences (each deep run warm-started from one flax-initialised bundle at
    dropout 0), then the svm (C 10, 5-fold CV) and the knn (k 5) on the
    classical vectors at the file's params. Each run names its own
    features_dir and inherits the mel test set through ``features_test_dir:
    null``, whose evaluation the four runs off mel features fail and log. Both CLIs write
    the same five candidates with the same hyperparameters (but the
    classical runs' ``backend``), bundle sizes and metrics, and the svm's
    CV scores agree."""
    import jax
    import jax.numpy as jnp

    from audio_edge_ml_pipeline_tpu.models import get_model as jget_model
    from audio_edge_ml_pipeline_tpu.train import train as jtrain

    r = np.random.default_rng(7)
    y = np.repeat(np.arange(len(NAMES)), 10).astype(np.int32)
    params = {"cnn": dict(filters=[4, 8], first_stride=2, batch_size=8), "mlp": dict(hidden_units=[16, 8]),
              "rnn": dict(units=8)}
    for model, name, shape in (("cnn", "mel", (16, 32)), ("mlp", "classical", (30,)), ("rnn", "mfcc_seq", (8, 12))):
        X = r.uniform(0, 0.2, size=(len(y), *shape)).astype(np.float32)
        for c in range(len(NAMES)):
            X[y == c, ..., c * 2 : c * 2 + 2] += 1.0
        for split, rows in (("train", slice(None)), ("val", slice(0, None, 5))):
            FeaturePipeline.save(FeatureSet(features=X[rows], feature_type=name, modality="audio",
                                            metadata=[{} for _ in y[rows]], labels=y[rows], label_names=NAMES),
                                 tmp_path / f"{name}_{split}")
        jt = jget_model(model)(dropout=0.0, **params[model])
        arch = jt._arch(jt._prepare_input(X).shape[1:], len(NAMES))
        jt._arch_dict = arch
        init = jt._module().init(jax.random.PRNGKey(1), jnp.zeros((1, *arch["input_shape"])), train=False)["params"]
        jdeep.save_model_bundle(tmp_path / f"{model}.npz", arch, init, np.zeros(1), np.ones(1))
        params[model].update(epochs=3, learning_rate=0.01, dropout=0.0, pretrained_model=str(tmp_path / f"{model}.npz"))
    shortlists, svm_cv = {}, {}
    for side, main in (("port", lambda a: ttrain.main([*a, "--device", "cpu"])), ("jax", jtrain.main)):
        (tmp_path / side).mkdir()
        monkeypatch.chdir(tmp_path / side)
        cfg = tmp_path / side / "training.yaml"
        cfg.write_text(f"""
features_dir: {tmp_path / 'mel_train'}
features_test_dir: {tmp_path / 'mel_val'}
output_dir: {tmp_path / side / 'models'}
experiment: runs-1-5
val_split: 0.2
auto_select_top_n: 5
runs:
  - model: cnn
    name: cnn_small
    params: {json.dumps(params['cnn'])}
  - model: mlp
    features_dir: {tmp_path / 'classical_train'}
    features_test_dir: null
    params: {json.dumps(params['mlp'])}
  - model: rnn
    features_dir: {tmp_path / 'mfcc_seq_train'}
    features_test_dir: null
    params: {json.dumps(params['rnn'])}
  - model: svm
    features_dir: {tmp_path / 'classical_train'}
    features_test_dir: null
    cv_folds: 5
    params: {{C: 10.0}}
  - model: knn
    features_dir: {tmp_path / 'classical_train'}
    features_test_dir: null
    params: {{n_neighbors: 5}}
""")
        main(["--config", str(cfg)])
        log = capsys.readouterr().err      # both CLIs log to stderr
        assert log.count("Test-set evaluation failed") == 4 and "Run 'mlp' failed" not in log
        assert "Run 'svm' failed" not in log and "Run 'knn' failed" not in log
        shortlists[side] = json.loads((tmp_path / side / "models" / "shortlist.json").read_text())
        store = ttracking if side == "port" else jtracking
        (svm_run,) = (r for r in store.search_runs("runs-1-5") if r.params["model"] == "svm")
        svm_cv[side] = (svm_run.params["cv_folds"], {k: v for k, v in svm_run.metrics.items() if k.startswith("cv_")})
        ttracking.set_tracking_uri(None)
    port, jax_ = shortlists["port"], shortlists["jax"]
    assert port["n_candidates"] == jax_["n_candidates"] == 5 and port["metric"] == jax_["metric"]

    def by_model(doc):
        return {c["model"]: c for c in doc["candidates"]}

    assert set(by_model(port)) == set(by_model(jax_)) == {"cnn", "mlp", "rnn", "svm", "knn"}
    for model, ours in by_model(port).items():
        theirs = by_model(jax_)[model]
        assert ours["run_name"].rsplit("_", 2)[0] == theirs["run_name"].rsplit("_", 2)[0]
        if model in ("svm", "knn"):
            assert (ours["params"].pop("backend"), theirs["params"].pop("backend")) == ("torch", "jax")
        assert ours["params"] == theirs["params"] and ours["features_dir"] == theirs["features_dir"]
        assert ours["model_size_kb"] == theirs["model_size_kb"]
        assert (ours["val_accuracy"], ours["val_f1_macro"]) == (theirs["val_accuracy"], theirs["val_f1_macro"])
    assert svm_cv["port"][0] == svm_cv["jax"][0] == "5" and svm_cv["port"][1]
    assert svm_cv["port"][1] == pytest.approx(svm_cv["jax"][1], abs=1e-6)
    for doc in (port, jax_):
        assert [c["rank"] for c in doc["candidates"]] == [1, 2, 3, 4, 5]
        f1 = [c["val_f1_macro"] for c in doc["candidates"]]
        assert f1 == sorted(f1, reverse=True)
