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
  - model: mlp
"""
    )
    ttrain.main(["--config", str(cfg), "--device", "cpu"])
    log = capsys.readouterr().err
    assert "CV fold 2/2" in log
    assert "Run 'mlp' failed" in log  # not yet ported: logged, the sweep goes on
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
