"""The port's tune CLI (audio_edge_ml_pipeline_torch.train.tune) end to end,
in-process on the CPU (``--device cpu``), against the JAX package's tune
CLI on the same FeatureSets from separate working directories: the small
classical fixture of tests/test_tune.py and a small mel set for the cnn."""

import contextlib
import json
import logging

import numpy as np
import pytest
import torch

from audio_edge_ml_pipeline_tpu.models import get_model as jget_model
from audio_edge_ml_pipeline_tpu.models import deep as jdeep
from audio_edge_ml_pipeline_tpu.train import tune as jtune
from audio_edge_ml_pipeline_tpu.utils import tracking as jtracking
from audio_edge_ml_pipeline_torch.features.base import FeatureSet
from audio_edge_ml_pipeline_torch.features.pipeline import FeaturePipeline
from audio_edge_ml_pipeline_torch.train import tune as ttune
from audio_edge_ml_pipeline_torch.utils import tracking as ttracking

NAMES = ["a", "b", "c"]
CNN_RUN = """
  - model: cnn
    params: {batch_size: 8}
    search_space:
      filters: [[4], [4, 8]]
      first_stride: [2, 4]
      learning_rate: {type: loguniform, low: 0.001, high: 0.01}
      dropout: {type: float, low: 0.0, high: 0.3}
"""


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)
    yield
    ttracking.set_tracking_uri(None)
    jtracking.set_tracking_uri(None)


@contextlib.contextmanager
def package_log(package: str):
    """The messages a package logs inside the block (the CLIs reset the root
    logger's handlers, caplog's among them, on the way in)."""
    messages: list[str] = []
    handler = logging.Handler()
    handler.emit = lambda record: messages.append(record.getMessage())
    logging.getLogger(package).addHandler(handler)
    try:
        yield messages
    finally:
        logging.getLogger(package).removeHandler(handler)


def _save(path, X, y, feature_type):
    FeaturePipeline.save(FeatureSet(features=X, feature_type=feature_type, modality="audio",
                                    metadata=[{} for _ in y], labels=y, label_names=NAMES), path)


@pytest.fixture(scope="module")
def feature_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("tunefeats")
    for name, seed, n in [("cls_train", 1, 25), ("cls_val", 2, 8)]:   # tests/test_tune.py's fixture
        rr = np.random.default_rng(seed)
        X, y = [], []
        for c in range(3):
            mu = np.zeros(16)
            mu[c * 5 : c * 5 + 5] = 2.0
            X.append(rr.normal(mu, 1.0, size=(n, 16)))
            y.append(np.full(n, c))
        X, y = np.concatenate(X).astype(np.float32), np.concatenate(y).astype(np.int32)
        idx = rr.permutation(len(X))
        _save(root / name, X[idx], y[idx], "classical")
    for name, seed, n in [("mel_train", 3, 20), ("mel_val", 4, 6)]:
        rr = np.random.default_rng(seed)
        y = np.repeat(np.arange(3), n).astype(np.int32)
        X = rr.uniform(0, 0.4, size=(len(y), 16, 24)).astype(np.float32)
        for c in range(3):
            X[y == c, c * 4 : c * 4 + 4, :] += 0.5
        _save(root / name, X, y, "audio_mel_spec")
    return root


def _config(path, feats, out, experiment, runs, **top):
    lines = [f"output_dir: {out}", f"experiment: {experiment}", f"features_dir: {feats / 'mel_train'}",
             f"features_test: {feats / 'mel_val'}", "cv: 3", "scoring: f1_macro", "n_trials: 3",
             "sweep_epochs: 2", "seed: 42", "pruner: none", *(f"{k}: {v}" for k, v in top.items()), "runs:"]
    path.write_text("\n".join(lines) + runs)
    return path


CLASSICAL_RUNS = """
  - model: pca_svm
    features_dir: {feats}/cls_train
    features_test: {feats}/cls_val
    grid: {{n_components: [4, 8], C: [1.0, 10.0], kernel: [rbf], iters: [100]}}
  - model: lda
    name: lda_inherits_mel_test
    features_dir: {feats}/cls_train
    features_test: null
    grid: {{solver: [svd, lsqr]}}
"""


@pytest.fixture(scope="module")
def both_clis(feature_dirs, tmp_path_factory):
    """Each CLI once on the same YAML, each from its own working directory.
    The lda run's ``features_test: null`` inherits the mel test set, as the
    pca_svm run of configs/tuning.yaml does."""
    runs = CNN_RUN + CLASSICAL_RUNS.format(feats=feature_dirs)
    out = {}
    mp = pytest.MonkeyPatch()
    handler_records = {}
    for name in ("jax", "port"):
        wd = tmp_path_factory.mktemp(f"cwd_{name}")
        cfg = _config(wd / "tuning.yaml", feature_dirs, wd / "tuned", f"parity-{name}", runs)
        mp.chdir(wd)
        with package_log(f"audio_edge_ml_pipeline_{'tpu' if name == 'jax' else 'torch'}") as messages:
            if name == "jax":
                jtune.main(["--config", str(cfg)])
            else:
                ttune.main(["--config", str(cfg), "--device", "cpu"])
        handler_records[name] = messages
        out[name] = wd
    mp.undo()
    return out, handler_records


def _shortlist(wd):
    return json.loads((wd / "tuned" / "shortlist.json").read_text())


def test_shortlist_and_summary_have_the_jax_schema(both_clis):
    (dirs, _) = both_clis
    sj, st = _shortlist(dirs["jax"]), _shortlist(dirs["port"])
    assert set(st) == set(sj)
    assert {tuple(sorted(c)) for c in st["candidates"]} == {tuple(sorted(c)) for c in sj["candidates"]}
    assert st["experiment"] == "parity-port" and st["metric"] == sj["metric"] == "val_f1_macro"
    assert (dirs["port"] / "tuned" / "shortlists" / "shortlist_parity-port.json").exists()
    assert (dirs["port"] / "config" / "experiments" / "parity-port.yaml").exists()
    summary_j = json.loads((dirs["jax"] / "tuned" / "cnn" / "trial_summary.json").read_text())
    summary_t = json.loads((dirs["port"] / "tuned" / "cnn" / "trial_summary.json").read_text())
    assert set(summary_t) == set(summary_j)
    assert summary_t["n_trials"] == 3 and summary_t["n_completed"] + summary_t["n_pruned"] == 3
    # the same TPE stream draws the same three trials (all start-up draws)
    assert [t["best_params"] for t in summary_t["trials"]] == [t["best_params"] for t in summary_j["trials"]]
    assert {tuple(sorted(t)) for t in summary_t["trials"]} == {tuple(sorted(t)) for t in summary_j["trials"]}


def test_classical_run_picks_the_jax_cell_and_score(both_clis):
    (dirs, _) = both_clis
    pick = {name: next(c for c in _shortlist(d)["candidates"] if c["model"] == "pca_svm") for name, d in dirs.items()}
    assert pick["port"]["best_params"] == pick["jax"]["best_params"]
    assert pick["port"]["cv_best_score"] == pytest.approx(pick["jax"]["cv_best_score"], abs=1e-12)
    run_dir = dirs["port"] / "tuned" / "pca_svm"
    for artifact in ("pca_svm.npz", "classification_report.txt", "confusion_matrix.png", "model_info.json"):
        assert (run_dir / artifact).exists(), artifact


def test_a_test_set_the_model_cannot_read_keeps_the_run(both_clis):
    """configs/tuning.yaml's pca_svm run inherits the cnn's mel test set: the
    JAX CLI fails the whole run there; the port logs the failed test-set
    evaluation and keeps the run, as its deep branch and the train CLIs do."""
    (dirs, logs) = both_clis
    assert sorted(c["model"] for c in _shortlist(dirs["jax"])["candidates"]) == ["cnn", "pca_svm"]
    assert any("run 'lda_inherits_mel_test' failed" in m for m in logs["jax"])
    assert sorted(c["model"] for c in _shortlist(dirs["port"])["candidates"]) == ["cnn", "lda", "pca_svm"]
    assert any("[lda_inherits_mel_test] Test-set evaluation failed" in m for m in logs["port"])
    assert not any("failed" in m for m in logs["port"] if "Test-set evaluation" not in m)


def test_the_ports_bundles_load_in_jax(both_clis, feature_dirs):
    (dirs, _) = both_clis
    tuned = dirs["port"] / "tuned"
    X_cls = FeaturePipeline.load(feature_dirs / "cls_val").features
    for name, run in (("pca_svm", "pca_svm"), ("lda", "lda_inherits_mel_test")):
        theirs = jget_model(name).load(tuned / run / f"{name}.npz")
        ours = ttune.get_model(name).load(tuned / run / f"{name}.npz", device="cpu")
        np.testing.assert_array_equal(theirs.predict(X_cls), ours.predict(X_cls))
    summary = json.loads((tuned / "cnn" / "trial_summary.json").read_text())
    best = jdeep.load_any_model(tuned / "cnn" / f"trial_{summary['best_trial']:02d}" / "model.flax.npz")
    assert best.predict(FeaturePipeline.load(feature_dirs / "mel_val").features).shape == (18,)
    # the tracking runs: one a trial, one a classical run, readable by the JAX store
    jtracking.set_tracking_uri(str(dirs["port"] / "mlruns"))
    runs = jtracking.search_runs("parity-port")
    assert sorted(r.params.get("model", "") for r in runs if "optuna_trial" not in r.params) == ["lda", "pca_svm"]
    assert sum("optuna_trial" in r.params for r in runs) == 3


def test_tune_parallel_runs_the_batched_path(feature_dirs, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    cfg = _config(tmp_path / "tuning.yaml", feature_dirs, tmp_path / "tuned", "batched", CNN_RUN, tune_parallel=3)
    with package_log("audio_edge_ml_pipeline_torch") as messages:
        ttune.main(["--config", str(cfg), "--device", "cpu"])
    log = "\n".join(messages)
    assert "in batched rounds of 3" in log and "batch of 3 trial(s)" in log
    assert "failed" not in log
    summary = json.loads((tmp_path / "tuned" / "cnn" / "trial_summary.json").read_text())
    assert summary["n_completed"] == 3 and len(summary["trials"]) == 3
    assert (tmp_path / "tuned" / "cnn" / f"trial_{summary['best_trial']:02d}" / "model.flax.npz").exists()


def test_no_card_and_no_device_raises(feature_dirs, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _config(tmp_path / "tuning.yaml", feature_dirs, tmp_path / "tuned", "nocard", CNN_RUN)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttune.main(["--config", str(cfg)])
    assert not (tmp_path / "tuned").exists()
