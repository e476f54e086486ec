"""The port's stage 7a CLI (``audio_edge_ml_pipeline_torch.compilation.
to_tflite``) on the cases of tests/test_compilation.py, against the JAX
package's CLI on the same JAX-trained mlp bundle, and its converter's
process isolation.

Gates: the JAX CLI's best mode, per-mode accuracies and report keys; the
deploy layout and report of tests/test_compilation.py; the int8 file's
accuracy drop against the port's int8 emulation within 0.1, as
tests/test_optimize.py holds JAX's; a converter process that dies fails
only its mode (test_torch_to_tflite_families.py runs an rnn through the
CLI).
"""

import json
import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

from audio_edge_ml_pipeline_tpu.compilation import to_tflite as jtflite
from audio_edge_ml_pipeline_tpu.features.base import FeatureSet
from audio_edge_ml_pipeline_tpu.features.pipeline import FeaturePipeline
from audio_edge_ml_pipeline_tpu.models import get_model as jget_model
from audio_edge_ml_pipeline_torch.compilation import to_tflite
from audio_edge_ml_pipeline_torch.models import get_model
from audio_edge_ml_pipeline_torch.models.deep import load_any_model
from audio_edge_ml_pipeline_torch.optimize.quantize import build_mode, evaluate_model


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def tf():
    """TensorFlow, imported when a test first needs it (not at collection)."""
    return pytest.importorskip("tensorflow")


@pytest.fixture(scope="module")
def mlp_setup(tf, tmp_path_factory):
    """tests/test_compilation.py's mlp_setup: a JAX-trained mlp on 12-d rows
    of 3 classes and its 30-row validation FeatureSet."""
    root = tmp_path_factory.mktemp("comp")
    r = np.random.default_rng(2)
    X, y = [], []
    for c in range(3):
        mu = np.zeros(12)
        mu[c * 4 : c * 4 + 4] = 2.0
        X.append(r.normal(mu, 0.7, size=(40, 12)))
        y.append(np.full(40, c))
    X = np.concatenate(X).astype(np.float32)
    y = np.concatenate(y).astype(np.int32)
    idx = r.permutation(len(X))
    X, y = X[idx], y[idx]
    trainer = jget_model("mlp")(epochs=25, batch_size=16, hidden_units=[16], learning_rate=5e-3)
    trainer.fit(X[:90], y[:90], X[90:], y[90:], ["a", "b", "c"], "m", root / "run", None)
    FeaturePipeline.save(
        FeatureSet(features=X[90:], feature_type="classical", modality="audio",
                   metadata=[{} for _ in X[90:]], labels=y[90:], label_names=["a", "b", "c"]),
        root / "val",
    )
    return root


@pytest.fixture(scope="module")
def both_clis(mlp_setup, tmp_path_factory):
    """tests/test_compilation.py's first case through each package's CLI."""
    root = mlp_setup
    out = {}
    for tag, main, extra in (("jax", jtflite.main, []), ("port", to_tflite.main, ["--device", "cpu"])):
        out[tag] = tmp_path_factory.mktemp(tag) / "compiled"
        main(["--model", str(root / "run" / "model.flax.npz"), "--features", str(root / "val"),
              "--features-val", str(root / "val"), "--output", str(out[tag]), "--max-accuracy-drop", "0.05", *extra])
    return out


def test_to_tflite_cli(both_clis):
    """The deploy layout and report of tests/test_compilation.py, and the
    JAX CLI's best mode, per-mode accuracies and report keys."""
    out = both_clis["port"]
    assert all((out / f"model_{m}.tflite").exists() for m in to_tflite.MODES)
    deploy = out / "deploy"
    assert (deploy / "model.tflite").exists()
    assert json.loads((deploy / "label_names.json").read_text()) == ["a", "b", "c"]
    mel = json.loads((deploy / "mel_params.json").read_text())
    assert mel["sample_rate"] == 16000 and mel["input_shape"] == [40, 501]
    fb = np.load(deploy / "mel_filterbank.npy")
    assert fb.shape == (40, 257) and fb.dtype == np.float32
    np.testing.assert_array_equal(fb, np.load(both_clis["jax"] / "deploy" / "mel_filterbank.npy"))
    report = json.loads((out / "compilation_report.json").read_text())
    assert report["modes"]["fp32"]["accuracy"] > 0.7
    assert report["fp32_accuracy"] == report["modes"]["fp32"]["accuracy"]
    assert report["n_classes"] == 3 and report["n_val_samples"] == 30
    assert report["modes"]["dynamic"]["size_kb"] <= report["modes"]["fp32"]["size_kb"]
    best = report["best_mode"]
    assert report["fp32_accuracy"] - report["modes"][best]["accuracy"] <= 0.05 + 1e-9
    assert report["best_size_kb"] == report["modes"][best]["size_kb"]
    assert (deploy / "model.tflite").read_bytes() == (out / f"model_{best}.tflite").read_bytes()

    theirs = json.loads((both_clis["jax"] / "compilation_report.json").read_text())
    assert set(report) == set(theirs) and set(report["modes"]) == set(theirs["modes"])
    assert report["best_mode"] == theirs["best_mode"]
    for mode, res in theirs["modes"].items():
        assert set(report["modes"][mode]) == set(res)
        assert report["modes"][mode]["accuracy"] == res["accuracy"], mode


def test_to_tflite_forced_mode_and_config(mlp_setup, tmp_path):
    """--config YAML drives the run; --mode overrides auto-selection."""
    root = mlp_setup
    out = tmp_path / "forced"
    cfg = tmp_path / "compilation.yaml"
    cfg.write_text(
        "model: {m}\nfeatures: {f}\nfeatures_val: {f}\noutput: {o}\n"
        "max_accuracy_drop: 0.5\nn_mels: 32\nduration: 2.0\n".format(m=root / "run" / "model.flax.npz",
                                                                      f=root / "val", o=out))
    to_tflite.main(["--config", str(cfg), "--mode", "fp32", "--device", "cpu"])
    report = json.loads((out / "compilation_report.json").read_text())
    assert report["best_mode"] == "fp32"
    assert report["mel_params"]["n_mels"] == 32
    assert report["mel_params"]["input_shape"] == [32, 201]
    assert np.load(out / "deploy" / "mel_filterbank.npy").shape == (32, 257)


def test_to_tflite_class_filter_missing_val_class(mlp_setup, tmp_path):
    """A filtered class absent from the validation set must not shift the
    label codes: they are encoded by name against the training-time list."""
    root = mlp_setup
    val = FeaturePipeline.load(root / "val")
    keep = val.labels != 1  # drop every 'b' sample
    FeaturePipeline.save(
        FeatureSet(features=val.features[keep], feature_type="classical", modality="audio",
                   metadata=[{} for _ in range(int(keep.sum()))], labels=val.labels[keep],
                   label_names=["a", "b", "c"]),
        tmp_path / "val_no_b",
    )
    out = tmp_path / "cf"
    to_tflite.main(["--model", str(root / "run" / "model.flax.npz"), "--features", str(root / "val"),
                    "--features-val", str(tmp_path / "val_no_b"), "--output", str(out), "--max-accuracy-drop",
                    "0.05", "--class-filter", "a", "b", "c", "--mode", "fp32", "--device", "cpu"])
    report = json.loads((out / "compilation_report.json").read_text())
    assert report["n_classes"] == 3
    assert json.loads((out / "deploy" / "label_names.json").read_text()) == ["a", "b", "c"]
    assert report["modes"]["fp32"]["accuracy"] > 0.7


def test_to_tflite_rejects_any_class_count_mismatch(mlp_setup, tmp_path):
    root = mlp_setup
    val = FeaturePipeline.load(root / "val")
    keep = val.labels != 2  # two-class feature set vs the 3-class model
    FeaturePipeline.save(
        FeatureSet(features=val.features[keep], feature_type="classical", modality="audio",
                   metadata=[{} for _ in range(int(keep.sum()))], labels=val.labels[keep], label_names=["a", "b"]),
        tmp_path / "val_ab",
    )
    with pytest.raises(ValueError, match="3 output classes .* 2"):
        to_tflite.compile_model(root / "run" / "model.flax.npz", tmp_path / "val_ab", tmp_path / "val_ab",
                                tmp_path / "out", class_filter=None, mel_params={}, device="cpu")


def test_without_a_card_and_without_device_raises(mlp_setup, tmp_path, monkeypatch):
    """The bundle loads by the port's device rule: the first card, or an
    error without one (no silent CPU fallback)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    root = mlp_setup
    with pytest.raises(RuntimeError, match="no CUDA device"):
        to_tflite.main(["--model", str(root / "run" / "model.flax.npz"), "--features", str(root / "val"),
                        "--output", str(tmp_path / "out")])


def _make(r, n):
    """tests/test_optimize.py's spectrogram-like rows: (12, 20), a bright band a class."""
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


def test_int8_file_drop_predicts_the_int8_emulation(tf, tmp_path):
    """tests/test_optimize.py's gate on the port: the static-int8 emulation
    of optimize/quantize.py and the real full-integer TFLite file lose
    accuracy alike (within 0.1), on a port-trained cnn."""
    r = np.random.default_rng(7)
    Xtr, ytr = _make(r, 25)
    Xev, yev = _make(r, 8)
    names = ["a", "b", "c"]
    cnn = get_model("cnn")(epochs=12, batch_size=16, filters=[8, 8], learning_rate=5e-3, device="cpu")
    cnn.fit(Xtr, ytr, Xev, yev, names, "cnn", tmp_path / "cnn_run", None)
    model_path = tmp_path / "cnn_run" / "model.flax.npz"
    trainer = load_any_model(model_path, device="cpu")
    acc_fp32 = evaluate_model(trainer, Xev, yev, names)["accuracy"]
    view, _, _ = build_mode(trainer, model_path, "static_int8", tmp_path, Xtr)
    acc_emu = evaluate_model(view, Xev, yev, names)["accuracy"]
    Xc, Xv = trainer._prepare_input(Xtr), trainer._prepare_input(Xev)
    paths = to_tflite.convert_modes(trainer, Xv.shape[1:], Xc, tmp_path)
    assert sorted(paths) == sorted(to_tflite.MODES)
    acc_real = to_tflite.evaluate_tflite(paths["int8"], Xv, yev)["accuracy"]
    assert acc_fp32 > 0.8
    assert abs((acc_fp32 - acc_emu) - (acc_fp32 - acc_real)) <= 0.1


def test_a_converter_that_dies_fails_its_mode_alone(mlp_setup, tmp_path, monkeypatch, caplog):
    """A child killed by SIGSEGV in its int8 conversion: int8 is logged as
    failed, fp32 and dynamic (converted before it) and float16 (in a new
    child after it) are written."""
    real = to_tflite._run_child

    def crashing(work, modes):
        code = ("import os, signal\n"
                "from audio_edge_ml_pipeline_torch.compilation import to_tflite as t\n"
                "convert = t.convert\n"
                "def crash(concrete, mode, calib):\n"
                "    if mode == 'int8':\n"
                "        os.kill(os.getpid(), signal.SIGSEGV)\n"
                "    return convert(concrete, mode, calib)\n"
                "t.convert = crash\n"
                f"t._convert_child({str(work)!r}, {list(modes)!r})\n")
        env = {**os.environ, "PYTHONPATH": str(to_tflite._PACKAGE_ROOT), "TF_USE_LEGACY_KERAS": "1"}
        calls.append(list(modes))
        return subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True)

    calls = []
    monkeypatch.setattr(to_tflite, "_run_child", crashing)
    trainer = load_any_model(mlp_setup / "run" / "model.flax.npz", device="cpu")
    X = np.asarray(FeaturePipeline.load(mlp_setup / "val").features, np.float32)
    caplog.set_level("WARNING")
    paths = to_tflite.convert_modes(trainer, X.shape[1:], X, tmp_path)
    assert sorted(paths) == ["dynamic", "float16", "fp32"]
    assert calls == [list(to_tflite.MODES), ["float16"]]
    assert f"exit {-signal.SIGSEGV}" in caplog.text and "'int8' failed" in caplog.text
    assert real is not crashing
