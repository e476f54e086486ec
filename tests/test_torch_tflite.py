"""The interpreter side of the port's stage 7a: ``to_tflite.evaluate_tflite``,
the edge simulator's ``.tflite`` branch and ``compile_xla --tflite``, on
files that the JAX package's ``to_tflite`` wrote (jax2tf), against the JAX
package's own functions on the same files.

Gates: the same accuracy and size on every file and mode; the simulator's
scores within 1e-6 on the same features (the same interpreter on the same
file) and 1e-5 through each package's mel frontend; JAX's report keys. With
TensorFlow hidden, each refuses with an ImportError that names it.
"""

import json
import sys

import numpy as np
import pytest
import torch

from audio_edge_ml_pipeline_tpu.compilation import compile_xla as jcompile
from audio_edge_ml_pipeline_tpu.compilation import to_tflite as jtflite
from audio_edge_ml_pipeline_tpu.features.base import FeatureSet
from audio_edge_ml_pipeline_tpu.features.pipeline import FeaturePipeline
from audio_edge_ml_pipeline_tpu.models import get_model as jget_model
from audio_edge_ml_pipeline_tpu.models.deep import load_any_model as jload
from audio_edge_ml_pipeline_tpu.serve.edge_simulator import EdgeDeviceSimulator as JSimulator
from audio_edge_ml_pipeline_torch.compilation import compile_xla, to_tflite
from audio_edge_ml_pipeline_torch.data.audio_io import write_wav
from audio_edge_ml_pipeline_torch.models.deep import RNNTrainer
from audio_edge_ml_pipeline_torch.serve.edge_simulator import EdgeDeviceSimulator

SR = 16000
MEL = {"sample_rate": SR, "n_mels": 16, "n_fft": 512, "hop_length": 160, "duration": 1.0}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def tf():
    """TensorFlow, imported when a test first needs it (not at collection:
    every worker collects every file)."""
    return pytest.importorskip("tensorflow")


def _separable(rng, n_per_class, shape, classes=3):
    y = np.repeat(np.arange(classes), n_per_class).astype(np.int32)
    X = rng.normal(0, 0.5, (len(y), *shape)).astype(np.float32)
    for c in range(classes):
        X[y == c, c * 4 : c * 4 + 4] += 2.0
    idx = rng.permutation(len(y))
    return X[idx], y[idx]


@pytest.fixture(scope="module")
def jax_files(tf, tmp_path_factory):
    """JAX's to_tflite files (all four modes) of a JAX-trained mlp on 12-d
    rows and cnn on (12, 20) rows, with 24-row validation FeatureSets."""
    root = tmp_path_factory.mktemp("jtflite")
    rng = np.random.default_rng(2)
    out = {}
    for name, shape, params in (("mlp", (12,), {"hidden_units": [16]}), ("cnn", (12, 20), {"filters": [4, 8]})):
        X, y = _separable(rng, 30, shape)
        trainer = jget_model(name)(epochs=8, batch_size=16, learning_rate=5e-3, **params)
        trainer.fit(X[:66], y[:66], X[66:], y[66:], ["a", "b", "c"], name, root / name, None)
        FeaturePipeline.save(FeatureSet(features=X[66:], feature_type="deep", modality="audio",
                                        metadata=[{} for _ in X[66:]], labels=y[66:], label_names=["a", "b", "c"]),
                             root / f"{name}_val")
        Xp = trainer._prepare_input(X)
        paths = jtflite.convert_modes(trainer, Xp.shape[1:], Xp[:66], root / name)
        assert sorted(paths) == sorted(to_tflite.MODES)
        out[name] = (root, paths, Xp[66:], y[66:])
    return out


@pytest.mark.parametrize("name", ["mlp", "cnn"])
@pytest.mark.parametrize("mode", to_tflite.MODES)
def test_evaluate_tflite_equals_jax(jax_files, name, mode):
    _, paths, Xv, yv = jax_files[name]
    ours = to_tflite.evaluate_tflite(paths[mode], Xv, yv)
    theirs = jtflite.evaluate_tflite(paths[mode], Xv, yv)
    assert set(ours) == set(theirs) == {"accuracy", "latency_ms", "size_kb"}
    assert ours["accuracy"] == theirs["accuracy"] and ours["size_kb"] == theirs["size_kb"]
    assert ours["latency_ms"] > 0
    if mode == "fp32":
        assert ours["accuracy"] > 0.7


def test_compile_xla_tflite_baseline_fills_jax_keys(jax_files, tmp_path):
    """--tflite times JAX's fp32 cnn file on the first B rows: both reports
    have the same keys, and both fill the baseline and the speedup."""
    root, paths, _, _ = jax_files["cnn"]
    reports = {}
    for tag, main, extra in (("jax", jcompile.main, []), ("port", compile_xla.main, ["--device", "cpu"])):
        out = tmp_path / f"{tag}.json"
        main(["--model", str(root / "cnn" / "model.flax.npz"), "--features", str(root / "cnn_val"), "--output",
              str(out), "--batch", "8", "--tflite", str(paths["fp32"]), *extra])
        reports[tag] = json.loads(out.read_text())
    assert set(reports["port"]) == set(reports["jax"])
    for rep in reports.values():
        assert rep["tflite_latency_ms_per_sample"] > 0
        assert rep["speedup_vs_tflite"] == pytest.approx(rep["tflite_latency_ms_per_sample"]
                                                        / rep["xla_latency_ms_per_sample"])
    missing = tmp_path / "missing.json"   # a path that does not exist is skipped, as in JAX
    compile_xla.main(["--model", str(root / "cnn" / "model.flax.npz"), "--features", str(root / "cnn_val"),
                      "--output", str(missing), "--batch", "8", "--tflite", str(tmp_path / "none.tflite"),
                      "--device", "cpu"])
    assert json.loads(missing.read_text())["tflite_latency_ms_per_sample"] is None


@pytest.fixture(scope="module")
def rnn_file(tf, tmp_path_factory):
    """A seeded rnn bundle on the simulator's (16 mels, 101 frames) features
    (16 steps of 101 values), its fp32 file written by JAX's jax2tf forward,
    and a clip tree of two classes."""
    root = tmp_path_factory.mktemp("sim")
    trainer = RNNTrainer(units=8, device="cpu")
    trainer.initialize((16, 101), 2, torch.Generator().manual_seed(1))
    trainer.save(root / "rnn.flax.npz")
    jtrainer = jload(root / "rnn.flax.npz")
    concrete = jtflite._tf_function_from_bundle(jtrainer, (16, 101))
    (root / "rnn_fp32.tflite").write_bytes(tf.lite.TFLiteConverter.from_concrete_functions([concrete]).convert())
    rng = np.random.default_rng(4)
    for c, name in enumerate(["low", "high"]):
        (root / "clips" / name).mkdir(parents=True)
        for i in range(3):
            t = np.arange(SR) / SR
            clip = 0.3 * np.sin(2 * np.pi * (300 + 900 * c + 40 * i) * t) + 0.02 * rng.standard_normal(SR)
            write_wav(root / "clips" / name / f"{i}.wav", clip.astype(np.float32), SR)
    return root


def test_simulator_tflite_branch_equals_jax(rnn_file, tmp_path):
    root = rnn_file
    kw = dict(device_id="d", upload_threshold=0.0, telemetry_dir=tmp_path / "t", stats_dir=tmp_path / "s",
              mel_params=MEL, seed=3)
    ours = EdgeDeviceSimulator(root / "rnn_fp32.tflite", ["low", "high"], root / "clips", device="cpu", **kw)
    theirs = JSimulator(root / "rnn_fp32.tflite", ["low", "high"], root / "clips", **{**kw, "device_id": "j"})
    feat = ours._extract(sorted((root / "clips").rglob("*.wav"))[0])
    assert feat.shape == (16, 101)
    np.testing.assert_allclose(ours._infer(feat), theirs._infer(feat), rtol=0, atol=1e-6)
    for _ in range(4):
        a, b = ours.step(), theirs.step()
        assert a["clip"] == b["clip"] and a["prediction"] == b["prediction"]
        assert abs(a["confidence"] - b["confidence"]) <= 1e-5


def test_without_tensorflow_each_refuses_by_name(jax_files, rnn_file, tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "tensorflow", None)
    root, paths, Xv, yv = jax_files["mlp"]
    with pytest.raises(ImportError, match="TensorFlow"):
        to_tflite.evaluate_tflite(paths["fp32"], Xv, yv)
    with pytest.raises(ImportError, match="TensorFlow"):
        EdgeDeviceSimulator(rnn_file / "rnn_fp32.tflite", ["low", "high"], rnn_file / "clips", device="cpu",
                            telemetry_dir=tmp_path / "t", stats_dir=tmp_path / "s", mel_params=MEL)
    with pytest.raises(ImportError, match="TensorFlow"):
        to_tflite.main(["--model", str(root / "mlp" / "model.flax.npz"), "--features", str(root / "mlp_val"),
                        "--output", str(tmp_path / "out"), "--device", "cpu"])
