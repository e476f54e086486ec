"""The port's TFLite forward (``compilation/tf_forward.py``) for every deep
family of ``models/deep.py``: each bundle's fp32 file, converted by the
port and run through TensorFlow's interpreter, against the port's
``predict_proba`` and against the fp32 file that the JAX package's jax2tf
forward makes of the same bundle. Gate: 1e-5 on the probabilities.

The bundles are seeded by the port (flax's initializers; every norm layer's
scale, bias and statistics, and the input normalisation, moved off their
init), at small widths. Their file's input is the prepared sample, NHWC for
the CNN families, as JAX's. The teacher runs at two image sizes: one its
square grows to, one it shrinks to (the antialiased resize). The files run
through the interpreter's default CPU path (the XNNPACK delegate), as
``evaluate_tflite`` runs them.

An rnn bundle also goes through the CLI in its own process with all four
modes: it must exit 0 (JAX's int8 conversion of an rnn kills its CLI).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from audio_edge_ml_pipeline_tpu.compilation import to_tflite as jtflite
from audio_edge_ml_pipeline_tpu.features.base import FeatureSet
from audio_edge_ml_pipeline_tpu.features.pipeline import FeaturePipeline
from audio_edge_ml_pipeline_tpu.models.deep import load_any_model as jload
from audio_edge_ml_pipeline_torch.compilation import tf_forward, to_tflite
from audio_edge_ml_pipeline_torch.models import get_model
from audio_edge_ml_pipeline_torch.models.deep import load_model_bundle
from audio_edge_ml_pipeline_torch.models.layers import BatchNorm, LayerNorm

TOL = 1e-5
# family -> (trainer params, one sample's feature shape before _prepare_input)
FAMILIES = {
    "mlp": ({"hidden_units": [16, 8]}, (12,)),
    "cnn": ({"filters": [4, 8], "first_stride": 4, "second_stride": 2}, (16, 41)),
    "distillation_cnn": ({"filters": [4, 8, 8]}, (16, 24)),
    "ds_cnn": ({"filters": [8, 8, 12], "pool": "max"}, (16, 40)),
    "rnn": ({"units": 8, "n_layers": 2}, (10, 6)),
    "transformer": ({"num_heads": 2, "ff_dim": 16, "n_blocks": 2}, (10, 8)),
    "efficientnet_teacher": ({"image_size": 32}, (20, 24)),
    "efficientnet_teacher-shrink": ({"image_size": 32}, (40, 52)),
}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def tf():
    """TensorFlow, imported when a test first needs it (not at collection)."""
    return pytest.importorskip("tensorflow")


def _seeded(family: str, path, seed: int = 0):
    name = family.split("-")[0]
    params, shape = FAMILIES[family]
    tr = get_model(name)(**params, device="cpu")
    prepared = tr._prepare_input(np.zeros((1, *shape), np.float32)).shape[1:]
    tr.initialize(prepared, 3, torch.Generator().manual_seed(seed))
    r = np.random.default_rng(seed)
    with torch.no_grad():
        for mod in tr._net.modules():
            if isinstance(mod, (BatchNorm, LayerNorm)):
                n = mod.weight.shape[0]
                mod.weight.copy_(torch.from_numpy(r.uniform(0.5, 1.5, n)))
                mod.bias.copy_(torch.from_numpy(r.normal(0.0, 0.2, n)))
            if isinstance(mod, BatchNorm):
                mod.mean.copy_(torch.from_numpy(r.normal(0.0, 0.3, n)))
                mod.var.copy_(torch.from_numpy(r.uniform(0.5, 2.0, n)))
        for p in tr._net.parameters():   # biases off zero, logits off uniform
            if p.requires_grad:
                p.add_(torch.from_numpy(r.normal(0.0, 0.1, tuple(p.shape)).astype(np.float32)))
        tr._norm_mean.copy_(torch.from_numpy(r.normal(0.0, 0.2, tuple(tr._norm_mean.shape))))
        tr._norm_var.copy_(torch.from_numpy(r.uniform(0.5, 2.0, tuple(tr._norm_var.shape))))
    tr.save(path)
    X = r.standard_normal((4, *shape)).astype(np.float32)
    return tr, X


def _interpret(tf, blob: bytes, X: np.ndarray) -> np.ndarray:
    interp = tf.lite.Interpreter(model_content=blob)
    interp.allocate_tensors()
    inp, out = interp.get_input_details()[0], interp.get_output_details()[0]
    assert tuple(inp["shape"]) == (1, *X.shape[1:])
    rows = []
    for i in range(len(X)):
        interp.set_tensor(inp["index"], X[i : i + 1])
        interp.invoke()
        rows.append(interp.get_tensor(out["index"])[0])
    return np.stack(rows)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_fp32_file_matches_predict_proba_and_jax_file(tf, family, tmp_path):
    tr, X = _seeded(family, tmp_path / "model.flax.npz")
    Xp = tr._prepare_input(X)
    arch, flat, mean, var = load_model_bundle(tmp_path / "model.flax.npz")
    ours = to_tflite.convert(tf_forward.concrete_function(arch, flat, mean, var, Xp.shape[1:]), "fp32", None)
    got = _interpret(tf, ours, Xp)
    want = tr.predict_proba(X)
    assert got.shape == want.shape == (4, 3)
    assert np.abs(got - want).max() <= TOL
    assert np.abs(want - 1 / 3).max() > 1e-3   # the probabilities are not flat

    jtr = jload(tmp_path / "model.flax.npz")
    theirs = tf.lite.TFLiteConverter.from_concrete_functions(
        [jtflite._tf_function_from_bundle(jtr, Xp.shape[1:])]).convert()
    assert np.abs(got - _interpret(tf, theirs, Xp)).max() <= TOL


def test_resize_matrix_is_square_resize(tf):
    """The teacher's resize as a matrix: the port's square_resize, growing
    and (antialiased) shrinking."""
    from audio_edge_ml_pipeline_torch.models.deep import square_resize

    x = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 20, 30, 1)).astype(np.float32))
    for size in (24, 48):
        m = tf_forward.resize_matrix(30, size)
        want = square_resize(x, size)[:, 0].numpy()
        got = np.einsum("sh,bhw,tw->bst", m[:, :20], x[..., 0].numpy(), m)
        assert np.abs(got - want).max() <= 1e-6


def test_unknown_family_and_legacy_teacher_refused(tf):
    with pytest.raises(ValueError, match="no TFLite forward"):
        tf_forward.concrete_function({"type": "svm"}, {}, np.zeros(1), np.ones(1), (4,))
    with pytest.raises(ValueError, match="arch revision"):
        tf_forward.concrete_function({"type": "efficientnet_teacher", "n_classes": 2}, {}, np.zeros(1), np.ones(1),
                                     (8, 8, 1))


def test_rnn_bundle_through_the_cli_exits_zero(tf, tmp_path):
    """The BiLSTM, whose int8 conversion through jax2tf kills JAX's CLI:
    the port's CLI, run as a user runs it, exits 0 and its report lists
    every mode, fp32 and dynamic among them."""
    r = np.random.default_rng(3)
    X = r.standard_normal((24, 10, 6)).astype(np.float32)
    y = (np.arange(24) % 3).astype(np.int32)
    FeaturePipeline.save(FeatureSet(features=X, feature_type="deep", modality="audio", metadata=[{} for _ in X],
                                    labels=y, label_names=["a", "b", "c"]), tmp_path / "feats")
    trainer = get_model("rnn")(units=8, device="cpu")
    trainer.initialize((10, 6), 3, torch.Generator().manual_seed(0))
    trainer.save(tmp_path / "rnn.flax.npz")
    env = {**os.environ, "PYTHONPATH": str(to_tflite._PACKAGE_ROOT)}
    proc = subprocess.run([sys.executable, "-m", "audio_edge_ml_pipeline_torch.compilation.to_tflite", "--model",
                           str(tmp_path / "rnn.flax.npz"), "--features", str(tmp_path / "feats"), "--output",
                           str(tmp_path / "out"), "--device", "cpu"], env=env, cwd=tmp_path, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    report = json.loads((tmp_path / "out" / "compilation_report.json").read_text())
    assert {"fp32", "dynamic"} <= set(report["modes"]) and sorted(report["modes"]) == sorted(to_tflite.MODES)
