"""The port's stage 7b (audio_edge_ml_pipeline_torch.compilation.compile_xla)
on the CPU against the JAX package's CLI, on a cnn bundle that JAX's trainer
wrote. No test here runs torch.compile (inductor's CPU build takes tens of
seconds); the CUDA graph and the compiled candidates are held to the eager
forward on the card (tests/test_torch_cuda.py, chip_smoke.py phase 5i)."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from audio_edge_ml_pipeline_tpu.compilation import compile_xla as jcompile
from audio_edge_ml_pipeline_tpu.features.base import FeatureSet
from audio_edge_ml_pipeline_tpu.features.pipeline import FeaturePipeline
from audio_edge_ml_pipeline_tpu.models import deep as jdeep
from audio_edge_ml_pipeline_tpu.models import get_model as jget_model
from audio_edge_ml_pipeline_torch.compilation import compile_xla

LOGIT_TOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def cnn_bundle(tmp_path_factory):
    """A [4, 8] cnn (strides 2, 2) that JAX's trainer fits for 2 epochs on
    (16, 40) mel-like rows of 3 classes, and a 20-row FeatureSet."""
    root = tmp_path_factory.mktemp("compile")
    rng = np.random.default_rng(4)
    y = np.repeat(np.arange(3), 12).astype(np.int32)
    X = rng.uniform(0, 0.4, (len(y), 16, 40)).astype(np.float32)
    for c in range(3):
        X[y == c, c * 5 : c * 5 + 5, :] += 0.5
    trainer = jget_model("cnn")(epochs=2, batch_size=8, filters=[4, 8], first_stride=2, second_stride=2)
    trainer.fit(X[:30], y[:30], X[30:], y[30:], ["a", "b", "c"], "c", root / "run", None)
    FeaturePipeline.save(FeatureSet(features=X[:20], feature_type="audio_mel_spec", modality="audio",
                                    metadata=[{} for _ in range(20)], labels=y[:20], label_names=["a", "b", "c"]),
                         root / "feats")
    return root


@pytest.fixture(scope="module")
def reports(cnn_bundle):
    out = {}
    for name, main in (("jax", jcompile.main), ("port", compile_xla.main)):
        path = cnn_bundle / f"{name}_report.json"
        main(["--model", str(cnn_bundle / "run" / "model.flax.npz"), "--features", str(cnn_bundle / "feats"),
              "--output", str(path), "--batch", "16", *(["--device", "cpu"] if name == "port" else [])])
        out[name] = json.loads(path.read_text())
    return out


def test_report_keys_equal_jax(reports):
    ours, theirs = reports["port"], reports["jax"]
    assert set(ours) == set(theirs)
    assert ours["backend"] == theirs["backend"] == "cpu"
    assert ours["batch"] == theirs["batch"] == 16
    assert ours["xla_latency_ms_per_sample"] > 0 and ours["compile_seconds"] > 0
    assert ours["flag_search"] is None and ours["tflite_latency_ms_per_sample"] is None
    assert ours["speedup_vs_tflite"] is None and ours["memory_analysis"] == {}


def test_eager_forward_equals_jax_logits(cnn_bundle):
    bundle = cnn_bundle / "run" / "model.flax.npz"
    _, forward, xb = compile_xla.load_forward(bundle, cnn_bundle / "feats", 16, torch.device("cpu"))
    assert xb.shape == (16, 16, 40, 1)
    theirs = jdeep.load_any_model(bundle)
    X = FeaturePipeline.load(cnn_bundle / "feats").features[:16]
    jlogits = theirs._batched_logits(theirs._prepare_input(X))
    err = float(np.abs(forward(xb).numpy() - jlogits).max())
    assert err <= LOGIT_TOL, err
    # B = min(batch, rows)
    assert len(compile_xla.load_forward(bundle, cnn_bundle / "feats", 64, torch.device("cpu"))[2]) == 20


def test_tune_flags_records_every_candidate(cnn_bundle, tmp_path, monkeypatch):
    """The search on the CPU with torch.compile unavailable: eager wins, and
    each torch.compile mode is recorded with its error."""
    def no_compile(*args, **kwargs):
        raise RuntimeError("torch.compile is not available here")

    monkeypatch.setattr(torch, "compile", no_compile)
    out = tmp_path / "report.json"
    compile_xla.main(["--model", str(cnn_bundle / "run" / "model.flax.npz"), "--features", str(cnn_bundle / "feats"),
                      "--output", str(out), "--batch", "8", "--tune-flags", "--device", "cpu"])
    search = json.loads(out.read_text())["flag_search"]
    assert set(search) == {"platform", "candidates", "best_flags", "best_latency_ms_per_sample"}
    assert search["platform"] == "cpu" and search["best_flags"] == {"backend": "eager"}
    eager, *compiled = search["candidates"]
    assert eager["flags"] == {"backend": "eager"} and eager["max_abs_diff_vs_eager"] == 0.0
    assert eager["latency_ms_per_sample"] == search["best_latency_ms_per_sample"] > 0
    assert [c["flags"] for c in compiled] == [{"backend": "torch.compile", "mode": "default"},
                                              {"backend": "torch.compile", "mode": "reduce-overhead"}]
    assert all("not available" in c["error"] for c in compiled)


def test_tflite_baseline_raises_not_yet_ported(cnn_bundle, tmp_path, monkeypatch):
    """The --tflite baseline is ported (tests/test_torch_tflite.py holds it to
    JAX's): the one refusal left is a machine without TensorFlow, which an
    existing file meets with an ImportError that names it."""
    import sys

    (tmp_path / "model.tflite").write_bytes(b"")
    monkeypatch.setitem(sys.modules, "tensorflow", None)
    with pytest.raises(ImportError, match="TensorFlow is not installed"):
        compile_xla.main(["--model", str(cnn_bundle / "run" / "model.flax.npz"), "--features",
                          str(cnn_bundle / "feats"), "--tflite", str(tmp_path / "model.tflite"), "--device", "cpu"])


def test_without_a_card_and_without_device_raises(cnn_bundle, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        compile_xla.main(["--model", str(cnn_bundle / "run" / "model.flax.npz"), "--features",
                          str(cnn_bundle / "feats")])
