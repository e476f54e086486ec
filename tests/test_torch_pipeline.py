"""Port parity end to end on the CPU: the feature-extraction CLI and the edge
simulator of audio_edge_ml_pipeline_torch against the JAX package's, on
tools/make_synth_dataset.py data."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import make_synth_dataset
from audio_edge_ml_pipeline_tpu.features import audio as jaudio
from audio_edge_ml_pipeline_tpu.features import pipeline as jpipeline
from audio_edge_ml_pipeline_tpu.features.config import ExperimentConfig as JExperimentConfig
from audio_edge_ml_pipeline_tpu.features.config import load_config as jload_config
from audio_edge_ml_pipeline_tpu.models import deep as jdeep
from audio_edge_ml_pipeline_tpu.serve import edge_simulator as jsim
from audio_edge_ml_pipeline_torch.features.config import load_config as tload_config
from audio_edge_ml_pipeline_torch.serve import edge_simulator as tsim

REPO = Path(__file__).resolve().parent.parent
TOL = 1e-5  # the repo's DSP parity gate


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    root = tmp_path_factory.mktemp("synth")
    make_synth_dataset.make_fsc22(root / "fsc22", n_classes=3, per_class=3, sr=16000)
    make_synth_dataset.make_audio_folder(root / "audio_folder", n_classes=3, per_class=2, sr=16000)
    return root


def _port_env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(REPO), env.get("PYTHONPATH", "")]).rstrip(os.pathsep)
    return env


def test_featureset_dirs_of_both_clis_match(synth, tmp_path, monkeypatch):
    # rows per device batch do not change per-clip results; 16 keeps the JAX
    # CPU compile small (the port's CLI runs unpatched, at its 256 rows)
    monkeypatch.setattr(jaudio.AudioMelSpectrogram, "batch_size", 16)
    jax_out, port_out = tmp_path / "jax", tmp_path / "port"
    jpipeline._run_experiment(JExperimentConfig(
        extractor="audio_mel_spec", loader="fsc22", dataset=str(synth / "fsc22"), split="all",
        output=str(jax_out)))
    proc = subprocess.run(
        [sys.executable, "-m", "audio_edge_ml_pipeline_torch.features.pipeline",
         "--loader", "fsc22", "--dataset", str(synth / "fsc22"), "--extractor", "audio_mel_spec",
         "--split", "all", "--output", str(port_out), "--device", "cpu"],
        cwd=REPO, env=_port_env(), capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    for name in ("info.json", "label_names.json", "metadata.json"):
        assert json.loads((port_out / name).read_text()) == json.loads((jax_out / name).read_text()), name
    np.testing.assert_array_equal(np.load(port_out / "labels.npy"), np.load(jax_out / "labels.npy"))
    ours, theirs = np.load(port_out / "features.npy"), np.load(jax_out / "features.npy")
    assert ours.shape == theirs.shape == (9, 40, 501) and ours.dtype == theirs.dtype == np.float32
    assert np.max(np.abs(ours - theirs)) <= TOL


def test_shipped_extraction_config_resolves_identically():
    ours = tload_config(REPO / "configs" / "feature_extraction.yaml").resolved_experiments()
    theirs = jload_config(REPO / "configs" / "feature_extraction.yaml").resolved_experiments()
    assert [vars(e) for e in ours] == [vars(e) for e in theirs]


def test_edge_simulator_matches_jax(synth, tmp_path):
    labels = [make_synth_dataset.class_name(c) for c in range(3)]
    module = jdeep.CNNModule((8, 16, 16), dropout=0.3, n_classes=3, first_stride=4, second_stride=2)
    params = module.init(jax.random.PRNGKey(7), jnp.zeros((1, 40, 501, 1)), train=False)["params"]
    arch = {"type": "cnn", "filters": [8, 16, 16], "dropout": 0.3, "n_classes": 3,
            "first_stride": 4, "second_stride": 2, "input_shape": [40, 501, 1]}
    bundle = tmp_path / "model.flax.npz"
    jdeep.save_model_bundle(bundle, arch, params, np.float32([0.5]), np.float32([0.08]))

    def run(sim_cls, tag, **kw):
        sim = sim_cls.EdgeDeviceSimulator(
            bundle, labels, synth / "audio_folder", device_id=f"sim-{tag}",
            telemetry_dir=tmp_path / tag / "telemetry", stats_dir=tmp_path / tag / "stats", seed=3, **kw)
        return [sim.step() for _ in range(3)], sim

    theirs, _ = run(jsim, "jax")
    ours, sim = run(tsim, "port", device="cpu")
    for a, b in zip(ours, theirs):
        assert (a["clip"], a["true_class"], a["prediction"], a["uploaded"]) == \
               (b["clip"], b["true_class"], b["prediction"], b["uploaded"])
        assert abs(a["confidence"] - b["confidence"]) <= 1e-6
        assert set(a) == set(b)
    lines = (tmp_path / "port" / "telemetry" / "sim-port_telemetry.jsonl").read_text().splitlines()
    assert len(lines) == 3 and json.loads(lines[-1])["device_id"] == "sim-port"
    stats = json.loads((tmp_path / "port" / "stats" / "sim-port_stats.json").read_text())
    jstats = json.loads((tmp_path / "jax" / "stats" / "sim-jax_stats.json").read_text())
    assert set(stats) == set(jstats) and stats["total_inferences"] == 3
    assert abs(stats["avg_confidence"] - jstats["avg_confidence"]) <= 1e-6
