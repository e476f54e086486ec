"""The port's user scripts (audio_edge_ml_pipeline_torch/tools/: the
diagnostics, test_model, load_sample_data, test_dashboard) against the
repository's scripts/*.py of the same name on one seeded FeatureSet and
bundle: the same stdout, test_model's confidences within 1e-5."""

from __future__ import annotations

import importlib.util
import json
import re
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from audio_edge_ml_pipeline_torch.features.base import FeatureSet
from audio_edge_ml_pipeline_torch.features.pipeline import FeaturePipeline
from audio_edge_ml_pipeline_torch.tools import diagnose_data, diagnose_training, load_sample_data, test_dashboard
from audio_edge_ml_pipeline_torch.tools import test_model as ttest_model
from audio_edge_ml_pipeline_torch.tools import verify_training_data

REPO = Path(__file__).resolve().parent.parent
NAMES = ["Birdsong", "Fire", "Rain", "Wind"]
CONF_TOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _jax_script(name: str):
    spec = importlib.util.spec_from_file_location(f"jax_script_{name}", REPO / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _stdout(fn, capsys) -> str:
    capsys.readouterr()
    fn()
    return capsys.readouterr().out


@pytest.fixture(scope="module")
def mel_set(tmp_path_factory) -> Path:
    """A seeded mel-shaped FeatureSet: 4 classes x 9 rows of (8, 21), one
    class thin (3 rows) and one constant feature dimension."""
    root = tmp_path_factory.mktemp("scripts")
    rng = np.random.default_rng(17)
    counts = [9, 9, 9, 3]
    y = np.concatenate([np.full(n, c) for c, n in enumerate(counts)]).astype(np.int32)
    X = rng.random((len(y), 8, 21), dtype=np.float32) + y[:, None, None] * 0.3
    X[:, 0, 0] = 0.5
    order = rng.permutation(len(y))
    FeaturePipeline.save(FeatureSet(features=X[order], feature_type="deep", modality="audio",
                                    metadata=[{"filename": f"c{i}.wav"} for i in range(len(y))],
                                    labels=y[order], label_names=NAMES), root / "mel")
    return root / "mel"


@pytest.mark.parametrize("script,argv", [
    ("diagnose_data", []),
    ("diagnose_training", []),
    ("diagnose_training", ["--val-split", "0.3"]),
    ("verify_training_data", []),
    ("verify_training_data", ["--classes", "Wind", "Fire", "Nope"]),
])
def test_diagnostics_print_what_the_jax_scripts_print(mel_set, capsys, monkeypatch, script, argv):
    port = {"diagnose_data": diagnose_data, "diagnose_training": diagnose_training,
            "verify_training_data": verify_training_data}[script]
    jax_mod = _jax_script(script)
    monkeypatch.setattr(sys, "argv", [script, str(mel_set), *argv])
    want = _stdout(jax_mod.main, capsys)
    got = _stdout(lambda: port.main([str(mel_set), *argv]), capsys)
    assert got == want
    if script == "diagnose_data":
        assert "NaN: 0  Inf: 0\n" in got and "PROBLEM" not in got
    if script == "diagnose_training":
        assert "1 constant feature dims" in got and "leakage" not in got
    if script == "verify_training_data" and argv:
        assert "classes ['Fire', 'Wind']" in got


@pytest.fixture(scope="module")
def bundle(mel_set, tmp_path_factory) -> Path:
    """A seeded cnn bundle (the flax layout), written by the port."""
    from audio_edge_ml_pipeline_torch.models.deep import CNNTrainer

    root = tmp_path_factory.mktemp("bundles")
    fs = FeaturePipeline.load(mel_set)
    cnn = CNNTrainer(filters=[4, 8], device="cpu")
    cnn.initialize((8, 21, 1), len(NAMES), torch.Generator().manual_seed(3))
    cnn.norm_mean = np.float32(fs.features.mean())
    cnn.norm_var = np.float32(fs.features.var())
    cnn.save(root / "model.flax.npz")
    return root / "model.flax.npz"


def _rows(text: str) -> list[tuple[str, float | None]]:
    out = []
    for line in text.splitlines():
        m = re.search(r" conf=(\S+)$", line)
        out.append((line[: m.start()] if m else line, float(m.group(1)) if m and m.group(1) != "n/a" else None))
    return out


@pytest.mark.parametrize("extra", [[], ["--n", "40"]])
def test_test_model_on_the_cpu_prints_what_the_jax_script_prints(mel_set, bundle, capsys, monkeypatch, extra):
    argv = [str(bundle), str(mel_set), *extra]
    monkeypatch.setattr(sys, "argv", ["test_model", *argv])
    want = _rows(_stdout(_jax_script("test_model").main, capsys))
    got = _rows(_stdout(lambda: ttest_model.main([*argv, "--device", "cpu"]), capsys))
    n = 30 if extra else 10
    assert len(got) == n + 1 and got[-1][0].endswith(f"/{n} correct")
    assert [g[0] for g in got] == [w[0] for w in want]
    assert all(abs(g[1] - w[1]) <= CONF_TOL for g, w in zip(got[:-1], want[:-1]))


def test_test_model_confidences_within_1e5_of_jax(mel_set, bundle):
    """The probabilities the printout rounds, before rounding."""
    from audio_edge_ml_pipeline_torch.optimize.quantize import load_trainer_any as tload
    from audio_edge_ml_pipeline_tpu.optimize.quantize import load_trainer_any as jload

    X = FeaturePipeline.load(mel_set).features
    p_port = tload(bundle, "cnn", device="cpu").predict_proba(X)
    p_jax = np.asarray(jload(bundle, "cnn").predict_proba(X))
    assert p_port.shape == (30, len(NAMES)) and np.abs(p_port - p_jax).max() <= CONF_TOL


def test_load_sample_data_posts_without_requests(tmp_path, monkeypatch, capsys):
    """The port's ingestion API on port 0, ``requests`` unimportable: 5
    uploads, each a WAV and a sidecar with the script's fields, the same
    fields the JAX script (through requests) gives the same server."""
    from audio_edge_ml_pipeline_torch.data.audio_io import write_wav
    from audio_edge_ml_pipeline_torch.serve import api

    data = tmp_path / "clips"
    for c in ("Fire", "Rain", "Wind"):
        (data / c).mkdir(parents=True)
        for i in range(2):
            write_wav(data / c / f"clip_{i}.wav", np.full(800, 0.1 * (i + 1), np.float32), 16000)
    stores = {}
    for who in ("jax", "port"):
        server = api.create_server(tmp_path / f"uploads_{who}", port=0)
        threading.Thread(target=server.serve_forever, daemon=True).start()
        url = f"http://127.0.0.1:{server.server_address[1]}"
        try:
            if who == "port":
                monkeypatch.setitem(sys.modules, "requests", None)
                out = _stdout(lambda: load_sample_data.main(["--dataset", str(data), "--api-url", url]), capsys)
            else:
                monkeypatch.setattr(sys, "argv", ["load_sample_data", "--dataset", str(data), "--api-url", url])
                out = _stdout(_jax_script("load_sample_data").main, capsys)
        finally:
            server.shutdown()
            server.server_close()
        metas = [json.loads(p.read_text()) for p in sorted((tmp_path / f"uploads_{who}").glob("*.json"))]
        stores[who] = sorted((m["filename"], m["true_class"], m["source"], m["size_bytes"]) for m in metas)
        assert [ln.split(": ", 1)[1][:4] for ln in out.splitlines()] == ["200 "] * 5, out
        assert len(list((tmp_path / f"uploads_{who}").glob("*.wav"))) == 5
    assert stores["port"] == stores["jax"]
    assert {m[1] for m in stores["port"]} == {"Fire", "Rain", "Wind"} and {m[2] for m in stores["port"]} == {
        "load_sample_data"}
    with pytest.raises(SystemExit, match="no .wav"):
        load_sample_data.main(["--dataset", str(tmp_path / "uploads_port" / "none")])


def test_load_sample_data_reports_an_error_status(tmp_path, capsys):
    """A reply with a status other than 2xx is printed, as requests returns
    it, not raised."""
    from audio_edge_ml_pipeline_torch.data.audio_io import write_wav
    from audio_edge_ml_pipeline_torch.serve import api

    (tmp_path / "a").mkdir()
    write_wav(tmp_path / "a" / "x.wav", np.zeros(80, np.float32), 16000)
    server = api.create_server(tmp_path / "up", port=0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        url = f"http://127.0.0.1:{server.server_address[1]}/nowhere"
        assert load_sample_data.post_clip(url, tmp_path / "a" / "x.wav") == (404, {"error": "not found"})
    finally:
        server.shutdown()
        server.server_close()


def test_test_dashboard_renders(capsys):
    out = _stdout(lambda: test_dashboard.main([]), capsys)
    assert out.startswith("render OK (") and "bytes of HTML" in out
