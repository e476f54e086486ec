"""The port's serving loop on the CPU against the JAX package's: the
ingestion API (serve/api.py), the ingestion preprocessor
(serve/audio_processor.py), the spectrogram dataset (train/dataset.py), the
dashboard (serve/dashboard.py) and the edge simulator's upload, which posts
through urllib with ``requests`` made unimportable."""

from __future__ import annotations

import base64
import json
import re
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from audio_edge_ml_pipeline_tpu.ops import golden as jgolden
from audio_edge_ml_pipeline_tpu.serve import api as japi
from audio_edge_ml_pipeline_tpu.serve import audio_processor as jproc
from audio_edge_ml_pipeline_tpu.serve import dashboard as jdash
from audio_edge_ml_pipeline_tpu.train import dataset as jdataset
from audio_edge_ml_pipeline_torch.data.audio_io import write_wav
from audio_edge_ml_pipeline_torch.models.deep import CNNTrainer, load_any_model
from audio_edge_ml_pipeline_torch.ops import mel_kernel
from audio_edge_ml_pipeline_torch.serve import api, audio_processor, dashboard
from audio_edge_ml_pipeline_torch.serve.edge_simulator import EdgeDeviceSimulator, multipart_body
from audio_edge_ml_pipeline_torch.train.dataset import SpectrogramDataset

SR = 16000
FEATURE_TOL = 1e-5   # the repo's DSP parity gate (max|delta| vs float64)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _serve(data_dir: Path):
    server = api.create_server(data_dir, port=0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, f"http://127.0.0.1:{server.server_address[1]}"


# ---------------------------------------------------------------------------
# Ingestion API
# ---------------------------------------------------------------------------


def test_ingestion_api_upload_and_health(tmp_path):
    """tests/test_serve_tools.py's cases, against the port's server."""
    import requests

    server, url = _serve(tmp_path / "uploads")
    try:
        r = requests.get(f"{url}/health", timeout=5)
        assert r.status_code == 200 and r.json() == {"status": "ok"}
        wav_bytes = b"RIFF" + b"\x00" * 40  # content is opaque to the API
        r = requests.post(f"{url}/upload", files={"file": ("clip.wav", wav_bytes, "audio/wav")},
                          data={"device_id": "sim0", "confidence": "0.42"}, timeout=5)
        assert r.status_code == 200, r.text
        body = r.json()
        assert set(body) == {"id", "filename"} and body["filename"] == "clip.wav"
        file_id = body["id"]
        stored = tmp_path / "uploads" / f"{file_id}.wav"
        assert stored.exists() and stored.read_bytes() == wav_bytes
        meta = json.loads((tmp_path / "uploads" / f"{file_id}.json").read_text())
        assert meta["device_id"] == "sim0" and meta["filename"] == "clip.wav" and meta["confidence"] == "0.42"
        assert meta["stored_as"] == stored.name and meta["size_bytes"] == len(wav_bytes) and meta["id"] == file_id
        # bad route, missing file field, a raw body
        assert requests.get(f"{url}/nope", timeout=5).status_code == 404
        assert requests.post(f"{url}/nope", data=b"x", timeout=5).status_code == 404
        r = requests.post(f"{url}/upload", files={"other": ("x", b"1")}, timeout=5)
        assert r.status_code == 400 and r.json() == {"error": "no 'file' field in upload"}
        r = requests.post(f"{url}/upload", data=b"raw bytes", timeout=5)
        assert r.status_code == 200 and r.json()["filename"] == "upload.bin"
        assert (tmp_path / "uploads" / f"{r.json()['id']}.bin").read_bytes() == b"raw bytes"
    finally:
        server.shutdown()
        server.server_close()


MULTIPART_CASES = {
    "file and fields": ("b0undary", [("device_id", None, b"sim0"), ("file", "clip.wav", b"RIFF\x00\x01")]),
    "quoted boundary": ('"q-b"', [("file", "a.wav", b"\x00\xff\r\n\r\n")]),
    "field with no file": ("xyz", [("note", None, b"hello world"), ("confidence", None, b"0.5")]),
    "binary tail bytes": ("tail", [("file", "t.bin", b"abc\r\n\r")]),
    "empty filename": ("e", [("file", "", b"data"), ("x", None, b"")]),
}


def _multipart(boundary: str, parts) -> tuple[bytes, str]:
    b = boundary.strip('"')
    chunks = []
    for name, filename, content in parts:
        disp = f'form-data; name="{name}"' + (f'; filename="{filename}"' if filename is not None else "")
        head = f"--{b}\r\nContent-Disposition: {disp}\r\n"
        head += "Content-Type: application/octet-stream\r\n\r\n" if filename is not None else "\r\n"
        chunks.append(head.encode() + content + b"\r\n")
    return b"".join(chunks) + f"--{b}--\r\n".encode(), f"multipart/form-data; boundary={boundary}"


@pytest.mark.parametrize("case", sorted(MULTIPART_CASES))
def test_parse_multipart_equals_jax(case):
    body, ctype = _multipart(*MULTIPART_CASES[case])
    ours = api._parse_multipart(body, ctype)
    assert ours == japi._parse_multipart(body, ctype)
    files, names, fields = ours
    for name, filename, content in MULTIPART_CASES[case][1]:
        if filename is None:
            assert fields[name] == content.decode()
        else:
            assert files[name] == content and names[name] == filename


def test_parse_multipart_without_boundary_raises():
    with pytest.raises(ValueError, match="boundary"):
        api._parse_multipart(b"", "multipart/form-data")


def test_simulator_multipart_body_parses_back():
    body = multipart_body("bnd", {"device_id": "d", "confidence": "0.25"}, "file", "c.wav", b"\r\nWAV\r\n",
                          "audio/wav")
    files, names, fields = api._parse_multipart(body, "multipart/form-data; boundary=bnd")
    assert files == {"file": b"\r\nWAV\r\n"} and names == {"file": "c.wav"}
    assert fields == {"device_id": "d", "confidence": "0.25"}


# ---------------------------------------------------------------------------
# audio_processor and SpectrogramDataset
# ---------------------------------------------------------------------------


def _clip(seed: int, n: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(n) / SR
    y = 0.4 * np.sin(2 * np.pi * (200 + 150 * seed) * t) * (1 + 0.3 * np.sin(2 * np.pi * 3 * t))
    return (y + 0.05 * rng.standard_normal(n)).astype(np.float32)


@pytest.fixture(scope="module")
def uploads(tmp_path_factory):
    """An uploads directory as the API writes it: <uuid>.wav + <uuid>.json,
    a clip longer and one shorter than 5 s, one without a sidecar."""
    root = tmp_path_factory.mktemp("uploads")
    for i, n in enumerate((5 * SR, 6 * SR + 7, 3 * SR + 11)):
        write_wav(root / f"u{i}.wav", _clip(i, n), SR)
        if i < 2:
            (root / f"u{i}.json").write_text(json.dumps({"id": f"u{i}", "device_id": "sim0",
                                                         "prediction": "a", "confidence": "0.3"}))
    return root


@pytest.fixture(scope="module")
def processed(uploads, tmp_path_factory):
    out = {name: tmp_path_factory.mktemp(f"processed_{name}") for name in ("port", "jax")}
    audio_processor.main(["--input", str(uploads), "--output", str(out["port"]), "--device", "cpu"])
    jproc.main(["--input", str(uploads), "--output", str(out["jax"])])
    return out


def test_audio_processor_matches_jax_and_golden(uploads, processed):
    from audio_edge_ml_pipeline_torch.data.audio_io import load_audio

    names = sorted(p.name for p in processed["jax"].iterdir())
    assert sorted(p.name for p in processed["port"].iterdir()) == names
    assert names == ["u0.json", "u0.npy", "u1.json", "u1.npy", "u2.npy"]
    for name in names:
        if name.endswith(".json"):
            assert (processed["port"] / name).read_text() == (processed["jax"] / name).read_text()
            continue
        ours, theirs = np.load(processed["port"] / name), np.load(processed["jax"] / name)
        assert ours.dtype == np.float32 and ours.shape == theirs.shape == (40, 501)
        assert float(np.abs(ours - theirs).max()) <= FEATURE_TOL
        y, _ = load_audio(uploads / name.replace(".npy", ".wav"), sr=SR)
        y = np.pad(y, (0, max(5 * SR - len(y), 0)))[: 5 * SR]
        assert float(np.abs(ours - jgolden.mel_spec_feature(y.astype(np.float64))).max()) <= FEATURE_TOL


def test_audio_processor_skips_a_corrupt_upload(uploads, tmp_path, caplog):
    src = tmp_path / "in"
    src.mkdir()
    for p in uploads.iterdir():
        (src / p.name).write_bytes(p.read_bytes())
    (src / "bad.wav").write_bytes(b"RIFF\x00\x00\x00\x00WAVEjunk")
    (src / "bad.json").write_text(json.dumps({"id": "bad"}))
    proc = audio_processor.AudioPreprocessor(device="cpu")
    assert proc.process_dataset(src, tmp_path / "out") == 3
    assert not (tmp_path / "out" / "bad.npy").exists() and not (tmp_path / "out" / "bad.json").exists()
    assert any("skipping" in r.getMessage() and "bad.wav" in r.getMessage() for r in caplog.records)


def test_a_failure_of_the_mel_path_propagates(uploads, tmp_path, monkeypatch):
    def broken(*args, **kwargs):
        raise RuntimeError("mel kernel launch failed")

    monkeypatch.setattr(mel_kernel, "mel_spec_feature", broken)
    with pytest.raises(RuntimeError, match="mel kernel launch failed"):
        audio_processor.main(["--input", str(uploads), "--output", str(tmp_path / "out"), "--device", "cpu"])
    assert not list((tmp_path / "out").glob("*.npy"))


def test_audio_processor_without_a_card_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        audio_processor.main(["--input", str(tmp_path), "--output", str(tmp_path / "out")])


@pytest.fixture()
def labelled(tmp_path):
    """.npy files with sidecars: two classes, one file without a sidecar,
    one with a sidecar without the label and one with a broken sidecar."""
    rng = np.random.default_rng(5)
    labels = {"f0": "rain", "f1": "fire", "f2": None, "f3": "rain", "f4": "__nolabel__", "f5": "__broken__"}
    for stem, label in labels.items():
        np.save(tmp_path / f"{stem}.npy", rng.random((40, 501)).astype(np.float32))
        if label == "__broken__":
            (tmp_path / f"{stem}.json").write_text("{not json")
        elif label == "__nolabel__":
            (tmp_path / f"{stem}.json").write_text(json.dumps({"id": stem}))
        elif label is not None:
            (tmp_path / f"{stem}.json").write_text(json.dumps({"id": stem, "true_class": label}))
    return tmp_path


def test_load_arrays_equals_jax(labelled):
    ours, theirs = SpectrogramDataset(labelled), jdataset.SpectrogramDataset(labelled)
    X, y = ours.load_arrays()
    jX, jy = theirs.load_arrays()
    np.testing.assert_array_equal(X, jX)
    np.testing.assert_array_equal(y, jy)
    assert ours.label_names == theirs.label_names == ["fire", "rain"]
    assert y.tolist() == [1, 0, -1, 1, -1, -1] and y.dtype == np.int32 and X.dtype == np.float32
    assert len(ours) == len(theirs) == 6
    # another label key; and no labels at all
    assert SpectrogramDataset(labelled, label_key="id").label_names == ["f0", "f1", "f3", "f4"]
    X2, y2 = SpectrogramDataset(labelled, label_key="nothing").load_arrays()
    assert y2 is None and X2.shape == (6, 40, 501)


def test_to_data_loader_batches_and_seeded_shuffle(labelled):
    ds = SpectrogramDataset(labelled)
    X, y = ds.load_arrays()
    batches = list(ds.to_data_loader(batch_size=4))
    assert [len(b[0]) for b in batches] == [4, 2]
    np.testing.assert_array_equal(torch.cat([b[0] for b in batches]).numpy(), X)
    np.testing.assert_array_equal(torch.cat([b[1] for b in batches]).numpy(), y)

    def shuffled(seed):
        batches = list(ds.to_data_loader(batch_size=4, shuffle=True, seed=seed))
        assert [len(b[0]) for b in batches] == [4, 2]
        rows, labels = torch.cat([b[0] for b in batches]).numpy(), torch.cat([b[1] for b in batches]).numpy()
        perm = [int(np.flatnonzero((X == row).all(axis=(1, 2)))[0]) for row in rows]
        np.testing.assert_array_equal(labels, y[perm])
        return perm

    first = shuffled(7)
    assert first == shuffled(7) and sorted(first) == list(range(6))
    assert any(shuffled(s) != list(range(6)) for s in (7, 8, 9))
    unlabelled = SpectrogramDataset(labelled, label_key="nothing").to_data_loader(batch_size=6)
    (only,) = list(unlabelled)
    assert isinstance(only, torch.Tensor) and only.shape == (6, 40, 501)


# ---------------------------------------------------------------------------
# Dashboard
# ---------------------------------------------------------------------------


@pytest.fixture()
def telemetry_files(tmp_path):
    tdir, sdir = tmp_path / "telemetry", tmp_path / "stats"
    tdir.mkdir()
    sdir.mkdir()
    rng = np.random.default_rng(3)
    classes = ["Fire", "Rain", "Wind"]
    for dev in ("devA", "devB"):
        events = []
        for i in range(30):
            c = classes[int(rng.integers(0, 3))]
            events.append({"timestamp": f"2026-08-19T10:{i // 60:02d}:{i % 60:02d}", "device_id": dev,
                           "true_class": c, "prediction": c if rng.random() > 0.2 else classes[0],
                           "confidence": float(rng.uniform(0.2, 1.0)), "uploaded": bool(rng.random() < 0.1)})
        (tdir / f"{dev}_telemetry.jsonl").write_text("\n".join(json.dumps(e) for e in events) + "\nnot json\n")
    (sdir / "devA_stats.json").write_text(json.dumps({"total_inferences": 30, "avg_confidence": 0.65, "uploads": 2}))
    (sdir / "devC_stats.json").write_text(json.dumps({"total_inferences": 0}))
    (sdir / "broken_stats.json").write_text("{")
    return tdir, sdir


def test_render_without_matplotlib_equals_jax(telemetry_files, monkeypatch):
    tdir, sdir = telemetry_files
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    assert dashboard._mpl() is None
    telemetry, stats = dashboard.load_telemetry(tdir), dashboard.load_stats(sdir)
    assert telemetry == jdash.load_telemetry(tdir) and stats == jdash.load_stats(sdir)
    assert sorted(stats) == ["devA", "devC"] and len(telemetry["devA"]) == 30
    page = dashboard.render(telemetry, stats)
    assert page == jdash.render(telemetry, stats)
    assert "base64," not in page and "devC" in page and "0.650" in page
    empty = dashboard.render({}, {})
    assert empty == jdash.render({}, {}) and "No telemetry yet" in empty


def test_render_with_matplotlib_has_jax_panels(telemetry_files):
    pytest.importorskip("matplotlib")
    tdir, sdir = telemetry_files
    telemetry, stats = dashboard.load_telemetry(tdir), dashboard.load_stats(sdir)
    page, jpage = dashboard.render(telemetry, stats), jdash.render(telemetry, stats)
    assert page.count("base64,") == jpage.count("base64,") == 3   # the fleet panel and one a device
    assert page == jpage   # the same matplotlib in one process renders the same PNG bytes
    for payload in re.findall(r"base64,([A-Za-z0-9+/=]+)", page):
        assert base64.b64decode(payload)[:8] == b"\x89PNG\r\n\x1a\n"


def test_dashboard_server_serves_the_page(telemetry_files, monkeypatch):
    import urllib.request

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    tdir, sdir = telemetry_files
    server = dashboard.create_server(tdir, sdir, port=0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{server.server_address[1]}/", timeout=5) as r:
            assert r.status == 200 and r.headers["Content-Type"].startswith("text/html")
            page = r.read().decode()
    finally:
        server.shutdown()
        server.server_close()
    assert page == dashboard.render(dashboard.load_telemetry(tdir), dashboard.load_stats(sdir))


# ---------------------------------------------------------------------------
# The loop: simulator -> API -> telemetry -> audio_processor -> dataset -> dashboard
# ---------------------------------------------------------------------------


@pytest.fixture()
def clips_and_bundle(tmp_path):
    ds = tmp_path / "clips"
    for c, name in enumerate(["low", "high"]):
        d = ds / name
        d.mkdir(parents=True)
        for i in range(3):
            write_wav(d / f"{i}.wav", _clip(c * 10 + i, SR), SR)
    trainer = CNNTrainer(filters=[8], device="cpu")
    trainer.initialize((16, 101, 1), 2, torch.Generator().manual_seed(0))
    trainer.save(tmp_path / "model.flax.npz")
    return ds, tmp_path / "model.flax.npz"


MEL = {"sample_rate": SR, "n_mels": 16, "n_fft": 512, "hop_length": 160, "duration": 1.0}


def test_serve_loop_with_requests_hidden(tmp_path, clips_and_bundle, monkeypatch):
    """tests/test_serve_tools.py's loop on the port, with ``requests``
    unimportable: every upload must reach the API."""
    monkeypatch.setitem(sys.modules, "requests", None)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    ds, bundle = clips_and_bundle
    server, url = _serve(tmp_path / "uploads")
    try:
        sim = EdgeDeviceSimulator(bundle, ["low", "high"], ds, device_id="loopdev", api_url=url,
                                  upload_threshold=1.1, telemetry_dir=tmp_path / "telemetry",
                                  stats_dir=tmp_path / "stats", mel_params=MEL, device="cpu")
        sim.run(6)
    finally:
        server.shutdown()
        server.server_close()

    events = [json.loads(l) for l in (tmp_path / "telemetry" / "loopdev_telemetry.jsonl").read_text().splitlines()]
    assert len(events) == 6 and all(e["uploaded"] for e in events)
    sidecars = sorted((tmp_path / "uploads").glob("*.json"))
    wavs = sorted((tmp_path / "uploads").glob("*.wav"))
    assert len(sidecars) == len(wavs) == 6
    metas = [json.loads(p.read_text()) for p in sidecars]
    assert all(m["device_id"] == "loopdev" for m in metas)
    assert sorted(m["filename"] for m in metas) == sorted(e["clip"] for e in events)
    assert sorted((m["prediction"], m["confidence"]) for m in metas) == \
        sorted((e["prediction"], str(e["confidence"])) for e in events)
    for m in metas:   # the stored clip is a clip the simulator scored
        stored = (tmp_path / "uploads" / m["stored_as"]).read_bytes()
        assert any(p.read_bytes() == stored for p in ds.rglob(m["filename"]))

    # relabel the uploads from the telemetry, preprocess them, read them back, score them again
    for p, m in zip(sidecars, metas):
        m["true_class"] = next(e["true_class"] for e in events if e["clip"] == m["filename"]
                               and str(e["confidence"]) == m["confidence"])
        p.write_text(json.dumps(m))
    proc = audio_processor.AudioPreprocessor(sample_rate=SR, n_mels=16, duration=1.0, device="cpu")
    assert proc.process_dataset(tmp_path / "uploads", tmp_path / "processed") == 6
    data = SpectrogramDataset(tmp_path / "processed")
    X, y = data.load_arrays()
    metas_p = [json.loads(p.read_text()) for p in sorted((tmp_path / "processed").glob("*.json"))]
    assert [data.label_names[i] for i in y] == [m["true_class"] for m in metas_p]
    probs = load_any_model(bundle, device="cpu").predict_proba(X)
    for row, m in zip(probs, metas_p):
        assert ["low", "high"][int(row.argmax())] == m["prediction"]
        assert abs(float(row.max()) - float(m["confidence"])) <= 1e-5

    page = dashboard.render(dashboard.load_telemetry(tmp_path / "telemetry"), dashboard.load_stats(tmp_path / "stats"))
    assert "loopdev" in page and "<span class='big'>6</span>" in page
    assert any(e["prediction"] in page for e in events)


def test_upload_to_a_dead_api_is_logged_not_raised(tmp_path, clips_and_bundle, monkeypatch, caplog):
    monkeypatch.setitem(sys.modules, "requests", None)
    ds, bundle = clips_and_bundle
    sim = EdgeDeviceSimulator(bundle, ["low", "high"], ds, device_id="dead", api_url="http://127.0.0.1:1",
                              upload_threshold=1.1, telemetry_dir=tmp_path / "telemetry",
                              stats_dir=tmp_path / "stats", mel_params=MEL, device="cpu")
    event = sim.step()
    assert event["uploaded"] is False
    assert any("upload failed" in r.getMessage() for r in caplog.records)
