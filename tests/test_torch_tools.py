"""The port's repository tools (audio_edge_ml_pipeline_torch/tools/) against
the JAX tools of the same name (tools/*.py, importable through conftest's
tools/ path): the synthetic dataset maker byte for byte, the split manifest
and its drift guard, the serial frames, the PCM captures, stage 8's
device-in-the-loop evaluation; and the public names the port lacked
(fault q) against the JAX names on the same input."""

from __future__ import annotations

import json
import random
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import evaluate_device as jeval
import generate_split as jsplit
import make_synth_dataset as jsynth
import receive_wav as jrecv
import record_dataset as jrec
import serial_proto as jsp
from audio_edge_ml_pipeline_torch.tools import evaluate_device as teval
from audio_edge_ml_pipeline_torch.tools import generate_split as tsplit
from audio_edge_ml_pipeline_torch.tools import make_synth_dataset as tsynth
from audio_edge_ml_pipeline_torch.tools import receive_wav as trecv
from audio_edge_ml_pipeline_torch.tools import record_dataset as trec
from audio_edge_ml_pipeline_torch.tools import serial_proto as tsp


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _tree(root: Path) -> dict[str, bytes]:
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*")) if p.is_file()}


def _jax_main(module, argv: list[str], monkeypatch) -> None:
    """A JAX tool's ``main()``, which parses ``sys.argv``."""
    monkeypatch.setattr(sys, "argv", [module.__file__, *argv])
    module.main()


@pytest.fixture(scope="module")
def synth(tmp_path_factory) -> Path:
    """3 classes x 6 clips in every layout, written by the port's tool."""
    root = tmp_path_factory.mktemp("synth")
    tsynth.main([str(root), "--classes", "3", "--per-class", "6", "--sr", "8000"])
    return root


# ---------------------------------------------------------------------------
# make_synth_dataset
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("classes,per_class,sr", [(3, 2, 16000), (13, 1, 8000)])
def test_make_synth_dataset_writes_the_jax_tools_bytes(tmp_path, monkeypatch, classes, per_class, sr):
    """Every file of every layout (fsc22 WAVs and CSV, audio_folder, text.csv,
    tabular.csv, the PNG tree), byte for byte; 13 classes reach class_name's
    wrapped names (index 12 is "Chainsaw2")."""
    argv = ["--classes", str(classes), "--per-class", str(per_class), "--sr", str(sr)]
    _jax_main(jsynth, [str(tmp_path / "jax"), *argv], monkeypatch)
    tsynth.main([str(tmp_path / "port"), *argv])
    jax_tree, port_tree = _tree(tmp_path / "jax"), _tree(tmp_path / "port")
    assert len(port_tree) == 2 * classes * per_class + 1 + 2 + 3 * 8
    assert sorted(port_tree) == sorted(jax_tree)
    assert [k for k in port_tree if port_tree[k] != jax_tree[k]] == []
    if classes > 12:
        assert (tmp_path / "port" / "audio_folder" / "Chainsaw2").is_dir()


def test_class_name_and_synth_clip_match_for_every_index():
    for c in range(30):
        assert tsynth.class_name(c) == jsynth.class_name(c)
    for c, i in [(0, 0), (5, 3), (12, 1), (25, 7)]:
        assert np.array_equal(tsynth.synth_clip(c, i, sr=8000, seconds=0.5), jsynth.synth_clip(c, i, sr=8000, seconds=0.5))


# ---------------------------------------------------------------------------
# generate_split
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layout", ["folder", "fsc22"])
@pytest.mark.parametrize("seed", [42, 7])
def test_generate_split_manifest_equals_the_jax_tools(synth, tmp_path, monkeypatch, capsys, layout, seed):
    dataset = synth / ("fsc22" if layout == "fsc22" else "audio_folder")
    argv = ["--dataset", str(dataset), "--layout", layout, "--seed", str(seed)]
    _jax_main(jsplit, [*argv, "--output", str(tmp_path / "jax.json")], monkeypatch)
    tsplit.main([*argv, "--output", str(tmp_path / "port.json")])
    out = capsys.readouterr().out
    assert (tmp_path / "port.json").read_text() == (tmp_path / "jax.json").read_text()
    manifest = json.loads((tmp_path / "port.json").read_text())
    # 6 clips a class: round(4.2) = 4 train, round(0.9) = 1 val, 1 test
    assert [len(manifest[s]) for s in ("train", "val", "test")] == [12, 3, 3]
    assert "train: 12  val: 3  test: 3" in out


def test_generate_split_drift_guard_exits_as_the_jax_tool(synth, tmp_path, monkeypatch, capsys):
    dataset = synth / "audio_folder"

    def run(tool, out: Path, *extra: str) -> tuple[int, str]:
        argv = ["--dataset", str(dataset), "--output", str(out), *extra]
        try:
            _jax_main(jsplit, argv, monkeypatch) if tool == "jax" else tsplit.main(argv)
            code = 0
        except SystemExit as exc:
            code = exc.code
        text = capsys.readouterr().out
        return code, text.replace(str(out), "<out>")

    runs = {}
    for tool in ("jax", "port"):
        out = tmp_path / f"{tool}.json"
        runs[tool] = [run(tool, out), run(tool, out), run(tool, out, "--seed", "7"),
                      run(tool, out, "--seed", "7", "--force")]
    assert [c for c, _ in runs["port"]] == [0, 0, 1, 0]
    assert "DRIFT GUARD" in runs["port"][2][1] and "WARNING: overwriting manifest" in runs["port"][3][1]
    assert runs["port"] == runs["jax"]
    assert (tmp_path / "port.json").read_text() == (tmp_path / "jax.json").read_text()


# ---------------------------------------------------------------------------
# serial_proto
# ---------------------------------------------------------------------------


def test_serial_frames_are_byte_identical_in_both_directions():
    rng = np.random.default_rng(3)
    feat = rng.standard_normal((40, 51)).astype(np.float32)
    pcm = rng.integers(-32768, 32767, 1600).astype(np.int16)
    wire = {}
    for name, sp in (("jax", jsp), ("port", tsp)):
        ser = sp.LoopbackSerial()
        sp.write_feat_frame(ser, feat)
        sp.write_pcm_frame(ser, pcm)
        wire[name] = ser.read(1 << 20)
    assert wire["port"] == wire["jax"]
    assert (tsp.MAGIC_FEAT, tsp.MAGIC_PCM, tsp.MAGIC_END) == (jsp.MAGIC_FEAT, jsp.MAGIC_PCM, jsp.MAGIC_END)
    for writer, reader in ((jsp, tsp), (tsp, jsp)):
        ser = reader.LoopbackSerial()
        ser.feed(b"\x00junk\xfe\xed\x12")   # a partial magic before the frame
        writer.write_feat_frame(ser, feat)
        ser.feed(b"noise")
        writer.write_pcm_frame(ser, pcm)
        assert np.array_equal(reader.read_feat_frame(ser), feat)
        assert np.array_equal(reader.read_pcm_frame(ser), pcm)
        with pytest.raises(TimeoutError):
            reader.read_pcm_frame(ser)


def test_eval_roundtrip_parses_the_same_reply():
    reply = b"log line\nPRED Rain\nSCORES 0.1 0.7 0.2\nEVAL_DONE\n"
    got = []
    for sp in (jsp, tsp):
        ser = sp.LoopbackSerial(on_write=lambda s, data: s.feed(reply) if data == b"R" else None)
        label, scores = sp.eval_roundtrip(ser)
        got.append((label, scores.tolist()))
    assert got[0] == got[1] == ("Rain", np.float32([0.1, 0.7, 0.2]).tolist())


def test_open_serial_without_pyserial_exits_with_the_jax_message(monkeypatch):
    monkeypatch.setitem(sys.modules, "serial", None)
    msgs = []
    for sp in (jsp, tsp):
        with pytest.raises(SystemExit) as exc:
            sp.open_serial("/dev/null")
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1] and "pyserial is not installed" in msgs[1]


# ---------------------------------------------------------------------------
# receive_wav and record_dataset
# ---------------------------------------------------------------------------


def _pcm_frames(n: int = 3, length: int = 4000) -> list[np.ndarray]:
    rng = np.random.default_rng(9)
    frames = [rng.integers(-20000, 20000, length).astype(np.int16) for _ in range(n)]
    frames[0][:2] = (-32768, 32767)   # full scale both ways
    return frames


def _pcm_loopback(sp, frames) -> object:
    ser = sp.LoopbackSerial()
    for f in frames:
        sp.write_pcm_frame(ser, f)
    return ser


def test_receive_wav_writes_the_jax_tools_wavs(tmp_path, monkeypatch):
    frames = _pcm_frames()
    for name, tool, sp in (("jax", jrecv, jrecv.serial_proto), ("port", trecv, tsp)):
        monkeypatch.setattr(sp, "open_serial", lambda *a, **k: _pcm_loopback(tsp, frames))
        argv = ["--port", "loop", "--count", "3", "--out", str(tmp_path / name), "--sample-rate", "16000"]
        _jax_main(tool, argv, monkeypatch) if name == "jax" else tool.main(argv)
    got = {name: [p.read_bytes() for p in sorted((tmp_path / name).glob("capture_*.wav"))] for name in ("jax", "port")}
    assert len(got["port"]) == 3 and got["port"] == got["jax"]
    from audio_edge_ml_pipeline_torch.data.audio_io import write_wav

    write_wav(tmp_path / "ref.wav", frames[1].astype("float32") / 32768.0, 16000)
    assert got["port"][1] == (tmp_path / "ref.wav").read_bytes()
    # one capture to a .wav path, and the data/debug/<experiment>/wav/ default
    trecv.receive(_pcm_loopback(tsp, frames[:1]), tmp_path, 1, 16000, out_path=tmp_path / "one.wav")
    assert (tmp_path / "one.wav").read_bytes() == got["port"][0]
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(tsp, "open_serial", lambda *a, **k: _pcm_loopback(tsp, frames[:1]))
    trecv.main(["--port", "loop", "--experiment", "e1"])
    assert len(list((tmp_path / "data" / "debug" / "e1" / "wav").glob("capture_*_00.wav"))) == 1


def test_receive_wav_count_0_reads_until_the_transport_runs_dry(tmp_path):
    """count=0 loops until interrupted; on a transport that runs dry that is
    serial_proto's read timeout, after every frame was saved (the JAX tool's
    behaviour)."""
    frames = _pcm_frames()
    for name, tool, sp in (("jax", jrecv, jsp), ("port", trecv, tsp)):
        with pytest.raises(TimeoutError, match="no magic"):
            tool.receive(_pcm_loopback(sp, frames), tmp_path / name, 0, 16000)
        assert len(list((tmp_path / name).glob("capture_*.wav"))) == 3


def test_record_dataset_writes_the_jax_tools_wavs(tmp_path, monkeypatch):
    frames = _pcm_frames(4)
    for name, tool in (("jax", jrec), ("port", trec)):
        cls = tmp_path / name / "Rain"
        cls.mkdir(parents=True)
        (cls / "rec_002.wav").write_bytes(b"old")   # numbering continues after the highest index
        monkeypatch.setattr(tool.serial_proto, "open_serial", lambda *a, **k: _pcm_loopback(tsp, frames))
        argv = ["--port", "loop", "--out", str(tmp_path / name), "--class", "Rain", "--count", "3", "--no-prompt"]
        _jax_main(tool, argv, monkeypatch) if name == "jax" else tool.main(argv)
    jax_tree, port_tree = _tree(tmp_path / "jax"), _tree(tmp_path / "port")
    assert sorted(port_tree) == ["Rain/rec_002.wav", "Rain/rec_003.wav", "Rain/rec_004.wav", "Rain/rec_005.wav"]
    assert port_tree == jax_tree


@pytest.mark.parametrize("layout", ["audio_folder", "fsc22"])
def test_record_dataset_source_dir_seed_plays_the_same_clips(synth, tmp_path, monkeypatch, layout):
    played = {"jax": [], "port": []}
    current = []

    def fake_run(cmd, **kwargs):
        assert cmd[:2] == ["aplay", "-q"]
        current.append(Path(cmd[2]).name)
        return subprocess.CompletedProcess(cmd, 0)

    monkeypatch.setattr(subprocess, "run", fake_run)
    label = jsynth.class_name(1)
    for name, tool in (("jax", jrec), ("port", trec)):
        current.clear()
        monkeypatch.setattr(tool.serial_proto, "open_serial", lambda *a, **k: _pcm_loopback(tsp, _pcm_frames(4)))
        argv = ["--port", "loop", "--out", str(tmp_path / name), "--class", label, "--count", "4",
                "--source-dir", str(synth / layout), "--seed", "7"]
        _jax_main(tool, argv, monkeypatch) if name == "jax" else tool.main(argv)
        played[name] = list(current)
    assert len(played["port"]) == 4 and played["port"] == played["jax"]
    clips = trec._source_clips(synth / layout, label)
    rng = random.Random(7)
    assert played["port"] == [rng.choice(clips).name for _ in range(4)]
    if layout == "fsc22":
        assert all(n.startswith("2_") for n in played["port"])


# ---------------------------------------------------------------------------
# evaluate_device (stage 8)
# ---------------------------------------------------------------------------


def _scripted_device(sp, replies: list[str]):
    """A loopback whose 'R' handler answers with the next scripted label."""
    queue = list(replies)

    def on_write(ser, data):
        if data == b"R":
            label = queue.pop(0)
            ser.feed(f"PRED {label}\nSCORES 0.25 0.5 0.25\nEVAL_DONE\n".encode())

    return sp.LoopbackSerial(on_write=on_write)


def test_evaluate_matches_the_jax_tool_with_an_out_of_set_reply(synth, tmp_path):
    folder = synth / "audio_folder"
    names = [jsynth.class_name(c) for c in range(3)]
    clips = [(p, p.parent.name) for c in names for p in sorted((folder / c).glob("*.wav"))[:3]]
    replies = [c for _, c in clips]
    replies[1] = names[2]          # wrong, in the set
    replies[4] = "Thunderstorm"    # outside the set: the label set grows
    got = {}
    for name, tool, sp in (("jax", jeval, jsp), ("port", teval, tsp)):
        got[name] = tool.evaluate(_scripted_device(sp, replies), clips, sorted(names), playback=False,
                                  output_dir=tmp_path / name)
    assert got["port"] == got["jax"]
    assert got["port"]["val_accuracy"] == pytest.approx(7 / 9)
    assert "Thunderstorm" in got["port"]["per_class"] and len(got["port"]["per_class"]) == 4
    report = (tmp_path / "port" / "classification_report.txt").read_text()
    assert report == (tmp_path / "jax" / "classification_report.txt").read_text()
    assert "Thunderstorm" in report
    assert (tmp_path / "port" / "confusion_matrix.png").read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


@pytest.mark.parametrize("with_report", [True, False])
def test_evaluate_device_cli_fsc22_and_tracking(synth, tmp_path, monkeypatch, with_report):
    """main() through a monkeypatched open_serial, as the JAX tool's: --loader
    fsc22 on a flat tree (the CSV beside the WAVs) whose manifest names a file
    the CSV lacks (its label "?"), with and without --optimization-report's
    class_filter (a JSON string, as the tracking store keeps it); the run
    device_eval_<split> in the --mlflow-uri store, its params, device_*
    metrics and both artifacts."""
    import shutil

    csv_path = next((synth / "fsc22").glob("Metadata*/Metadata/*.csv"))
    flat = tmp_path / "flat"
    flat.mkdir()
    for wav in next((synth / "fsc22").glob("Audio Wise*/Audio Wise V1.0")).glob("*.wav"):
        shutil.copy(wav, flat / wav.name)
    shutil.copy(csv_path, flat / "meta.csv")
    (flat / "stray.wav").write_bytes((flat / "1_1.wav").read_bytes())
    manifest = {"test": sorted(p.name for p in flat.glob("*.wav"))}
    (tmp_path / "m.json").write_text(json.dumps(manifest))
    keep = [jsynth.class_name(0), jsynth.class_name(2)]
    (tmp_path / "report.json").write_text(json.dumps({"class_filter": json.dumps(keep)}))
    truth = {r.split(",")[1]: r.split(",")[3] for r in csv_path.read_text().splitlines()[1:]}
    labels = [truth.get(n, "?") for n in manifest["test"]]
    labels = [c for c in labels if c in keep] if with_report else labels
    replies = [keep[1]] + labels[1:]                      # the first clip (class 0) answered wrong
    replies = [keep[0] if c == "?" else c for c in replies]   # and the stray one
    records = {}
    try:
        for name, tool, sp in (("jax", jeval, jeval.serial_proto), ("port", teval, tsp)):
            cwd = tmp_path / name
            cwd.mkdir()
            monkeypatch.chdir(cwd)
            monkeypatch.setattr(sp, "open_serial", lambda *a, **k: _scripted_device(tsp, replies))
            argv = ["--port", "loop", "--dataset", str(flat), "--loader", "fsc22", "--manifest",
                    str(tmp_path / "m.json"), "--no-playback", "--mlflow-uri", str(cwd / "store"),
                    "--output", str(cwd / "eval")]
            if with_report:
                argv += ["--optimization-report", str(tmp_path / "report.json")]
            _jax_main(tool, argv, monkeypatch) if name == "jax" else tool.main(argv)
            (records[name],) = (jeval.tracking if name == "jax" else teval.tracking).search_runs("device-eval")
            assert not (cwd / "mlruns").exists()
    finally:
        jeval.tracking.set_tracking_uri(None)
        teval.tracking.set_tracking_uri(None)
    port, jax = records["port"], records["jax"]
    n = 12 if with_report else 19
    assert port.run_name == "device_eval_test" and port.status == "FINISHED"
    assert port.params == jax.params and port.params["n_clips"] == str(n)
    assert port.params.get("class_filter") == (json.dumps(sorted(keep)) if with_report else None)
    assert port.metrics == jax.metrics
    assert port.metrics["device_val_accuracy"] == pytest.approx((n - 1 - (not with_report)) / n)
    arts = sorted(p.name for p in Path(port.artifact_uri).iterdir())
    assert arts == ["classification_report.txt", "confusion_matrix.png"]
    report = (Path(port.artifact_uri) / "classification_report.txt").read_text()
    assert report == (Path(jax.artifact_uri) / "classification_report.txt").read_text()
    assert ("?" in report.split()) == (not with_report)


def test_evaluate_device_without_aplay_exits_2(tmp_path, monkeypatch):
    def no_aplay(*a, **k):
        raise FileNotFoundError("aplay")

    monkeypatch.setattr(subprocess, "Popen", no_aplay)
    clip = tmp_path / "a.wav"
    clip.write_bytes(b"")
    for tool, sp in ((jeval, jsp), (teval, tsp)):
        with pytest.raises(SystemExit) as exc:
            tool.evaluate(_scripted_device(sp, ["a"]), [(clip, "a")], ["a"], playback=True, output_dir=tmp_path)
        assert exc.value.code == 2


def test_fsc22_label_lookup_marks_files_missing_from_the_csv(synth):
    audio = next((synth / "fsc22").glob("Audio Wise*/Audio Wise V1.0"))
    want = jeval._fsc22_label_map(synth / "fsc22")
    assert teval._fsc22_label_map(synth / "fsc22") == want and len(want) == 18
    with pytest.raises(SystemExit):
        teval._fsc22_label_map(audio)


# ---------------------------------------------------------------------------
# Fault q: the public names the port lacked, against the JAX names
# ---------------------------------------------------------------------------

LOADER_NAMES = ["BIRDeepImageLoader", "BIRDeepLoader", "ImageFolderLoader", "TabularLoader", "TextCSVLoader",
                "TextFolderLoader", "TextJSONLoader", "VideoFolderLoader"]


@pytest.mark.parametrize("name", LOADER_NAMES)
def test_data_package_re_exports_every_loader(name):
    import audio_edge_ml_pipeline_torch.data as tdata
    import audio_edge_ml_pipeline_tpu.data as jdata
    from audio_edge_ml_pipeline_torch.data import loaders

    assert getattr(tdata, name) is getattr(loaders, name)
    assert getattr(jdata, name).__name__ == name


def test_re_exported_text_csv_loader_reads_what_the_jax_one_reads(tmp_path):
    from audio_edge_ml_pipeline_torch.data import TextCSVLoader
    from audio_edge_ml_pipeline_tpu.data import TextCSVLoader as JTextCSVLoader

    tsynth.make_text_csv(tmp_path / "text.csv")
    port, jax = (list(cls(tmp_path / "text.csv", label_col="label")) for cls in (TextCSVLoader, JTextCSVLoader))
    assert len(port) == 60 and port == jax


@pytest.mark.parametrize("class_filter", [["Wind", "Fire"], ["Rain", "Nope"], None])
def test_apply_class_filter_gives_the_jax_rows_and_encoding(class_filter):
    from audio_edge_ml_pipeline_torch.train.train import apply_class_filter
    from audio_edge_ml_pipeline_tpu.train.train import apply_class_filter as japply

    rng = np.random.default_rng(5)
    names = ["Rain", "Fire", "Wind", "Axe"]   # not sorted: the filter re-encodes by name
    X = rng.standard_normal((40, 6)).astype(np.float32)
    y = rng.integers(0, 4, 40).astype(np.int32)
    Xp, yp, np_ = apply_class_filter(X, y, names, class_filter, "run")
    Xj, yj, nj = japply(X, y, names, class_filter, "run")
    assert np_ == nj and np.array_equal(Xp, Xj) and np.array_equal(yp, yj) and yp.dtype == yj.dtype
    if class_filter:
        assert np_ == sorted(set(class_filter) & set(names)) and len(Xp) < len(X)
    with pytest.raises(ValueError):
        apply_class_filter(X, y, names, ["Nope"], "run")


def test_setup_logging_is_re_exported_with_the_jax_format():
    import logging

    from audio_edge_ml_pipeline_torch.utils import logging as tlogging
    from audio_edge_ml_pipeline_torch.utils import setup_logging
    from audio_edge_ml_pipeline_tpu.utils import setup_logging as jsetup

    root = logging.getLogger()
    saved = root.handlers[:], root.level
    try:
        formats = []
        for fn in (jsetup, setup_logging):
            fn(logging.WARNING)
            formats.append((root.level, root.handlers[0].formatter._fmt))
        assert setup_logging is tlogging.setup_logging and formats[0] == formats[1]
    finally:
        root.handlers[:], _ = saved[0], root.setLevel(saved[1])


@pytest.mark.parametrize("window", ["hann", "ones"])
@pytest.mark.parametrize("n,n_fft,hop", [(16000, 512, 160), (6400, 401, 160), (4000, 2048, 512)])
def test_stft_complex_fft_matches_jax(window, n, n_fft, hop):
    """torch.fft.rfft on the caller's device (the CPU here) against XLA's rFFT:
    the same (B, n_freq, n_frames) complex64 layout, within 1e-5 of the
    largest magnitude; 6400 = 40 hops at an odd n_fft reaches past the
    padded clip, where XLA's gather clamps the index."""
    import jax.numpy as jnp

    from audio_edge_ml_pipeline_torch.ops import dsp as tdsp
    from audio_edge_ml_pipeline_tpu.ops import dsp as jdsp

    y = np.random.default_rng(n_fft).standard_normal((3, n)).astype(np.float32)
    want = np.asarray(jdsp.stft_complex_fft(jnp.asarray(y), n_fft, hop, window))
    got = tdsp.stft_complex_fft(torch.from_numpy(y), n_fft, hop, window)
    assert got.dtype == torch.complex64 and tuple(got.shape) == want.shape == (3, n_fft // 2 + 1, 1 + n // hop)
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()
