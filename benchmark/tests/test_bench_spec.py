"""BENCHMARK.json against the contract, every name against its file, and
the yardstick's arithmetic against hand counts."""

from __future__ import annotations

import json
import re

import numpy as np
import pytest

from benchmark import run
from benchmark.harness import files, judge, trace
from benchmark.tests import tiny

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
SPEC = files.spec()


def test_top_level_keys_and_limits():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "benchmark/run.py"] and SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51 and isinstance(SPEC["run_seconds"], int)
    assert len(json.dumps(SPEC)) < 64 * 1024
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert "setup_s" in {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in {e["name"] for e in SPEC["end_to_end"]}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


def test_names_and_units():
    names = [x["name"] for g in ("configs", "workloads", "end_to_end", "per_layer") for x in SPEC[g]]
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in SPEC["workloads"]] + [w["config"] for w in SPEC["workloads"]]:
        assert NAME.fullmatch(n), n
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.fullmatch(m["unit"]) and m["better"] in ("lower", "higher")
    for w in SPEC["workloads"] + SPEC["configs"]:
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"] and "\t" not in w["why"]


@pytest.mark.parametrize("cfg", SPEC["configs"], ids=lambda c: c["name"])
def test_config_resolves(cfg):
    data = files.load_json("configs", cfg["name"])
    assert cfg["file"] == f"benchmark/configs/{cfg['name']}.json"
    assert data["name"] == cfg["name"] and data["source"] == cfg["source"] and data["reduced"] == cfg["reduced"]
    assert any(w["config"] == cfg["name"] for w in SPEC["workloads"])


@pytest.mark.parametrize("cell", SPEC["workloads"], ids=lambda w: w["name"])
def test_cell_resolves(cell):
    spec, data, config, mix = run.load_cell(cell["name"])
    assert data["why"] == cell["why"] and data["chips"] in (1, 4)
    assert files.load_module("traffic", mix["generator"]).Traffic
    assert files.load_module("entries", mix["entry"]).build
    assert data["limits"] and all(v is not None for v in data["limits"].values())
    e2e = {m["name"] for m in files.cell_metrics(spec, cell["name"], "end_to_end")}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert files.cell_metrics(spec, cell["name"], "per_layer")


@pytest.mark.parametrize("metric", SPEC["end_to_end"] + SPEC["per_layer"], ids=lambda m: m["name"])
def test_metric_resolves(metric):
    assert callable(files.load_module("metrics", metric["name"]).read)
    listed = {w["name"] for w in SPEC["workloads"]}
    assert set(metric.get("workloads", listed)) <= listed


def test_new_cell_is_found_without_an_edit(tmp_path):
    """A cell added as a file and an entry runs with no existing file changed."""
    bench = tiny.make(tmp_path)
    before = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    cell = json.loads((bench / "workloads" / "mel-cnn.extract-b256.json").read_text())
    cell.update(name="mel-cnn.extract-b4x", traffic="extract-b4x")
    (bench / "workloads" / "mel-cnn.extract-b4x.json").write_text(json.dumps(cell))
    mix = json.loads((bench / "traffic" / "extract-b256.json").read_text())
    (bench / "traffic" / "extract-b4x.json").write_text(json.dumps({**mix, "batch": 3}))
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "mel-cnn.extract-b4x", "config": "fsc22-mel-cnn", "traffic": "extract-b4x",
                              "chips": 1, "why": cell["why"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    import torch

    result = run.run_cell(tiny.args("mel-cnn.extract-b4x"), torch.device("cpu"), 0.0, bench, tmp_path).result
    assert result["correct"] and set(result["metrics"]) == {"clips_per_s", "batch_ms_p95", "setup_s"}
    assert all(p.read_bytes() == b for p, b in before.items())


def test_mel_bound_by_hand():
    mel = files.load_module("metrics", "mel_roofline")
    # fsc22-mel-cnn: 32 clips x 501 frames; 512 + 2.5*512*9 + 3*257 + 2*490 FLOP a frame
    ms, what, flops = mel.mel_folded_bound(32, 80000, 512, 490, 160, 40)
    assert flops == 32 * 501 * 13783
    assert what == "bytes" and ms == pytest.approx(1e3 * 4 * (32 * 80000 + 32 * 501 * 40) / 3.35e12)
    cfg, mix = files.load_json("configs", "fsc22-mel-cnn"), files.load_json("traffic", "score-b32")
    assert mel.bound(cfg, mix) == (ms, what, flops)
    # fsc22-feat22: 216 frames of n_fft 1024, 128 mels over 1008 nonzeros, float64
    cfg22, mix22 = files.load_json("configs", "fsc22-feat22"), files.load_json("traffic", "mfcc-b256")
    ms22, what22, flops22 = mel.bound(cfg22, mix22)
    assert flops22 == 256 * 216 * (1024 + 25600 + 3 * 513 + 2 * 1008)
    assert what22 == "bytes" and ms22 == pytest.approx(1e3 * 4 * (256 * 110250 + 256 * 216 * 128) / 3.35e12)
    # a batch of 256 split over 4 cards: one launch a card, on 64 clips
    mix4 = files.load_json("traffic", "extract-4card-b256")
    assert mel.launch_rows(mix4) == 64 and mel.launch_rows(mix) == 32
    ms4, what4, flops4 = mel.bound(cfg, mix4, mel.launch_rows(mix4))
    assert flops4 == 64 * 501 * 13783
    assert what4 == "bytes" and ms4 == pytest.approx(1e3 * 4 * (64 * 80000 + 64 * 501 * 40) / 3.35e12)


def test_step_flops_by_hand():
    mfu = files.load_module("metrics", "step_mfu")
    cfg, mix = files.load_json("configs", "fsc22-mel-cnn"), files.load_json("traffic", "score-b32")
    # SAME convs on (501, 40): 126x10x16 from 1 channel, 63x5x64 from 16, 63x5x64 from 64 (then a 2x2 pool)
    cnn = 126 * 10 * 16 * 19 + 63 * 5 * 64 * 289 + 63 * 5 * 64 * 1153 + 128 * 129 + 27 * 257
    assert mfu.cnn_flops(cfg["model"], 501, 40) == cnn == 29_477_211
    assert mfu.step_flops(cfg, mix) == 32 * 501 * 13783 + 32 * (10 * 40 * 501 + cnn)


def test_trace_summary(tmp_path):
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "benchmark.batch", "ts": 0, "dur": 100},
        {"ph": "X", "cat": "user_annotation", "name": "benchmark.entry", "ts": 1, "dur": 20},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mul", "ts": 2, "dur": 5},
        {"ph": "X", "cat": "kernel", "name": "void mel_rfft_kernel<256, float, 8>(...)", "ts": 10, "dur": 30},
        {"ph": "X", "cat": "kernel", "name": "k2", "ts": 30, "dur": 20},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 70, "dur": 10},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaEventSynchronize", "ts": 55, "dur": 40},
        {"ph": "X", "cat": "kernel", "name": "outside", "ts": 150, "dur": 10},
    ]
    (tmp_path / "t.json").write_text(json.dumps({"traceEvents": ev}))
    s = trace.summarize(tmp_path / "t.json")
    assert s.window_s == pytest.approx(100e-6) and s.busy_s == pytest.approx(50e-6)
    assert s.kernels_matching(("mel_rfft_kernel",)) == (pytest.approx(30e-6), 1)
    assert s.spans == {"batch": [pytest.approx(100e-6)], "entry": [pytest.approx(20e-6)]}
    # gaps 50-70 and 80-100 (the host waits on the copy), 0-10 (the host issues)
    assert [g[0] for g in s.gaps] == ["host: cudaEventSynchronize"] * 2 + ["host: aten::mul"]
    assert [g[1] for g in s.gaps] == [pytest.approx(20e-6), pytest.approx(20e-6), pytest.approx(10e-6)]
    assert "outside" not in s.device_ops and len(s.breakdown()["device_ops"]) == 3


def test_trace_summary_per_card(tmp_path):
    """Two cards: each card's busy time and idle gaps on its own, busy_s
    their mean, device time by name summed over both; a third card with no
    events is idle the whole window."""
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "benchmark.batch", "ts": 0, "dur": 100},
        {"ph": "X", "cat": "user_annotation", "name": "benchmark.entry", "ts": 1, "dur": 89},
        {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 2, "dur": 10},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaMemcpyAsync", "ts": 40, "dur": 30},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaStreamSynchronize", "ts": 70, "dur": 25},
        {"ph": "X", "cat": "kernel", "name": "mel_rfft_kernel", "ts": 10, "dur": 30, "args": {"device": 0}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 60, "dur": 10, "args": {"device": 0}},
        {"ph": "X", "cat": "kernel", "name": "mel_rfft_kernel", "ts": 50, "dur": 30, "args": {"device": 1}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 85, "dur": 5, "args": {"device": 1}},
        {"ph": "X", "cat": "kernel", "name": "outside", "ts": 150, "dur": 10, "args": {"device": 0}},
    ]
    (tmp_path / "t.json").write_text(json.dumps({"traceEvents": ev}))
    s = trace.summarize(tmp_path / "t.json", cards=2)
    # card 0 busy 10-40 and 60-70 (40 µs), card 1 50-80 and 85-90 (35 µs)
    assert s.window_s == pytest.approx(100e-6) and s.busy_s == pytest.approx(37.5e-6)
    assert s.device_ops == {"mel_rfft_kernel": [pytest.approx(60e-6), 2], "Memcpy DtoH": [pytest.approx(15e-6), 2]}
    # gaps, longest first (ties in card order): card 1 0-50, card 0 70-100, 40-60, 0-10, card 1 90-100, 80-85
    assert s.gaps == [("card 1 · host: benchmark.entry", pytest.approx(50e-6)),
                      ("card 0 · host: cudaStreamSynchronize", pytest.approx(30e-6)),
                      ("card 0 · host: cudaMemcpyAsync", pytest.approx(20e-6)),
                      ("card 0 · host: aten::copy_", pytest.approx(10e-6)),
                      ("card 1 · host: benchmark.batch", pytest.approx(10e-6)),
                      ("card 1 · host: cudaStreamSynchronize", pytest.approx(5e-6))]
    three = trace.summarize(tmp_path / "t.json", cards=3)
    assert three.busy_s == pytest.approx(25e-6) and three.gaps[0] == ("card 2 · host: cudaMemcpyAsync",
                                                                      pytest.approx(100e-6))
    assert len(three.gaps) == 7 and three.device_ops == s.device_ops


def test_sampler_is_uniform_and_seeded():
    counts = np.zeros(40)
    for seed in range(400):
        s = judge.Sampler(4, seed)
        for i in range(10):
            s.take(i, np.arange(4 * i, 4 * i + 4)[:, None])
        assert len(s.rows) == 4
        for i, r, row in s.rows:
            assert row[0] == 4 * i + r
            counts[4 * i + r] += 1
    assert counts.min() > 0.6 * 40 and counts.max() < 1.4 * 40
    a, b, c = judge.Sampler(4, 7), judge.Sampler(4, 7), judge.Sampler(4, 8)
    for s in (a, b, c):
        for i in range(10):
            s.take(i, np.zeros((4, 1)))
    assert [x[:2] for x in a.rows] == [x[:2] for x in b.rows] != [x[:2] for x in c.rows]


@pytest.mark.parametrize("name", ["audio_mel_spec", "audio_mfcc_seq", "audio_classical"])
def test_reference_computes_in_its_dtype(name):
    """The float32 control computes every step in float32 (numpy would
    widen the result if any step ran in float64), and the float64 reference
    in float64."""
    from benchmark.entries import extractor

    sr = 16000 if name == "audio_mel_spec" else 22050
    p = {"sample_rate": sr, "n_mels": 40 if sr == 16000 else 128, "n_mfcc": 40, "n_fft": 512 if sr == 16000 else 1024,
         "hop_length": 160 if sr == 16000 else 512}
    clip = (0.3 * np.random.default_rng(5).standard_normal(sr)).astype(np.float32)
    f64 = extractor.golden(name, p, clip)
    f32 = extractor.golden(name, p, clip, np.float32)
    assert f64.dtype == np.float64 and f32.dtype == np.float32
    assert 1e-8 < judge.max_rel(f32, f64) < 1e-3
    if name == "audio_classical":
        rounded = extractor.golden(name, p, clip, mag_dtype=np.float32)
        assert rounded.dtype == np.float64 and 0 < judge.max_rel(rounded, f64) < 1e-6
