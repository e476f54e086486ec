"""The program's spans (``utils/profiling.py::span``): off, a span is one
check that enters no ``record_function`` and stores nothing; on, under a
``torch.profiler``, each hot path stores its tree of layers, the trace
holds an ``aep.<name>`` range around each layer's operations, and
``take_spans`` drains the bounded store with each span's self time.

The ``cuda``-marked tests need a card and skip without one; this file
imports neither jax nor the JAX package, so they also run as

    python -m pytest --noconftest -m cuda tests/test_torch_spans.py
"""

import json
import time
import tracemalloc

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from audio_edge_ml_pipeline_torch.entry import flagship
from audio_edge_ml_pipeline_torch.features import get
from audio_edge_ml_pipeline_torch.models.deep import CNNTrainer
from audio_edge_ml_pipeline_torch.utils import profiling

CPU = [ProfilerActivity.CPU]


@pytest.fixture(autouse=True)
def _empty_store():
    profiling.clear_spans()
    yield
    profiling.clear_spans()


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA events and the caching allocator's counts")
    return torch.device("cuda")


def _trees(records) -> list[tuple]:
    """Each root span as (name, [children as (name, [...]), in order])."""
    kids: dict = {}
    for r in records:
        kids.setdefault(r.parent, []).append(r)

    def node(r):
        return r.name, [node(k) for k in kids.get(r.id, [])]

    return [node(r) for r in kids.get(None, [])]


def _waves(batch: int, n: int, seed: int = 0) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.from_numpy((0.3 * rng.standard_normal((batch, n))).astype(np.float32))


def test_off_a_span_enters_nothing_and_stores_nothing(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered with no profiler recording")

    monkeypatch.setattr(profiling, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    assert profiling.span("a") is profiling.span("b")
    module, forward = flagship(n_classes=5, filters=(4, 8, 8))
    with torch.inference_mode():
        forward(dict(module.state_dict()), _waves(2, 16000))
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        for _ in range(2000):
            with profiling.span("x"):
                with profiling.span("y"):
                    pass
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    grown = [d for d in after.compare_to(before, "filename")
             if d.traceback[0].filename == profiling.__file__ and d.size_diff > 0]
    assert grown == []
    assert profiling.take_spans() == [] and profiling.STORE.dropped == 0


def test_on_nested_spans_keep_parents_roots_and_self_times():
    with profile(activities=CPU):
        for _ in range(2):
            with profiling.span("outer"):
                time.sleep(0.002)
                with profiling.span("inner"):
                    time.sleep(0.003)
                with profiling.span("inner"):
                    time.sleep(0.001)
    records = profiling.take_spans()
    assert [r.name for r in records] == ["outer", "inner", "inner"] * 2
    roots = [r for r in records if r.parent is None]
    assert len(roots) == 2 and roots[0].root != roots[1].root
    for root in roots:
        kids = [r for r in records if r.parent == root.id]
        assert len(kids) == 2 and all(k.root == root.root == root.id for k in kids)
        assert root.host_self_ms == pytest.approx(root.host_ms - sum(k.host_ms for k in kids))
        assert root.host_self_ms >= 1.9 and all(k.host_self_ms == pytest.approx(k.host_ms) for k in kids)
        # on a CPU the device clock is the host's, from the root's start
        assert root.device_start_ms == 0 and root.device_ms == pytest.approx(root.host_ms)
        assert root.device_self_ms == pytest.approx(root.device_ms - sum(k.device_ms for k in kids))
        assert all(root.device_start_ms <= k.device_start_ms <= k.device_end_ms <= root.device_end_ms for k in kids)
        assert root.mallocs == 0 and all(k.mallocs is None for k in kids) and root.events is None


def test_the_chrome_trace_holds_aep_ranges_around_the_layers_ops(tmp_path):
    extractor = get("audio_mel_spec")(device="cpu")
    with profile(activities=CPU) as prof:
        extractor.batch_feature(_waves(2, 16000), None)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"] if e.get("ph") == "X"]

    def inside(e, outer):
        return outer["ts"] <= e["ts"] and e["ts"] + e["dur"] <= outer["ts"] + outer["dur"]

    (root,) = [e for e in events if e["name"] == "aep.audio_mel_spec"]
    for layer in ("aep.mel", "aep.epilogue"):
        (r,) = [e for e in events if e["name"] == layer]
        ops = [e for e in events if e.get("cat") == "cpu_op" and e["name"].startswith("aten::") and inside(e, r)]
        assert inside(r, root) and ops, layer
    assert any(e["name"] == "aten::matmul" and inside(e, next(x for x in events if x["name"] == "aep.mel"))
               for e in events)


@pytest.mark.parametrize("path,want", [
    ("score", ("score", [("mel", []), ("epilogue", []), ("cnn", [])])),
    ("audio_mel_spec", ("audio_mel_spec", [("mel", []), ("epilogue", [])])),
    ("audio_mel_spec_odd", ("audio_mel_spec", [("mel", []), ("epilogue", [])])),
    ("audio_mfcc_seq", ("audio_mfcc_seq", [("mfcc", [("mel", [])])])),
    ("audio_mfcc_seq_odd", ("audio_mfcc_seq", [("mfcc", [("mel", [])])])),
    ("audio_classical", ("audio_classical", [("stft", []), ("mfcc", [("mel", [])]), ("spectral", [])])),
])
def test_each_hot_path_stores_its_tree(path, want):
    if path == "score":
        module, forward = flagship(n_classes=5, filters=(4, 8, 8))
        call = lambda w: forward(dict(module.state_dict()), w)  # noqa: E731
        n = 16000
    else:
        name, odd = path.removesuffix("_odd"), path.endswith("_odd")
        kwargs = {"n_fft": 511 if name == "audio_mel_spec" else 1023} if odd else {}
        extractor = get(name)(device="cpu", **kwargs)
        call = lambda w: extractor.batch_feature(w, None)  # noqa: E731
        n = 16000 if name == "audio_mel_spec" else 22050
    with torch.inference_mode(), profile(activities=CPU):
        for seed in range(2):
            call(_waves(2, n, seed))
    records = profiling.take_spans()
    assert _trees(records) == [want, want]
    roots = [r for r in records if r.parent is None]
    assert [r.mallocs for r in roots] == [0, 0]   # no card, no device allocation
    for root in roots:
        under = [r for r in records if r.root == root.id]
        # self times on either clock sum to the root's interval
        assert sum(r.device_self_ms for r in under) == pytest.approx(root.device_ms)
        assert sum(r.host_self_ms for r in under) == pytest.approx(root.host_ms)


def test_take_drains_and_the_cap_keeps_the_newest(monkeypatch):
    store = profiling.SpanStore(cap=4)
    monkeypatch.setattr(profiling, "STORE", store)
    with profile(activities=CPU):
        for i in range(6):
            with profiling.span(f"s{i}"):
                pass
    assert store.dropped == 2
    assert [r.name for r in profiling.take_spans()] == ["s2", "s3", "s4", "s5"]
    assert profiling.take_spans() == [] and store.dropped == 2
    profiling.clear_spans()
    assert store.dropped == 0


def test_a_traced_stage_keeps_train_step_and_reports_its_spans(monkeypatch, tmp_path):
    """An AEP_PROFILE_DIR stage clears the store when it starts; its trace
    holds the ``aep.train_step`` range (``chip_smoke.py`` phase 4g reads it
    by that name) around the ``aep.cnn`` forward, and ``timing_report``
    gains each span's calls and median self ms."""
    trainer = CNNTrainer(filters=[4, 8], dropout=0.0, batch_size=4, device="cpu")
    X = trainer._prepare_input(np.random.default_rng(0).standard_normal((8, 40, 50)).astype(np.float32))
    trainer.prepare_fit(X, 3)
    trainer._net.train()
    opt = torch.optim.SGD(trainer._net.parameters(), lr=0.1)
    y = torch.from_numpy(np.arange(8) % 3)
    with profile(activities=CPU):
        with profiling.span("stale"):
            pass
    profiling.reset()
    monkeypatch.setenv("AEP_PROFILE_DIR", str(tmp_path))
    with profiling.stage_timer("fit:cnn"):
        for s in range(2):
            trainer.train_step(opt, torch.from_numpy(X), y, torch.arange(4 * s, 4 * s + 4), torch.ones(4))
    (path,) = (tmp_path / "fit:cnn").glob("*.pt.trace.json")
    events = [e for e in json.loads(path.read_text())["traceEvents"] if e.get("ph") == "X"]
    steps = [e for e in events if e.get("cat") == "user_annotation" and e["name"] == "aep.train_step"]
    cnns = [e for e in events if e.get("cat") == "user_annotation" and e["name"] == "aep.cnn"]
    assert len(steps) == len(cnns) == 2
    assert all(s["ts"] <= c["ts"] and c["ts"] + c["dur"] <= s["ts"] + s["dur"] for s, c in zip(steps, cnns))
    report = profiling.timing_report()
    assert set(report) == {"fit:cnn", "aep.train_step", "aep.cnn"}
    assert report["aep.train_step"]["calls"] == report["aep.cnn"]["calls"] == 2
    assert report["aep.cnn"]["device_self_ms"] == report["aep.cnn"]["host_self_ms"] > 0   # one clock on a CPU
    assert profiling.take_spans() == []   # the stage folded what it recorded
    profiling.reset()
    assert "aep.cnn" not in profiling.timing_report()


@pytest.mark.cuda
def test_a_span_in_a_graph_capture_records_no_event(cuda_device):
    x = torch.ones(1 << 16, device=cuda_device)
    y = x * 2
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with profile(activities=CPU):
        with torch.cuda.graph(graph):
            with profiling.span("captured"):
                y.copy_(x * 3)
        graph.replay()
        with profiling.span("eager"):
            y.add_(1)
    records = {r.name: r for r in profiling.take_spans()}
    assert records["captured"].events is None and records["captured"].device_ms is None
    assert records["captured"].device_self_ms is None and records["captured"].host_ms > 0
    assert records["eager"].events is not None and records["eager"].device_ms >= 0
    assert float(y[0]) == 4.0


@pytest.mark.cuda
def test_a_new_allocator_segment_counts_one_device_allocation(cuda_device):
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    with profile(activities=CPU):
        with profiling.span("fresh"):
            block = torch.empty(1 << 28, dtype=torch.uint8, device=cuda_device)   # 256 MiB: no cached segment
            with profiling.span("child"):
                pass
        del block
        with profiling.span("cached"):
            block = torch.empty(1 << 28, dtype=torch.uint8, device=cuda_device)   # the segment just freed
    records = {r.name: r for r in profiling.take_spans()}
    assert records["fresh"].mallocs == 1 and records["cached"].mallocs == 0 and records["child"].mallocs is None
    assert records["fresh"].device_ms >= records["child"].device_ms >= 0
    del block
