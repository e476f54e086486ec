"""The per-layer metrics that read the program's spans (``harness/spans.py``):
each run reads only its own traced batches, the per-batch self-time
arithmetic on a store made by hand, and None where there is nothing to
read."""

from __future__ import annotations

import time
from types import SimpleNamespace

import pytest
import torch

from benchmark import run
from benchmark.harness import files, spans
from benchmark.tests import tiny

SPAN_METRICS = ("epilogue_ms", "cnn_ms", "cnn_issue_ms", "stft_ms", "spectral_ms", "mfcc_ms", "device_mallocs")


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return tiny.make(tmp_path_factory.mktemp("tiny"))


def _record(name, id, parent, root, host, device, mallocs=None):
    """A resolved span: ``host`` and ``device`` are (start, end) ms."""
    from audio_edge_ml_pipeline_torch.utils.profiling import SpanRecord

    return SpanRecord(name, id, parent, root, int(host[0] * 1e6), int(host[1] * 1e6), device[0], device[1],
                      0.0, None, mallocs, None)


def _ctx(trace_batches=2, traced=True):
    return SimpleNamespace(trace=object() if traced else None, trace_batches=trace_batches)


def _resolved(raw):
    """Self times as ``take_spans`` gives them: interval less the children's."""
    out = []
    for r in raw:
        kids = [k for k in raw if k.parent == r.id]
        host_self = r.host_ms - sum(k.host_ms for k in kids)
        device_self = r.device_ms - sum(k.device_ms for k in kids)
        out.append(r.__class__(**{**r.__dict__, "host_self_ms": host_self, "device_self_ms": device_self}))
    return out


def _store():
    """Three batches of score{mel, epilogue, cnn, epilogue}: an old one (an
    earlier run's) and the two newest."""
    raw = []
    for b, t in enumerate((0.0, 100.0, 200.0)):
        root = 10 * (b + 1)
        raw += [_record("score", root, None, root, (t, t + 10), (0.0, 10.0), mallocs=b),
                _record("mel", root + 1, root, root, (t + 1, t + 2), (0.5, 1.0)),
                _record("epilogue", root + 2, root, root, (t + 2, t + 3), (1.0, 2.0 + b)),
                _record("cnn", root + 3, root, root, (t + 3, t + 9), (3.0, 7.5)),
                _record("epilogue", root + 4, root, root, (t + 9, t + 9.5), (7.5, 7.75))]
    return _resolved(raw)


def test_the_helper_keeps_the_newest_batches(monkeypatch):
    monkeypatch.setattr(spans, "_take", _store)
    ctx = _ctx()
    own = spans.records(ctx)
    assert {r.root for r in own} == {20, 30} and [r.id for r in spans.roots(ctx)] == [20, 30]
    assert spans.records(ctx) is own   # drained once, kept on the run's context
    # epilogue runs twice a batch: (1 + b) + 0.25 ms of device self time, summed
    assert spans.batch_self_ms(ctx, "epilogue") == pytest.approx([2.25, 3.25])
    assert spans.median_self_ms(ctx, "epilogue") == pytest.approx(2.75)
    assert spans.batch_self_ms(ctx, "epilogue", clock="host") == pytest.approx([1.5, 1.5])
    # score's self time: 10 ms less its children's 0.5 + (1 + b) + 4.5 + 0.25
    assert spans.batch_self_ms(ctx, "score") == pytest.approx([10 - 7.25, 10 - 8.25])
    assert spans.median_self_ms(ctx, "stft") is None
    read = {m: files.load_module("metrics", m).read(ctx) for m in SPAN_METRICS}
    assert read == {"epilogue_ms": pytest.approx(2.75), "cnn_ms": pytest.approx(4.5), "cnn_issue_ms": pytest.approx(6.0),
                    "stft_ms": None, "spectral_ms": None, "mfcc_ms": None, "device_mallocs": pytest.approx(1500.0)}


def test_metrics_read_none_without_their_spans(monkeypatch):
    monkeypatch.setattr(spans, "_take", list)
    for ctx in (_ctx(), _ctx(traced=False), _ctx(trace_batches=0)):
        assert {m: files.load_module("metrics", m).read(ctx) for m in SPAN_METRICS} == dict.fromkeys(SPAN_METRICS)
    # a program without spans (a checkout from before them): its import fails, the metrics read None
    monkeypatch.undo()
    import audio_edge_ml_pipeline_torch.utils.profiling as profiling

    monkeypatch.delattr(profiling, "take_spans")
    assert spans._take() == []
    assert files.load_module("metrics", "device_mallocs").read(_ctx()) is None


def test_two_traced_runs_in_one_process_read_their_own_spans(bench, monkeypatch):
    """A stale batch left in the store and two traced runs: each run reads
    its own trace_batches roots, none of the other's, none of the stale."""
    from torch.profiler import ProfilerActivity, profile

    from audio_edge_ml_pipeline_torch.utils import profiling

    seen = []
    records = spans.records

    def kept(ctx):
        out = records(ctx)
        if not seen or seen[-1][0] is not ctx:
            seen.append((ctx, out))
        return out

    monkeypatch.setattr(spans, "records", kept)
    profiling.clear_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("score"):
            with profiling.span("epilogue"):
                time.sleep(0.2)
    cell = "mel-cnn.score-b32"
    lines = [run.run_cell(tiny.args(cell, seed, trace=1), torch.device("cpu"), 0.0, bench, bench.parent).result
             for seed in (5, 3_000_000_019)]
    assert len(seen) == 2
    ids = []
    for (ctx, own), line in zip(seen, lines):
        roots = [r for r in own if r.parent is None]
        assert len(roots) == ctx.trace_batches == 2 and {r.name for r in roots} == {"score"}
        assert {r.name for r in own} == {"score", "mel", "epilogue", "cnn"}
        assert line["metrics"]["epilogue_ms"]["value"] < 200
        assert line["metrics"]["device_mallocs"]["value"] == 0
        ids.append({r.id for r in own})
    assert not ids[0] & ids[1] and min(ids[1]) > max(ids[0])
    assert profiling.take_spans() == []
