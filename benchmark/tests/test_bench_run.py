"""Whole runs of each cell at a tiny size on the CPU (the harness's look for
a card skipped): the result line, the controls, the faults that
``correct`` must catch, and what the run imports."""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import calibrate, run
from benchmark.harness import files
from benchmark.tests import tiny

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return tiny.make(tmp_path_factory.mktemp("tiny"))


def _run(bench: Path, cell: str, trace: int = 0, seed: int = 2_900_000_017) -> dict:
    done = run.run_cell(tiny.args(cell, seed, trace), CPU, 0.0, bench, bench.parent)
    result = done.result
    assert done.lines == [f"check {k}: {c['value']!r} limit {c['limit']!r}" for k, c in result["checks"].items()]
    return result


def _plant(monkeypatch, bench: Path, cell: str, fault) -> None:
    """Break the cell's timed call underneath the harness: ``fault(call,
    waves)`` runs in place of the entry's ``__call__``."""
    mix = files.load_json("traffic", files.load_json("workloads", cell, bench)["traffic"], bench)
    entry = files.load_module("entries", mix["entry"], bench).Entry
    call = entry.__call__
    monkeypatch.setattr(entry, "__call__", lambda self, waves: fault(lambda w: call(self, w), waves))


@pytest.mark.parametrize("cell", tiny.CELLS)
def test_untraced_line(bench, cell):
    r = _run(bench, cell)
    assert list(r) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    assert set(r["metrics"]) == {"clips_per_s", "batch_ms_p95", "setup_s"}
    assert all(set(m) == {"value", "unit"} and m["value"] > 0 for m in r["metrics"].values())
    assert set(r["device"]) == {"platform", "kind", "count", "memory_peak_bytes", "build_s"}
    chips = files.load_json("workloads", cell, bench)["chips"]
    assert r["device"]["count"] == chips and r["device"]["build_s"] == 0.0
    json.dumps(r)


@pytest.mark.parametrize("cell", tiny.CELLS)
def test_traced_line(bench, cell):
    r = _run(bench, cell, trace=1)
    assert list(r) == ["correct", "attempted", "failed", "metrics", "device", "breakdown", "checks"] and r["correct"]
    listed = {m["name"] for m in files.cell_metrics(files.spec(bench.parent), cell, "per_layer")}
    # no mel kernel runs on the CPU, so mel_roofline has nothing to read there
    assert set(r["metrics"]) == listed - {"mel_roofline"} and "issue_ms" in r["metrics"]
    assert r["device"]["window_s"] > 0 and set(r["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("cell", tiny.CELLS)
def test_control_fails_and_program_passes(bench, cell):
    """The reference one precision below the configuration's fails a limit
    that the program meets, on three seeds."""
    limits = files.load_json("workloads", cell)["limits"]
    for seed in (11, 3_000_000_021, 2**31 + 5):
        program, control = calibrate.readings(cell, seed, 0.2, True, CPU, bench, bench.parent)
        (key,) = limits
        assert program[key] <= limits[key] < control[key], (seed, program[key], control[key])


# The faults take and give what the entry does: a card's tensor, or host
# NumPy where the entry feeds the program from the host (split_extractor).
def _fresh(out):
    return out.copy() if isinstance(out, np.ndarray) else out.clone(memory_format=torch.contiguous_format)


def _half_left_out(call, waves):
    out = call(waves[: len(waves) // 2])
    return (np.concatenate if isinstance(out, np.ndarray) else torch.cat)([out, out])[: len(waves)]


def _answer_altered(call, waves):
    out = _fresh(call(waves))
    out.reshape(out.shape[0], -1)[:, 0] += 1e-2 * abs(out).max()
    return out


def _not_finite(call, waves):
    out = _fresh(call(waves))
    out.reshape(-1)[-1] = float("nan")
    return out


def _parts_rotated(call, waves):
    """A quarter of the rows moved round: over four cards, each card's part
    gathered into the next card's place."""
    out = call(waves)
    shift = len(waves) // 4
    return np.roll(out, shift, axis=0) if isinstance(out, np.ndarray) else torch.roll(out, shift, dims=0)


@pytest.mark.parametrize("fault", [_half_left_out, _answer_altered, _not_finite, _parts_rotated],
                         ids=lambda f: f.__name__)
@pytest.mark.parametrize("cell", tiny.CELLS)
def test_fault_is_caught(bench, cell, fault, monkeypatch):
    _plant(monkeypatch, bench, cell, fault)
    assert not _run(bench, cell)["correct"]


def test_rolloff_moved_two_frames_is_caught(bench, monkeypatch):
    """Two frames' rolloff one bin higher each, in every clip (the mean up
    by two bins over the frame count) fails the classical cell."""
    cell = "feat22.classical-b256"
    config = files.load_json("configs", files.load_json("workloads", cell, bench)["config"], bench)
    p = config["features"]["audio_classical"]
    frames = 1 + int(round(tiny.MIX["clip_seconds"] * p["sample_rate"])) // p["hop_length"]
    mean = 2 * (3 * p["n_mfcc"] + 1)    # after mfcc, its two deltas and the centroid, each as mean then std

    def moved(call, waves):
        out = call(waves).clone()
        out[:, mean] += 2 * p["sample_rate"] / p["n_fft"] / frames
        return out

    assert _run(bench, cell)["correct"]
    _plant(monkeypatch, bench, cell, moved)
    r = _run(bench, cell)
    assert not r["correct"] and r["checks"]["classical_gap"]["value"] > r["checks"]["classical_gap"]["limit"]


def test_host_pool_holds_the_device_pools_clips(bench):
    """host_chunks feeds the clips closed_batches keeps on the device, from
    the same seed, as pageable float32 host rows, in the same batches."""
    from benchmark.traffic import closed_batches, host_chunks

    config = files.load_json("configs", "fsc22-mel-cnn", bench)
    mix = files.load_json("traffic", "extract-4card-b256", bench)
    host = host_chunks.Traffic(mix, config, 3_000_000_023, CPU)
    device = closed_batches.Traffic(mix, config, 3_000_000_023, CPU)
    assert isinstance(host.pool, np.ndarray) and host.pool.dtype == np.float32
    assert np.array_equal(host.pool, device.pool.numpy())
    for i in range(4):
        assert np.array_equal(host.waves(i), device.waves(i).numpy())
    picks = [(0, 1), (3, 2), (7, 0)]
    assert np.array_equal(host.clips(picks), device.clips(picks))


def test_refuses_without_a_card_or_the_program(tmp_path):
    """No card (here), or a directory with the benchmark and nothing else:
    a code other than 0 and no result line."""
    bare = tiny.make(tmp_path).parent
    for cwd in (files.ROOT, bare):
        p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "mel-cnn.score-b32", "--seed", "1",
                            "--seconds", "1", "--trace", "0"], cwd=cwd, capture_output=True, text=True, timeout=300,
                           env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
        assert p.returncode != 0 and p.stdout.strip() == ""


def test_a_run_imports_no_jax(bench):
    """A whole run and its reference load neither JAX nor the JAX package
    (top-level names compared whole: the port's name starts with the JAX
    package's)."""
    code = (f"import sys; sys.path.insert(0, {str(files.ROOT)!r}); import torch; from benchmark import run; "
            f"from benchmark.tests import tiny; from pathlib import Path; b = Path({str(bench)!r}); "
            "run.run_cell(tiny.args('mel-cnn.score-b32'), torch.device('cpu'), 0.0, b, b.parent); "
            "run.run_cell(tiny.args('feat22.classical-b256', trace=1), torch.device('cpu'), 0.0, b, b.parent); "
            "run.run_cell(tiny.args('mel-cnn.extract-4card'), torch.device('cpu'), 0.0, b, b.parent); "
            "print(run.forbidden_modules(), 'audio_edge_ml_pipeline_torch' in sys.modules)")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300,
                       env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == "[] True"
