"""Stage 7b — ahead-of-time capture + latency benchmark CLI.

Counterpart of the JAX package's ``compilation/compile_xla.py``, with its
module name, CLI flags and ``xla_report.json`` keys, so that scripts that read
the report read this one. The JAX stage lowers and compiles the jitted
forward with XLA; here the forward is the loaded bundle's normalised forward
(``_prepare_input``, then ``(x - mean) / sqrt(var + 1e-6)``, then the module),
and "ahead of time" on a CUDA card is a CUDA graph of it captured at the
static batch ``B = min(--batch, rows)``, replayed for every call. On the CPU
there is nothing to capture and the forward runs eagerly.

``--tune-flags`` is the counterpart of JAX's XLA flag search: it times the
candidates (eager, the CUDA graph, ``torch.compile`` in its ``default`` and
``reduce-overhead`` modes), records each with its compile seconds and its
largest logit difference from the eager forward, keeps the fastest, and a
candidate that fails is recorded with its error. ``memory_analysis`` holds the
argument, output and temporary bytes from the CUDA allocator's peak around
one eager call (empty on the CPU). ``--tflite`` times an existing ``.tflite``
file through TensorFlow's interpreter on the first ``B`` rows
(``to_tflite.evaluate_tflite``; TensorFlow must be installed) and fills
``tflite_latency_ms_per_sample`` and ``speedup_vs_tflite``; a path that
does not exist is skipped, as in JAX. The whole timed section runs under
the bundle's card (``--device``), whichever card is current.

CLI:
    python -m audio_edge_ml_pipeline_torch.compilation.compile_xla \
        --model model.flax.npz --features <featureset dir> \
        [--output xla_report.json] [--batch 32] [--tune-flags] [--tflite model.tflite] \
        [--device cpu]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import logging
import time
from datetime import datetime
from pathlib import Path
from typing import Callable

import numpy as np
import torch

from ..features.pipeline import FeaturePipeline
from ..models.deep import load_any_model
from ..utils.device import resolve_device
from ..utils.logging import setup_logging

logger = logging.getLogger(__name__)

Forward = Callable[[], torch.Tensor]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _bench(fn: Forward, device: torch.device, iters: int = 20) -> float:
    """Seconds a call: the best of 3 rounds of ``iters`` calls, after one warm call."""
    fn()
    _sync(device)
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        _sync(device)
        best = min(best, (time.perf_counter() - t0) / iters)
    return best


def load_forward(model: Path | str, features: Path | str, batch: int, device: torch.device):
    """(the loaded trainer, its normalised forward, the first
    ``min(batch, rows)`` prepared rows on ``device``)."""
    trainer = load_any_model(Path(model), device=device)
    X = trainer._prepare_input(FeaturePipeline.load(features).features.astype(np.float32))
    xb = torch.from_numpy(np.ascontiguousarray(X[: min(batch, len(X))])).to(device)
    net = trainer._net.eval()

    def forward(x: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            return net(trainer._normalize(x))

    return trainer, forward, xb


def capture_graph(forward: Callable[[torch.Tensor], torch.Tensor], xb: torch.Tensor) -> Forward:
    """The forward on ``xb`` captured as one CUDA graph: warmed up on a side
    stream, then recorded with static input and output buffers. The returned
    call replays it and returns the static output. It holds both buffers:
    the graph reads and writes their addresses but keeps no reference, so a
    freed input would be reused by the next allocation.

    The warm-up, the capture and every replay run under ``xb``'s card, on
    that card's streams, whichever card is current: ``torch.cuda.graph``'s
    own default capture stream is made once, on the card that was current
    at its first capture, and a capture there records nothing of another
    card's work.

    cuBLAS keeps a workspace a stream, and every capture runs on the same
    capture stream, so a graph would otherwise take the workspace that an
    earlier capture allocated in that capture's memory pool. The cached
    workspaces are cleared before and after the capture, as inductor's CUDA
    graph trees do: the capture allocates its own in its own pool, and a later
    clear (``torch.compile``'s reduce-overhead mode clears them whenever it
    records) cannot free memory that this graph's kernels use."""
    device = xb.device
    with torch.cuda.device(device):
        static_x = xb.clone()
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            for _ in range(3):
                forward(static_x)
        torch.cuda.current_stream(device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        torch._C._cuda_clearCublasWorkspaces()
        with torch.cuda.graph(graph, stream=side):
            static_y = forward(static_x)
        torch._C._cuda_clearCublasWorkspaces()
    buffers = (static_x, static_y)

    def replay() -> torch.Tensor:
        with torch.cuda.device(device):
            graph.replay()
        return buffers[1]

    return replay


def _candidates(forward, xb) -> list[tuple[dict, Callable[[], Forward]]]:
    """(flags, builder) for each candidate of the search, eager first."""
    out = [({"backend": "eager"}, lambda: (lambda: forward(xb)))]
    if xb.device.type == "cuda":
        out.append(({"backend": "cuda_graph"}, lambda: capture_graph(forward, xb)))
    for mode in ("default", "reduce-overhead"):
        def build(mode=mode) -> Forward:
            compiled = torch.compile(forward, mode=mode)
            return lambda: compiled(xb)
        out.append(({"backend": "torch.compile", "mode": mode}, build))
    return out


def flag_search(forward, xb: torch.Tensor, batch: int) -> tuple[Forward, dict]:
    """Build and time each candidate; return (the fastest, the search
    record). A candidate that fails to build or run is recorded, not fatal."""
    device = xb.device
    eager = forward(xb).clone()
    results = []
    best = None
    for flags, build in _candidates(forward, xb):
        try:
            t0 = time.perf_counter()
            fn = build()
            logits = fn().clone()
            _sync(device)
            compile_s = time.perf_counter() - t0
            latency_ms = _bench(fn, device) * 1000.0 / batch
            results.append({"flags": flags, "latency_ms_per_sample": latency_ms, "compile_seconds": round(compile_s, 3),
                            "max_abs_diff_vs_eager": float((logits - eager).abs().max())})
            if best is None or latency_ms < best[1]:
                best = (fn, latency_ms, flags)
        except Exception as exc:  # a candidate this machine cannot build (no Triton, no card) is recorded
            results.append({"flags": flags, "error": str(exc).splitlines()[0][:160] if str(exc) else type(exc).__name__})
    if best is None:
        raise RuntimeError("no candidate of the search ran")
    record = {"platform": device.type, "candidates": results, "best_flags": best[2],
              "best_latency_ms_per_sample": best[1]}
    logger.info("flag search: best %s -> %.4f ms/sample", best[2], best[1])
    return best[0], record


def memory_analysis(trainer, forward, xb: torch.Tensor) -> dict:
    """Argument (weights, normalisation, input), output and temporary bytes
    of one eager call, from the CUDA allocator's peak around it; {} off a
    card."""
    if xb.device.type != "cuda":
        return {}
    args = [*trainer._net.parameters(), *trainer._net.buffers(), trainer._norm_mean, trainer._norm_var, xb]
    _sync(xb.device)
    torch.cuda.reset_peak_memory_stats(xb.device)
    base = torch.cuda.memory_allocated(xb.device)
    out = forward(xb)
    _sync(xb.device)
    peak = torch.cuda.max_memory_allocated(xb.device)
    out_bytes = out.numel() * out.element_size()
    return {"argument_size_bytes": int(sum(t.numel() * t.element_size() for t in args)),
            "output_size_bytes": int(out_bytes), "temp_size_bytes": int(max(peak - base - out_bytes, 0))}


def main(argv=None) -> None:
    setup_logging()
    p = argparse.ArgumentParser(
        prog="python -m audio_edge_ml_pipeline_torch.compilation.compile_xla",
        description="Stage 7b — ahead-of-time capture + latency benchmark",
    )
    p.add_argument("--model", required=True)
    p.add_argument("--features", required=True)
    p.add_argument("--output", default=None)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--tflite", default=None, help="optional TFLite baseline to compare against")
    p.add_argument("--tune-flags", action="store_true",
                   help="time eager, the CUDA graph and torch.compile's modes and keep the fastest")
    p.add_argument("--device", default=None,
                   help="torch device (default: the first CUDA card; 'cpu' runs the forward eagerly)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    # the whole timed section on the bundle's card: its streams, its graph, its allocator
    with torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext():
        trainer, forward, xb = load_forward(args.model, args.features, args.batch, device)
        B = len(xb)
        search_record = None
        t0 = time.perf_counter()
        if args.tune_flags:
            compiled, search_record = flag_search(forward, xb, B)
        elif device.type == "cuda":
            compiled = capture_graph(forward, xb)
        else:
            compiled = lambda: forward(xb)  # noqa: E731
        compiled()
        _sync(device)
        compile_s = time.perf_counter() - t0
        mem = memory_analysis(trainer, forward, xb)

        per_sample_ms = _bench(compiled, device) * 1000.0 / B
    logger.info("compiled: compile=%.2fs  latency=%.4f ms/sample (batch %d)", compile_s, per_sample_ms, B)

    baseline_ms = None
    if args.tflite and Path(args.tflite).exists():
        from .to_tflite import evaluate_tflite

        fs = FeaturePipeline.load(args.features)
        X = trainer._prepare_input(fs.features.astype(np.float32))
        y = fs.labels[:B] if fs.labels is not None else np.zeros(B, np.int32)
        baseline = evaluate_tflite(Path(args.tflite), X[:B], y)
        baseline_ms = baseline["latency_ms"]
        logger.info("TFLite baseline: %.4f ms/sample", baseline_ms)

    report = {
        "model": str(args.model),
        "backend": device.type,
        "batch": B,
        "compile_seconds": compile_s,
        "xla_latency_ms_per_sample": per_sample_ms,
        "tflite_latency_ms_per_sample": baseline_ms,
        "speedup_vs_tflite": (baseline_ms / per_sample_ms) if baseline_ms else None,
        "memory_analysis": mem,
        "flag_search": search_record,
        "timestamp": datetime.now().isoformat(timespec="seconds"),
    }
    out = Path(args.output or Path(args.model).parent / "xla_report.json")
    out.write_text(json.dumps(report, indent=2))
    print(json.dumps(report, indent=2))


if __name__ == "__main__":
    main()
