"""Closed-loop batches over a device-resident pool: the generator of every
mix whose ``generator`` is ``closed_batches``.

The mix's parameters: ``classes`` x ``per_class`` clips of
``clip_seconds`` at the configuration's ``sample_rate`` make the pool,
made on the device from the seed (``harness.clips``). Batches of ``batch``
clips are taken in order, wrapping round, so every batch has one shape.
Each goes through the entry; its output is copied into a pinned host
buffer, as a FeatureSet or a score has to leave the card, and the host
waits for that copy before it issues the next batch (``in_flight`` 1, as
the program's extraction waits for a chunk). Two host buffers take turns,
so that the harness samples a batch's output while the next one runs.
``warm_batches`` run in the set-up. A batch's time runs from the host issuing it to its output landing
in host memory, read on the device's clock by two events; on a CPU (the
tests) by the host's.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from benchmark.harness.clips import make_pool

MAX_BATCHES = 1 << 17   # a window's batches at most: 51 s at 0.4 ms a batch


@dataclass
class Window:
    batches: int = 0
    rows: int = 0
    seconds: float = 0.0
    batch_ms: list[float] = field(default_factory=list)
    finite: list[bool] = field(default_factory=list)


class _Clock:
    """Times one batch: device events on a card, the host clock on a CPU."""

    def __init__(self, device: torch.device) -> None:
        self.cuda = device.type == "cuda"
        if self.cuda:
            self.start, self.end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    def begin(self) -> None:
        if self.cuda:
            self.start.record()
        else:
            self.t0 = time.perf_counter()

    def finish(self) -> float:
        """Wait for everything issued before it; the batch's ms."""
        if self.cuda:
            self.end.record()
            self.end.synchronize()
            return self.start.elapsed_time(self.end)
        return (time.perf_counter() - self.t0) * 1e3


class Traffic:
    def __init__(self, mix: dict, config: dict, seed: int, device: torch.device) -> None:
        if mix.get("in_flight", 1) != 1:
            raise ValueError("closed_batches keeps one batch in flight; another in_flight needs its own generator")
        self.device = device
        self.batch = int(mix["batch"])
        self.n_clips = int(mix["classes"]) * int(mix["per_class"])
        n = int(round(mix["clip_seconds"] * config["sample_rate"]))
        self.pool = make_pool(seed, int(mix["classes"]), int(mix["per_class"]), n, config["sample_rate"],
                              self.batch - 1, device)
        self.warm_batches = int(mix.get("warm_batches", 3))
        self.hosts: list[torch.Tensor] = []

    def waves(self, i: int) -> torch.Tensor:
        start = (i * self.batch) % self.n_clips
        return self.pool[start:start + self.batch]

    def clips(self, picks: list[tuple[int, int]]) -> np.ndarray:
        """The clips of (batch index, row) pairs, on the host."""
        idx = torch.tensor([(i * self.batch + r) % self.n_clips for i, r in picks], device=self.device)
        return self.pool[idx].cpu().numpy()

    def _issue(self, call, i: int, sums: torch.Tensor, entry_span) -> None:
        with entry_span():
            out = call(self.waves(i))
        if not self.hosts:
            self.hosts = [torch.empty(out.shape, dtype=out.dtype, pin_memory=self.device.type == "cuda")
                          for _ in range(2)]
        self.hosts[i % 2].copy_(out, non_blocking=True)
        torch.sum(out.reshape(-1), dim=0, out=sums[i])

    def warm(self, call) -> None:
        """Run ``warm_batches`` batches as the window runs them (set-up)."""
        sums = torch.empty(self.warm_batches, device=self.device)
        clock = _Clock(self.device)
        with torch.inference_mode():
            for i in range(self.warm_batches):
                clock.begin()
                self._issue(call, i, sums, contextlib.nullcontext)
                clock.finish()

    def run(self, call, seconds: float, sampler, prof=None, trace_batches: int = 0) -> Window:
        """Batches through ``call`` for ``seconds``; every output that lands
        is offered to ``sampler``, each while the next batch runs. With
        ``prof`` the first ``trace_batches`` are traced, each inside a
        ``benchmark.batch`` span with the call inside ``benchmark.entry``,
        and the profiler stops after them."""
        from torch.profiler import record_function

        sums = torch.empty(MAX_BATCHES, device=self.device)
        clock = _Clock(self.device)
        win = Window()
        landed = None
        t0 = time.perf_counter()
        with torch.inference_mode():
            while True:
                i = win.batches
                traced = prof is not None and i < trace_batches
                with record_function("benchmark.batch") if traced else contextlib.nullcontext():
                    clock.begin()
                    self._issue(call, i, sums, (lambda: record_function("benchmark.entry")) if traced
                                else contextlib.nullcontext)
                    if landed is not None:
                        sampler.take(*landed)
                    win.batch_ms.append(clock.finish())
                landed = (i, self.hosts[i % 2].numpy())
                win.batches += 1
                if traced and win.batches == trace_batches:
                    prof.stop()
                elapsed = time.perf_counter() - t0
                if elapsed >= seconds or win.batches == MAX_BATCHES:
                    break
        sampler.take(*landed)
        if prof is not None and win.batches < trace_batches:
            prof.stop()
        win.seconds = elapsed
        win.rows = win.batches * self.batch
        win.finite = torch.isfinite(sums[:win.batches]).tolist()
        return win
