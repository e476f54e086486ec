"""Closed-loop batches fed from host memory: the generator of every mix
whose ``generator`` is ``host_chunks``.

The program's extraction (``features/base.py::extract_dataset``) decodes
each chunk of clips on the host and hands it to ``_device_batch`` as
pageable float32 NumPy; over several cards that call copies each card's
rows up, runs its part there and fetches every part back in order. This
generator feeds an entry the same way. The pool (the mix's ``classes`` x
``per_class`` clips of ``clip_seconds``, the clips ``closed_batches``
makes from the same seed) is made on the card from the seed
(``harness.clips``), then held in pageable host memory and the card's copy
freed. Batches of ``batch`` host rows are taken in order, wrapping round,
one in flight (``in_flight`` 1): the entry returns host NumPy only once
every card's rows have landed. ``warm_batches`` run in the set-up. A
batch's time runs from the host issuing it to its return, read on card 0's
clock by two events (on a CPU by the host's); every batch's sum is checked
finite on the host, and every output is offered to the sampler.
"""

from __future__ import annotations

import contextlib
import math
import time

import numpy as np
import torch

from benchmark.harness.clips import make_pool
from benchmark.traffic.closed_batches import MAX_BATCHES, Window, _Clock


class Traffic:
    def __init__(self, mix: dict, config: dict, seed: int, device: torch.device) -> None:
        if mix.get("in_flight", 1) != 1:
            raise ValueError("host_chunks keeps one batch in flight; another in_flight needs its own generator")
        self.device = device
        self.batch = int(mix["batch"])
        self.n_clips = int(mix["classes"]) * int(mix["per_class"])
        n = int(round(mix["clip_seconds"] * config["sample_rate"]))
        pool = make_pool(seed, int(mix["classes"]), int(mix["per_class"]), n, config["sample_rate"], self.batch - 1,
                         device)
        self.pool = pool.cpu().numpy()
        del pool
        if device.type == "cuda":
            torch.cuda.empty_cache()
        self.warm_batches = int(mix.get("warm_batches", 3))

    def waves(self, i: int) -> np.ndarray:
        start = (i * self.batch) % self.n_clips
        return self.pool[start:start + self.batch]

    def clips(self, picks: list[tuple[int, int]]) -> np.ndarray:
        """The clips of (batch index, row) pairs."""
        return self.pool[[(i * self.batch + r) % self.n_clips for i, r in picks]]

    def warm(self, call) -> None:
        """Run ``warm_batches`` batches as the window runs them (set-up)."""
        with torch.inference_mode():
            for i in range(self.warm_batches):
                call(self.waves(i))

    def run(self, call, seconds: float, sampler, prof=None, trace_batches: int = 0) -> Window:
        """Batches through ``call`` for ``seconds``; every output is offered
        to ``sampler``. With ``prof`` the first ``trace_batches`` are
        traced, each inside a ``benchmark.batch`` span with the call inside
        ``benchmark.entry``, and the profiler stops after them."""
        from torch.profiler import record_function

        clock = _Clock(self.device)
        win = Window()
        t0 = time.perf_counter()
        with torch.inference_mode():
            while True:
                i = win.batches
                traced = prof is not None and i < trace_batches
                with record_function("benchmark.batch") if traced else contextlib.nullcontext():
                    clock.begin()
                    with record_function("benchmark.entry") if traced else contextlib.nullcontext():
                        out = call(self.waves(i))
                    win.batch_ms.append(clock.finish())
                win.finite.append(math.isfinite(out.sum(dtype=np.float32)))
                sampler.take(i, out)
                win.batches += 1
                if traced and win.batches == trace_batches:
                    prof.stop()
                elapsed = time.perf_counter() - t0
                if elapsed >= seconds or win.batches == MAX_BATCHES:
                    break
        if prof is not None and win.batches < trace_batches:
            prof.stop()
        win.seconds = elapsed
        win.rows = win.batches * self.batch
        return win
