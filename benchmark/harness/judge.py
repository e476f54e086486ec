"""What decides ``correct``: a sample, drawn from the seed, of the outputs
that reached the host in the window, and the numbers that compare them
with the reference, each against its limit."""

from __future__ import annotations

import numpy as np


class Sampler:
    """A uniform sample of ``k`` rows over every row of every batch that
    reached the host (reservoir sampling, its draws from the seed). Each
    kept row is (batch index, row in the batch, a copy of the output row)."""

    def __init__(self, k: int, seed: int) -> None:
        self.k = k
        self.rng = np.random.default_rng([seed, 0x5A11])
        self.seen = 0
        self.rows: list[tuple[int, int, np.ndarray]] = []

    def take(self, batch_index: int, host_out) -> None:
        """Offer every row of one batch's host output (rows on axis 0)."""
        b = host_out.shape[0]
        pos = self.seen + np.arange(b)
        draw = self.rng.integers(0, pos + 1)
        for r in np.flatnonzero((pos < self.k) | (draw < self.k)):
            if pos[r] < self.k:
                self.rows.append((batch_index, r, np.array(host_out[r])))
            elif draw[r] < self.k:
                self.rows[draw[r]] = (batch_index, r, np.array(host_out[r]))
        self.seen += b


def max_abs(out: np.ndarray, ref: np.ndarray) -> float:
    """max|out - ref| over every value."""
    return float(np.max(np.abs(out.astype(np.float64) - ref)))


def max_rel(out: np.ndarray, ref: np.ndarray) -> float:
    """max over values of |out - ref| / max(|ref|, 1)."""
    return float(np.max(np.abs(out.astype(np.float64) - ref) / np.maximum(np.abs(ref), 1.0)))


def max_over_largest(out: np.ndarray, ref: np.ndarray) -> float:
    """max|out - ref| over the largest |ref|."""
    return float(np.max(np.abs(out.astype(np.float64) - ref)) / np.max(np.abs(ref)))


def verdict(numbers: dict[str, float], limits: dict[str, float]) -> tuple[bool, dict[str, dict]]:
    """(every number within its limit, {name: {value, limit}}). A number
    that is not finite, or has no limit, fails."""
    checks = {k: {"value": v, "limit": limits.get(k)} for k, v in numbers.items()}
    ok = bool(checks) and all(c["limit"] is not None and np.isfinite(c["value"]) and c["value"] <= c["limit"]
                              for c in checks.values())
    return ok, checks
