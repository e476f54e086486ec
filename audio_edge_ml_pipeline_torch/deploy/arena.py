"""Activation arena estimation for generated C projects.

Ping-pong two-buffer model (contract of reference arena_estimator.py:1-224):
the forward pass alternates between buf_a and buf_b, so the peak requirement
of layer i is in_bytes(i) + out_bytes(i); the arena must hold
max_i(in+out). check_max_ram raises when the peak exceeds the budget
(e.g. ~180 KB usable on the Nicla Vision M7, BASELINE.md).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass

import numpy as np

logger = logging.getLogger(__name__)


@dataclass
class LayerCost:
    name: str
    in_shape: tuple
    out_shape: tuple

    @property
    def in_bytes(self) -> int:
        return int(np.prod(self.in_shape)) * 4

    @property
    def out_bytes(self) -> int:
        return int(np.prod(self.out_shape)) * 4

    @property
    def peak_bytes(self) -> int:
        return self.in_bytes + self.out_bytes


class ArenaEstimator:
    def __init__(self, layers: list[LayerCost]):
        self.layers = layers

    @property
    def peak_bytes(self) -> int:
        return max((l.peak_bytes for l in self.layers), default=0)

    @property
    def buffer_bytes(self) -> int:
        """Size of each ping-pong buffer: the largest single activation."""
        sizes = [l.in_bytes for l in self.layers] + [l.out_bytes for l in self.layers]
        return max(sizes, default=0)

    def table(self) -> str:
        lines = [f"{'layer':<28} {'in':>12} {'out':>12} {'peak KB':>9}"]
        for l in self.layers:
            lines.append(
                f"{l.name:<28} {str(tuple(l.in_shape)):>12} {str(tuple(l.out_shape)):>12} "
                f"{l.peak_bytes / 1024:>9.1f}"
            )
        lines.append(f"{'TOTAL PEAK':<28} {'':>12} {'':>12} {self.peak_bytes / 1024:>9.1f}")
        return "\n".join(lines)

    def check_max_ram(self, max_ram_kb: float) -> None:
        peak_kb = self.peak_bytes / 1024
        if peak_kb > max_ram_kb:
            raise MemoryError(
                f"Estimated activation arena {peak_kb:.1f} KB exceeds the "
                f"--max-ram budget of {max_ram_kb:.1f} KB.\n{self.table()}"
            )
        logger.info("Arena peak %.1f KB within budget %.1f KB", peak_kb, max_ram_kb)


def estimate_arena(layer_shapes: list[tuple[str, tuple, tuple]]) -> ArenaEstimator:
    return ArenaEstimator([LayerCost(n, i, o) for n, i, o in layer_shapes])
