"""Extraction split over cards: a host batch in, host features out, through
one of the program's registered audio extractors built with ``devices``
set to the mix's ``cards`` cards (cuda:0 on; on a CPU, the CPU that many
times), and called per chunk as ``extract_dataset`` calls it:
``_device_batch(waves, None)``, which copies each card's contiguous rows
up, runs that card's part and fetches every part back in order.

The reference, the control and the numbers compared are those of
``entries/extractor.py``: each row's computation is the one-card
extractor's.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.entries import extractor


class Entry(extractor.Entry):
    def __init__(self, config: dict, mix: dict, seed: int, device: torch.device) -> None:
        from audio_edge_ml_pipeline_torch.features import get

        super().__init__(config, mix, seed, device)
        cards = int(mix["cards"])
        devices = [torch.device("cuda", k) for k in range(cards)] if device.type == "cuda" else [device] * cards
        self.extractor = get(self.name)(**self.params, devices=devices)

    def __call__(self, waves: np.ndarray) -> np.ndarray:
        return self.extractor._device_batch(waves, None)


def build(config: dict, mix: dict, seed: int, device: torch.device) -> Entry:
    return Entry(config, mix, seed, device)
