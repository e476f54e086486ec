"""Ingestion-path spectrogram dataset.

Counterpart of the JAX package's ``train/dataset.py``: iterates the .npy mel
spectrograms the ingestion ``AudioPreprocessor`` writes (with optional JSON
metadata sidecars carrying labels) for ad-hoc scripts, such as relabelling
the uploads an edge device was unsure of. The main training path uses
FeatureSet directories instead.
"""

from __future__ import annotations

import json
import logging
from pathlib import Path
from typing import Optional

import numpy as np
import torch

logger = logging.getLogger(__name__)


class SpectrogramDataset:
    """Directory of <id>.npy spectrograms (+ optional <id>.json sidecars
    with a label field)."""

    def __init__(self, data_dir: Path | str, label_key: str = "true_class") -> None:
        self.data_dir = Path(data_dir)
        self.label_key = label_key
        self._items: list[tuple[Path, Optional[str]]] = []
        for npy in sorted(self.data_dir.glob("*.npy")):
            label = None
            sidecar = npy.with_suffix(".json")
            if sidecar.exists():
                try:
                    label = json.loads(sidecar.read_text()).get(label_key)
                except json.JSONDecodeError:
                    pass
            self._items.append((npy, label))
        labels = sorted({l for _, l in self._items if l is not None})
        self.label_names = labels
        self._label_to_idx = {l: i for i, l in enumerate(labels)}
        logger.info("SpectrogramDataset: %d files, %d labelled classes", len(self._items), len(labels))

    def __len__(self) -> int:
        return len(self._items)

    def load_arrays(self) -> tuple[np.ndarray, Optional[np.ndarray]]:
        """(X float32 (N, ...), y int32 (N,)) in file-name order, the labels
        indexing the sorted ``label_names`` and -1 for a file without one;
        y is None when no file has a label."""
        X = np.stack([np.load(p) for p, _ in self._items]).astype(np.float32)
        if self.label_names:
            y = np.array([self._label_to_idx.get(l, -1) for _, l in self._items], dtype=np.int32)
            return X, y
        return X, None

    def to_data_loader(self, batch_size: int = 32, shuffle: bool = False,
                       seed: Optional[int] = None) -> torch.utils.data.DataLoader:
        """A batched, optionally shuffled ``DataLoader`` over ``load_arrays``:
        batches of (X, y) tensors, or of X alone when nothing is labelled.
        It replaces the JAX package's ``to_tf_dataset`` (a ``tf.data``
        pipeline): the same ``batch_size``, ``shuffle`` and ``seed``, the order
        drawn from an explicit ``torch.Generator`` seeded with ``seed``."""
        X, y = self.load_arrays()
        data = torch.from_numpy(X) if y is None else torch.utils.data.TensorDataset(torch.from_numpy(X),
                                                                                     torch.from_numpy(y))
        generator = torch.Generator()
        if seed is not None:
            generator.manual_seed(seed)
        else:
            generator.seed()
        return torch.utils.data.DataLoader(data, batch_size=batch_size, shuffle=shuffle, generator=generator)
