"""Trainer base abstractions: TrainResult + BaseTrainer.

API contract of the JAX package's ``models/base.py`` (fit/predict/
predict_proba/save/load + flatten helper), so CLIs, tuning, selection and
optimization interoperate across trainers.
"""

from __future__ import annotations

import logging
from abc import ABC, abstractmethod
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

import numpy as np

logger = logging.getLogger(__name__)


@dataclass
class TrainResult:
    model_name: str
    run_id: str
    output_dir: Path
    metrics: dict
    model_size_kb: float
    params: dict = field(default_factory=dict)

    def __repr__(self) -> str:
        acc = self.metrics.get("val_accuracy", float("nan"))
        return (
            f"TrainResult(model={self.model_name!r}, val_accuracy={acc:.4f}, "
            f"size={self.model_size_kb:.1f} KB, output={self.output_dir})"
        )


class BaseTrainer(ABC):
    """All trainers expose: fit(X_train, y_train, X_val, y_val, label_names,
    run_name, output_dir, mlflow_run) -> TrainResult; predict; optional
    predict_proba; save(path); classmethod load(path)."""

    name: str
    model_type: str  # "classical" | "deep"

    @abstractmethod
    def fit(
        self,
        X_train: np.ndarray,
        y_train: np.ndarray,
        X_val: np.ndarray,
        y_val: np.ndarray,
        label_names: list[str],
        run_name: str,
        output_dir: Path,
        mlflow_run,
    ) -> TrainResult: ...

    @abstractmethod
    def predict(self, X: np.ndarray) -> np.ndarray: ...

    def predict_proba(self, X: np.ndarray) -> Optional[np.ndarray]:
        return None

    @abstractmethod
    def save(self, path: Path) -> None: ...

    @classmethod
    @abstractmethod
    def load(cls, path: Path) -> "BaseTrainer": ...

    @staticmethod
    def flatten(X: np.ndarray) -> np.ndarray:
        """Flatten ND features to (N, D) for classical estimators."""
        if X.ndim > 2:
            return X.reshape(X.shape[0], -1)
        return X
