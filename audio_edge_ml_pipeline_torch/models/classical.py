"""Classical trainers in PyTorch: svm, lda, knn, kmeans, pca_svm, pca_lda,
pca_knn, and the sklearn trees decision_tree and random_forest.

Counterpart of the JAX package's ``models/classical.py``, with its names,
params, bundle files and artifacts (classification_report.txt,
confusion_matrix.png, model_info.json):

- ``svm``, ``lda``, ``knn``, ``kmeans``, ``pca_svm``, ``pca_lda`` and
  ``pca_knn`` run their math in torch on ``device`` (the first CUDA card
  unless the caller passes ``device="cpu"``): distance products, Lloyd's
  iterations with every restart in one batch, Gram-eigh PCA, closed-form
  LDA and the batched one-vs-one SVM of ``classical_core``. Each saves one
  ``<name>.npz`` with the JAX package's keys (and a ``__meta__`` JSON entry
  for the state-bundle trainers), so either package loads what the other
  wrote.
- ``decision_tree`` and ``random_forest`` stay on sklearn on the host, as in
  JAX, and import it when built: where scikit-learn is not installed they
  raise an ImportError that names it and the trainer.
"""

from __future__ import annotations

import importlib
import json
import logging
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..train.evaluate import (
    compute_metrics,
    log_run_to_mlflow,
    save_classification_report,
    save_confusion_matrix_png,
    save_model_info,
)
from ..utils.device import resolve_device
from . import classical_core as cc
from .base import BaseTrainer, TrainResult
from .registry import register_model

logger = logging.getLogger(__name__)

KNN_METRICS = ("minkowski", "euclidean", "cosine")


def _finish_fit(trainer, y_val, y_pred_val, val_metrics, label_names, run_name, output_dir, mlflow_run, params,
                model_filename, skip_reports=False):
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    model_path = output_dir / model_filename
    trainer.save(model_path)
    model_size_kb = model_path.stat().st_size / 1024
    if not skip_reports:
        save_classification_report(y_val, y_pred_val, label_names, output_dir / "classification_report.txt")
        save_confusion_matrix_png(val_metrics.get("confusion_matrix", []), label_names,
                                  output_dir / "confusion_matrix.png")
    save_model_info(output_dir, trainer.name, run_name, val_metrics, params, model_size_kb)
    val_metrics["model_size_kb"] = model_size_kb
    log_run_to_mlflow(mlflow_run, params, val_metrics, output_dir)
    if mlflow_run is not None:
        mlflow_run.log_artifact(model_path)
    return TrainResult(
        model_name=trainer.name,
        run_id=mlflow_run.info.run_id if mlflow_run else "",
        output_dir=output_dir,
        metrics=val_metrics,
        model_size_kb=model_size_kb,
        params=params,
    )


# ---------------------------------------------------------------------------
# sklearn trees (host)
# ---------------------------------------------------------------------------


def _sklearn_class(trainer: str, module: str, cls: str):
    try:
        return getattr(importlib.import_module(module), cls)
    except ImportError as exc:
        raise ImportError(
            f"trainer {trainer!r} needs scikit-learn ({module}.{cls}), which is not installed here; "
            "the port has no other implementation of it"
        ) from exc


class SklearnTrainer(BaseTrainer):
    """Generic fit -> metrics -> joblib -> artifacts wrapper around an
    sklearn estimator, on the host."""

    model_type = "classical"

    def __init__(self, estimator):
        self._estimator = estimator

    def fit(self, X_train, y_train, X_val, y_val, label_names, run_name, output_dir, mlflow_run) -> TrainResult:
        X_train = self.flatten(np.asarray(X_train))
        X_val = self.flatten(np.asarray(X_val))
        logger.info("Training %s on %d samples ...", self.name, len(X_train))
        self._estimator.fit(X_train, y_train)
        y_pred_val = self._estimator.predict(X_val)
        val_metrics = compute_metrics(y_val, y_pred_val, label_names=label_names)
        params = {"model": self.name}
        if hasattr(self._estimator, "get_params"):
            params.update({k: str(v) for k, v in self._estimator.get_params().items()})
        return _finish_fit(self, y_val, y_pred_val, val_metrics, label_names, run_name, output_dir, mlflow_run,
                           params, f"{self.name}.joblib")

    def predict(self, X):
        return self._estimator.predict(self.flatten(np.asarray(X)))

    def predict_proba(self, X):
        if hasattr(self._estimator, "predict_proba"):
            try:
                return self._estimator.predict_proba(self.flatten(np.asarray(X)))
            except Exception:
                pass
        return None

    def save(self, path: Path) -> None:
        import joblib

        Path(path).parent.mkdir(parents=True, exist_ok=True)
        joblib.dump(self._estimator, path)

    @classmethod
    def load(cls, path: Path, device=None) -> "SklearnTrainer":
        import joblib

        inst = cls.__new__(cls)
        inst._estimator = joblib.load(path)
        return inst


@register_model
class DecisionTreeTrainer(SklearnTrainer):
    name = "decision_tree"

    def __init__(self, max_depth: Optional[int] = None, min_samples_leaf: int = 1, **_):
        tree = _sklearn_class(self.name, "sklearn.tree", "DecisionTreeClassifier")
        super().__init__(tree(max_depth=max_depth, min_samples_leaf=min_samples_leaf, random_state=42))


@register_model
class RandomForestTrainer(SklearnTrainer):
    name = "random_forest"

    def __init__(self, n_estimators: int = 100, max_depth: Optional[int] = None, **_):
        forest = _sklearn_class(self.name, "sklearn.ensemble", "RandomForestClassifier")
        super().__init__(forest(n_estimators=n_estimators, max_depth=max_depth, n_jobs=-1, random_state=42))


# ---------------------------------------------------------------------------
# kNN and k-means
# ---------------------------------------------------------------------------


@cc.full_float32()
def knn_counts(q: torch.Tensor, Xr: torch.Tensor, yr: torch.Tensor, k: int, n_classes: int,
               metric: str = "minkowski") -> torch.Tensor:
    """Neighbour class counts (B, n_classes) of the queries ``q`` among the
    rows ``Xr`` labelled ``yr``. minkowski / euclidean: squared L2 as
    |q|^2 - 2 q.X^T + |X|^2 (one product); cosine: 1 - q^.X^. The k nearest
    by a stable sort, so that among equal distances the lower row index
    comes first, as ``jax.lax.top_k`` orders them."""
    if metric == "cosine":
        qn = q / q.norm(dim=1, keepdim=True).clamp_min(1e-12)
        Xn = Xr / Xr.norm(dim=1, keepdim=True).clamp_min(1e-12)
        d = 1.0 - qn @ Xn.T
    else:
        d = (q * q).sum(1, keepdim=True) - 2.0 * q @ Xr.T + (Xr * Xr).sum(1)[None, :]
    idx = torch.sort(d, dim=1, stable=True).indices[:, :k]
    return cc.one_hot(yr[idx], n_classes).sum(1)


def _knn_counts(q, Xr, yr, k: int, n_classes: int, metric: str, device: torch.device) -> np.ndarray:
    return cc._np(knn_counts(cc._tensor(q, device), cc._tensor(Xr, device), cc._tensor(yr, device, torch.int64),
                             k, n_classes, metric))


def _check_metric(name: str, metric: str) -> None:
    if metric not in KNN_METRICS:
        raise ValueError(f"{name} metric must be minkowski/euclidean/cosine, got {metric!r}")


@register_model
class KNNTrainer(BaseTrainer):
    """k-nearest-neighbours on ``device``: squared-L2 distances as one
    |x|^2 - 2 x.y^T + |y|^2 product, top-k vote. predict_proba = neighbour
    class fractions."""

    name = "knn"
    model_type = "classical"

    def __init__(self, n_neighbors: int = 5, metric: str = "minkowski", device=None, **_):
        _check_metric(self.name, metric)
        self.n_neighbors = n_neighbors
        self.metric = metric
        self.device = resolve_device(device)
        self._X = None
        self._y = None
        self._n_classes = None

    def _predict_counts(self, X: np.ndarray) -> np.ndarray:
        q = self.flatten(np.asarray(X)).astype(np.float32)
        k = min(self.n_neighbors, len(self._X))
        return _knn_counts(q, self._X, self._y, k, self._n_classes, self.metric, self.device)

    def _fit_body(self, X, y, n_classes: int) -> None:
        self._X = self.flatten(np.asarray(X)).astype(np.float32)
        self._y = np.asarray(y).astype(np.int32)
        self._n_classes = n_classes

    def fit(self, X_train, y_train, X_val, y_val, label_names, run_name, output_dir, mlflow_run) -> TrainResult:
        self._fit_body(X_train, y_train, len(label_names))
        y_pred_val = self.predict(X_val)
        val_metrics = compute_metrics(y_val, y_pred_val, label_names=label_names)
        params = {"model": self.name, "n_neighbors": str(self.n_neighbors), "backend": "torch"}
        return _finish_fit(self, y_val, y_pred_val, val_metrics, label_names, run_name, output_dir, mlflow_run,
                           params, f"{self.name}.npz")

    def predict(self, X):
        return self._predict_counts(X).argmax(-1).astype(np.int32)

    def predict_proba(self, X):
        c = self._predict_counts(X)
        return c / c.sum(axis=1, keepdims=True)

    def save(self, path: Path) -> None:
        np.savez(path, X=self._X, y=self._y, n_neighbors=self.n_neighbors,
                 n_classes=self._n_classes, metric=self.metric)

    @classmethod
    def load(cls, path: Path, device=None) -> "KNNTrainer":
        d = np.load(path)
        metric = str(d["metric"]) if "metric" in d else "minkowski"
        inst = cls(n_neighbors=int(d["n_neighbors"]), metric=metric, device=device)
        inst._X, inst._y, inst._n_classes = d["X"], d["y"], int(d["n_classes"])
        return inst


@cc.full_float32()
def lloyd(X: torch.Tensor, inits: torch.Tensor, max_iter: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Every k-means restart at once: ``inits`` (R, k, D) initial centres,
    ``max_iter`` Lloyd steps each; returns (centres (R, k, D), inertia (R,)).
    Ties go to the lower centre index; an empty cluster keeps its centre."""
    k = inits.shape[1]
    xx = (X * X).sum(1, keepdim=True)   # (N, 1)

    def dist(centers):   # (R, N, k)
        return xx - 2.0 * X @ centers.transpose(1, 2) + (centers * centers).sum(2)[:, None, :]

    centers = inits
    for _ in range(max_iter):
        onehot = cc.one_hot(dist(centers).argmin(2), k, X.dtype)   # (R, N, k)
        sums = onehot.transpose(1, 2) @ X
        counts = onehot.sum(1)[:, :, None]
        centers = torch.where(counts > 0, sums / counts.clamp_min(1.0), centers)
    return centers, dist(centers).amin(2).sum(1)


@register_model
class KMeansTrainer(BaseTrainer):
    """K-Means by Lloyd's iterations on ``device``, the ``n_init`` restarts
    as one batch. Unsupervised: labels are ignored in fit; n_clusters
    defaults to len(label_names); predict returns cluster indices and the
    metrics carry the JAX package's 'note' marker."""

    name = "kmeans"
    model_type = "classical"

    def __init__(self, n_clusters: Optional[int] = None, n_init: int = 10, max_iter: int = 100, seed: int = 42,
                 device=None, **_):
        self._n_clusters_override = n_clusters
        self.n_init = n_init
        self.max_iter = max_iter
        self.seed = seed
        self.device = resolve_device(device)
        self._centers = None

    def _lloyd(self, X: np.ndarray, k: int) -> tuple[np.ndarray, float]:
        rng = np.random.default_rng(self.seed)
        inits = np.stack([X[rng.choice(len(X), size=k, replace=False)] for _ in range(self.n_init)])
        centers, inertia = (cc._np(t) for t in lloyd(cc._tensor(X, self.device), cc._tensor(inits, self.device),
                                                    self.max_iter))
        best = int(np.argmin(inertia))
        return centers[best], float(inertia[best])

    def fit(self, X_train, y_train, X_val, y_val, label_names, run_name, output_dir, mlflow_run) -> TrainResult:
        X = self.flatten(np.asarray(X_train)).astype(np.float32)
        k = self._n_clusters_override or len(label_names)
        self._centers, inertia = self._lloyd(X, k)
        y_pred_val = self.predict(X_val)
        val_metrics: dict = {"note": "KMeans — cluster assignments, no supervised accuracy", "inertia": inertia}
        params = {"model": self.name, "n_clusters": str(k), "n_init": str(self.n_init), "backend": "torch"}
        return _finish_fit(self, y_val, y_pred_val, val_metrics, label_names, run_name, output_dir, mlflow_run,
                           params, f"{self.name}.npz", skip_reports=True)

    def predict(self, X):
        X = self.flatten(np.asarray(X)).astype(np.float32)
        d = (X * X).sum(1, keepdims=True) - 2.0 * X @ self._centers.T + (self._centers**2).sum(1)[None, :]
        return d.argmin(axis=1).astype(np.int32)

    def save(self, path: Path) -> None:
        np.savez(path, centers=self._centers, n_init=self.n_init)

    @classmethod
    def load(cls, path: Path, device=None) -> "KMeansTrainer":
        d = np.load(path)
        inst = cls(device=device)
        inst._centers = d["centers"]
        return inst


# ---------------------------------------------------------------------------
# margin / discriminant trainers (classical_core)
# ---------------------------------------------------------------------------


class _StateTrainer(BaseTrainer):
    """Shared persistence for trainers whose fitted model is a flat dict of
    numpy arrays (``_state``): one ``.npz`` with a JSON ``__meta__`` entry,
    readable by numpy alone. ``load`` falls back to legacy sklearn
    ``.joblib`` artifacts."""

    model_type = "classical"
    _meta_fields: tuple = ()

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self._state: dict = {}

    def save(self, path: Path) -> None:
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        meta = {"name": self.name, **{k: getattr(self, k) for k in self._meta_fields}}
        np.savez(path, __meta__=json.dumps(meta), **self._state)

    @classmethod
    def load(cls, path: Path, device=None):
        path = Path(path)
        if path.suffix == ".joblib":   # legacy sklearn artifact
            inst = SklearnTrainer.load(path)
            inst.name = cls.name
            return inst
        d = np.load(path, allow_pickle=False)
        meta = json.loads(str(d["__meta__"]))
        inst = cls(**{k: meta[k] for k in cls._meta_fields if k in meta}, device=device)
        inst._state = {k: d[k] for k in d.files if k != "__meta__"}
        return inst

    def _fit_body(self, X_train, y_train, n_classes: int) -> None:
        raise NotImplementedError

    def fit(self, X_train, y_train, X_val, y_val, label_names, run_name, output_dir, mlflow_run) -> TrainResult:
        X_train = self.flatten(np.asarray(X_train)).astype(np.float32)
        X_val = self.flatten(np.asarray(X_val)).astype(np.float32)
        y_train = np.asarray(y_train).astype(np.int32)
        logger.info("Training %s (torch, %s) on %d samples ...", self.name, self.device, len(X_train))
        self._fit_body(X_train, y_train, len(label_names))
        y_pred_val = self.predict(X_val)
        val_metrics = compute_metrics(y_val, y_pred_val, self.predict_proba(X_val), label_names)
        params = {"model": self.name, "backend": "torch",
                  **{k: str(getattr(self, k)) for k in self._meta_fields}}
        return _finish_fit(self, y_val, y_pred_val, val_metrics, label_names, run_name,
                           output_dir, mlflow_run, params, f"{self.name}.npz")

    def _rows(self, X) -> np.ndarray:
        return self.flatten(np.asarray(X)).astype(np.float32)


class _SVMHead:
    """predict / predict_proba of a fitted OvO SVM state on the rows
    ``_features`` gives."""

    def predict(self, X):
        return cc.predict_svm_np(self._features(X), self._state, self.device)

    def predict_proba(self, X):
        return cc.predict_proba_svm_np(self._features(X), self._state, self.device)


class _LDAHead:
    """predict / predict_proba of a fitted LDA state (softmax probability)."""

    def _decision(self, X):
        return cc.lda_decision_np(self._features(X), self._state, self.device)

    def predict(self, X):
        return self._decision(X).argmax(1).astype(np.int32)

    def predict_proba(self, X):
        return cc.softmax_np(self._decision(X))


@register_model
class SVMTrainer(_SVMHead, _StateTrainer):
    """One-vs-one kernel SVM (rbf/linear) with balanced class weights and
    Platt / pairwise-coupling probabilities; every dual QP is solved at once
    (classical_core.fit_svm_np)."""

    name = "svm"
    _meta_fields = ("C", "kernel", "gamma", "iters")

    def __init__(self, C: float = 1.0, kernel: str = "rbf", gamma="scale", iters: int = 800, device=None, **_):
        super().__init__(device)
        self.C = float(C)
        self.kernel = kernel
        self.gamma = gamma
        self.iters = int(iters)

    def _features(self, X):
        return self._rows(X)

    def _fit_body(self, X, y, n_classes):
        self._state = cc.fit_svm_np(X, y, n_classes, C=self.C, kernel=self.kernel, gamma=self.gamma,
                                    iters=self.iters, device=self.device)


@register_model
class LDATrainer(_LDAHead, _StateTrainer):
    """Closed-form Gaussian LDA (classical_core.fit_lda_np); softmax
    probability. ``n_components`` / ``solver`` are accepted for grid
    compatibility: in sklearn they change only the transform, never the
    classification."""

    name = "lda"
    _meta_fields = ()

    def __init__(self, n_components: Optional[int] = None, solver: str = "svd", device=None, **_):
        super().__init__(device)
        self.n_components = n_components
        self.solver = solver

    def _features(self, X):
        return self._rows(X)

    def _fit_body(self, X, y, n_classes):
        self._state = cc.fit_lda_np(X, y, n_classes, self.device)


class _PCAPipelineTrainer(_StateTrainer):
    """scaler -> PCA front end (Gram eigh, classical_core.fit_scaler_pca_np)
    shared by the pca_* pipelines."""

    def _fit_pca(self, X, n_components: int) -> np.ndarray:
        self._state = cc.fit_scaler_pca_np(X, n_components, self.device)
        return cc.transform_scaler_pca_np(X, self._state, self.device)

    def _features(self, X) -> np.ndarray:
        return cc.transform_scaler_pca_np(self._rows(X), self._state, self.device)


@register_model
class PCASVMTrainer(_SVMHead, _PCAPipelineTrainer):
    """scaler -> PCA -> OvO kernel SVM. With kernel='linear' the fitted
    model collapses to explicit OvO coefficients for export_svm."""

    name = "pca_svm"
    _meta_fields = ("n_components", "C", "kernel", "gamma", "iters")

    def __init__(self, n_components: int = 50, C: float = 1.0, kernel: str = "rbf",
                 gamma="scale", iters: int = 800, device=None, **_):
        super().__init__(device)
        self.n_components = int(n_components)
        self.C = float(C)
        self.kernel = kernel
        self.gamma = gamma
        self.iters = int(iters)

    def _fit_body(self, X, y, n_classes):
        Z = self._fit_pca(X, self.n_components)
        self._state.update(cc.fit_svm_np(Z, y, n_classes, C=self.C, kernel=self.kernel, gamma=self.gamma,
                                         iters=self.iters, device=self.device))


@register_model
class PCALDATrainer(_LDAHead, _PCAPipelineTrainer):
    name = "pca_lda"
    _meta_fields = ("n_components", "n_components_lda")

    def __init__(self, n_components_pca: Optional[int] = None, n_components_lda: Optional[int] = None,
                 solver: str = "svd", n_components: Optional[int] = None, device=None, **_):
        # n_components_pca / n_components_lda are the reference's knob names;
        # n_components is kept as a PCA-dim alias. n_components_lda bounds only
        # sklearn's LDA transform, never the classification, and is persisted
        # so grid configs round-trip.
        super().__init__(device)
        self.n_components = int(n_components_pca if n_components_pca is not None else (n_components or 50))
        self.n_components_lda = n_components_lda

    def _fit_body(self, X, y, n_classes):
        Z = self._fit_pca(X, self.n_components)
        self._state.update(cc.fit_lda_np(Z, y, n_classes, self.device))


@register_model
class PCAKNNTrainer(_PCAPipelineTrainer):
    name = "pca_knn"
    _meta_fields = ("n_components", "n_neighbors", "metric")

    def __init__(self, n_components: int = 50, n_neighbors: int = 5, metric: str = "minkowski", device=None, **_):
        _check_metric(self.name, metric)
        super().__init__(device)
        self.n_components = int(n_components)
        self.n_neighbors = int(n_neighbors)
        self.metric = metric

    def _fit_body(self, X, y, n_classes):
        Z = self._fit_pca(X, self.n_components)
        self._state["knn_X"] = np.asarray(Z, np.float32)
        self._state["knn_y"] = np.asarray(y, np.int32)
        self._state["knn_n_classes"] = np.int32(n_classes)

    def _counts(self, X):
        k = min(self.n_neighbors, len(self._state["knn_X"]))
        return _knn_counts(self._features(X), self._state["knn_X"], self._state["knn_y"], k,
                           int(self._state["knn_n_classes"]), self.metric, self.device)

    def predict(self, X):
        return self._counts(X).argmax(-1).astype(np.int32)

    def predict_proba(self, X):
        c = self._counts(X)
        return c / c.sum(axis=1, keepdims=True)
