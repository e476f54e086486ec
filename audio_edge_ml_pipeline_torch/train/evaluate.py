"""Evaluation helpers shared by the trainers and CLIs.

Counterpart of the JAX package's ``train/evaluate.py``: the same metric keys,
artifact filenames and model_info.json schema, from pure numpy
implementations (accuracy, macro precision/recall/F1, confusion matrix,
per-class breakdown, one-vs-rest macro ROC-AUC).

The confusion-matrix PNG is drawn with matplotlib where it is installed, as
in the JAX package; where it is not, a plain heatmap PNG (one block per cell,
no text) is written with zlib, so training also runs where only torch and
numpy are installed.
"""

from __future__ import annotations

import json
import logging
import struct
import zlib
from pathlib import Path
from typing import Optional

import numpy as np

logger = logging.getLogger(__name__)


def confusion_matrix(y_true: np.ndarray, y_pred: np.ndarray, n_classes: Optional[int] = None) -> np.ndarray:
    if n_classes is None:
        n_classes = int(max(y_true.max(initial=0), y_pred.max(initial=0))) + 1
    cm = np.zeros((n_classes, n_classes), dtype=np.int64)
    np.add.at(cm, (y_true.astype(int), y_pred.astype(int)), 1)
    return cm


def _prf_per_class(cm: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    tp = np.diag(cm).astype(np.float64)
    pred_tot = cm.sum(axis=0).astype(np.float64)
    true_tot = cm.sum(axis=1).astype(np.float64)
    precision = np.divide(tp, pred_tot, out=np.zeros_like(tp), where=pred_tot > 0)
    recall = np.divide(tp, true_tot, out=np.zeros_like(tp), where=true_tot > 0)
    denom = precision + recall
    f1 = np.divide(2 * precision * recall, denom, out=np.zeros_like(tp), where=denom > 0)
    return precision, recall, f1


def f1_macro(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    """sklearn's ``f1_score(average="macro", zero_division=0)``: the mean F1
    over the classes present in y_true or y_pred."""
    y_true = np.asarray(y_true).astype(int)
    y_pred = np.asarray(y_pred).astype(int)
    present = np.union1d(np.unique(y_true), np.unique(y_pred))
    _, _, f1 = _prf_per_class(confusion_matrix(y_true, y_pred))
    return float(f1[present].mean())


def roc_auc_ovr_macro(y_true: np.ndarray, y_proba: np.ndarray) -> float:
    """Macro-average one-vs-rest ROC-AUC via the rank statistic
    (Mann-Whitney U), matching sklearn's roc_auc_score(multi_class='ovr')."""
    n_classes = y_proba.shape[1]
    aucs = []
    for c in range(n_classes):
        pos = y_true == c
        n_pos, n_neg = int(pos.sum()), int((~pos).sum())
        if n_pos == 0 or n_neg == 0:
            continue
        scores = y_proba[:, c]
        order = np.argsort(scores, kind="mergesort")
        ranks = np.empty(len(scores), dtype=np.float64)
        # average ranks for ties
        sorted_scores = scores[order]
        i = 0
        while i < len(scores):
            j = i
            while j + 1 < len(scores) and sorted_scores[j + 1] == sorted_scores[i]:
                j += 1
            ranks[order[i : j + 1]] = 0.5 * (i + j) + 1.0
            i = j + 1
        auc = (ranks[pos].sum() - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg)
        aucs.append(auc)
    if not aucs:
        raise ValueError("ROC-AUC undefined: need both positive and negative samples")
    return float(np.mean(aucs))


def compute_metrics(
    y_true: np.ndarray,
    y_pred: np.ndarray,
    y_proba: Optional[np.ndarray] = None,
    label_names: Optional[list[str]] = None,
) -> dict:
    """val_accuracy / val_f1_macro / val_precision_macro / val_recall_macro /
    confusion_matrix / per_class (+ val_roc_auc_macro when y_proba given)."""
    y_true = np.asarray(y_true).astype(int)
    y_pred = np.asarray(y_pred).astype(int)
    observed = int(max(y_true.max(initial=0), y_pred.max(initial=0))) + 1
    n_classes = max(observed, len(label_names) if label_names else 0)
    names = label_names or [str(i) for i in range(n_classes)]
    cm = confusion_matrix(y_true, y_pred, n_classes)
    # match sklearn: macro over classes present in y_true or y_pred
    present = np.union1d(np.unique(y_true), np.unique(y_pred))
    precision, recall, f1 = _prf_per_class(cm)
    metrics: dict = {
        "val_accuracy": float((y_true == y_pred).mean()),
        "val_f1_macro": float(f1[present].mean()),
        "val_precision_macro": float(precision[present].mean()),
        "val_recall_macro": float(recall[present].mean()),
        "confusion_matrix": cm[np.ix_(present, present)].tolist(),
    }
    support = np.bincount(y_true, minlength=n_classes)
    per_class = {}
    for i, name in enumerate(names[:n_classes]):
        per_class[name] = {
            "precision": float(precision[i]),
            "recall": float(recall[i]),
            "f1": float(f1[i]),
            "support": int(support[i]),
        }
    metrics["per_class"] = per_class
    if y_proba is not None and len(np.unique(y_true)) >= 2:
        try:
            metrics["val_roc_auc_macro"] = roc_auc_ovr_macro(y_true, np.asarray(y_proba))
        except ValueError as exc:
            logger.debug("ROC-AUC skipped: %s", exc)
    return metrics


def classification_report_text(y_true, y_pred, label_names: list[str]) -> str:
    """Plain-text per-class report (sklearn classification_report layout)."""
    m = compute_metrics(y_true, y_pred, label_names=label_names)
    width = max([len(n) for n in label_names] + [12])
    lines = [f"{'':>{width}}  precision    recall  f1-score   support", ""]
    total = 0
    for name in label_names:
        pc = m["per_class"].get(name)
        if pc is None:
            continue
        lines.append(
            f"{name:>{width}}  {pc['precision']:9.2f} {pc['recall']:9.2f} {pc['f1']:9.2f} {pc['support']:9d}"
        )
        total += pc["support"]
    lines.append("")
    lines.append(f"{'accuracy':>{width}}  {'':9} {'':9} {m['val_accuracy']:9.2f} {total:9d}")
    lines.append(
        f"{'macro avg':>{width}}  {m['val_precision_macro']:9.2f} {m['val_recall_macro']:9.2f} "
        f"{m['val_f1_macro']:9.2f} {total:9d}"
    )
    return "\n".join(lines) + "\n"


def save_classification_report(y_true, y_pred, label_names: list[str], path: Path) -> None:
    try:
        Path(path).write_text(classification_report_text(y_true, y_pred, label_names))
    except OSError as exc:
        logger.warning("Could not write classification report: %s", exc)


def heatmap_png(cm, cell: int = 16) -> bytes:
    """A plain PNG heatmap of ``cm``: one ``cell`` x ``cell`` block per entry,
    white (0) to dark blue (the maximum), RGB, no text."""
    cm_arr = np.atleast_2d(np.asarray(cm, np.float64))
    if cm_arr.size == 0:
        cm_arr = np.zeros((1, 1))
    frac = cm_arr / max(float(cm_arr.max()), 1.0)
    white, blue = np.array([247.0, 251.0, 255.0]), np.array([8.0, 48.0, 107.0])
    rgb = np.rint(white + frac[..., None] * (blue - white)).astype(np.uint8)
    img = np.repeat(np.repeat(rgb, cell, axis=0), cell, axis=1)
    h, w = img.shape[:2]
    raw = b"".join(b"\x00" + img[r].tobytes() for r in range(h))  # filter type 0 per row

    def chunk(kind: bytes, data: bytes) -> bytes:
        return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data))

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


def save_confusion_matrix_png(cm, label_names: list[str], path: Path) -> None:
    """Confusion-matrix heatmap PNG (the JAX package's figure where
    matplotlib is installed, else ``heatmap_png``)."""
    try:
        import matplotlib
    except ImportError:
        logger.info("matplotlib is not installed: writing a plain heatmap to %s", path)
        Path(path).write_bytes(heatmap_png(cm))
        return

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    cm_arr = np.array(cm)
    n = len(label_names)
    fig, ax = plt.subplots(figsize=(max(6, n), max(5, n - 1)))
    im = ax.imshow(cm_arr, interpolation="nearest", cmap=plt.cm.Blues)
    plt.colorbar(im, ax=ax)
    ax.set(
        xticks=range(n), yticks=range(n),
        xticklabels=label_names, yticklabels=label_names,
        ylabel="True label", xlabel="Predicted label", title="Confusion Matrix",
    )
    plt.setp(ax.get_xticklabels(), rotation=45, ha="right")
    if cm_arr.size:
        thresh = cm_arr.max() / 2.0
        for i in range(min(n, cm_arr.shape[0])):
            for j in range(min(n, cm_arr.shape[1])):
                ax.text(
                    j, i, str(cm_arr[i, j]), ha="center", va="center",
                    color="white" if cm_arr[i, j] > thresh else "black",
                    fontsize=max(6, 10 - n // 5),
                )
    fig.tight_layout()
    fig.savefig(path, dpi=100)
    plt.close(fig)


def save_model_info(output_dir: Path, model_name: str, run_name: str, metrics: dict, params: dict,
                    model_size_kb: float) -> None:
    info = {
        "model_name": model_name,
        "run_name": run_name,
        "model_size_kb": model_size_kb,
        "params": {k: str(v) for k, v in params.items()},
        "val_accuracy": metrics.get("val_accuracy"),
        "val_f1_macro": metrics.get("val_f1_macro"),
        "val_precision_macro": metrics.get("val_precision_macro"),
        "val_recall_macro": metrics.get("val_recall_macro"),
        "val_roc_auc_macro": metrics.get("val_roc_auc_macro"),
    }
    (Path(output_dir) / "model_info.json").write_text(json.dumps(info, indent=2))


def log_run_to_mlflow(run, params: dict, metrics: dict, output_dir: Path) -> None:
    """Log params, scalar metrics and the run's report files to a tracking
    run (no-op when run is None)."""
    if run is None:
        return
    for k, v in params.items():
        run.log_param(k, str(v))
    for k, v in metrics.items():
        if isinstance(v, (int, float)):
            run.log_metric(k, float(v))
    for name in ("confusion_matrix.png", "classification_report.txt", "model_info.json"):
        art = Path(output_dir) / name
        if art.exists():
            run.log_artifact(art)
