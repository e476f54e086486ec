"""Stage 5 — model selection, the pre-optimisation checkpoint.

Counterpart of the first half of the JAX package's ``train/select.py``:
rank FINISHED tracking runs by a quality metric with an optional accuracy
floor and write shortlist.json (including the ``_train -> _val``
features_eval_dir convention). The train CLI's end-of-sweep auto-select
calls it. The post-optimisation half (optimization_report.json ranking,
best_model.json) and the select CLI are still to be ported.
"""

from __future__ import annotations

import json
import logging
from datetime import datetime
from pathlib import Path
from typing import Optional

from ..utils import tracking

logger = logging.getLogger(__name__)


def _eval_dir_for(params: dict) -> Optional[str]:
    """Explicitly logged features_eval_dir, else the `_train -> _val`
    directory-name convention when that sibling exists on disk."""
    explicit = params.get("features_eval_dir")
    if explicit:
        return explicit
    train_dir = params.get("features_dir")
    if not train_dir:
        return None
    guess = train_dir.replace("_train", "_val")
    if guess != train_dir and Path(guess).exists():
        return guess
    return None


def _as_record(run) -> dict:
    p, m = run.params, run.metrics
    return {
        "run_id": run.run_id,
        "run_name": run.run_name or run.run_id[:8],
        "model": p.get("model", "unknown"),
        "val_accuracy": m.get("val_accuracy"),
        "val_f1_macro": m.get("val_f1_macro"),
        "model_size_kb": m.get("model_size_kb"),
        "params": p,
        "metrics": m,
        "artifact_uri": run.artifact_uri,
        "features_dir": p.get("features_dir"),
        "features_eval_dir": _eval_dir_for(p),
        "class_filter": p.get("class_filter"),
    }


def select_preopt(
    experiment: str,
    mlflow_uri: Optional[str] = None,
    metric: str = "val_f1_macro",
    min_accuracy: Optional[float] = None,
    top_n: int = 5,
) -> list[dict]:
    """Query the tracking store and return the top-N FINISHED runs ranked by
    ``metric`` (descending), after the optional ``min_accuracy`` floor. No
    size filter here — real sizes are only known post-optimisation."""
    tracking.set_tracking_uri(mlflow_uri)
    ranked: list[dict] = []
    for run in tracking.search_runs(experiment, status="FINISHED", max_results=500):
        rec = _as_record(run)
        acc = rec.get("val_accuracy")
        if acc is None or (min_accuracy is not None and acc < min_accuracy):
            continue
        value = rec["metrics"].get(metric, rec.get(metric))
        if value is None:
            continue
        rec["_rank_metric"] = float(value)
        ranked.append(rec)
    ranked.sort(key=lambda r: -r["_rank_metric"])
    return ranked[:top_n]


def write_shortlist(
    records: list[dict],
    path: Path,
    experiment: str,
    metric: str = "val_f1_macro",
    features_eval_dir_override: Optional[str] = None,
) -> None:
    # candidate dict keys are the shortlist.json contract
    candidates = []
    for rank, r in enumerate(records, start=1):
        candidates.append(
            {
                "rank": rank,
                "run_id": r["run_id"],
                "run_name": r.get("run_name"),
                "model": r.get("model"),
                "val_accuracy": r.get("val_accuracy"),
                "val_f1_macro": r.get("val_f1_macro"),
                "model_size_kb": r.get("model_size_kb"),
                "params": r.get("params", {}),
                "artifact_uri": r.get("artifact_uri"),
                "features_dir": r.get("features_dir"),
                "features_eval_dir": features_eval_dir_override or r.get("features_eval_dir"),
                "class_filter": r.get("class_filter"),
            }
        )
    doc = {
        "experiment": experiment,
        "metric": metric,
        "n_candidates": len(candidates),
        "generated_at": datetime.now().isoformat(timespec="seconds"),
        "candidates": candidates,
    }
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(doc, indent=2))
    logger.info("Shortlist (%d candidates) written: %s", len(candidates), path)


def _num(v, places: int = 4) -> str:
    return "N/A" if v is None else f"{float(v):.{places}f}"


def _render_table(headers: tuple, rows: list[tuple], footnote: str) -> None:
    widths = [
        max(len(str(h)), max((len(str(row[i])) for row in rows), default=0))
        for i, h in enumerate(headers)
    ]

    def line(cells):
        return "  ".join(str(c).ljust(w) for c, w in zip(cells, widths)).rstrip()

    sep = "-" * (sum(widths) + 2 * (len(widths) - 1))
    print("\n".join(["", sep, line(headers), sep] + [line(r) for r in rows] + [sep, footnote, ""]))


def print_preopt_table(records: list[dict], metric: str, top_n: int) -> None:
    shown = records[:top_n]
    rows = [
        (
            f"{i}{'*' if i == 1 else ''}",
            r.get("model", "?"),
            (r.get("run_name") or "")[:32],
            _num(r.get("val_accuracy")),
            _num(r.get("val_f1_macro")),
            _num(r.get("model_size_kb"), 1),
            _num(r.get("_rank_metric")),
            r["run_id"][:12],
        )
        for i, r in enumerate(shown, start=1)
    ]
    headers = ("#", "Model", "Run name", "Accuracy", "F1-macro", "Size(KB)", f"Rank({metric[:12]})", "Run ID")
    _render_table(headers, rows, f"  * = Shortlist #1 | top {len(shown)} of {len(records)} qualifying run(s).")
