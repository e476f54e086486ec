"""Stage 5 — model selection (two-checkpoint design).

Counterpart of the JAX package's ``train/select.py``, the same CLI and files:

1. Pre-optimisation: rank FINISHED tracking runs by a quality metric with an
   optional accuracy floor -> shortlist.json (including the
   ``_train -> _val`` features_eval_dir convention). The train and tune
   CLIs' end-of-sweep auto-select call it too.
2. Post-optimisation: read Stage 6 optimization_report.json files, apply the
   hard --max-size-kb bound against real optimized sizes, rank (ascending
   for latency metrics), write best_model.json.

Host only: it reads the tracking store and JSON files, nothing runs on a
device.

CLI:
    python -m audio_edge_ml_pipeline_torch.train.select --experiment <name>
        [--min-accuracy 0.7] [--metric val_f1_macro] [--top-n 5]
        [--output shortlist.json]
    python -m audio_edge_ml_pipeline_torch.train.select --post-opt
        --shortlist shortlist.json --opt-dir data/models/optimized
        [--max-size-kb 256] [--metric val_accuracy_optimized] [--ascending]
"""

from __future__ import annotations

import argparse
import json
import logging
from datetime import datetime
from pathlib import Path
from typing import Optional

from ..utils import tracking
from ..utils.logging import setup_logging

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


# ---------------------------------------------------------------------------
# Post-optimisation checkpoint
# ---------------------------------------------------------------------------


def _report_for(opt_dir: Path, candidate: dict) -> Optional[dict]:
    """Locate and parse the Stage-6 report for a shortlist candidate (run
    name preferred, model name as fallback)."""
    for label in (candidate.get("run_name"), candidate.get("model")):
        if not label:
            continue
        p = Path(opt_dir) / label / "optimization_report.json"
        if p.exists():
            return json.loads(p.read_text())
    return None


def select_postopt(
    shortlist_path: Path,
    opt_dir: Path,
    max_size_kb: Optional[float] = None,
    metric: str = "val_accuracy_optimized",
    ascending: bool = False,
) -> Optional[dict]:
    shortlist_path = Path(shortlist_path)
    if not shortlist_path.exists():
        raise FileNotFoundError(f"Shortlist not found: {shortlist_path}")
    candidates = json.loads(shortlist_path.read_text()).get("candidates", [])
    if not candidates:
        logger.warning("Shortlist is empty — nothing to evaluate.")
        return None

    qualified: list[dict] = []
    for candidate in candidates:
        label = candidate.get("run_name") or candidate.get("model") or "?"
        report = _report_for(Path(opt_dir), candidate)
        if report is None:
            logger.warning("No optimization_report.json under %s for %r — skipping.", opt_dir, label)
            continue
        size = report.get("optimized_size_kb")
        if max_size_kb is not None and size is not None and size > max_size_kb:
            logger.info("%r exceeds the size bound (%.1f > %.1f KB) — dropped.", label, size, max_size_kb)
            continue
        value = report.get(metric)
        if value is None:
            continue
        report["_rank_metric"] = float(value)
        report["_shortlist_candidate"] = candidate
        qualified.append(report)

    if not qualified:
        return None
    qualified.sort(key=lambda r: r["_rank_metric"], reverse=not ascending)
    _print_postopt_table(qualified, metric, ascending)
    return qualified[0]


def write_best(report: dict, path: Path, experiment: str) -> None:
    # best_model.json contract
    candidate = report.get("_shortlist_candidate", {})
    doc = {
        "run_id": report.get("run_id") or candidate.get("run_id"),
        "run_name": report.get("run_name") or candidate.get("run_name"),
        "model": report.get("model_name") or candidate.get("model"),
        "optimized_model_path": report.get("optimized_model_path"),
        "original_size_kb": report.get("original_size_kb"),
        "optimized_size_kb": report.get("optimized_size_kb"),
        "compression_ratio": report.get("compression_ratio"),
        "quantization_method": report.get("quantization_method"),
        "val_accuracy_original": report.get("val_accuracy_original"),
        "val_accuracy_optimized": report.get("val_accuracy_optimized"),
        "accuracy_drop": report.get("accuracy_drop"),
        "latency_ms": report.get("latency_ms"),
        "params": candidate.get("params", {}),
        "experiment": experiment,
    }
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(doc, indent=2))
    logger.info("Best model written: %s", path)


# ---------------------------------------------------------------------------
# ASCII tables
# ---------------------------------------------------------------------------


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


def _print_postopt_table(results: list[dict], metric: str, ascending: bool) -> None:
    rows = [
        (
            f"{i}{'*' if i == 1 else ''}",
            (r.get("run_name") or r.get("model_name") or "?")[:32],
            _num(r.get("optimized_size_kb"), 1),
            _num(r.get("original_size_kb"), 1),
            _num(r.get("val_accuracy_optimized")),
            _num(r.get("accuracy_drop")),
            _num(r.get("_rank_metric")),
        )
        for i, r in enumerate(results, start=1)
    ]
    order = "asc" if ascending else "desc"
    headers = ("#", "Run name", "Opt KB", "Orig KB", "Acc(opt)", "Acc drop", f"Rank({metric[:10]}) {order}")
    _render_table(headers, rows, f"  * = Best post-optimisation model | {len(results)} model(s) evaluated.")


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m audio_edge_ml_pipeline_torch.train.select",
        description="Stage 5 — Model Selection (two-checkpoint design)",
    )
    p.add_argument("--post-opt", action="store_true")
    p.add_argument("--experiment", default="ml-pipeline")
    p.add_argument("--mlflow-uri", default=None)
    p.add_argument("--metric", default=None)
    p.add_argument("--min-accuracy", type=float, default=None)
    p.add_argument("--top-n", type=int, default=5)
    p.add_argument("--output", default=None)
    p.add_argument("--features-eval-dir", dest="features_eval_dir", default=None,
                   help="override every candidate's features_eval_dir")
    p.add_argument("--shortlist", default=None)
    p.add_argument("--opt-dir", default=None)
    p.add_argument("--max-size-kb", type=float, default=None)
    p.add_argument("--ascending", "--sort-asc", dest="ascending", action="store_true",
                   help="rank ascending (for cost metrics like latency_ms)")
    return p


def main(argv=None) -> None:
    setup_logging()
    args = build_parser().parse_args(argv)
    if args.post_opt:
        if not args.shortlist or not args.opt_dir:
            build_parser().error("--post-opt requires --shortlist and --opt-dir")
        best = select_postopt(
            Path(args.shortlist), Path(args.opt_dir),
            max_size_kb=args.max_size_kb,
            metric=args.metric or "val_accuracy_optimized",
            ascending=args.ascending,
        )
        if best is None:
            print("No model qualified post-optimisation.")
            return
        out = Path(args.output or Path(args.opt_dir) / "best_model.json")
        experiment = json.loads(Path(args.shortlist).read_text()).get("experiment", "")
        write_best(best, out, experiment)
    else:
        metric = args.metric or "val_f1_macro"
        candidates = select_preopt(
            experiment=args.experiment, mlflow_uri=args.mlflow_uri,
            metric=metric, min_accuracy=args.min_accuracy, top_n=args.top_n,
        )
        print_preopt_table(candidates, metric, args.top_n)
        if candidates:
            out = Path(args.output or "data/models/shortlist.json")
            write_shortlist(candidates, out, args.experiment, metric,
                            features_eval_dir_override=args.features_eval_dir)


if __name__ == "__main__":
    main()
