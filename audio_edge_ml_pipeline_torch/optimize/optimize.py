"""Stage 6 — optimization benchmark CLI.

Counterpart of the JAX package's ``optimize/optimize.py``, with the same
flags and outputs, plus ``--device``. Per shortlist candidate: locate the
model file, load it on the device, build an fp32 baseline, run every
quantization mode, evaluate each on the eval FeatureSet (re-baselining fp32
on the same split), pick the smallest mode within --max-accuracy-drop (fp32
fallback), and write optimization_report.json + per-mode metrics to the
tracking store. Supports --model-path single-model mode, calibration
FeatureSet remapping, and by-class-name eval-set re-encoding.

CLI:
    python -m audio_edge_ml_pipeline_torch.optimize.optimize \
        --shortlist shortlist.json --features <calib dir> \
        [--features-eval <dir>] [--output data/models/optimized] \
        [--max-accuracy-drop 0.05] [--target-device arduino_nicla_vision] \
        [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
from datetime import datetime
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..features.pipeline import FeaturePipeline
from ..train.tune import apply_class_filter_canonical, encode_labels_by_name
from ..utils import tracking
from ..utils.device import resolve_device
from ..utils.logging import setup_logging
from ..utils.profiling import log_timing_report, stage_timer
from . import quantize as qz

logger = logging.getLogger(__name__)


def _optimize_one(
    candidate: dict,
    X: np.ndarray,
    y: np.ndarray,
    label_names: list[str],
    output_dir: Path,
    max_accuracy_drop: float,
    target_device: str,
    use_tracking: bool,
    X_eval: Optional[np.ndarray] = None,
    y_eval: Optional[np.ndarray] = None,
    device: torch.device | str | None = None,
) -> Optional[dict]:
    if X_eval is None:
        X_eval, y_eval = X, y
    model_name = candidate["model"]
    run_id = candidate.get("run_id", "")
    run_name = candidate.get("run_name", model_name)
    artifact_uri = candidate.get("artifact_uri", "")
    val_acc_orig_train = candidate.get("val_accuracy", 0.0)

    dir_key = run_name if run_name and run_name != model_name else model_name
    model_dir = output_dir / dir_key
    model_dir.mkdir(parents=True, exist_ok=True)

    try:
        model_path = qz.find_model_file(artifact_uri, model_name)
    except FileNotFoundError as exc:
        logger.error("[%s] Cannot find model file: %s", model_name, exc)
        return None
    original_size_kb = model_path.stat().st_size / 1024
    logger.info("[%s] Original model: %s (%.1f KB)", model_name, model_path.name, original_size_kb)

    try:
        trainer = qz.load_trainer_any(model_path, model_name, device=device)
    except Exception as exc:
        logger.error("[%s] Cannot load model: %s", model_name, exc)
        return None

    # fp32 baseline, re-measured on the eval set
    try:
        fp32_view, fp32_path, fp32_size = qz.build_mode(trainer, model_path, "fp32", model_dir, X)
    except Exception as exc:
        logger.error("[%s] fp32 baseline failed: %s", model_name, exc)
        return None
    fp32_metrics = qz.evaluate_model(fp32_view, X_eval, y_eval, label_names)
    logger.info(
        "[%s] fp32         acc=%.4f latency=%.3f ms size=%.1f KB",
        model_name, fp32_metrics["accuracy"], fp32_metrics["latency_ms"], fp32_size,
    )
    reference_acc = fp32_metrics["accuracy"]

    is_deep = model_path.name.endswith(".flax.npz")
    mode_names = qz.DEEP_MODES if is_deep else qz.CLASSICAL_MODES
    modes = {
        "fp32": {"path": fp32_path, "size_kb": fp32_size,
                 "accuracy": fp32_metrics["accuracy"], "latency_ms": fp32_metrics["latency_ms"]}
    }
    for mode in mode_names:
        try:
            view, path, size_kb = qz.build_mode(trainer, model_path, mode, model_dir, X)
            m = qz.evaluate_model(view, X_eval, y_eval, label_names)
            modes[mode] = {"path": path, "size_kb": size_kb, "accuracy": m["accuracy"], "latency_ms": m["latency_ms"]}
            logger.info(
                "[%s] %-12s acc=%.4f latency=%.3f ms size=%.1f KB",
                model_name, mode, m["accuracy"], m["latency_ms"], size_kb,
            )
        except Exception as exc:
            logger.warning("[%s] Mode %r failed (skipping): %s", model_name, mode, exc)

    eligible = {k: v for k, v in modes.items() if reference_acc - v["accuracy"] <= max_accuracy_drop}
    if not eligible:
        eligible = {"fp32": modes["fp32"]}
    best_key = min(eligible, key=lambda k: eligible[k]["size_kb"])
    best = modes[best_key]
    logger.info(
        "[%s] best: %s (%.1f KB, acc=%.4f, drop=%.4f)",
        model_name, best_key, best["size_kb"], best["accuracy"], reference_acc - best["accuracy"],
    )

    benchmark_results = {
        k: {"size_kb": v["size_kb"], "accuracy": v["accuracy"], "latency_ms": v["latency_ms"], "path": Path(v["path"]).name}
        for k, v in modes.items()
    }
    report = {
        "run_id": run_id,
        "run_name": run_name,
        "model_name": model_name,
        "original_model_path": str(model_path),
        "class_filter": candidate.get("class_filter"),
        "feature_params": candidate.get("feature_params"),
        "original_size_kb": original_size_kb,
        "val_accuracy_original_train": val_acc_orig_train,
        "val_accuracy_original": reference_acc,
        "benchmark_results": benchmark_results,
        "optimized_model_path": str(best["path"]),
        "optimized_size_kb": best["size_kb"],
        "compression_ratio": round(original_size_kb / max(best["size_kb"], 1e-9), 3),
        "quantization_method": best_key,
        "target_device": target_device,
        "val_accuracy_optimized": best["accuracy"],
        "accuracy_drop": round(reference_acc - best["accuracy"], 6),
        "latency_ms": best["latency_ms"],
        "timestamp": datetime.now().isoformat(timespec="seconds"),
    }
    report_path = model_dir / "optimization_report.json"
    report_path.write_text(json.dumps(report, indent=2))
    logger.info("[%s] Report -> %s", model_name, report_path)

    if use_tracking:
        with tracking.start_run(run_name=f"opt_{dir_key}") as run:
            run.log_param("model", model_name)
            run.log_param("original_run_id", run_id)
            run.log_param("best_mode", best_key)
            run.log_param("max_accuracy_drop_threshold", max_accuracy_drop)
            run.log_metric("original_size_kb", original_size_kb)
            run.log_metric("val_accuracy_original", reference_acc)
            run.log_metric("val_accuracy_original_train", float(val_acc_orig_train or 0.0))
            for mode_key, mv in modes.items():
                run.log_metric(f"{mode_key}_size_kb", mv["size_kb"])
                run.log_metric(f"{mode_key}_val_accuracy", mv["accuracy"])
                run.log_metric(f"{mode_key}_latency_ms", mv["latency_ms"])
                run.log_metric(f"{mode_key}_accuracy_drop", reference_acc - mv["accuracy"])
                run.log_metric(f"{mode_key}_compression_ratio", original_size_kb / max(mv["size_kb"], 1e-9))
            run.log_metric("best_size_kb", best["size_kb"])
            run.log_metric("best_val_accuracy", best["accuracy"])
            run.log_metric("best_latency_ms", best["latency_ms"])
            run.log_artifact(report_path)
    return report


def _load_eval_set(features_eval: str, label_names: list[str], class_filter, run_label: str):
    """Load the eval FeatureSet, re-encoding labels **by class name** against
    the calibration label order. Classes the calibration set filtered out
    vanish from ``label_names``, so the by-name mapping drops them from the
    eval set too."""
    fs = FeaturePipeline.load(features_eval)
    keep, y_eval = encode_labels_by_name(fs.labels, fs.label_names or [], label_names)
    X_eval = fs.features[keep]
    dropped = len(keep) - int(keep.sum())
    if dropped or (fs.label_names or []) != list(label_names):
        logger.info(
            "[%s] eval labels re-encoded by class name (%d kept, %d dropped)",
            run_label, len(X_eval), dropped,
        )
    return X_eval, y_eval


def main(argv=None) -> None:
    setup_logging()
    parser = argparse.ArgumentParser(
        prog="python -m audio_edge_ml_pipeline_torch.optimize.optimize",
        description="Stage 6 — multi-mode quantization benchmark (emulated, evaluated on the card)",
    )
    parser.add_argument("--shortlist", default=None)
    parser.add_argument("--model-path", default=None)
    parser.add_argument("--model-name", default=None)
    parser.add_argument("--run-name", default=None)
    parser.add_argument("--class-filter", nargs="+", default=None, metavar="CLASS")
    parser.add_argument("--features", default=None, help="FeatureSet dir for INT8 calibration")
    parser.add_argument("--features-eval", default=None, help="held-out FeatureSet dir for accuracy")
    parser.add_argument("--output", "--output-dir", dest="output", default="data/models/optimized")
    parser.add_argument("--experiment", default="ml-pipeline-optimization")
    parser.add_argument("--mlflow-uri", default=None)
    parser.add_argument("--max-accuracy-drop", type=float, default=0.05)
    parser.add_argument("--target-device", default="arduino_nicla_vision")
    parser.add_argument("--no-tracking", action="store_true")
    parser.add_argument("--device", default=None,
                        help="torch device to evaluate on (default: the first CUDA card; 'cpu' runs on the CPU)")
    args = parser.parse_args(argv)

    if not args.shortlist and not args.model_path:
        parser.error("either --shortlist or --model-path is required")
    device = resolve_device(args.device)  # no card and no --device: raise before any candidate

    if args.model_path:
        if not args.model_name:
            parser.error("--model-name is required with --model-path")
        candidates = [
            {
                "model": args.model_name,
                "run_name": args.run_name or args.model_name,
                "run_id": "",
                "artifact_uri": str(Path(args.model_path).parent),
                "class_filter": args.class_filter,
                "features_dir": args.features,
                "features_eval_dir": args.features_eval,
            }
        ]
    else:
        sl = json.loads(Path(args.shortlist).read_text())
        candidates = sl.get("candidates", [])
        if not candidates:
            logger.error("Shortlist has no candidates.")
            sys.exit(1)

    use_tracking = not args.no_tracking
    if use_tracking:
        tracking.set_tracking_uri(args.mlflow_uri)
        tracking.set_experiment(args.experiment)

    output_dir = Path(args.output)
    reports = []
    for candidate in candidates:
        run_label = candidate.get("run_name") or candidate.get("model", "?")
        features_dir = args.features or candidate.get("features_dir")
        if not features_dir or not Path(features_dir).exists():
            logger.error("[%s] No calibration FeatureSet (--features or shortlist features_dir).", run_label)
            continue
        fs = FeaturePipeline.load(features_dir)
        X, y, label_names = fs.features, fs.labels, fs.label_names or []
        class_filter = candidate.get("class_filter") or args.class_filter
        if isinstance(class_filter, str):
            try:
                class_filter = json.loads(class_filter)
            except json.JSONDecodeError:
                class_filter = [class_filter]
        if class_filter:
            X, y, label_names = apply_class_filter_canonical(X, y, label_names, class_filter, run_label)

        features_eval = args.features_eval or candidate.get("features_eval_dir")
        X_eval = y_eval = None
        if features_eval and Path(features_eval).exists():
            X_eval, y_eval = _load_eval_set(features_eval, label_names, class_filter, run_label)

        try:
            with stage_timer(f"optimize:{run_label}"):
                report = _optimize_one(
                    candidate, X, y, label_names, output_dir,
                    args.max_accuracy_drop, args.target_device, use_tracking,
                    X_eval=X_eval, y_eval=y_eval, device=device,
                )
            if report:
                reports.append(report)
        except Exception as exc:
            logger.error("[%s] optimization failed: %s", run_label, exc, exc_info=True)

    if not reports:
        logger.error("No optimization reports produced.")
        sys.exit(1)
    log_timing_report()
    logger.info("Optimized %d model(s) -> %s", len(reports), output_dir)


if __name__ == "__main__":
    main()
