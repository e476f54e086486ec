"""Stage 3 — model training CLI.

Counterpart of the JAX package's ``train/train.py``, with the same flags and
YAML schema plus ``--device``: FeatureSet load, class_filter remap to the
canonical name-sorted indices, stratified train/val split with
non-stratified fallback, optional stratified K-fold CV (folds clamped to the
smallest class count) before the final fit, held-out test evaluation,
per-sweep config archival, end-of-sweep auto-select shortlist. Training runs
on the first CUDA card unless ``--device`` names another device; ``cpu``
trains there.

CLI:
    python -m audio_edge_ml_pipeline_torch.train.train --config training.yaml
    python -m audio_edge_ml_pipeline_torch.train.train \\
        --features <featureset dir> --model cnn --output data/models \\
        [--param filters=32] [--features-test <dir>] [--experiment name] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import logging
import shutil
import sys
import tempfile
from datetime import datetime
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..features.pipeline import FeaturePipeline
from ..models import get_model, list_models
from ..utils import tracking
from ..utils.device import resolve_device
from ..utils.logging import setup_logging
from ..utils.profiling import stage_timer
from . import evaluate as ev
from .config import ModelRunConfig, load_train_config
from .split import split_indices, stratified_kfold
from .tune import apply_class_filter_canonical, encode_labels_by_name

logger = logging.getLogger(__name__)


def setup_tracking(uri: Optional[str], experiment: str):
    tracking.set_tracking_uri(uri)
    tracking.set_experiment(experiment)
    logger.info("Tracking backend: %s  experiment: %s", tracking.tracking_location(), experiment)


def stratified_train_val_split(X, y, val_split: float, seed: int = 42):
    """Deterministic stratified split, with a non-stratified fallback when
    some class is too small to stratify; the rows scikit-learn's
    ``train_test_split`` picks for the same seed."""
    try:
        train, val = split_indices(len(X), val_split, seed, stratify=y)
    except ValueError:
        train, val = split_indices(len(X), val_split, seed)
    return X[train], X[val], y[train], y[val]


def _cross_validate(run: ModelRunConfig, trainer_cls, device, X, y, label_names, run_name, active_run) -> None:
    """Stratified K-fold CV for measurement; the final model is trained on
    the main split afterwards."""
    counts = np.bincount(y)
    min_class_n = int(counts[counts > 0].min())
    folds = min(run.cv_folds, min_class_n)
    if folds < run.cv_folds:
        logger.warning("[%s] cv_folds=%d reduced to %d — smallest class has only %d samples.",
                       run.name, run.cv_folds, folds, min_class_n)
    if folds < 2:
        logger.warning("[%s] CV skipped: %d usable fold(s) (stratified K-fold needs >= 2).", run.name, folds)
        return
    active_run.log_param("cv_folds", folds)
    cv_seed = run.cv_random_state if run.cv_random_state is not None else 42
    active_run.log_param("cv_random_state", cv_seed)
    fold_metrics = []
    with tempfile.TemporaryDirectory(prefix="cv_fold_") as tmp:
        for fold_i, (tr_idx, vl_idx) in enumerate(stratified_kfold(y, folds, cv_seed), 1):
            fold_trainer = trainer_cls(**run.params, device=device)
            fold_trainer.fit(X[tr_idx], y[tr_idx], X[vl_idx], y[vl_idx],
                             label_names, f"{run_name}_cv{fold_i}", Path(tmp) / f"fold_{fold_i}", None)
            m = ev.compute_metrics(y[vl_idx], fold_trainer.predict(X[vl_idx]),
                                   fold_trainer.predict_proba(X[vl_idx]), label_names)
            fold_metrics.append(m)
            logger.info("[%s] CV fold %d/%d — accuracy=%.4f  f1=%.4f",
                        run.name, fold_i, folds, m["val_accuracy"], m["val_f1_macro"])
    for k in [k for k, v in fold_metrics[0].items() if isinstance(v, (int, float))]:
        vals = [m[k] for m in fold_metrics]
        active_run.log_metric(f"cv_{k}_mean", float(np.mean(vals)))
        active_run.log_metric(f"cv_{k}_std", float(np.std(vals)))
    accs = [m["val_accuracy"] for m in fold_metrics]
    logger.info("[%s] CV complete (%d folds) — accuracy=%.4f±%.4f", run.name, folds, np.mean(accs), np.std(accs))


def _evaluate_test_set(run: ModelRunConfig, trainer, label_names, active_run) -> None:
    test_dir = Path(run.features_test_dir)
    logger.info("[%s] Evaluating on test set: %s", run.name, test_dir)
    test_fs = FeaturePipeline.load(test_dir)
    if test_fs.labels is None:
        return
    # re-encode test labels by class NAME against the (possibly
    # class-filtered) training label order
    keep, y_test = encode_labels_by_name(test_fs.labels, test_fs.label_names or label_names, label_names)
    X_test = test_fs.features[keep]
    test_metrics = ev.compute_metrics(y_test, trainer.predict(X_test), trainer.predict_proba(X_test), label_names)
    for k, v in test_metrics.items():
        if isinstance(v, (int, float)):
            active_run.log_metric(f"test_{k}", float(v))
    logger.info("[%s] Test accuracy: %.4f  F1-macro: %.4f",
                run.name, test_metrics["val_accuracy"], test_metrics["val_f1_macro"])


def run_one(
    run: ModelRunConfig,
    experiment: str,
    mlflow_uri: Optional[str],
    max_samples: Optional[int] = None,
    config_path: Optional[Path] = None,
    device: torch.device | str | None = None,
) -> None:
    device = resolve_device(device)
    features_dir = Path(run.features_dir)
    logger.info("[%s] Loading features from %s", run.name, features_dir)
    fs = FeaturePipeline.load(features_dir)
    X, y = fs.features, fs.labels
    label_names = fs.label_names or []
    if y is None:
        raise ValueError(f"FeatureSet at '{features_dir}' has no labels. Supervised training requires labelled data.")

    if max_samples and max_samples < len(X):
        rng = np.random.default_rng(42)
        idx = rng.choice(len(X), max_samples, replace=False)
        X, y = X[idx], y[idx]
        logger.info("[%s] Subsampled to %d samples", run.name, max_samples)

    if run.class_filter:
        X, y, label_names = apply_class_filter_canonical(X, y, label_names, run.class_filter, run.name)
        logger.info("[%s] class_filter: keeping %d classes, %d samples", run.name, len(label_names), len(X))

    val_split = run.val_split if run.val_split is not None else 0.2
    X_train, X_val, y_train, y_val = stratified_train_val_split(X, y, val_split)
    logger.info("[%s] Train: %d  Val: %d  Classes: %d", run.name, len(X_train), len(X_val), len(label_names))

    output_dir = Path(run.output_dir) / run.name
    output_dir.mkdir(parents=True, exist_ok=True)

    setup_tracking(mlflow_uri, experiment)
    run_name = f"{run.name}_{datetime.now().strftime('%Y%m%d_%H%M%S')}"

    with tracking.start_run(run_name=run_name) as active_run:
        if config_path is not None:
            active_run.log_artifact(config_path)
        active_run.log_param("features_dir", str(run.features_dir))
        if run.features_test_dir:
            active_run.log_param("features_eval_dir", str(run.features_test_dir))
        if run.class_filter:
            active_run.log_param("class_filter", json.dumps(sorted(run.class_filter)))

        trainer_cls = get_model(run.model)
        trainer = trainer_cls(**run.params, device=device)

        if run.cv_folds:
            _cross_validate(run, trainer_cls, device, X, y, label_names, run_name, active_run)

        with stage_timer(f"fit:{run.model}"):
            result = trainer.fit(
                X_train=X_train, y_train=y_train, X_val=X_val, y_val=y_val,
                label_names=label_names, run_name=run_name, output_dir=output_dir, mlflow_run=active_run,
            )

        if run.features_test_dir:
            # as the JAX CLI: any failure of the test-set evaluation is logged and the run stands. In
            # configs/training.yaml the mlp and rnn runs inherit the CNN's mel test set (``null`` inherits),
            # whose features their models cannot read.
            try:
                _evaluate_test_set(run, trainer, label_names, active_run)
            except Exception as exc:
                logger.warning("[%s] Test-set evaluation failed: %s", run.name, exc)

        logger.info(
            "[%s] Done — val_accuracy=%.4f  val_f1_macro=%.4f  size=%.1f KB",
            run.name,
            result.metrics.get("val_accuracy", float("nan")),
            result.metrics.get("val_f1_macro", float("nan")),
            result.model_size_kb,
        )


def _auto_select(experiment, mlflow_uri, output_dir: Path, metric="val_f1_macro",
                 min_accuracy=None, top_n=5, n_runs=1) -> None:
    """Write shortlist.json after a sweep (skipped for single runs; failures
    are logged and do not fail the sweep)."""
    if n_runs <= 1:
        return
    from .select import select_preopt, write_shortlist

    try:
        candidates = select_preopt(
            experiment=experiment, mlflow_uri=mlflow_uri, metric=metric,
            min_accuracy=min_accuracy, top_n=top_n,
        )
        if candidates:
            safe_name = experiment.replace("/", "_").replace(" ", "_")
            scoped = Path(output_dir) / f"shortlists/shortlist_{safe_name}.json"
            write_shortlist(candidates, scoped, experiment, metric)
            write_shortlist(candidates, Path(output_dir) / "shortlist.json", experiment, metric)
            logger.info("Shortlist -> %s", scoped)
        else:
            logger.warning("Auto-select: no qualifying runs found in experiment %r.", experiment)
    except Exception as exc:  # the sweep's runs are done; a failed shortlist must not fail it
        logger.warning("Auto-select failed (non-fatal): %s", exc, exc_info=True)


def parse_param(s: str):
    """key=value with int -> float -> bool -> str coercion; JSON lists pass
    through (e.g. filters=[16,64])."""
    if "=" not in s:
        raise argparse.ArgumentTypeError(f"--param must be 'key=value', got '{s}'")
    k, v = s.split("=", 1)
    v = v.strip()
    if v.startswith("[") or v.startswith("{"):
        try:
            return k.strip(), json.loads(v)
        except json.JSONDecodeError:
            pass
    for cast in (int, float):
        try:
            return k.strip(), cast(v)
        except ValueError:
            pass
    if v.lower() in ("true", "yes"):
        return k.strip(), True
    if v.lower() in ("false", "no"):
        return k.strip(), False
    return k.strip(), v


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m audio_edge_ml_pipeline_torch.train.train",
        description="Stage 3 — Model Training",
    )
    p.add_argument("--config", metavar="YAML")
    p.add_argument("--features", metavar="DIR")
    p.add_argument("--features-test", metavar="DIR")
    p.add_argument("--model", metavar="NAME")
    p.add_argument("--output", metavar="DIR", default="data/models")
    p.add_argument("--val-split", type=float, default=0.2)
    p.add_argument("--experiment", default="ml-pipeline")
    p.add_argument("--run-name", metavar="NAME")
    p.add_argument("--max-samples", type=int, metavar="N")
    p.add_argument("--param", action="append", dest="params", metavar="KEY=VALUE", type=parse_param, default=[])
    p.add_argument("--no-auto-select", action="store_true")
    p.add_argument("--device", default=None,
                   help="torch device to train on (default: the first CUDA card; 'cpu' trains on the CPU)")
    return p


def main(argv: Optional[list[str]] = None) -> None:
    setup_logging()
    parser = build_parser()
    args = parser.parse_args(argv)
    device = resolve_device(args.device)  # no card and no --device: raise before any run starts

    if args.config:
        cfg = load_train_config(Path(args.config))
        runs = cfg.resolved_runs()
        if not runs:
            logger.error("No runs defined in %s", args.config)
            sys.exit(1)
        logger.info("Config sweep: %d run(s) in experiment %r", len(runs), cfg.experiment)
        experiments_dir = Path("config/experiments")
        experiments_dir.mkdir(parents=True, exist_ok=True)
        archive = experiments_dir / f"{cfg.experiment.replace('/', '_').replace(' ', '_')}.yaml"
        if Path(args.config).resolve() != archive.resolve():
            shutil.copy2(args.config, archive)
            logger.info("Config archived -> %s", archive)
        for run in runs:
            try:
                run_one(run, cfg.experiment, cfg.mlflow_uri, config_path=Path(args.config), device=device)
            except Exception as exc:  # skip-and-continue: one failed run must not end the sweep
                logger.error("Run %r failed: %s", run.name, exc, exc_info=True)
        if cfg.auto_select and not args.no_auto_select:
            _auto_select(
                cfg.experiment, cfg.mlflow_uri, Path(cfg.output_dir),
                metric=cfg.auto_select_metric, min_accuracy=cfg.auto_select_min_accuracy,
                top_n=cfg.auto_select_top_n, n_runs=len(runs),
            )
        return

    if not args.features:
        parser.error("--features is required when not using --config")
    if not args.model:
        parser.error(f"--model is required. Available: {', '.join(list_models())}")
    run = ModelRunConfig(
        model=args.model,
        name=args.run_name or args.model,
        features_dir=args.features,
        features_test_dir=args.features_test,
        output_dir=args.output,
        val_split=args.val_split,
        params=dict(args.params) if args.params else {},
    )
    run_one(run, args.experiment, mlflow_uri=None, max_samples=args.max_samples, device=device)


if __name__ == "__main__":
    main()
