"""Stage 4 — unified hyperparameter search CLI.

Counterpart of the JAX package's ``train/tune.py``, with its YAML schema and
outputs plus ``--device``. Dispatch by registered model_type:

  classical -> the fold-batched device grid search (``search_cv.py``) for
               svm / lda / knn / pca_*; GridSearchCV (scikit-learn) with the
               friendly->Pipeline param remap (_PARAM_PREFIXES) for the trees
  deep      -> TPE search (``search.py``) + median / Hyperband pruner with
               per-epoch pruning callbacks, the search-space DSL (list ->
               categorical; dict {type: categorical/float/uniform/
               loguniform/int}), JSON-encoded list-valued categoricals; with
               ``tune_parallel`` > 1 the cnn / mlp / ds_cnn / rnn / transformer trials train in
               batched rounds (``tune_batched.py``) and the winner is refit

plus: the canonical class-name-sorted label encoding of the class filter,
held-out test evaluation of the best run, the shortlist.json writer
(``shortlist.json`` and ``shortlists/shortlist_<experiment>.json``), the
config archived under ``config/experiments/``, and per-run catch-all error
handling: a run that fails is logged and the others go on, a trial that
raises is marked FAIL, a failed winner refit only warns (as in JAX).

Everything runs on the first CUDA card unless ``--device`` names another
device; ``cpu`` tunes there. With no card and no ``--device`` it raises
before any run starts. With ``tune_parallel`` > 1 and several cards, a
grid cell's folds and a round's trials split over min(tune_parallel,
cards) of them (``search_cv.py``, ``tune_batched.py``), as JAX shards them.

CLI: python -m audio_edge_ml_pipeline_torch.train.tune --config tuning.yaml [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import logging
import math
import shutil
import sys
from datetime import datetime
from pathlib import Path
from typing import Optional

import numpy as np
import torch
import yaml

from ..features.pipeline import FeaturePipeline
from ..models import get_model
from ..utils import tracking
from ..utils.device import resolve_device
from ..utils.logging import setup_logging
from . import search
from .evaluate import (
    compute_metrics,
    log_run_to_mlflow,
    save_classification_report,
    save_confusion_matrix_png,
    save_model_info,
)

logger = logging.getLogger(__name__)


def _cfg(run_cfg: dict, defaults: dict, key: str, fallback=None):
    """Per-run value with study-level default fallback."""
    value = run_cfg.get(key)
    return value if value is not None else defaults.get(key, fallback)


# ===========================================================================
# classical branch: device grid search, or GridSearchCV for the trees
# ===========================================================================


def _build_estimator(model_name: str):
    """The sklearn estimator factory of a tree trainer (the only classical
    models that do not tune on the device)."""
    from ..models.classical import _sklearn_class

    factories = {
        "decision_tree": lambda: _sklearn_class(model_name, "sklearn.tree", "DecisionTreeClassifier")(
            class_weight="balanced"),
        "random_forest": lambda: _sklearn_class(model_name, "sklearn.ensemble", "RandomForestClassifier")(
            class_weight="balanced", n_jobs=-1, random_state=42),
    }
    try:
        factory = factories[model_name]
    except KeyError:
        raise ValueError(
            f"no estimator factory registered for {model_name!r}; choose one of {sorted(factories)}"
        ) from None
    factory()  # raises here, naming scikit-learn and the trainer, where it is not installed
    return factory


# friendly grid keys -> sklearn Pipeline step__param addressing
_PARAM_PREFIXES: dict[str, dict[str, str]] = {
    "pca_svm": {"n_components": "pca__n_components", "C": "svm__C", "kernel": "svm__kernel", "gamma": "svm__gamma"},
    "pca_lda": {"n_components": "pca__n_components", "n_components_lda": "lda__n_components", "solver": "lda__solver"},
    "pca_knn": {"n_components": "pca__n_components", "n_neighbors": "knn__n_neighbors", "metric": "knn__metric"},
}


def _remap_param_grid(model_name: str, param_grid: dict) -> dict:
    aliases = _PARAM_PREFIXES.get(model_name)
    if not aliases:
        return dict(param_grid)
    return {aliases.get(key, key): grid for key, grid in param_grid.items()}


def encode_labels_by_name(y, source_names, target_names):
    """Vectorized by-NAME label re-encoding: map integer labels encoded
    against ``source_names`` onto the ``target_names`` ordering, dropping
    samples whose class has no slot in the target. Returns ``(keep_mask,
    remapped_labels)``.

    Two loaders may order the same classes differently (audio_folder is
    alphabetical, FSC22Loader follows the metadata CSV), so reusing integer
    codes across FeatureSets scrambles labels.
    """
    slot = {name: j for j, name in enumerate(target_names)}
    lut = np.array([slot.get(name, -1) for name in source_names], dtype=np.int64)
    remapped = lut[np.asarray(y, dtype=np.int64)]
    keep = remapped >= 0
    return keep, remapped[keep].astype(np.int32)


def apply_class_filter_canonical(X, y, label_names, class_filter, run_label: str):
    """Restrict a FeatureSet to ``class_filter`` under the canonical
    **name-sorted** integer encoding (sorting by class name makes the
    encoding loader-order independent)."""
    if not class_filter:
        return X, y, label_names
    wanted = set(class_filter)
    kept_names = sorted(wanted.intersection(label_names))
    if not kept_names:
        raise ValueError(
            f"[{run_label}] none of class_filter={sorted(wanted)} occur in {label_names}"
        )
    absent = wanted.difference(label_names)
    if absent:
        logger.warning("[%s] class_filter names absent from dataset: %s", run_label, sorted(absent))
    keep, y_new = encode_labels_by_name(y, label_names, kept_names)
    logger.info(
        "[%s] class filter kept %d/%d classes, %d/%d samples",
        run_label, len(kept_names), len(label_names), int(keep.sum()), len(y),
    )
    return X[keep], y_new, kept_names


def _split(X, y, val_split, seed=42):
    # the train CLI's stratified-with-fallback split (imported here: train.py imports this module)
    from .train import stratified_train_val_split

    return stratified_train_val_split(X, y, val_split, seed=seed)


def _tune_classical(run_cfg: dict, default_cfg: dict, device: torch.device) -> Optional[dict]:
    model_name = run_cfg["model"]
    run_label = run_cfg.get("name") or model_name
    features_dir = Path(_cfg(run_cfg, default_cfg, "features_dir", ""))
    features_test_raw = _cfg(run_cfg, default_cfg, "features_test")
    output_dir = Path(_cfg(run_cfg, default_cfg, "output_dir")) / run_label
    val_split = float(_cfg(run_cfg, default_cfg, "val_split", 0.2))
    cv = int(_cfg(run_cfg, default_cfg, "cv", 5))
    scoring = str(_cfg(run_cfg, default_cfg, "scoring", "f1_macro"))
    param_grid = run_cfg.get("grid") or {}
    class_filter = _cfg(run_cfg, default_cfg, "class_filter") or None

    fs = FeaturePipeline.load(features_dir)
    X, y, label_names = fs.features, fs.labels, fs.label_names or []
    if y is None:
        logger.error("[%s] unlabeled FeatureSet — grid search needs labels, skipping", run_label)
        return None
    X, y, label_names = apply_class_filter_canonical(X, y, label_names, class_filter, run_label)
    X_flat = X.reshape(len(X), -1).astype(np.float32)
    X_train, X_val, y_train, y_val = _split(X_flat, y, val_split)
    n_combos = math.prod(len(v) for v in param_grid.values()) if param_grid else 1

    from . import search_cv

    on_device = model_name in search_cv.DEVICE_TUNABLE
    if on_device:
        # every fold of a cell in ONE batch on the device; the OvO layout and
        # each n_components' PCA are built once per search
        tune_parallel = int(_cfg(run_cfg, default_cfg, "tune_parallel", 1) or 1)
        logger.info("[%s] grid-device: %d combination(s), %d folds batched on %s%s",
                    run_label, n_combos, cv, device,
                    f" across {tune_parallel} devices" if tune_parallel > 1 else "")
        best_estimator, best_params, cv_best_score = search_cv.grid_search_cv_device(
            model_name, param_grid, X_train, y_train, cv=cv, scoring=scoring,
            devices=tune_parallel, device=device,
        )
    else:
        logger.info("[%s] GridSearchCV: %d combination(s) x %d folds = %d fits",
                    run_label, n_combos, cv, n_combos * cv)
        best_estimator, best_params, cv_best_score = search.grid_search_cv(
            _build_estimator(model_name), _remap_param_grid(model_name, param_grid),
            X_train, y_train, cv=cv, scoring=scoring,
        )
    logger.info("[%s] Best CV %s = %.4f -> %s", run_label, scoring, cv_best_score, dict(best_params))

    y_pred_val = best_estimator.predict(X_val)
    y_proba_val = None
    if hasattr(best_estimator, "predict_proba"):
        try:
            y_proba_val = best_estimator.predict_proba(X_val)
        except Exception:
            pass
    val_metrics = compute_metrics(y_val, y_pred_val, y_proba_val, label_names)

    test_metrics: dict = {}
    if features_test_raw and Path(features_test_raw).exists():
        # a failed test-set evaluation is logged and the run stands, as in the
        # deep branch and the train CLI: in configs/tuning.yaml the pca_svm run's
        # `features_test: null` inherits the cnn's mel test set, which its
        # model cannot read (the JAX CLI fails the whole run there)
        try:
            test_fs = FeaturePipeline.load(features_test_raw)
            if test_fs.labels is not None:
                # re-encode test labels by class NAME against the training
                # ordering: the test set may come from a loader with another order
                keep, y_test_f = encode_labels_by_name(
                    test_fs.labels, test_fs.label_names or [], label_names
                )
                X_test_f = test_fs.features.reshape(len(test_fs.features), -1).astype(np.float32)[keep]
                test_metrics = compute_metrics(y_test_f, best_estimator.predict(X_test_f), None, label_names)
                logger.info(
                    "[%s] Test accuracy=%.4f f1_macro=%.4f (n=%d)",
                    run_label, test_metrics["val_accuracy"], test_metrics["val_f1_macro"], len(y_test_f),
                )
        except Exception as exc:
            logger.warning("[%s] Test-set evaluation failed: %s", run_label, exc)

    output_dir.mkdir(parents=True, exist_ok=True)
    if on_device:
        model_path = output_dir / f"{model_name}.npz"
        best_estimator.save(model_path)
    else:
        import joblib

        model_path = output_dir / f"{model_name}.joblib"
        joblib.dump(best_estimator, model_path)
    model_size_kb = model_path.stat().st_size / 1024

    run_name = f"{run_label}_{datetime.now().strftime('%Y%m%d_%H%M%S')}"
    params_str = {"model": model_name, **{k: str(v) for k, v in best_params.items()}}
    save_classification_report(y_val, y_pred_val, label_names, output_dir / "classification_report.txt")
    save_confusion_matrix_png(val_metrics.get("confusion_matrix", []), label_names, output_dir / "confusion_matrix.png")
    save_model_info(output_dir, model_name, run_name, val_metrics, params_str, model_size_kb)

    with tracking.start_run(run_name=run_name) as active_run:
        log_run_to_mlflow(
            active_run,
            {"model": model_name, "cv_folds": str(cv), "cv_scoring": scoring,
             "features_dir": str(features_dir), **params_str},
            {**val_metrics, "cv_best_score": cv_best_score, "model_size_kb": model_size_kb},
            output_dir,
        )
        for k, v in test_metrics.items():
            if isinstance(v, (int, float)):
                active_run.log_metric(f"test_{k}", float(v))
        active_run.log_artifact(model_path)
        run_id = active_run.info.run_id

    return {
        "model": model_name, "run_name": run_name, "run_id": run_id,
        "val_accuracy": val_metrics.get("val_accuracy", 0.0),
        "val_f1_macro": val_metrics.get("val_f1_macro", 0.0),
        "cv_best_score": cv_best_score, "model_size_kb": model_size_kb,
        "best_params": params_str, "artifact_uri": str(output_dir),
        "features_dir": str(features_dir), "features_test": str(features_test_raw or ""),
        "class_filter": class_filter or None,
    }


# ===========================================================================
# deep branch: TPE search over the YAML search-space DSL
# ===========================================================================


def _draw_categorical(trial: search.Trial, name: str, choices):
    """The sampler needs hashable primitives, so list-valued options are
    keyed by their JSON text; the winning key is mapped back to the original
    object by position."""
    keys = [json.dumps(c) if isinstance(c, (list, tuple)) else c for c in choices]
    pick = trial.suggest_categorical(name, keys)
    chosen = choices[keys.index(pick)]
    return list(chosen) if isinstance(chosen, tuple) else chosen


def sample_search_space(trial: search.Trial, search_space: dict) -> dict:
    """YAML search-space DSL -> trial draws: a bare list is a categorical; a
    dict selects a distribution through its ``type`` key (categorical /
    float / uniform / loguniform / int)."""
    drawn: dict = {}
    for name, spec in search_space.items():
        if isinstance(spec, list):
            spec = {"type": "categorical", "choices": spec}
        if not isinstance(spec, dict):
            raise ValueError(f"search_space entry {name!r} must be a list or dict, got {spec!r}")
        kind = str(spec.get("type", "categorical")).lower()
        if kind == "categorical":
            drawn[name] = _draw_categorical(trial, name, spec["choices"])
            continue
        if kind == "int":
            drawn[name] = trial.suggest_int(
                name, int(spec["low"]), int(spec["high"]), step=int(spec.get("step", 1))
            )
            continue
        lo, hi = float(spec["low"]), float(spec["high"])
        if kind in ("float", "uniform"):
            drawn[name] = trial.suggest_float(name, lo, hi, step=spec.get("step"))
        elif kind == "loguniform":
            drawn[name] = trial.suggest_float(name, lo, hi, log=True)
        else:
            raise ValueError(
                f"search_space entry {name!r}: unknown type {kind!r} "
                "(expected categorical, float, uniform, loguniform or int)"
            )
    return drawn


def _tune_deep(run_cfg: dict, default_cfg: dict, device: torch.device) -> Optional[dict]:
    model_name = run_cfg["model"]
    run_label = run_cfg.get("name") or model_name
    features_dir = Path(_cfg(run_cfg, default_cfg, "features_dir", ""))
    features_test_raw = _cfg(run_cfg, default_cfg, "features_test")
    output_dir = Path(_cfg(run_cfg, default_cfg, "output_dir")) / run_label
    val_split = float(_cfg(run_cfg, default_cfg, "val_split", 0.2))
    n_trials = int(_cfg(run_cfg, default_cfg, "n_trials", 20))
    sweep_epochs = int(_cfg(run_cfg, default_cfg, "sweep_epochs", 25))
    seed = int(default_cfg.get("seed", 42))
    pruner_name = str(_cfg(run_cfg, default_cfg, "pruner", "median")).lower()
    search_space = run_cfg.get("search_space") or {}
    class_filter = _cfg(run_cfg, default_cfg, "class_filter") or None

    fs = FeaturePipeline.load(features_dir)
    X, y, label_names = fs.features, fs.labels, fs.label_names or []
    if y is None:
        logger.error("[%s] unlabeled FeatureSet — tuning needs labels, skipping", run_label)
        return None
    X, y, label_names = apply_class_filter_canonical(X, y, label_names, class_filter, run_label)
    X_train, X_val, y_train, y_val = _split(X, y, val_split, seed)

    pruner_map = {
        "median": lambda: search.MedianPruner(n_startup_trials=5, n_warmup_steps=10),
        "hyperband": lambda: search.HyperbandPruner(max_resource=sweep_epochs),
        "none": lambda: search.NopPruner(),
        "nop": lambda: search.NopPruner(),
    }
    study = search.create_study(
        direction="maximize", sampler=search.TPESampler(seed=seed),
        pruner=pruner_map.get(pruner_name, pruner_map["median"])(), study_name=run_label,
    )
    trial_records: dict[int, dict] = {}
    refit_mode = {"on": False}
    if "epochs" in (search_space or {}):
        logger.info(
            "[%s] search space samples `epochs`: sweep trials still train "
            "sweep_epochs=%d; the sampled value applies at the winner refit", run_label, sweep_epochs,
        )

    def objective(trial: search.Trial) -> float:
        sampled = sample_search_space(trial, search_space) if search_space else {}
        fixed = run_cfg.get("params") or {}
        trial_params = {**fixed, **sampled}
        trial_num = trial.number
        trial_run_name = f"{run_label}_t{trial_num:02d}_{datetime.now().strftime('%Y%m%d_%H%M%S')}"
        trial_dir = output_dir / f"trial_{trial_num:02d}"
        logger.info("[%s] Trial %d/%d  %s", run_label, trial_num + 1, n_trials, trial_params)

        pruned = {"flag": False}

        def epoch_cb(epoch, logs):
            trial.report(logs.get("val_accuracy", 0.0), step=epoch)
            if trial.should_prune():
                pruned["flag"] = True
                return True
            return False

        # sweep_epochs is THE trial budget; a sampled/fixed `epochs` applies
        # only when the winner is refit for its artifacts (refit_mode)
        fit_epochs = int(trial_params.get("epochs", sweep_epochs)) if refit_mode["on"] else sweep_epochs
        trainer = get_model(model_name)(
            epochs=fit_epochs, device=device, **{k: v for k, v in trial_params.items() if k != "epochs"}
        )
        with tracking.start_run(run_name=trial_run_name) as active_run:
            active_run.log_param("optuna_trial", trial_num)
            active_run.log_param("features_dir", str(features_dir))
            result = trainer.fit(
                X_train, y_train, X_val, y_val,
                label_names=label_names, run_name=trial_run_name,
                output_dir=trial_dir, mlflow_run=active_run, epoch_callback=epoch_cb,
            )
            run_id = active_run.info.run_id
        if pruned["flag"]:
            raise search.TrialPruned()
        score = result.metrics.get("val_f1_macro", 0.0)
        trial.report(score, step=sweep_epochs)
        trial_records[trial_num] = {
            "trial": trial_num, "run_id": run_id, "run_name": trial_run_name,
            "model": model_name,
            "val_accuracy": result.metrics.get("val_accuracy", 0.0),
            "val_f1_macro": score, "cv_best_score": None,
            "model_size_kb": result.model_size_kb,
            "best_params": {k: str(v) for k, v in sampled.items()},
            "artifact_uri": str(trial_dir), "features_dir": str(features_dir),
            "features_test": str(features_test_raw or ""),
            "class_filter": class_filter or None,
        }
        logger.info(
            "[%s] Trial %d  val_accuracy=%.4f  val_f1_macro=%.4f",
            run_label, trial_num + 1, result.metrics.get("val_accuracy", float("nan")), score,
        )
        return score

    tune_parallel = int(_cfg(run_cfg, default_cfg, "tune_parallel", 1) or 1)
    from . import tune_batched

    if tune_parallel > 1 and model_name in tune_batched.BATCHABLE_MODELS:
        # batched ask-tell rounds on the device; the winner is refit through
        # the sequential path below so its artifacts match exactly
        logger.info(
            "[%s] TPE study: %d trial(s) in batched rounds of %d on %s  pruner=%s  epochs/trial=%d",
            run_label, n_trials, tune_parallel, device, pruner_name, sweep_epochs,
        )
        batched_results = tune_batched.run_study_batched(
            study, search_space, run_cfg.get("params") or {}, sample_search_space,
            model_name, X_train, y_train, X_val, y_val, len(label_names),
            n_trials, sweep_epochs, batch_k=tune_parallel, seed=seed,
            devices=tune_parallel, device=device,
        )
        # record EVERY completed trial's sweep metrics in the summary; only
        # the winner gets real artifacts, through the refit below
        for num, rec in batched_results.items():
            trial_records[num] = {
                "trial": num, "run_id": "", "run_name": f"{run_label}_t{num:02d}_batched",
                "model": model_name,
                "val_accuracy": rec["val_accuracy"], "val_f1_macro": rec["val_f1_macro"],
                "cv_best_score": None, "model_size_kb": 0.0,
                "best_params": {k: str(v) for k, v in rec["params"].items()},
                "artifact_uri": "", "features_dir": str(features_dir),
                "features_test": str(features_test_raw or ""),
                "class_filter": class_filter or None,
            }
        if any(t.state == search.TrialState.COMPLETE for t in study.trials):
            # refit the winner through the sequential path for full
            # artifacts; its sweep value stays the study value (overwriting
            # it after selection could flip best_trial to a record with no
            # artifacts), and a failed refit must not lose the whole study
            best = study.best_trial
            refit_trial = search.Trial(study, best)  # params preset -> same draw
            saved_pruner, study.pruner = study.pruner, search.NopPruner()
            refit_mode["on"] = True  # a sampled `epochs` applies here
            try:
                objective(refit_trial)  # fills trial_records[best.number]
            except Exception as exc:
                logger.warning("[%s] winner refit failed (%s); summary keeps sweep metrics",
                               run_label, exc)
            finally:
                study.pruner = saved_pruner
                refit_mode["on"] = False
    else:
        logger.info(
            "[%s] TPE study: %d trial(s) on %s  pruner=%s  epochs/trial=%d",
            run_label, n_trials, device, pruner_name, sweep_epochs,
        )
        study.optimize(objective, n_trials=n_trials, catch=(Exception,))

    completed = [t for t in study.trials if t.state == search.TrialState.COMPLETE]
    n_pruned = sum(1 for t in study.trials if t.state == search.TrialState.PRUNED)
    logger.info("[%s] Completed: %d  Pruned: %d", run_label, len(completed), n_pruned)
    if not completed:
        logger.error("[%s] All %d trials failed or were pruned.", run_label, n_trials)
        return None

    best_trial = study.best_trial
    logger.info("[%s] Best trial #%d  val_f1_macro=%.4f  params=%s",
                run_label, best_trial.number + 1, best_trial.value, best_trial.params)

    output_dir.mkdir(parents=True, exist_ok=True)
    (output_dir / "trial_summary.json").write_text(
        json.dumps(
            {
                "run_name": run_label, "model": model_name, "n_trials": n_trials,
                "n_completed": len(completed), "n_pruned": n_pruned,
                "sweep_epochs": sweep_epochs, "best_trial": best_trial.number,
                "best_val_f1_macro": best_trial.value,
                "best_params": {k: str(v) for k, v in best_trial.params.items()},
                "trials": [trial_records[t.number] for t in study.trials if t.number in trial_records],
            },
            indent=2,
        )
    )

    # held-out test eval of the best trial (reloaded from disk)
    if features_test_raw and best_trial.number in trial_records and Path(features_test_raw).exists():
        try:
            test_fs = FeaturePipeline.load(features_test_raw)
            if test_fs.labels is not None:
                # by-name re-encoding against the training label order (see _tune_classical)
                keep, y_test_f = encode_labels_by_name(
                    test_fs.labels, test_fs.label_names or [], label_names
                )
                X_test_f = test_fs.features[keep]
                from ..models.deep import MODEL_FILENAME

                best_dir = output_dir / f"trial_{best_trial.number:02d}"
                best_trainer = get_model(model_name).load(best_dir / MODEL_FILENAME, device=device)
                test_metrics = compute_metrics(
                    y_test_f, best_trainer.predict(X_test_f), best_trainer.predict_proba(X_test_f), label_names
                )
                logger.info(
                    "[%s] Best trial test accuracy=%.4f f1_macro=%.4f (n=%d)",
                    run_label, test_metrics["val_accuracy"], test_metrics["val_f1_macro"], len(y_test_f),
                )
                trial_records[best_trial.number]["test_accuracy"] = test_metrics.get("val_accuracy", 0.0)
                trial_records[best_trial.number]["test_f1_macro"] = test_metrics.get("val_f1_macro", 0.0)
        except Exception as exc:
            logger.warning("[%s] Test evaluation of best trial failed: %s", run_label, exc)

    return trial_records.get(best_trial.number)


# ===========================================================================
# CLI entry
# ===========================================================================


def _archive_config(cfg_path: Path, experiment: str) -> str:
    """Copy the study YAML into config/experiments/ for provenance; returns
    the filesystem-safe experiment name."""
    safe_name = experiment.replace("/", "_").replace(" ", "_")
    archive = Path("config/experiments") / f"{safe_name}.yaml"
    archive.parent.mkdir(parents=True, exist_ok=True)
    if cfg_path.resolve() != archive.resolve():
        shutil.copy2(cfg_path, archive)
    return safe_name


def _dispatch_run(run_cfg: dict, study_cfg: dict, device: torch.device) -> Optional[dict]:
    """Route one run to the classical or deep tuner; None when skipped."""
    model_name = run_cfg.get("model", "?")
    run_label = run_cfg.get("name") or model_name
    try:
        model_type = get_model(model_name).model_type
    except (KeyError, ValueError) as exc:
        logger.error("unknown model %r: %s", model_name, exc)
        return None
    logger.info("run %-20s (model_type=%s)", run_label, model_type)
    required_key = "grid" if model_type == "classical" else "search_space"
    if required_key not in run_cfg:
        logger.warning("[%s] missing %r section — run skipped", run_label, required_key)
        return None
    tuner = _tune_classical if model_type == "classical" else _tune_deep
    return tuner(run_cfg, study_cfg, device)


def main(argv=None) -> None:
    setup_logging()
    parser = argparse.ArgumentParser(
        prog="python -m audio_edge_ml_pipeline_torch.train.tune",
        description="Stage 4 — Hyperparameter search (fold-batched grid CV classical, TPE deep)",
    )
    parser.add_argument("--config", metavar="YAML", required=True)
    parser.add_argument("--device", default=None,
                        help="torch device to tune on (default: the first CUDA card; 'cpu' tunes on the CPU)")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)  # no card and no --device: raise before any run starts

    cfg_path = Path(args.config)
    if not cfg_path.exists():
        logger.error("config YAML does not exist: %s", cfg_path)
        sys.exit(1)
    study_cfg = yaml.safe_load(cfg_path.read_text()) or {}
    missing_keys = [k for k in ("output_dir", "runs") if k not in study_cfg]
    if missing_keys:
        logger.error("tuning config is missing required key(s): %s", missing_keys)
        sys.exit(1)

    output_dir = Path(study_cfg["output_dir"])
    experiment = study_cfg.get("experiment", "ml-pipeline-tuning")
    safe_name = _archive_config(cfg_path, experiment)

    tracking.set_tracking_uri(study_cfg.get("mlflow_uri"))
    tracking.set_experiment(experiment)

    eligible = list(study_cfg.get("runs") or [])
    if study_cfg.get("shortlist"):
        doc = json.loads(Path(study_cfg["shortlist"]).read_text())
        shortlisted = {c["model"] for c in doc.get("candidates", [])}
        logger.info("shortlist filter active — tuning only: %s", sorted(shortlisted))
        eligible = [r for r in eligible if r.get("model") in shortlisted]
    if not eligible:
        logger.error("no eligible runs (does the shortlist cover any configured model?)")
        sys.exit(1)

    from ..utils.profiling import log_timing_report, stage_timer

    results = []
    for run_cfg in eligible:
        try:
            with stage_timer(f"tune:{run_cfg.get('name') or run_cfg.get('model')}"):
                outcome = _dispatch_run(run_cfg, study_cfg, device)
        except Exception as exc:
            logger.error("run %r failed: %s", run_cfg.get("name") or run_cfg.get("model"), exc, exc_info=True)
            continue
        if outcome:
            results.append(outcome)
    log_timing_report()

    if not results:
        logger.error("every tuning run failed")
        sys.exit(1)

    results.sort(key=lambda r: r.get("val_f1_macro", 0.0), reverse=True)
    output_dir.mkdir(parents=True, exist_ok=True)
    shortlist_doc = {
        "experiment": experiment,
        "metric": "val_f1_macro",
        "n_candidates": len(results),
        "generated_at": datetime.now().isoformat(timespec="seconds"),
        "candidates": [
            {
                "rank": rank,
                "run_id": r.get("run_id", ""),
                "run_name": r.get("run_name", ""),
                "model": r.get("model", ""),
                "val_accuracy": r.get("val_accuracy", 0.0),
                "val_f1_macro": r.get("val_f1_macro", 0.0),
                "cv_best_score": r.get("cv_best_score"),
                "model_size_kb": r.get("model_size_kb", 0.0),
                "best_params": r.get("best_params", {}),
                "artifact_uri": r.get("artifact_uri", ""),
                "features_dir": r.get("features_dir", ""),
                "features_eval_dir": r.get("features_test") or None,
                "class_filter": r.get("class_filter") or None,
            }
            for rank, r in enumerate(results, 1)
        ],
    }
    (output_dir / "shortlist.json").write_text(json.dumps(shortlist_doc, indent=2))
    scoped = output_dir / f"shortlists/shortlist_{safe_name}.json"
    scoped.parent.mkdir(parents=True, exist_ok=True)
    scoped.write_text(json.dumps(shortlist_doc, indent=2))
    logger.info("Shortlist (%d candidates) -> %s", len(results), output_dir / "shortlist.json")

    logger.info("  %22s | %12s | %8s | %8s", "run", "model", "val_acc", "f1_macro")
    for r in results:
        logger.info(
            "  %22s | %12s | %8.4f | %8.4f",
            r.get("run_name", "")[:22], r.get("model", ""), r.get("val_accuracy", 0.0), r.get("val_f1_macro", 0.0),
        )


if __name__ == "__main__":
    main()
