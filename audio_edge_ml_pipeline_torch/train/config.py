"""Training YAML config: defaults-merge + cv_folds fan-out.

Counterpart of the JAX package's ``train/config.py``, the same schema
(top-level defaults, per-run overrides, cv_folds int-or-list fanning out
into _cvK runs, auto_select knobs, species_filter alias).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path

import yaml


@dataclass
class ModelRunConfig:
    model: str
    name: str | None = None
    features_dir: str | None = None
    features_test_dir: str | None = None
    output_dir: str | None = None
    # None = "not set on this run" -> inherit the top-level value; using the
    # default VALUE as the sentinel silently discarded an explicit 0.2 / 42
    val_split: float | None = None
    cv_folds: int | list[int] | None = None
    cv_random_state: int | None = None
    params: dict[str, object] = field(default_factory=dict)
    class_filter: list[str] | None = None


@dataclass
class TrainConfig:
    features_dir: str
    output_dir: str
    experiment: str = "ml-pipeline"
    mlflow_uri: str | None = None
    val_split: float = 0.2
    features_test_dir: str | None = None
    cv_folds: int | list[int] = 0
    cv_random_state: int = 42
    class_filter: list[str] | None = None
    runs: list[ModelRunConfig] = field(default_factory=list)
    auto_select: bool = True
    auto_select_top_n: int = 5
    auto_select_metric: str = "val_f1_macro"
    auto_select_min_accuracy: float | None = None

    # run fields that inherit the top-level value when left as None
    _INHERITED = ("features_dir", "features_test_dir", "output_dir",
                  "val_split", "cv_random_state", "class_filter")

    def resolved_runs(self) -> list[ModelRunConfig]:
        """Merge defaults into each run; a list-valued cv_folds fans out one
        run per fold count with a _cvK name suffix."""
        resolved = []
        for run in self.runs:
            run_name = run.name or run.model
            inherited = {
                k: getattr(run, k) if getattr(run, k) is not None else getattr(self, k)
                for k in self._INHERITED
            }
            effective = run.cv_folds if run.cv_folds is not None else self.cv_folds
            fold_list = effective if isinstance(effective, list) else [effective]
            for k in fold_list:
                name = f"{run_name}_cv{k}" if len(fold_list) > 1 and k > 0 else run_name
                resolved.append(
                    ModelRunConfig(model=run.model, name=name, cv_folds=k,
                                   params=run.params, **inherited)
                )
        return resolved


def _parsed_run(r: dict) -> ModelRunConfig:
    if "model" not in r:
        raise ValueError(f"run entry without a 'model' key: {r}")
    return ModelRunConfig(
        model=r["model"],
        name=r.get("name"),
        features_dir=r.get("features_dir"),
        # `features_test` is the key the reference's archived run configs
        # use (its tune.py key); accept it as an alias here
        features_test_dir=r.get("features_test_dir") or r.get("features_test"),
        output_dir=r.get("output_dir"),
        val_split=float(r["val_split"]) if "val_split" in r else None,
        cv_folds=(
            [int(k) for k in r["cv_folds"]]
            if isinstance(r.get("cv_folds"), list)
            else (int(r["cv_folds"]) if "cv_folds" in r else None)
        ),
        cv_random_state=int(r["cv_random_state"]) if "cv_random_state" in r else None,
        params=r.get("params") or {},
        class_filter=r.get("class_filter") or r.get("species_filter") or None,
    )


def load_train_config(path: Path) -> TrainConfig:
    path = Path(path)
    if not path.exists():
        raise FileNotFoundError(f"no such training config: {path}")
    doc = yaml.safe_load(path.read_text()) or {}
    feats_dir = doc.get("features_dir", "")
    if not feats_dir:
        raise ValueError("TrainConfig requires 'features_dir' at the top level.")
    cv = doc.get("cv_folds", 0)
    amin = doc.get("auto_select_min_accuracy", None)
    return TrainConfig(
        features_dir=feats_dir,
        output_dir=doc.get("output_dir", "data/models"),
        experiment=doc.get("experiment", "ml-pipeline"),
        mlflow_uri=doc.get("mlflow_uri", None),
        val_split=float(doc.get("val_split", 0.2)),
        features_test_dir=doc.get("features_test_dir") or doc.get("features_test"),
        cv_folds=[int(k) for k in cv] if isinstance(cv, list) else int(cv),
        cv_random_state=int(doc.get("cv_random_state", 42)),
        class_filter=doc.get("class_filter") or doc.get("species_filter") or None,
        runs=[_parsed_run(r) for r in doc.get("runs", [])],
        auto_select=bool(doc.get("auto_select", True)),
        auto_select_top_n=int(doc.get("auto_select_top_n", 5)),
        auto_select_metric=str(doc.get("auto_select_metric", "val_f1_macro")),
        auto_select_min_accuracy=float(amin) if amin is not None else None,
    )
