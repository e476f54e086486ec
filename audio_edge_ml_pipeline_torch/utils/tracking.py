"""Run tracking: an MLflow-compatible experiment tracker (file store).

Counterpart of the JAX package's ``utils/tracking.py``. It writes the same
``mlruns/`` file-store layout (experiment meta.yaml, per-run meta.yaml /
metrics / params / tags / artifacts), so the JAX package's ``search_runs``
reads the port's runs and the other way round, and a real MLflow UI pointed
at the directory reads both.

The subset of the MLflow client API that training and selection use is
provided: set_tracking_uri, set_experiment, start_run (a run logs params,
metrics, tags and artifacts), search_runs, get_run. The REST backend
(``http(s)://`` tracking URIs) is not yet ported and raises.

Env var MLFLOW_TRACKING_URI is honored.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import time
import uuid
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

logger = logging.getLogger(__name__)

_ACTIVE_URI: Optional[str] = None
_ACTIVE_EXPERIMENT: Optional[str] = None
_ACTIVE_RUN: Optional["ActiveRun"] = None


def _yaml_dump(d: dict) -> str:
    lines = []
    for k, v in d.items():
        if isinstance(v, str):
            lines.append(f"{k}: {v}")
        else:
            lines.append(f"{k}: {json.dumps(v)}")
    return "\n".join(lines) + "\n"


def _yaml_load(text: str) -> dict:
    out = {}
    for line in text.splitlines():
        if ":" not in line:
            continue
        k, _, v = line.partition(":")
        v = v.strip()
        try:
            out[k.strip()] = json.loads(v)
        except json.JSONDecodeError:
            out[k.strip()] = v
    return out


def set_tracking_uri(uri: Optional[str]) -> None:
    global _ACTIVE_URI
    _ACTIVE_URI = uri


def _current_uri() -> str:
    return _ACTIVE_URI or os.environ.get("MLFLOW_TRACKING_URI") or "mlruns"


def _require_file_store() -> None:
    uri = _current_uri()
    if uri.startswith(("http://", "https://")):
        raise NotImplementedError(
            f"the MLflow REST tracking backend ({uri}) is not yet ported to "
            "audio_edge_ml_pipeline_torch; use a file-store URI or audio_edge_ml_pipeline_tpu")


def tracking_location() -> str:
    """Human-readable backend location (the file-store dir)."""
    return str(get_tracking_dir())


def get_tracking_dir() -> Path:
    _require_file_store()
    uri = _current_uri()
    if uri.startswith("file://"):
        uri = uri[len("file://") :]
    elif uri.startswith("file:"):
        uri = uri[len("file:") :]
    if "://" in uri:
        logger.warning("Tracking URI %r is not a file store; using ./mlruns", uri)
        uri = "mlruns"
    return Path(uri)


def _experiment_dir(name: str, create: bool = True) -> Path:
    root = get_tracking_dir()
    # find existing experiment by name
    if root.exists():
        for d in sorted(root.iterdir()):
            meta = d / "meta.yaml"
            if d.is_dir() and meta.exists():
                if _yaml_load(meta.read_text()).get("name") == name:
                    return d
    if not create:
        raise KeyError(f"Experiment not found: {name}")
    # allocate next integer id
    existing = [int(d.name) for d in root.iterdir() if d.is_dir() and d.name.isdigit()] if root.exists() else []
    exp_id = str(max(existing) + 1 if existing else 0)
    d = root / exp_id
    (d / "artifacts").mkdir(parents=True, exist_ok=True)
    (d / "meta.yaml").write_text(
        _yaml_dump(
            {
                "artifact_location": str((d / "artifacts").resolve()),
                "creation_time": int(time.time() * 1000),
                "experiment_id": exp_id,
                "last_update_time": int(time.time() * 1000),
                "lifecycle_stage": "active",
                "name": name,
            }
        )
    )
    return d


def set_experiment(name: str) -> str:
    global _ACTIVE_EXPERIMENT
    _ACTIVE_EXPERIMENT = name
    return _experiment_dir(name).name


@dataclass
class RunInfo:
    run_id: str
    experiment_id: str
    run_name: str
    artifact_uri: str
    status: str = "RUNNING"
    start_time: int = 0
    end_time: Optional[int] = None


class ActiveRun:
    """Context-manager handle mirroring mlflow.ActiveRun (.info.run_id)."""

    def __init__(self, run_dir: Path, info: RunInfo):
        self._dir = run_dir
        self.info = info
        self._previous: Optional[ActiveRun] = None

    # -- context manager ------------------------------------------------
    def __enter__(self) -> "ActiveRun":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        # finalize THIS run (not whatever run is globally active) and restore
        # the run that was active when this one started
        self._finalize("FAILED" if exc_type else "FINISHED")

    def _finalize(self, status: str) -> None:
        global _ACTIVE_RUN
        self.info.status = status
        self.info.end_time = int(time.time() * 1000)
        self._write_meta()
        if _ACTIVE_RUN is self:
            _ACTIVE_RUN = self._previous

    # -- logging --------------------------------------------------------
    def log_param(self, key: str, value) -> None:
        pdir = self._dir / "params"
        pdir.mkdir(exist_ok=True)
        (pdir / _safe_key(key)).write_text(str(value))

    def log_metric(self, key: str, value: float, step: int = 0) -> None:
        mdir = self._dir / "metrics"
        mdir.mkdir(exist_ok=True)
        with open(mdir / _safe_key(key), "a") as f:
            f.write(f"{int(time.time() * 1000)} {float(value)} {int(step)}\n")

    def set_tag(self, key: str, value) -> None:
        tdir = self._dir / "tags"
        tdir.mkdir(exist_ok=True)
        (tdir / _safe_key(key)).write_text(str(value))

    def log_artifact(self, local_path: str | Path) -> None:
        art = Path(self.info.artifact_uri)
        art.mkdir(parents=True, exist_ok=True)
        src = Path(local_path)
        if src.is_dir():
            shutil.copytree(src, art / src.name, dirs_exist_ok=True)
        else:
            shutil.copy2(src, art / src.name)

    def _write_meta(self) -> None:
        self._dir.joinpath("meta.yaml").write_text(
            _yaml_dump(
                {
                    "artifact_uri": self.info.artifact_uri,
                    "end_time": self.info.end_time,
                    "experiment_id": self.info.experiment_id,
                    "lifecycle_stage": "active",
                    "run_id": self.info.run_id,
                    "run_name": self.info.run_name,
                    "run_uuid": self.info.run_id,
                    "start_time": self.info.start_time,
                    "status": self.info.status,
                    "user_id": os.environ.get("USER", "unknown"),
                }
            )
        )


def _safe_key(key: str) -> str:
    return key.replace("/", "_").replace(" ", "_")


def start_run(run_name: Optional[str] = None, experiment: Optional[str] = None) -> ActiveRun:
    global _ACTIVE_RUN
    exp_name = experiment or _ACTIVE_EXPERIMENT or "Default"
    exp_dir = _experiment_dir(exp_name)
    run_id = uuid.uuid4().hex
    run_dir = exp_dir / run_id
    (run_dir / "artifacts").mkdir(parents=True, exist_ok=True)
    for sub in ("metrics", "params", "tags"):
        (run_dir / sub).mkdir(exist_ok=True)
    info = RunInfo(
        run_id=run_id,
        experiment_id=exp_dir.name,
        run_name=run_name or run_id[:8],
        artifact_uri=str((run_dir / "artifacts").resolve()),
        start_time=int(time.time() * 1000),
    )
    run = ActiveRun(run_dir, info)
    run.set_tag("mlflow.runName", info.run_name)
    run._write_meta()
    run._previous = _ACTIVE_RUN  # restored when this run finalizes
    _ACTIVE_RUN = run
    return run


# -- querying (select.py backend) ----------------------------------------


@dataclass
class RunRecord:
    run_id: str
    run_name: str
    experiment_id: str
    status: str
    start_time: int
    artifact_uri: str
    params: dict = field(default_factory=dict)
    metrics: dict = field(default_factory=dict)
    tags: dict = field(default_factory=dict)


def _read_run(run_dir: Path) -> Optional[RunRecord]:
    meta_p = run_dir / "meta.yaml"
    if not meta_p.exists():
        return None
    meta = _yaml_load(meta_p.read_text())

    def files(sub: str):
        d = run_dir / sub
        return d.glob("*") if d.exists() else []

    params = {p.name: p.read_text() for p in files("params")}
    metrics = {}
    for m in files("metrics"):
        lines = m.read_text().strip().splitlines()
        if lines:
            metrics[m.name] = float(lines[-1].split()[1])  # last logged value
    tags = {t.name: t.read_text() for t in files("tags")}
    return RunRecord(
        run_id=str(meta.get("run_id", run_dir.name)),
        run_name=str(meta.get("run_name", tags.get("mlflow.runName", run_dir.name))),
        experiment_id=str(meta.get("experiment_id", run_dir.parent.name)),
        status=str(meta.get("status", "FINISHED")),
        start_time=int(meta.get("start_time") or 0),
        artifact_uri=str(meta.get("artifact_uri", run_dir / "artifacts")),
        params=params,
        metrics=metrics,
        tags=tags,
    )


def search_runs(
    experiment: str,
    status: Optional[str] = "FINISHED",
    max_results: int = 500,
) -> list[RunRecord]:
    """All runs of an experiment, newest first (select.py query backend)."""
    try:
        exp_dir = _experiment_dir(experiment, create=False)
    except KeyError:
        return []
    records = []
    for d in exp_dir.iterdir():
        if not d.is_dir() or d.name == "artifacts":
            continue
        rec = _read_run(d)
        if rec is None:
            continue
        if status is not None and rec.status != status:
            continue
        records.append(rec)
    records.sort(key=lambda r: r.start_time, reverse=True)
    return records[:max_results]


def get_run(run_id: str) -> Optional[RunRecord]:
    root = get_tracking_dir()
    if not root.exists():
        return None
    for exp in root.iterdir():
        run_dir = exp / run_id
        if run_dir.exists():
            return _read_run(run_dir)
    return None
