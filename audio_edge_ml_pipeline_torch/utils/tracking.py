"""Run tracking: an MLflow-compatible experiment tracker (file + REST).

Counterpart of the JAX package's ``utils/tracking.py``, with its two
backends, selected by the tracking URI:

- **file store** (default): the ``mlruns/`` file-store layout (experiment
  meta.yaml, per-run meta.yaml / metrics / params / tags / artifacts), so
  the JAX package's ``search_runs`` reads the port's runs and the other way
  round, and a real MLflow UI pointed at the directory reads both.
- **REST store** (``http(s)://`` URIs): the MLflow REST protocol over
  stdlib urllib, against an MLflow tracking server (the one
  ``docker/docker-compose.yaml`` provisions). Endpoints used:
  experiments/create + get-by-name, runs/create + update, runs/log-batch,
  runs/log-metric, runs/log-parameter, runs/set-tag, runs/search, runs/get,
  and artifact upload through the server's ``mlflow-artifacts:/`` HTTP
  proxy, or straight into a shared-filesystem artifact root.

The subset of the MLflow client API that training and selection use is
provided against both: set_tracking_uri, set_experiment, start_run (a run
logs params, metrics, tags and artifacts), active_run, end_run, the
module-level log_params / log_metric / log_metrics / log_artifact / set_tag
on the active run, search_runs, get_run.

Env var MLFLOW_TRACKING_URI is honored.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import time
import urllib.error
import urllib.parse
import urllib.request
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


def _rest_base() -> Optional[str]:
    """HTTP(S) tracking-server base URL, or None when in file-store mode."""
    uri = _current_uri()
    if uri.startswith(("http://", "https://")):
        return uri.rstrip("/")
    return None


def tracking_location() -> str:
    """Human-readable backend location (server URL or file-store dir)."""
    return _rest_base() or str(get_tracking_dir())


def get_tracking_dir() -> Path:
    uri = _current_uri()
    if uri.startswith("file://"):
        uri = uri[len("file://") :]
    elif uri.startswith("file:"):
        uri = uri[len("file:") :]
    if "://" in uri:
        logger.warning("Tracking URI %r is not a file store; using ./mlruns", uri)
        uri = "mlruns"
    return Path(uri)


# -- MLflow REST protocol (stdlib urllib) ---------------------------------


class TrackingServerError(RuntimeError):
    """The MLflow tracking server rejected a request or is unreachable."""


def _rest_call(
    endpoint: str,
    payload: Optional[dict] = None,
    method: str = "POST",
    query: Optional[dict] = None,
    base: Optional[str] = None,
) -> dict:
    base = base or _rest_base()
    url = f"{base}/api/2.0/mlflow/{endpoint}"
    if query:
        url += "?" + urllib.parse.urlencode(query)
    data = json.dumps(payload).encode() if payload is not None else None
    req = urllib.request.Request(url, data=data, method=method, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            body = resp.read()
    except urllib.error.HTTPError as e:
        try:
            err = json.loads(e.read().decode() or "{}")
        except ValueError:
            err = {}
        raise TrackingServerError(
            f"MLflow server {method} {endpoint}: HTTP {e.code} "
            f"{err.get('error_code', '')} {err.get('message', '')}".strip()
        ) from e
    except urllib.error.URLError as e:
        raise TrackingServerError(f"MLflow server unreachable at {base}: {e.reason}") from e
    return json.loads(body) if body else {}


def _rest_experiment_id(name: str, create: bool = True, base: Optional[str] = None) -> str:
    try:
        got = _rest_call("experiments/get-by-name", method="GET", query={"experiment_name": name}, base=base)
        return str(got["experiment"]["experiment_id"])
    except TrackingServerError:
        if not create:
            raise KeyError(f"Experiment not found on server: {name}")
    try:
        made = _rest_call("experiments/create", {"name": name}, base=base)
        return str(made["experiment_id"])
    except TrackingServerError:
        # lost a create race: someone else made it between our two calls
        got = _rest_call("experiments/get-by-name", method="GET", query={"experiment_name": name}, base=base)
        return str(got["experiment"]["experiment_id"])


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
    if _rest_base():
        return _rest_experiment_id(name)
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

    def log_batch(self, metrics: Optional[dict] = None, params: Optional[dict] = None,
                  tags: Optional[dict] = None, step: int = 0) -> None:
        for k, v in (params or {}).items():
            self.log_param(k, v)
        for k, v in (metrics or {}).items():
            self.log_metric(k, float(v), step)
        for k, v in (tags or {}).items():
            self.set_tag(k, v)

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


class _RestRun(ActiveRun):
    """ActiveRun whose storage is an MLflow tracking server (REST)."""

    def __init__(self, base: str, info: RunInfo):
        self._base = base
        self.info = info
        self._previous: Optional[ActiveRun] = None

    def _finalize(self, status: str) -> None:
        global _ACTIVE_RUN
        self.info.status = status
        self.info.end_time = int(time.time() * 1000)
        _rest_call("runs/update", {"run_id": self.info.run_id, "status": status, "end_time": self.info.end_time},
                   base=self._base)
        if _ACTIVE_RUN is self:
            _ACTIVE_RUN = self._previous

    def log_param(self, key: str, value) -> None:
        _rest_call("runs/log-parameter", {"run_id": self.info.run_id, "key": _safe_key(key), "value": str(value)},
                   base=self._base)

    def log_metric(self, key: str, value: float, step: int = 0) -> None:
        _rest_call("runs/log-metric", {"run_id": self.info.run_id, "key": _safe_key(key), "value": float(value),
                                       "timestamp": int(time.time() * 1000), "step": int(step)}, base=self._base)

    def set_tag(self, key: str, value) -> None:
        _rest_call("runs/set-tag", {"run_id": self.info.run_id, "key": _safe_key(key), "value": str(value)},
                   base=self._base)

    def log_batch(self, metrics: Optional[dict] = None, params: Optional[dict] = None,
                  tags: Optional[dict] = None, step: int = 0) -> None:
        now = int(time.time() * 1000)
        payload = {
            "run_id": self.info.run_id,
            "metrics": [{"key": _safe_key(k), "value": float(v), "timestamp": now, "step": int(step)}
                        for k, v in (metrics or {}).items()],
            "params": [{"key": _safe_key(k), "value": str(v)} for k, v in (params or {}).items()],
            "tags": [{"key": _safe_key(k), "value": str(v)} for k, v in (tags or {}).items()],
        }
        _rest_call("runs/log-batch", payload, base=self._base)

    def log_artifact(self, local_path: str | Path) -> None:
        src = Path(local_path)
        files = sorted(p for p in src.rglob("*") if p.is_file()) if src.is_dir() else [src]
        root = src.parent  # a directory uploads as <dirname>/... (mlflow's log_artifact contract)
        for f in files:
            self._upload_artifact_bytes(f.relative_to(root).as_posix(), f.read_bytes())

    def _upload_artifact_bytes(self, artifact_path: str, data: bytes) -> None:
        uri = self.info.artifact_uri
        prefix = "mlflow-artifacts:"
        if uri.startswith(prefix):
            # mlflow-artifacts:/<exp>/<run>/artifacts is served by the tracking
            # server's artifact HTTP proxy under /api/2.0/mlflow-artifacts/
            sub = uri[len(prefix):].lstrip("/")
            url = f"{self._base}/api/2.0/mlflow-artifacts/artifacts/{sub}/{urllib.parse.quote(artifact_path)}"
            req = urllib.request.Request(url, data=data, method="PUT")
            try:
                with urllib.request.urlopen(req, timeout=120):
                    pass
            except (urllib.error.HTTPError, urllib.error.URLError) as e:
                raise TrackingServerError(f"artifact upload failed for {artifact_path}: {e}") from e
        elif "://" not in uri:
            # a server started with a shared-filesystem artifact root
            dest = Path(uri) / artifact_path
            dest.parent.mkdir(parents=True, exist_ok=True)
            dest.write_bytes(data)
        else:
            logger.warning("Unsupported artifact store %r (only the mlflow-artifacts proxy and shared paths are "
                           "supported); skipping %s", uri, artifact_path)


def _rest_start_run(base: str, run_name: Optional[str], exp_name: str) -> _RestRun:
    global _ACTIVE_RUN
    exp_id = _rest_experiment_id(exp_name, base=base)
    start = int(time.time() * 1000)
    payload = {"experiment_id": exp_id, "start_time": start, "tags": []}
    if run_name:
        payload["run_name"] = run_name
        payload["tags"].append({"key": "mlflow.runName", "value": run_name})
    rinfo = _rest_call("runs/create", payload, base=base)["run"]["info"]
    info = RunInfo(
        run_id=str(rinfo["run_id"]),
        experiment_id=str(rinfo.get("experiment_id", exp_id)),
        run_name=run_name or str(rinfo.get("run_name") or rinfo["run_id"][:8]),
        artifact_uri=str(rinfo.get("artifact_uri", "")),
        start_time=start,
    )
    run = _RestRun(base, info)
    run._previous = _ACTIVE_RUN
    _ACTIVE_RUN = run
    return run


def start_run(run_name: Optional[str] = None, experiment: Optional[str] = None) -> ActiveRun:
    global _ACTIVE_RUN
    exp_name = experiment or _ACTIVE_EXPERIMENT or "Default"
    base = _rest_base()
    if base:
        return _rest_start_run(base, run_name, exp_name)
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


def active_run() -> Optional[ActiveRun]:
    return _ACTIVE_RUN


def end_run(status: str = "FINISHED") -> None:
    if _ACTIVE_RUN is not None:
        _ACTIVE_RUN._finalize(status)


# -- module-level conveniences (mlflow-style), on the active run of either store


def log_params(params: dict) -> None:
    if _ACTIVE_RUN:
        _ACTIVE_RUN.log_batch(params=params)


def log_metric(key: str, value: float, step: int = 0) -> None:
    if _ACTIVE_RUN:
        _ACTIVE_RUN.log_metric(key, value, step)


def log_metrics(metrics: dict, step: int = 0) -> None:
    if _ACTIVE_RUN:
        numeric = {k: v for k, v in metrics.items() if isinstance(v, (int, float))}
        _ACTIVE_RUN.log_batch(metrics=numeric, step=step)


def log_artifact(path: str | Path) -> None:
    if _ACTIVE_RUN:
        _ACTIVE_RUN.log_artifact(path)


def set_tag(key: str, value) -> None:
    if _ACTIVE_RUN:
        _ACTIVE_RUN.set_tag(key, value)


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


def _record_from_rest(run: dict) -> RunRecord:
    info = run.get("info", {})
    data = run.get("data", {})
    params = {p["key"]: str(p.get("value", "")) for p in data.get("params", []) or []}
    metrics = {m["key"]: float(m.get("value", 0.0)) for m in data.get("metrics", []) or []}
    tags = {t["key"]: str(t.get("value", "")) for t in data.get("tags", []) or []}
    return RunRecord(
        run_id=str(info.get("run_id", "")),
        run_name=str(info.get("run_name") or tags.get("mlflow.runName") or str(info.get("run_id", ""))[:8]),
        experiment_id=str(info.get("experiment_id", "")),
        status=str(info.get("status", "FINISHED")),
        start_time=int(info.get("start_time") or 0),
        artifact_uri=str(info.get("artifact_uri", "")),
        params=params,
        metrics=metrics,
        tags=tags,
    )


def _rest_search_runs(experiment: str, status: Optional[str], max_results: int) -> list[RunRecord]:
    try:
        exp_id = _rest_experiment_id(experiment, create=False)
    except KeyError:
        return []
    payload: dict = {"experiment_ids": [exp_id], "max_results": int(max_results),
                     "order_by": ["attributes.start_time DESC"]}
    if status is not None:
        payload["filter"] = f"attributes.status = '{status}'"
    got = _rest_call("runs/search", payload)
    return [_record_from_rest(r) for r in got.get("runs", []) or []]


def search_runs(
    experiment: str,
    status: Optional[str] = "FINISHED",
    max_results: int = 500,
) -> list[RunRecord]:
    """All runs of an experiment, newest first (select.py query backend)."""
    if _rest_base():
        return _rest_search_runs(experiment, status, max_results)
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
    if _rest_base():
        try:
            got = _rest_call("runs/get", method="GET", query={"run_id": run_id})
        except TrackingServerError:
            return None
        return _record_from_rest(got.get("run", {}))
    root = get_tracking_dir()
    if not root.exists():
        return None
    for exp in root.iterdir():
        run_dir = exp / run_id
        if run_dir.exists():
            return _read_run(run_dir)
    return None
