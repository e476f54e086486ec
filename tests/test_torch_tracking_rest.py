"""The port's MLflow REST tracking backend (audio_edge_ml_pipeline_torch.
utils.tracking) against an in-process stub server, beside the JAX package's.

The stub is a copy of tests/test_tracking_rest.py's: the slice of the MLflow
REST protocol both trackers speak (experiments/create + get-by-name,
runs/create + update, runs/log-batch + log-metric + log-parameter + set-tag,
runs/search, runs/get, and the mlflow-artifacts HTTP proxy). It binds
127.0.0.1 on port 0: no network."""

from __future__ import annotations

import json
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import numpy as np
import pytest
import torch

from audio_edge_ml_pipeline_tpu.utils import tracking as jtracking
from audio_edge_ml_pipeline_torch.features.base import FeatureSet
from audio_edge_ml_pipeline_torch.features.pipeline import FeaturePipeline
from audio_edge_ml_pipeline_torch.optimize import optimize as toptimize
from audio_edge_ml_pipeline_torch.train import select as tselect
from audio_edge_ml_pipeline_torch.train import train as ttrain
from audio_edge_ml_pipeline_torch.train import tune as ttune
from audio_edge_ml_pipeline_torch.utils import tracking


class _StubState:
    def __init__(self):
        self.experiments = {}  # id -> {"experiment_id", "name"}
        self.runs = {}  # run_id -> {"info": {...}, "params": {}, "metrics": {}, "tags": {}}
        self.artifacts = {}  # path -> bytes
        self.next_exp = 1
        self.next_run = 1
        self.batch_calls = 0


class _Handler(BaseHTTPRequestHandler):
    state: _StubState = None  # set per server
    # When set, runs/create hands out artifact_uri as a LOCAL path under this
    # root (a server started with --default-artifact-root /shared/fs); when
    # None, the mlflow-artifacts: HTTP-proxy scheme is used.
    artifact_root: str = None

    def log_message(self, *a):  # silence
        pass

    def _json(self, code: int, obj: dict) -> None:
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _payload(self) -> dict:
        n = int(self.headers.get("Content-Length") or 0)
        return json.loads(self.rfile.read(n) or b"{}")

    def do_GET(self):
        st = self.state
        url = urllib.parse.urlparse(self.path)
        q = dict(urllib.parse.parse_qsl(url.query))
        if url.path.endswith("/experiments/get-by-name"):
            name = q.get("experiment_name")
            for e in st.experiments.values():
                if e["name"] == name:
                    return self._json(200, {"experiment": e})
            return self._json(404, {"error_code": "RESOURCE_DOES_NOT_EXIST", "message": f"no experiment {name}"})
        if url.path.endswith("/runs/get"):
            run = st.runs.get(q.get("run_id"))
            if run is None:
                return self._json(404, {"error_code": "RESOURCE_DOES_NOT_EXIST", "message": "no run"})
            return self._json(200, {"run": self._run_obj(run)})
        return self._json(404, {"error_code": "ENDPOINT_NOT_FOUND", "message": url.path})

    def do_PUT(self):
        st = self.state
        marker = "/api/2.0/mlflow-artifacts/artifacts/"
        if marker in self.path:
            rel = urllib.parse.unquote(self.path.split(marker, 1)[1])
            n = int(self.headers.get("Content-Length") or 0)
            st.artifacts[rel] = self.rfile.read(n)
            return self._json(200, {})
        return self._json(404, {"error_code": "ENDPOINT_NOT_FOUND", "message": self.path})

    def _run_obj(self, run: dict) -> dict:
        return {
            "info": run["info"],
            "data": {
                "params": [{"key": k, "value": v} for k, v in run["params"].items()],
                "metrics": [{"key": k, "value": v} for k, v in run["metrics"].items()],
                "tags": [{"key": k, "value": v} for k, v in run["tags"].items()],
            },
        }

    def do_POST(self):
        st = self.state
        p = self._payload()
        path = self.path
        if path.endswith("/experiments/create"):
            for e in st.experiments.values():
                if e["name"] == p["name"]:
                    return self._json(400, {"error_code": "RESOURCE_ALREADY_EXISTS", "message": p["name"]})
            eid = str(st.next_exp)
            st.next_exp += 1
            st.experiments[eid] = {"experiment_id": eid, "name": p["name"]}
            return self._json(200, {"experiment_id": eid})
        if path.endswith("/runs/create"):
            rid = f"r{st.next_run:08d}"
            st.next_run += 1
            exp_id = str(p["experiment_id"])
            if self.artifact_root:
                art_uri = f"{self.artifact_root}/{exp_id}/{rid}/artifacts"
            else:
                art_uri = f"mlflow-artifacts:/{exp_id}/{rid}/artifacts"
            info = {
                "run_id": rid,
                "run_uuid": rid,
                "experiment_id": exp_id,
                "run_name": p.get("run_name", rid[:8]),
                "status": "RUNNING",
                "start_time": p.get("start_time", 0),
                "artifact_uri": art_uri,
            }
            tags = {t["key"]: t["value"] for t in p.get("tags", [])}
            st.runs[rid] = {"info": info, "params": {}, "metrics": {}, "tags": tags}
            return self._json(200, {"run": {"info": info}})
        if path.endswith("/runs/update"):
            run = st.runs[p["run_id"]]
            run["info"]["status"] = p.get("status", run["info"]["status"])
            run["info"]["end_time"] = p.get("end_time")
            return self._json(200, {"run_info": run["info"]})
        if path.endswith("/runs/log-metric"):
            st.runs[p["run_id"]]["metrics"][p["key"]] = float(p["value"])
            return self._json(200, {})
        if path.endswith("/runs/log-parameter"):
            st.runs[p["run_id"]]["params"][p["key"]] = str(p["value"])
            return self._json(200, {})
        if path.endswith("/runs/set-tag"):
            st.runs[p["run_id"]]["tags"][p["key"]] = str(p["value"])
            return self._json(200, {})
        if path.endswith("/runs/log-batch"):
            st.batch_calls += 1
            run = st.runs[p["run_id"]]
            for m in p.get("metrics", []):
                run["metrics"][m["key"]] = float(m["value"])
            for pr in p.get("params", []):
                run["params"][pr["key"]] = str(pr["value"])
            for t in p.get("tags", []):
                run["tags"][t["key"]] = str(t["value"])
            return self._json(200, {})
        if path.endswith("/runs/search"):
            exp_ids = set(str(e) for e in p.get("experiment_ids", []))
            want_status = None
            filt = p.get("filter", "")
            if "attributes.status" in filt:
                want_status = filt.split("'")[1]
            runs = [
                self._run_obj(r)
                for r in st.runs.values()
                if str(r["info"]["experiment_id"]) in exp_ids
                and (want_status is None or r["info"]["status"] == want_status)
            ]
            runs.sort(key=lambda r: -int(r["info"].get("start_time") or 0))
            return self._json(200, {"runs": runs[: int(p.get("max_results", 500))]})
        return self._json(404, {"error_code": "ENDPOINT_NOT_FOUND", "message": path})


def _serve(artifact_root: str | None = None):
    state = _StubState()
    handler = type("H", (_Handler,), {"state": state, "artifact_root": artifact_root})
    srv = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://127.0.0.1:{srv.server_address[1]}", state


@pytest.fixture(autouse=True)
def _reset_trackers():
    torch.set_num_threads(1)
    yield
    tracking.set_tracking_uri(None)
    jtracking.set_tracking_uri(None)


@pytest.fixture()
def stub_server():
    srv, uri, state = _serve()
    try:
        yield uri, state
    finally:
        srv.shutdown()
        srv.server_close()


def test_rest_round_trip_log_then_query(stub_server, tmp_path):
    uri, state = stub_server
    tracking.set_tracking_uri(uri)
    assert tracking.tracking_location() == uri
    exp_id = tracking.set_experiment("rest-exp")
    assert exp_id == "1"

    art = tmp_path / "report.json"
    art.write_text('{"ok": true}')
    with tracking.start_run(run_name="svm_c1") as run:
        run.log_batch(params={"model": "svm", "features_dir": "/tmp/f_train"})
        run.log_batch(metrics={"val_accuracy": 0.91, "val_f1_macro": 0.90})
        run.log_param("cv_folds", 4)
        run.log_metric("loss", 0.5, step=2)
        run.set_tag("stage", "train")
        run.log_artifact(art)
    assert tracking._ACTIVE_RUN is None
    with tracking.start_run(run_name="svm_c2") as run:   # a worse metric, to rank
        run.log_batch(params={"model": "svm"}, metrics={"val_accuracy": 0.80, "val_f1_macro": 0.78})

    # set_experiment resolves to the same id the second time (get-by-name)
    assert tracking.set_experiment("rest-exp") == exp_id

    recs = tracking.search_runs("rest-exp", status="FINISHED")
    assert len(recs) == 2
    by_name = {r.run_name: r for r in recs}
    assert by_name["svm_c1"].metrics["val_accuracy"] == pytest.approx(0.91)
    assert by_name["svm_c1"].metrics["loss"] == pytest.approx(0.5)
    assert by_name["svm_c1"].params == {"model": "svm", "features_dir": "/tmp/f_train", "cv_folds": "4"}
    assert by_name["svm_c1"].tags["stage"] == "train" and by_name["svm_c1"].tags["mlflow.runName"] == "svm_c1"
    assert by_name["svm_c1"].status == "FINISHED"
    assert state.batch_calls == 3
    # the artifact went through the mlflow-artifacts proxy, under its run
    art_keys = [k for k in state.artifacts if k.endswith("report.json")]
    assert len(art_keys) == 1 and state.artifacts[art_keys[0]] == b'{"ok": true}'
    assert by_name["svm_c1"].run_id in art_keys[0]

    got = tracking.get_run(by_name["svm_c1"].run_id)
    assert got is not None and got.metrics["val_f1_macro"] == pytest.approx(0.90)
    assert tracking.get_run("does-not-exist") is None
    assert tracking.search_runs("no-such-experiment") == []


def test_rest_failed_run_status_and_artifact_dir(stub_server, tmp_path):
    uri, state = stub_server
    tracking.set_tracking_uri(uri)
    tracking.set_experiment("rest-exp2")
    with pytest.raises(RuntimeError, match="boom"):
        with tracking.start_run(run_name="bad"):
            raise RuntimeError("boom")
    recs = tracking.search_runs("rest-exp2", status="FAILED")
    assert len(recs) == 1 and recs[0].run_name == "bad"
    assert tracking.search_runs("rest-exp2") == []
    # a directory uploads recursively under <dirname>/...
    d = tmp_path / "bundle"
    (d / "sub").mkdir(parents=True)
    (d / "a.txt").write_text("A")
    (d / "sub" / "b.txt").write_text("B")
    with tracking.start_run(run_name="arts") as run:
        run.log_artifact(d)
    assert sorted(k.split("/artifacts/", 1)[1] for k in state.artifacts) == ["bundle/a.txt", "bundle/sub/b.txt"]


def test_rest_shared_artifact_root_writes_files(tmp_path):
    root = tmp_path / "shared"
    srv, uri, _ = _serve(str(root))
    try:
        tracking.set_tracking_uri(uri)
        tracking.set_experiment("shared")
        art = tmp_path / "model.npz"
        art.write_bytes(b"\x00\x01\r\n")
        with tracking.start_run(run_name="m") as run:
            run.log_artifact(art)
        (rec,) = tracking.search_runs("shared")
        assert rec.artifact_uri.startswith(str(root))
        assert (Path(rec.artifact_uri) / "model.npz").read_bytes() == b"\x00\x01\r\n"
    finally:
        srv.shutdown()
        srv.server_close()


def test_select_preopt_ranks_against_rest_backend(stub_server):
    uri, _ = stub_server
    tracking.set_tracking_uri(uri)
    tracking.set_experiment("sel-exp")
    for name, acc, f1 in [("m_lo", 0.70, 0.65), ("m_hi", 0.95, 0.94), ("m_mid", 0.85, 0.83)]:
        with tracking.start_run(run_name=name) as run:
            run.log_batch(params={"model": name}, metrics={"val_accuracy": acc, "val_f1_macro": f1})
    ranked = tselect.select_preopt("sel-exp", mlflow_uri=uri, min_accuracy=0.75, top_n=5)
    assert [r["run_name"] for r in ranked] == ["m_hi", "m_mid"]


def test_unreachable_server_raises_tracking_error():
    tracking.set_tracking_uri("http://127.0.0.1:1")  # port 1: nothing listens
    with pytest.raises(tracking.TrackingServerError, match="unreachable"):
        tracking.set_experiment("nope")


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_run_written_by_one_package_reads_back_in_the_other(stub_server, writer):
    uri, _ = stub_server
    write, read = (jtracking, tracking) if writer == "jax" else (tracking, jtracking)
    write.set_tracking_uri(uri)
    read.set_tracking_uri(uri)
    write.set_experiment("shared-exp")
    with write.start_run(run_name=f"{writer}_run") as run:
        run.log_batch(params={"model": "cnn", "epochs": 3}, metrics={"val_accuracy": 0.5, "val_f1_macro": 0.25})
        run.log_param("features_dir", "/data/mel")
        run.set_tag("writer", writer)
    (rec,) = read.search_runs("shared-exp")
    assert rec.run_name == f"{writer}_run" and rec.status == "FINISHED"
    assert rec.params == {"model": "cnn", "epochs": "3", "features_dir": "/data/mel"}
    assert rec.metrics == {"val_accuracy": 0.5, "val_f1_macro": 0.25}
    assert rec.tags["writer"] == writer
    again = read.get_run(rec.run_id)
    assert (again.run_name, again.params, again.metrics) == (rec.run_name, rec.params, rec.metrics)


def _module_api_session(trk, experiment: str, art: Path) -> None:
    """The MLflow-style module functions of ``trk`` (either package), as
    tests/test_tracking_rest.py drives the JAX ones."""
    trk.set_experiment(experiment)
    assert trk.active_run() is None
    trk.log_metric("ignored", 1.0)   # no active run: nothing is logged
    with trk.start_run(run_name="svm_c1") as run:
        assert trk.active_run() is run
        trk.log_params({"model": "svm", "features_dir": "/tmp/f_train"})
        trk.log_metrics({"val_accuracy": 0.91, "val_f1_macro": 0.90, "note": "not a number"})
        trk.log_metric("loss", 0.5, step=2)
        trk.set_tag("stage", "train")
        trk.log_artifact(art)
    assert trk.active_run() is None
    trk.start_run(run_name="svm_c2")
    trk.log_params({"model": "svm"})
    trk.log_metrics({"val_accuracy": 0.80, "val_f1_macro": 0.78})
    trk.end_run("FAILED")
    assert trk.active_run() is None
    trk.end_run()   # nothing active: a no-op


@pytest.mark.parametrize("store", ["rest", "file"])
def test_module_level_api_records_what_the_jax_one_records(stub_server, tmp_path, store):
    """active_run, end_run, log_params, log_metric, log_metrics, log_artifact
    and set_tag on the port's active run, REST or file store, against the
    same calls of the JAX package's functions."""
    uri, state = stub_server
    art = tmp_path / "report.json"
    art.write_text('{"ok": true}')
    records = {}
    for name, trk in (("jax", jtracking), ("port", tracking)):
        trk.set_tracking_uri(uri if store == "rest" else str(tmp_path / f"mlruns_{name}"))
        _module_api_session(trk, f"module-api-{name}", art)
        recs = sorted(trk.search_runs(f"module-api-{name}", status=None), key=lambda r: r.run_name)
        records[name] = [(r.run_name, r.status, r.params, r.metrics, r.tags) for r in recs]
        ((_, c1),) = [(r.run_name, r) for r in recs if r.run_name == "svm_c1"]
        if store == "rest":
            assert state.artifacts[next(k for k in state.artifacts if c1.run_id in k)] == b'{"ok": true}'
        else:
            assert (Path(c1.artifact_uri) / "report.json").read_text() == '{"ok": true}'
    assert records["port"] == records["jax"]
    (c1, c2) = records["port"]
    assert c1[1:4] == ("FINISHED", {"model": "svm", "features_dir": "/tmp/f_train"},
                       {"val_accuracy": 0.91, "val_f1_macro": 0.90, "loss": 0.5})
    assert c1[4]["stage"] == "train" and c2[1] == "FAILED" and c2[3] == {"val_accuracy": 0.80, "val_f1_macro": 0.78}


@pytest.mark.parametrize("store", ["rest", "file"])
def test_nested_runs_finalize_and_restore_the_outer_run(stub_server, tmp_path, store):
    """tests/test_infra.py's nested runs on the port: each run finalizes
    itself and hands active_run back to the run it interrupted."""
    uri, _ = stub_server
    tracking.set_tracking_uri(uri if store == "rest" else str(tmp_path / "mlruns"))
    tracking.set_experiment("nested")
    with tracking.start_run(run_name="outer") as outer:
        with tracking.start_run(run_name="inner") as inner:
            assert tracking.active_run() is inner
        assert tracking.active_run() is outer
        assert inner.info.status == "FINISHED"
        tracking.log_metric("m", 1.0)   # lands on the outer run
    assert outer.info.status == "FINISHED"
    assert tracking.active_run() is None
    runs = {r.run_name: r for r in tracking.search_runs("nested", status="FINISHED")}
    assert set(runs) == {"outer", "inner"} and runs["outer"].metrics == {"m": 1.0} and runs["inner"].metrics == {}


# ---------------------------------------------------------------------------
# The port's stage CLIs (train sweep -> select -> optimize, and tune) with
# MLFLOW_TRACKING_URI=http://<stub> and a shared-filesystem artifact root,
# against the same CLIs on a file store.
# ---------------------------------------------------------------------------

NAMES = ["a", "b", "c"]


def _make_featuresets(root: Path) -> None:
    def make(n_per_class, seed):
        rr = np.random.default_rng(seed)
        X, y = [], []
        for c in range(3):
            mu = np.zeros(24)
            mu[c * 8 : c * 8 + 8] = 1.3  # overlapping blobs: distinct model scores
            X.append(rr.normal(mu, 1.0, size=(n_per_class, 24)))
            y.append(np.full(n_per_class, c))
        X = np.concatenate(X).astype(np.float32)
        y = np.concatenate(y).astype(np.int32)
        idx = rr.permutation(len(X))
        return X[idx], y[idx]

    for name, (X, y) in [("synth_train", make(30, 1)), ("synth_val", make(8, 2))]:
        FeaturePipeline.save(FeatureSet(features=X, feature_type="classical", modality="audio",
                                        metadata=[{} for _ in range(len(X))], labels=y, label_names=NAMES),
                             root / name)


def _run_pipeline(workdir: Path, feats: Path, tracking_uri: str, mp: pytest.MonkeyPatch) -> dict:
    """train (config sweep) -> select -> optimize, and a tune study, through
    the port's CLIs on the CPU with MLFLOW_TRACKING_URI set. Returns their
    JSON files."""
    workdir.mkdir(parents=True, exist_ok=True)
    mp.setenv("MLFLOW_TRACKING_URI", tracking_uri)
    mp.chdir(workdir)
    out = workdir / "models"
    cfg = workdir / "training.yaml"
    cfg.write_text(f"features_dir: {feats / 'synth_train'}\noutput_dir: {out}\nexperiment: rest-pipe\n"
                   "val_split: 0.2\nauto_select_top_n: 2\nruns:\n  - model: lda\n  - model: knn\n")
    ttrain.main(["--config", str(cfg), "--device", "cpu"])
    sl_train = json.loads((out / "shortlist.json").read_text())

    sl2_path = workdir / "sl2.json"
    tselect.main(["--experiment", "rest-pipe", "--top-n", "2", "--output", str(sl2_path),
                  "--features-eval-dir", str(feats / "synth_val")])
    sl2 = json.loads(sl2_path.read_text())

    opt_dir = workdir / "optimized"
    toptimize.main(["--shortlist", str(sl2_path), "--features", str(feats / "synth_train"),
                    "--features-eval", str(feats / "synth_val"), "--output", str(opt_dir),
                    "--experiment", "rest-pipe-opt", "--device", "cpu"])
    reports = {}
    for p in sorted(opt_dir.glob("*/optimization_report.json")):
        rep = json.loads(p.read_text())
        reports[rep["model_name"]] = rep

    tcfg = workdir / "tuning.yaml"
    tcfg.write_text(f"output_dir: {workdir / 'tuned'}\nexperiment: rest-tune\nfeatures_dir: {feats / 'synth_train'}\n"
                    f"features_test: {feats / 'synth_val'}\ncv: 3\nscoring: f1_macro\nseed: 42\nruns:\n"
                    "  - model: lda\n    grid: {solver: [svd, lsqr]}\n")
    ttune.main(["--config", str(tcfg), "--device", "cpu"])
    tuned = json.loads((workdir / "tuned" / "shortlist.json").read_text())
    mp.delenv("MLFLOW_TRACKING_URI")
    return {"shortlist": sl_train, "select": sl2, "reports": reports, "tune": tuned}


@pytest.fixture(scope="module")
def pipelines(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("rest_pipe")
    feats = tmp / "feats"
    _make_featuresets(feats)
    art_root = tmp / "artifacts_sharedfs"
    srv, uri, state = _serve(str(art_root))
    mp = pytest.MonkeyPatch()
    try:
        rest = _run_pipeline(tmp / "rest", feats, uri, mp)
        filed = _run_pipeline(tmp / "filed", feats, str(tmp / "filed" / "mlruns"), mp)
    finally:
        mp.undo()
        srv.shutdown()
        srv.server_close()
        tracking.set_tracking_uri(None)
    return {"rest": rest, "filed": filed, "art_root": art_root, "state": state}


def _ranking(doc):
    return [(c["rank"], c["model"], round(c["val_accuracy"], 6), round(c["val_f1_macro"], 6))
            for c in doc["candidates"]]


@pytest.mark.parametrize("stage", ["shortlist", "select", "tune"])
def test_rest_cli_shortlists_equal_the_file_store(pipelines, stage):
    rest, filed = pipelines["rest"][stage], pipelines["filed"][stage]
    assert set(rest) == set(filed)
    assert all(set(c) == set(filed["candidates"][0]) for c in rest["candidates"])
    assert _ranking(rest) == _ranking(filed)
    assert rest["candidates"]


def test_rest_train_artifacts_land_in_the_shared_root(pipelines):
    art_root = pipelines["art_root"]
    assert len(pipelines["rest"]["shortlist"]["candidates"]) == 2
    for c in pipelines["rest"]["shortlist"]["candidates"]:
        assert c["artifact_uri"].startswith(str(art_root))
        assert any(Path(c["artifact_uri"]).glob("*.npz"))
    names = {run["info"]["run_name"] for run in pipelines["state"].runs.values()}
    assert any(n.startswith("lda_") for n in names) and any(n.startswith("knn_") for n in names)
    assert sum(n.startswith("opt_") for n in names) == 2


def test_rest_optimize_reports_equal_the_file_store(pipelines):
    rest, filed = pipelines["rest"]["reports"], pipelines["filed"]["reports"]
    assert set(rest) == set(filed) == {"lda", "knn"}
    for m in rest:
        assert set(rest[m]) == set(filed[m])
        assert set(rest[m]["benchmark_results"]) == set(filed[m]["benchmark_results"])
        assert rest[m]["quantization_method"] == filed[m]["quantization_method"]
