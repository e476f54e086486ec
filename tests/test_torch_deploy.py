"""Port parity: C codegen (``deploy/``) and the TFLite Micro header
(``compilation/generate_c_header.py``) of audio_edge_ml_pipeline_torch
against the JAX package's, on the CPU: generated projects byte-equal for the
same bundle (a cnn the port trained in fp32, dynamic_int8 and static_int8,
and a ds_cnn the JAX package trained, which covers the BatchNorm branch),
the gcc host harness within 1e-4 of the port's ``predict_proba`` and its C
mel within 5e-5 of the port's ``mel_spec_feature``, ``deploy --report``
routing, the arena estimate, the MicroPython pca_svm export and the header."""

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from audio_edge_ml_pipeline_tpu.compilation import generate_c_header as jhdr
from audio_edge_ml_pipeline_tpu.deploy import arena as jarena
from audio_edge_ml_pipeline_tpu.deploy import codegen as jcg
from audio_edge_ml_pipeline_tpu.deploy import deploy as jdeploy
from audio_edge_ml_pipeline_tpu.deploy import export_svm as jexport
from audio_edge_ml_pipeline_tpu.models import get_model as jget
from audio_edge_ml_pipeline_torch.compilation import generate_c_header as thdr
from audio_edge_ml_pipeline_torch.deploy import arena as tarena
from audio_edge_ml_pipeline_torch.deploy import codegen as tcg
from audio_edge_ml_pipeline_torch.deploy import deploy as tdeploy
from audio_edge_ml_pipeline_torch.deploy import export_svm as texport
from audio_edge_ml_pipeline_torch.models import get_model
from audio_edge_ml_pipeline_torch.ops import golden, mel_kernel
from audio_edge_ml_pipeline_torch.optimize import quantize as tq

LABELS = ["a", "b", "c"]
N_MELS, N_FRAMES, HOP, SR = 16, 51, 160, 16000
DURATION = (N_FRAMES - 1) * HOP / SR
C_SCORE_TOL = 1e-4   # tests/test_codegen.py, tests/test_codegen_ext.py
C_MEL_TOL = 5e-5     # tests/test_codegen.py: float32 C against the float64 oracle


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _spec_blobs(seed, n_per=25):
    r = np.random.default_rng(seed)
    X = r.uniform(0, 0.3, size=(3 * n_per, N_MELS, N_FRAMES)).astype(np.float32)
    y = np.repeat(np.arange(3), n_per).astype(np.int32)
    for c in range(3):
        X[y == c, c * 5 : c * 5 + 4, :] += 0.6
    idx = r.permutation(len(X))
    return np.clip(X, 0, 1)[idx], y[idx]


@pytest.fixture(scope="module")
def bundles(tmp_path_factory):
    """name -> (bundle path, the port's CPU view of it, eval rows): a cnn the
    port trained, its dynamic_int8 and static_int8 artifacts, and a ds_cnn
    the JAX package trained (view None: the port has no ds_cnn yet)."""
    root = tmp_path_factory.mktemp("tdeploy")
    X, y = _spec_blobs(7)
    cnn = get_model("cnn")(epochs=6, batch_size=16, filters=[8, 8], first_stride=2, learning_rate=5e-3, device="cpu")
    cnn.fit(X[:60], y[:60], X[60:], y[60:], LABELS, "cnn", root / "cnn", None)
    fp32 = root / "cnn" / "model.flax.npz"
    out = {"cnn_fp32": (fp32, cnn, X[60:])}
    for mode in ("dynamic_int8", "static_int8"):
        art = root / f"model_{mode}.npz"
        out[f"cnn_{mode}"] = (art, tq._quantize_deep_bundle(fp32, mode, art, X[:60], device="cpu"), X[60:])
    Xd, yd = _spec_blobs(6)
    ds = jget("ds_cnn")(epochs=2, batch_size=16, filters=[8, 16], first_stride=2, pool="avg", batch_norm=True,
                        learning_rate=5e-3)
    ds.fit(Xd[:60], yd[:60], Xd[60:], yd[60:], LABELS, "ds", root / "ds", None)
    out["ds_cnn"] = (root / "ds" / "model.flax.npz", None, Xd[60:])
    return out


BOARDS = {"cnn_fp32": "nicla_vision", "cnn_dynamic_int8": "generic", "cnn_static_int8": "esp32s3",
          "ds_cnn": "xiao_nrf52840"}


def _generate(module, bundle, out, board):
    gen = module.ModelToC(bundle, LABELS, sample_rate=SR, n_mels=N_MELS, n_fft=512, hop_length=HOP,
                          duration=DURATION, board=board, max_ram_kb=180)
    gen.generate(out)
    return gen


def _assert_same_project(ours, theirs):
    files = sorted(p.relative_to(theirs) for p in theirs.rglob("*") if p.is_file())
    assert files == sorted(p.relative_to(ours) for p in ours.rglob("*") if p.is_file())
    for rel in files:
        if rel.name == "codegen_report.json":
            a, b = (json.loads((d / rel).read_text()) for d in (ours, theirs))
            assert {**a, "bundle": None} == {**b, "bundle": None}
        else:
            assert (ours / rel).read_bytes() == (theirs / rel).read_bytes(), rel


@pytest.fixture(scope="module")
def projects(bundles, tmp_path_factory):
    """name -> (port project dir, JAX project dir, port generator)."""
    root = tmp_path_factory.mktemp("projects")
    out = {}
    for name, (bundle, _, _) in bundles.items():
        gen = _generate(tcg, bundle, root / name / "port", BOARDS[name])
        _generate(jcg, bundle, root / name / "jax", BOARDS[name])
        out[name] = (root / name / "port", root / name / "jax", gen)
    return out


@pytest.mark.parametrize("name", sorted(BOARDS))
def test_project_is_byte_equal_to_jax(projects, name):
    ours, theirs, gen = projects[name]
    _assert_same_project(ours, theirs)
    report = json.loads((ours / "codegen_report.json").read_text())
    assert report["quantization"] == {"cnn_dynamic_int8": "dynamic_int8", "cnn_static_int8": "static_int8"}.get(
        name, "fp32")
    if name == "ds_cnn":
        assert {"dwconv2d", "batchnorm", "avgpool2d"} <= {p["op"] for p in gen.plan}
    if name.endswith("int8"):
        assert "signed char wt_conv0_k" in (ours / "src" / "weights.c").read_text()


def _compile(out):
    srcs = [out / "host_main.c"] + sorted((out / "src").glob("*.c"))
    exe = out / "host_runner"
    r = subprocess.run(["gcc", "-O2", "-std=c99", f"-I{out / 'src'}", "-o", str(exe), *map(str, srcs), "-lm"],
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stderr
    return exe


@pytest.fixture(scope="module")
def harness(projects):
    return {name: _compile(projects[name][0]) for name in ("cnn_fp32", "cnn_dynamic_int8", "cnn_static_int8")}


@pytest.mark.parametrize("name", ["cnn_fp32", "cnn_dynamic_int8", "cnn_static_int8"])
def test_host_harness_matches_the_port_view(bundles, projects, harness, name):
    _, view, Xv = bundles[name]
    out = projects[name][0]
    for feat in Xv[:3]:
        (out / "feat.f32").write_bytes(feat.astype(np.float32).tobytes())
        r = subprocess.run([str(harness[name]), "--predict-feat", str(out / "feat.f32")], capture_output=True,
                           text=True)
        assert r.returncode == 0, r.stderr
        c_scores = np.array([float(v) for v in r.stdout.split()])
        ours = view.predict_proba(feat[None])[0]
        assert c_scores.shape == ours.shape == (3,)
        assert np.max(np.abs(c_scores - ours)) <= C_SCORE_TOL
        assert c_scores.argmax() == ours.argmax()


def test_c_mel_frontend_matches_the_port_mel_feature(projects, harness):
    out, _, gen = projects["cnn_fp32"]
    rng = np.random.default_rng(3)
    t = np.arange(gen.n_samples) / SR
    wav = (0.5 * np.sin(2 * np.pi * 440 * t) + 0.05 * rng.standard_normal(gen.n_samples)).astype(np.float32)
    (out / "wav.f32").write_bytes(wav.tobytes())
    r = subprocess.run([str(harness["cnn_fp32"]), "--features", str(out / "wav.f32")], capture_output=True, text=True)
    assert r.returncode == 0, r.stderr
    c_feat = np.array([float(x) for x in r.stdout.split()]).reshape(gen.n_mels, gen.n_frames)
    ours = mel_kernel.mel_spec_feature(torch.from_numpy(wav[None]), sr=SR, n_mels=N_MELS, n_fft=512,
                                       hop_length=HOP)[0].numpy()
    assert np.max(np.abs(c_feat - ours)) <= C_MEL_TOL
    assert np.max(np.abs(c_feat - golden.mel_spec_feature(wav, sr=SR, n_mels=N_MELS, n_fft=512,
                                                          hop_length=HOP))) <= C_MEL_TOL


def test_deploy_report_routes_the_chosen_artifact(bundles, tmp_path):
    art = bundles["cnn_dynamic_int8"][0]
    report = {"optimized_model_path": str(art), "original_model_path": str(bundles["cnn_fp32"][0]),
              "quantization_method": "dynamic_int8", "class_filter": json.dumps(["a", "b", "c"]),
              "feature_params": {"sample_rate": SR, "n_mels": N_MELS, "n_fft": 512, "hop_length": HOP,
                                 "duration": DURATION}}
    (tmp_path / "optimization_report.json").write_text(json.dumps(report))
    (tmp_path / "fs").mkdir()
    (tmp_path / "fs" / "label_names.json").write_text(json.dumps(["c", "b", "a", "d"]))
    args = ["--report", str(tmp_path / "optimization_report.json"), "--features-dir", str(tmp_path / "fs"),
            "--board", "generic"]
    tdeploy.main([*args, "--output", str(tmp_path / "port")])
    jdeploy.main([*args, "--output", str(tmp_path / "jax")])
    _assert_same_project(tmp_path / "port", tmp_path / "jax")
    cg = json.loads((tmp_path / "port" / "codegen_report.json").read_text())
    assert cg["bundle"] == str(art) and cg["quantization"] == "dynamic_int8"
    assert cg["labels"] == ["a", "b", "c"]   # the report's class filter, class-name sorted


def test_deploy_cli_infers_the_frontend_from_the_featureset(bundles, tmp_path):
    """--features-dir: labels from label_names.json, duration from info.json's
    (n_mels, n_frames), as JAX does."""
    from audio_edge_ml_pipeline_torch.features.base import FeatureSet
    from audio_edge_ml_pipeline_torch.features.pipeline import FeaturePipeline

    _, _, Xv = bundles["cnn_fp32"]
    FeaturePipeline.save(FeatureSet(features=Xv, feature_type="deep", modality="audio", metadata=[{} for _ in Xv],
                                    labels=np.zeros(len(Xv), np.int32), label_names=LABELS), tmp_path / "fs")
    args = ["--model", str(bundles["cnn_fp32"][0]), "--features-dir", str(tmp_path / "fs"), "--n-mels", "40"]
    tdeploy.main([*args, "--output", str(tmp_path / "port")])
    jdeploy.main([*args, "--output", str(tmp_path / "jax")])
    _assert_same_project(tmp_path / "port", tmp_path / "jax")
    fe = json.loads((tmp_path / "port" / "codegen_report.json").read_text())["frontend"]
    assert (fe["n_mels"], fe["n_frames"], fe["duration"]) == (N_MELS, N_FRAMES, DURATION)


def test_codegen_refuses_a_non_mel_input_as_jax_does(tmp_path):
    """The shipped mlp reads 302-d vectors: no mel frontend produces them."""
    mlp = get_model("mlp")(hidden_units=[8], device="cpu")
    mlp.initialize((302,), 3, torch.Generator().manual_seed(0))
    mlp.save(tmp_path / "mlp.npz")
    errors = []
    for module in (tcg, jcg):
        with pytest.raises(ValueError, match="frontend geometry") as exc:
            _generate(module, tmp_path / "mlp.npz", tmp_path / "out", "generic")
        errors.append(str(exc.value))
    assert errors[0] == errors[1]


def test_arena_estimate_matches_jax(projects):
    layers = [("normalize", (40, 501, 1), (40, 501, 1)), ("conv1", (40, 501, 1), (10, 126, 16)),
              ("conv2", (10, 126, 16), (5, 63, 64)), ("dense", (20160,), (27,))]
    ours, theirs = tarena.estimate_arena(layers), jarena.estimate_arena(layers)
    assert (ours.peak_bytes, ours.buffer_bytes, ours.table()) == (theirs.peak_bytes, theirs.buffer_bytes,
                                                                   theirs.table())
    with pytest.raises(MemoryError):
        ours.check_max_ram(100)
    gen = projects["ds_cnn"][2]
    assert gen.arena.table() == jcg.ModelToC(gen.bundle_path, LABELS, n_mels=N_MELS, duration=DURATION,
                                             board="generic").arena.table()


@pytest.fixture(scope="module")
def pca_svm_bundle(tmp_path_factory):
    root = tmp_path_factory.mktemp("psvm")
    r = np.random.default_rng(2)
    y = np.repeat(np.arange(3), 15).astype(np.int32)
    X = (r.standard_normal((3, 20))[y] * 2 + r.standard_normal((45, 20))).astype(np.float32)
    tr = get_model("pca_svm")(n_components=5, kernel="linear", iters=300, device="cpu")
    tr.fit(X, y, X[:9], y[:9], LABELS, "p", root / "run", None)
    return root / "run" / "pca_svm.npz"


def test_export_svm_matches_jax(pca_svm_bundle, tmp_path):
    for module, key in ((texport, "port"), (jexport, "jax")):
        module.export_bundle(pca_svm_bundle, tmp_path / key, LABELS, sample_rate=22050)
    files = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert files == sorted(p.name for p in (tmp_path / "port").iterdir())
    assert "nicla_main.py" in files and "svm_coef.npy" in files
    for f in files:
        if f.endswith(".npy"):
            a, b = np.load(tmp_path / "port" / f), np.load(tmp_path / "jax" / f)
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b, err_msg=f)
        else:
            assert (tmp_path / "port" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes(), f


def test_export_svm_refuses_rbf_and_names_joblib(tmp_path, monkeypatch):
    r = np.random.default_rng(1)
    y = np.repeat(np.arange(3), 8).astype(np.int32)
    X = (r.standard_normal((3, 6))[y] + r.standard_normal((24, 6))).astype(np.float32)
    tr = get_model("pca_svm")(n_components=3, kernel="rbf", iters=50, device="cpu")
    tr.fit(X, y, X, y, LABELS, "p", tmp_path / "run", None)
    with pytest.raises(ValueError, match="kernel: linear"):
        texport.export_bundle(tmp_path / "run" / "pca_svm.npz", tmp_path / "out", LABELS)
    (tmp_path / "legacy.joblib").write_bytes(b"")
    monkeypatch.setitem(sys.modules, "joblib", None)
    with pytest.raises(ImportError, match="joblib"):
        texport.export_bundle(tmp_path / "legacy.joblib", tmp_path / "out", LABELS)


def test_generate_c_header_matches_jax(tmp_path):
    blob = np.random.default_rng(0).integers(0, 256, 1003, dtype=np.uint8).tobytes()
    (tmp_path / "model.tflite").write_bytes(blob)
    for module, key in ((thdr, "port"), (jhdr, "jax")):
        (tmp_path / key).mkdir()
        module.generate_header(tmp_path / "model.tflite", tmp_path / key / "model_data.h")
    ours = (tmp_path / "port" / "model_data.h").read_bytes()
    assert ours == (tmp_path / "jax" / "model_data.h").read_bytes()
    assert b"const size_t g_model_len = 1003;" in ours and b"#ifndef MODEL_DATA_H" in ours
