"""The port stands alone: audio_edge_ml_pipeline_torch and chip_smoke.py
import no jax and nothing of the JAX package, and its entry points never run
on the CPU unless asked to."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "audio_edge_ml_pipeline_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "audio_edge_ml_pipeline_tpu")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _port_modules():
    mods = []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(REPO).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        mods.append(".".join(parts))
    return mods


def test_importing_every_port_module_leaves_jax_out():
    mods = _port_modules()
    assert "audio_edge_ml_pipeline_torch.ops.mel_kernel" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print('BAD', bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(REPO), env.get("PYTHONPATH", "")]).rstrip(os.pathsep)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]


def test_post_training_clis_load_no_jax_ml_dtypes_sklearn_or_joblib():
    """The H100 machine has none of them (nor matplotlib or requests): the
    post-training, serving and compile CLIs, the text and tabular extractors
    and what they stand on, and the extraction CLI import them at no point of
    their import."""
    mods = ["audio_edge_ml_pipeline_torch.optimize.optimize", "audio_edge_ml_pipeline_torch.train.select",
            "audio_edge_ml_pipeline_torch.deploy.deploy", "audio_edge_ml_pipeline_torch.deploy.export_svm",
            "audio_edge_ml_pipeline_torch.compilation.generate_c_header",
            "audio_edge_ml_pipeline_torch.serve.api", "audio_edge_ml_pipeline_torch.serve.audio_processor",
            "audio_edge_ml_pipeline_torch.serve.dashboard", "audio_edge_ml_pipeline_torch.serve.edge_simulator",
            "audio_edge_ml_pipeline_torch.train.dataset", "audio_edge_ml_pipeline_torch.compilation.compile_xla",
            "audio_edge_ml_pipeline_torch.data.native_wavio", "audio_edge_ml_pipeline_torch.utils.tracking",
            "audio_edge_ml_pipeline_torch.features.text", "audio_edge_ml_pipeline_torch.features.tabular",
            "audio_edge_ml_pipeline_torch.features.vectorize", "audio_edge_ml_pipeline_torch.features.preprocess",
            "audio_edge_ml_pipeline_torch.ops.textops", "audio_edge_ml_pipeline_torch.ops.lsa",
            "audio_edge_ml_pipeline_torch.data.loaders", "audio_edge_ml_pipeline_torch.features.pipeline"]
    absent = (*FORBIDDEN, "ml_dtypes", "sklearn", "joblib", "matplotlib", "requests")
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {absent!r})\n"
        "print('BAD', bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(REPO), env.get("PYTHONPATH", "")]).rstrip(os.pathsep)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_import_statement(path):
    assert not (_imported_roots(path) & set(FORBIDDEN)), path


@pytest.fixture()
def no_cuda(monkeypatch):
    """A machine without a card, whatever this one has."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_without_device_raise_when_cuda_is_absent(no_cuda, tmp_path):
    from audio_edge_ml_pipeline_torch import entry
    from audio_edge_ml_pipeline_torch.features import pipeline
    from audio_edge_ml_pipeline_torch.features.audio import AudioMelSpectrogram
    from audio_edge_ml_pipeline_torch.models import deep
    from audio_edge_ml_pipeline_torch.optimize import optimize, quantize
    from audio_edge_ml_pipeline_torch.serve.edge_simulator import EdgeDeviceSimulator
    from audio_edge_ml_pipeline_torch.compilation import compile_xla
    from audio_edge_ml_pipeline_torch.serve import audio_processor
    from audio_edge_ml_pipeline_torch.train import train

    bundle = tmp_path / "m.npz"
    tr = deep.CNNTrainer(filters=[4], device="cpu")
    tr.initialize((40, 51, 1), 3, torch.Generator().manual_seed(0))
    tr.save(bundle)
    (tmp_path / "data" / "a").mkdir(parents=True)
    from audio_edge_ml_pipeline_torch.data.audio_io import write_wav

    write_wav(tmp_path / "data" / "a" / "x.wav", np.zeros(800, np.float32), 16000)

    calls = [
        lambda: AudioMelSpectrogram(),
        lambda: deep.CNNTrainer(),
        lambda: deep.load_any_model(bundle),
        lambda: entry.entry(),
        lambda: EdgeDeviceSimulator(bundle, ["a", "b", "c"], tmp_path / "data"),
        lambda: pipeline._run_experiment(pipeline_exp(tmp_path)),
        lambda: train.main(["--features", str(tmp_path), "--model", "cnn"]),
        lambda: quantize.load_trainer_any(bundle, "cnn"),
        lambda: optimize.main(["--model-path", str(bundle), "--model-name", "cnn", "--no-tracking",
                               "--output", str(tmp_path / "opt")]),
        lambda: audio_processor.main(["--input", str(tmp_path / "data" / "a"), "--output", str(tmp_path / "mel")]),
        lambda: compile_xla.main(["--model", str(bundle), "--features", str(tmp_path)]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    # asking for the CPU is the only way onto it
    assert AudioMelSpectrogram(device="cpu").device.type == "cpu"


def pipeline_exp(tmp_path):
    from audio_edge_ml_pipeline_torch.features.config import ExperimentConfig

    return ExperimentConfig(extractor="audio_mel_spec", loader="audio_folder",
                            dataset=str(tmp_path / "data"), split="all", output=str(tmp_path / "out"))


def test_unported_names_raise_not_yet_ported(tmp_path):
    """Every extractor and loader name of the JAX package is ported now: the
    text and tabular ones resolve, an unknown name is still a KeyError."""
    from audio_edge_ml_pipeline_torch.data.loaders import TabularLoader, build_loader
    from audio_edge_ml_pipeline_torch.features.registry import NOT_YET_PORTED, get
    from audio_edge_ml_pipeline_torch.features.text import TextTFIDFExtractor

    assert not NOT_YET_PORTED
    assert get("text_tfidf") is TextTFIDFExtractor
    with pytest.raises(KeyError):
        get("no_such_extractor")
    (tmp_path / "rows.csv").write_text("a,label\n1,x\n")
    assert isinstance(build_loader("tabular", str(tmp_path / "rows.csv"), "train", label_col="label"), TabularLoader)
