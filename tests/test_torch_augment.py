"""The port's augmentation stage (``features/augment.py``) against the JAX
package's: the same augmentors bit for bit, the host backend's output tree
byte for byte at any worker count (shipped ``configs/augmentation.yaml``
layout: ``audio_folder`` with a split manifest, a ``Thunderstorm`` override
that time-stretches; and the ``fsc22`` loader), the device backend on the
CPU (``device="cpu"``) against the host backend: byte for byte without a
vocoder stage, within 5e-3 with one and 1e-2 with two (the tolerances of
``tests/test_effects_jax.py``), its vocoder copies counted by route; and the
fail-fast cases of ``tests/test_augment.py``."""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from audio_edge_ml_pipeline_tpu.features import augment as jaug
from audio_edge_ml_pipeline_torch.data.audio_io import load_audio, write_wav
from audio_edge_ml_pipeline_torch.features import augment as taug

REPO = Path(__file__).resolve().parent.parent
ONE_STAGE_TOL = 5e-3
TWO_STAGE_TOL = 1e-2
CLASSES = ("Rain", "Thunderstorm", "Wind")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def src(tmp_path_factory):
    """3 classes x 4 clips of 1.5 s at 16 kHz, class-per-subfolder, with a
    split_manifest.json that puts 3 a class in train and 1 in validation."""
    root = tmp_path_factory.mktemp("aug_src") / "fsc22_device"
    rng = np.random.default_rng(7)
    manifest = {"train": [], "validation": []}
    for c, cls in enumerate(CLASSES):
        (root / cls).mkdir(parents=True)
        for i in range(4):
            t = np.arange(24000) / 16000
            y = 0.3 * np.sin(2 * np.pi * (300 + 150 * c + 20 * i) * t) + 0.1 * rng.standard_normal(len(t))
            write_wav(root / cls / f"{cls.lower()}{i}.wav", y.astype(np.float32), 16000)
            manifest["train" if i < 3 else "validation"].append(f"{cls}/{cls.lower()}{i}.wav")
    (root / "split_manifest.json").write_text(json.dumps(manifest))
    return root


def _shipped(src, out, **over):
    """configs/augmentation.yaml with its dataset, manifest and output moved."""
    doc = yaml.safe_load((REPO / "configs" / "augmentation.yaml").read_text())
    doc.update(dataset=str(src), manifest=str(src / "split_manifest.json"), output_dir=str(out), **over)
    return doc


def _cfg_file(tmp_path, name, doc):
    path = tmp_path / f"{name}.yaml"
    path.write_text(yaml.safe_dump(doc))
    return path


def _tree(root):
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(Path(root).rglob("*.wav"))}


def _waves(root):
    return {str(p.relative_to(root)): load_audio(p)[0] for p in sorted(Path(root).rglob("*.wav"))}


@pytest.fixture(scope="module")
def jax_host_tree(src, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("aug_jax")
    jaug.run(jaug.load_config(_cfg_file(tmp, "jax", _shipped(src, tmp / "out", workers=1))))
    return _tree(tmp / "out")


@pytest.mark.parametrize("workers", [1, 4])
def test_host_backend_tree_is_jaxs_byte_for_byte(src, jax_host_tree, tmp_path, workers):
    taug.run(taug.load_config(_cfg_file(tmp_path, "port", _shipped(src, tmp_path / "out", workers=workers))))
    ours = _tree(tmp_path / "out")
    assert len(jax_host_tree) == 3 * 3 * (1 + 4)               # train clips only, 4 copies each
    assert ours.keys() == jax_host_tree.keys()
    assert all(ours[k] == jax_host_tree[k] for k in ours)


def test_fsc22_loader_tree_is_jaxs_byte_for_byte(tmp_path):
    sys.path.insert(0, str(REPO / "tools"))
    try:
        import make_synth_dataset
    finally:
        sys.path.remove(str(REPO / "tools"))
    make_synth_dataset.make_fsc22(tmp_path / "fsc22", n_classes=2, per_class=5, sr=16000)
    doc = {"loader": "fsc22", "dataset": str(tmp_path / "fsc22"), "split": "train", "seed": 3, "n_augments": 2,
           "workers": 1, "level_match_db": -3.0, "sample_rate": 8000,
           "augmentations": [{"type": "gaussian_noise"}, {"type": "polarity_inversion"}, {"type": "pdm_hiss"}]}
    jaug.run(jaug.load_config(_cfg_file(tmp_path, "j", {**doc, "output_dir": str(tmp_path / "j")})))
    taug.run(taug.load_config(_cfg_file(tmp_path, "t", {**doc, "output_dir": str(tmp_path / "t")})))
    theirs, ours = _tree(tmp_path / "j"), _tree(tmp_path / "t")
    assert len(ours) == 2 * 4 * 3 and ours == theirs          # 70 % of 5 clips a class, 3 files each


@pytest.mark.parametrize("name", sorted(taug.AUGMENTORS))
def test_augmentors_are_jaxs_bit_for_bit(name):
    y = (0.5 * np.sin(2 * np.pi * 220 * np.arange(8000) / 16000)).astype(np.float32)
    ours = taug.AUGMENTORS[name](y, 16000, np.random.default_rng(0))
    theirs = jaug.AUGMENTORS[name](y, 16000, np.random.default_rng(0))
    assert ours.dtype == theirs.dtype and np.array_equal(ours, theirs)


def _run(src, tmp_path, name, backend, augs, n_augments=2, device_batch=64, device="cpu", overrides=None):
    out = tmp_path / name
    taug.run({
        "output_dir": str(out), "audio_folder": str(src), "manifest": str(src / "split_manifest.json"),
        "loader": "audio_folder", "split": "train", "seed": 11, "n_augments": n_augments,
        "preserve_length": True, "sample_rate": None, "level_match_db": 0.0, "augmentations": augs,
        "class_overrides": overrides or {}, "backend": backend, "device_batch": device_batch, "workers": 1,
    }, device=device)
    return out


@pytest.mark.parametrize("augs,tol", [
    ([{"type": "volume_scale"}, {"type": "gaussian_noise"}, {"type": "time_shift"}, {"type": "pdm_hiss"}], 0.0),
    ([{"type": "volume_scale"}, {"type": "time_stretch"}, {"type": "gaussian_noise"}], ONE_STAGE_TOL),
    ([{"type": "time_stretch"}, {"type": "pitch_shift"}], TWO_STAGE_TOL),
], ids=["no_vocoder", "one_stage", "two_stages"])
def test_device_backend_matches_host(src, tmp_path, caplog, augs, tol):
    host = _run(src, tmp_path, "host", "host", augs)
    with caplog.at_level("INFO"):
        dev = _run(src, tmp_path, "dev", "device", augs, device_batch=6)
    h, d = _waves(host), _waves(dev)
    assert h.keys() == d.keys() and len(h) == 3 * 3 * (1 + 2)
    if tol == 0.0:
        assert _tree(host) == _tree(dev)
    for k in h:
        assert h[k].shape == d[k].shape, k
        assert np.max(np.abs(h[k] - d[k])) <= tol, k
        if "_aug" not in k:
            assert np.array_equal(h[k], d[k]), k       # originals are never augmented
    stages = sum(a["type"] in ("time_stretch", "pitch_shift") for a in augs)
    counts = re.search(r"vocoder copies: (\d+) batched, (\d+) on the oracle", caplog.text)
    assert counts and (int(counts[1]), int(counts[2])) == (3 * 3 * 2 * stages, 0)


def test_device_backend_shipped_config(src, tmp_path, caplog):
    """The shipped config on the device backend: every file but the
    Thunderstorm copies byte for byte, those within the one-stage gate."""
    taug.run(taug.load_config(_cfg_file(tmp_path, "h", _shipped(src, tmp_path / "h", workers=1))))
    with caplog.at_level("INFO"):
        taug.run(taug.load_config(_cfg_file(tmp_path, "d", _shipped(src, tmp_path / "d", backend="device"))),
                 device="cpu")
    assert re.search(r"vocoder copies: 12 batched, 0 on the oracle", caplog.text)
    host, dev = _tree(tmp_path / "h"), _tree(tmp_path / "d")
    assert host.keys() == dev.keys()
    hw, dw = _waves(tmp_path / "h"), _waves(tmp_path / "d")
    for k in host:
        if k.startswith("Thunderstorm/") and "_aug" in k:
            assert hw[k].shape == dw[k].shape and 0 < np.max(np.abs(hw[k] - dw[k])) <= ONE_STAGE_TOL, k
        else:
            assert host[k] == dev[k], k


def test_small_groups_take_the_oracle(src, tmp_path, caplog):
    """A flush group under _DEVICE_MIN_GROUP copies runs the float64 oracle:
    one file a class override, 2 copies, so every group holds 2."""
    augs = [{"type": "time_stretch"}]
    overrides = {c: {"augmentations": [{"type": "time_stretch", "min_rate": 0.9 + 0.01 * i}]}
                 for i, c in enumerate(CLASSES)}
    host = _run(src, tmp_path, "host", "host", augs, overrides=overrides)
    with caplog.at_level("INFO"):
        dev = _run(src, tmp_path, "dev", "device", augs, device_batch=2, overrides=overrides)
    assert re.search(r"vocoder copies: 0 batched, 18 on the oracle", caplog.text)
    assert _tree(host) == _tree(dev)                          # the oracle is the host backend's arithmetic


def test_augmented_tree_extracts_with_split_all(src, tmp_path):
    """The augmented tree feeds the port's extraction CLI with split all:
    originals x (1 + n_augments) rows."""
    from audio_edge_ml_pipeline_torch.features import pipeline

    taug.run(taug.load_config(_cfg_file(tmp_path, "a", _shipped(src, tmp_path / "aug", workers=1))))
    pipeline.main(["--loader", "audio_folder", "--dataset", str(tmp_path / "aug"), "--split", "all",
                   "--extractor", "audio_mel_spec", "--output", str(tmp_path / "mel"), "--device", "cpu"])
    info = json.loads((tmp_path / "mel" / "info.json").read_text())
    assert info["n_samples"] == 9 * (1 + 4) and info["n_classes"] == 3


def test_config_fails_fast_on_bad_specs(tmp_path):
    bad_kwarg = tmp_path / "bad_kwarg.yaml"
    bad_kwarg.write_text("output_dir: /tmp/x\naugmentations:\n  - type: pitch_shift\n    n_steps: 2\n")
    with pytest.raises(ValueError, match="pitch_shift got unknown parameter.*n_steps.*max_steps"):
        taug.load_config(bad_kwarg)
    bad_override = tmp_path / "bad_override.yaml"
    bad_override.write_text(
        "output_dir: /tmp/x\naugmentations: []\n"
        "class_overrides:\n  rain:\n    augmentations:\n      - type: gaussian_noise\n        snr_db: 10\n")
    with pytest.raises(ValueError, match="class_overrides\\['rain'\\]: gaussian_noise"):
        taug.load_config(bad_override)
    no_root = tmp_path / "no_root.yaml"
    no_root.write_text("output_dir: /tmp/x\naugmentations: [{type: polarity_inversion}]\n")
    with pytest.raises(ValueError, match="must include 'audio_folder'"):
        list(taug._iter_samples(taug.load_config(no_root)))
    bare = tmp_path / "bare.yaml"
    bare.write_text("output_dir: /tmp/x\naugmentations: [gaussian_noise]\n")
    with pytest.raises(ValueError, match="must be a mapping with a 'type' key"):
        taug.load_config(bare)
    bad_backend = tmp_path / "bad_backend.yaml"
    bad_backend.write_text("output_dir: /tmp/x\nbackend: tpu\n")
    with pytest.raises(ValueError, match="backend must be 'host' or 'device'"):
        taug.load_config(bad_backend)
    nulls = tmp_path / "nulls.yaml"
    nulls.write_text("output_dir: /tmp/x\naugmentations:\nclass_overrides:\n")
    cfg = taug.load_config(nulls)
    assert cfg["augmentations"] == [] and cfg["class_overrides"] == {}
    null_overrides = tmp_path / "null_overrides.yaml"
    null_overrides.write_text(
        "output_dir: /tmp/x\naugmentations: [{type: polarity_inversion}]\n"
        "class_overrides:\n  dog:\n  cat:\n    augmentations:\n")
    cfg = taug.load_config(null_overrides)
    assert cfg["class_overrides"]["dog"] == {} and cfg["class_overrides"]["cat"]["augmentations"] == []
    # the defaults are JAX's
    for path in (nulls, null_overrides):
        ours, theirs = taug.load_config(path), jaug.load_config(path)
        assert ours == theirs


def test_same_stem_inputs_rejected(tmp_path):
    d = tmp_path / "src" / "dog"
    d.mkdir(parents=True)
    write_wav(d / "0.wav", np.zeros(4000, np.float32), 16000)
    write_wav(d / "0.WAV", np.zeros(4000, np.float32), 16000)
    cfg = tmp_path / "aug.yaml"
    cfg.write_text(f"loader: audio_folder\naudio_folder: {tmp_path / 'src'}\n"
                   f"output_dir: {tmp_path / 'out'}\naugmentations: [{{type: polarity_inversion}}]\n")
    with pytest.raises(ValueError, match="same output dog/0.wav"):
        taug.run(taug.load_config(cfg))


@pytest.mark.parametrize("backend", ["host", "device"])
def test_unknown_type_fails_before_any_output(src, tmp_path, backend):
    with pytest.raises(ValueError, match="Unknown augmentation type"):
        _run(src, tmp_path, "bad", backend, [{"type": "reverb"}])
    assert not list((tmp_path / "bad").rglob("*.wav"))


def _cli(cfg, *extra):
    env = dict(os.environ, PYTHONPATH=str(REPO), CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "-m", "audio_edge_ml_pipeline_torch.features.augment", "--config",
                           str(cfg), *extra], capture_output=True, text=True, env=env, cwd=cfg.parent, timeout=300)


def test_cli_host_and_device_without_a_card(src, jax_host_tree, tmp_path):
    """The CLI as a user runs it: the host backend needs no card and writes
    JAX's tree; the device backend without a card and without --device cpu
    raises "no CUDA device" before writing anything."""
    r = _cli(_cfg_file(tmp_path, "host", _shipped(src, tmp_path / "host", workers=2)))
    assert r.returncode == 0, r.stderr[-2000:]
    assert _tree(tmp_path / "host") == jax_host_tree
    r = _cli(_cfg_file(tmp_path, "dev", _shipped(src, tmp_path / "dev", backend="device")))
    assert r.returncode != 0 and "no CUDA device" in r.stderr
    assert not list((tmp_path / "dev").rglob("*.wav"))
