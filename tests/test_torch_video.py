"""Port parity: the video loader (``video_folder``) and extractors
(``video_classical``, ``video_frame_seq``, ``video_mobilenet_v2_seq``) of
audio_edge_ml_pipeline_torch against the JAX package on the CPU, on clips
written with cv2 (JAX's tests/test_loaders_extended.py recipe)."""

import shutil

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from audio_edge_ml_pipeline_tpu import features as jfeatures
from audio_edge_ml_pipeline_tpu.data import loaders as jloaders
from audio_edge_ml_pipeline_tpu.features import pipeline as jpipeline
from audio_edge_ml_pipeline_tpu.features.config import load_config as jload_config
from audio_edge_ml_pipeline_tpu.models import backbones as jbackbones
from audio_edge_ml_pipeline_torch import features as tfeatures
from audio_edge_ml_pipeline_torch.data import loaders as tloaders
from audio_edge_ml_pipeline_torch.features import pipeline as tpipeline
from audio_edge_ml_pipeline_torch.features import video as tvideo

cv2 = pytest.importorskip("cv2")

EMBED_SIZE = 32


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _write_clip(path, frames: int, shift: int, seed: int) -> None:
    w = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"MJPG"), 10, (64, 64))
    if not w.isOpened():
        pytest.skip("no cv2 video codec available")
    rng = np.random.default_rng(seed)
    for i in range(frames):
        frame = np.full((64, 64, 3), (i * 10 + shift) % 255, np.uint8)
        frame[:, : 8 * (i % 8)] = rng.integers(0, 255, 3, dtype=np.uint8)
        frame[20:30, (3 * i) % 50 : (3 * i) % 50 + 10] = 255  # a moving square for the optical flow
        w.write(frame)
    w.release()


@pytest.fixture(scope="module")
def video_tree(tmp_path_factory):
    """Two classes x 2 MJPG clips of 24 and 5 frames (fewer than max_frames:
    padded) and a text file the loader passes over."""
    root = tmp_path_factory.mktemp("vids") / "vids"
    for c, cls in enumerate(("walk", "wave")):
        (root / cls).mkdir(parents=True)
        _write_clip(root / cls / "long.avi", 24, 7 * c, seed=c)
        _write_clip(root / cls / "short.avi", 5, 11 * c + 3, seed=10 + c)
        (root / cls / "readme.txt").write_text("not a video")
    return root


def test_video_folder_loader_matches_jax(video_tree):
    ours = tloaders.build_loader("video_folder", str(video_tree), "all")
    theirs = jloaders.build_loader("video_folder", str(video_tree), "all")
    assert isinstance(ours, tloaders.VideoFolderLoader)
    items = [(str(p), label, meta) for p, label, meta in ours]
    assert items == [(str(p), label, meta) for p, label, meta in theirs] and len(items) == 4
    assert ours.class_names == ["walk", "wave"]


PER_SAMPLE = {  # name -> (extractor params, feature shape of the long clip)
    "video_classical": ({"max_frames": 6, "frame_size": 32, "optical_flow": True}, (2 * 132 + 10,)),
    "video_classical_noflow": ({"max_frames": 4, "frame_size": 32}, (2 * 132,)),
    "video_frame_seq": ({"max_frames": 8, "frame_size": 32}, (8, 32, 32, 3)),
    "video_frame_seq_gray": ({"max_frames": 8, "frame_size": 32, "grayscale": True}, (8, 32, 32, 1)),
}


@pytest.mark.parametrize("case", sorted(PER_SAMPLE))
def test_video_extract_matches_jax(case, video_tree):
    """The per-sample path (the CPU's): classical vectors equal JAX's (the
    same numpy oracle and cv2 flow), frame stacks equal, the short clip
    zero-padded to max_frames."""
    params, shape = PER_SAMPLE[case]
    name = case.removesuffix("_noflow").removesuffix("_gray")
    ours = tfeatures.get(name)(**params, device="cpu")
    theirs = jfeatures.get(name)(**params)
    for clip in ("long", "short"):
        a, b = ours.extract(video_tree / "walk" / f"{clip}.avi"), theirs.extract(video_tree / "walk" / f"{clip}.avi")
        assert a.dtype == np.float32 and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert ours.extract(video_tree / "wave" / "long.avi").shape == shape


def test_video_classical_batched_matches_per_sample(video_tree):
    """The batched path (forced on the CPU; padded frames and a padded
    chunk) against the per-sample path, and JAX's batched path."""
    ours = tvideo.VideoClassicalExtractor(max_frames=6, frame_size=32, optical_flow=True, device="cpu")
    theirs = jfeatures.get("video_classical")(max_frames=6, frame_size=32, optical_flow=True)
    ours.use_device_batch = theirs.use_device_batch = True
    ours.videos_per_chunk = theirs.videos_per_chunk = 3
    loader = tloaders.VideoFolderLoader(video_tree)
    fs = ours.extract_dataset(loader)
    jfs = theirs.extract_dataset(jloaders.VideoFolderLoader(video_tree))
    per_sample = np.stack([ours.extract(p) for p, _, _ in loader])
    assert fs.features.shape == per_sample.shape == jfs.features.shape == (4, 274)
    assert float(np.max(np.abs(fs.features - per_sample))) <= 2e-4
    assert float(np.max(np.abs(fs.features - jfs.features))) <= 2e-4
    assert fs.metadata == jfs.metadata and list(fs.labels) == list(jfs.labels)


def test_video_mobilenet_v2_seq_matches_jax(video_tree, tmp_path):
    """Per-frame embeddings (T, 1280) through both extraction CLIs with JAX's
    variables in a .npz: within 1e-5 of their largest; padded frames embed
    the zero frame, as in JAX."""
    variables = jbackbones.MobileNetV2().init(jax.random.PRNGKey(4), jnp.zeros((1, EMBED_SIZE, EMBED_SIZE, 3)))
    np.savez(tmp_path / "mbv2.npz", **jbackbones.flatten_variables(variables))
    params = {"max_frames": 6, "image_size": EMBED_SIZE, "weights": str(tmp_path / "mbv2.npz")}
    for side in ("jax", "port"):
        doc = {"dataset": str(video_tree), "experiments": [{
            "name": "seq", "extractor": "video_mobilenet_v2_seq", "loader": "video_folder", "split": "all",
            "extractor_params": params, "output": str(tmp_path / side / "seq")}]}
        (tmp_path / f"{side}.yaml").write_text(yaml.safe_dump(doc))
    for exp in jload_config(tmp_path / "jax.yaml").resolved_experiments():
        jpipeline._run_experiment(exp)
    tpipeline.main(["--config", str(tmp_path / "port.yaml"), "--device", "cpu"])
    ours = tpipeline.FeaturePipeline.load(tmp_path / "port" / "seq")
    theirs = jpipeline.FeaturePipeline.load(tmp_path / "jax" / "seq")
    assert ours.features.shape == theirs.features.shape == (4, 6, 1280)
    assert ours.metadata == theirs.metadata and ours.label_names == theirs.label_names
    scale = float(np.max(np.abs(theirs.features)))
    assert float(np.max(np.abs(ours.features - theirs.features))) <= 1e-5 * scale


def test_video_classical_cli_matches_jax(video_tree, tmp_path):
    """video_classical (optical flow on) and video_frame_seq through both
    CLIs on the tree, the port with --device cpu."""
    exps = [{"name": "cls", "extractor": "video_classical", "extractor_params":
             {"max_frames": 6, "frame_size": 32, "optical_flow": True}},
            {"name": "seq", "extractor": "video_frame_seq", "extractor_params": {"max_frames": 6, "frame_size": 32}}]
    for side in ("jax", "port"):
        doc = {"dataset": str(video_tree), "loader": "video_folder", "split": "all",
               "experiments": [{**e, "output": str(tmp_path / side / e["name"])} for e in exps]}
        (tmp_path / f"{side}.yaml").write_text(yaml.safe_dump(doc))
    for exp in jload_config(tmp_path / "jax.yaml").resolved_experiments():
        jpipeline._run_experiment(exp)
    tpipeline.main(["--config", str(tmp_path / "port.yaml"), "--device", "cpu"])
    for e in exps:
        ours = tpipeline.FeaturePipeline.load(tmp_path / "port" / e["name"])
        theirs = jpipeline.FeaturePipeline.load(tmp_path / "jax" / e["name"])
        assert ours.features.shape == theirs.features.shape and ours.modality == "video"
        np.testing.assert_array_equal(ours.features, theirs.features)
        assert ours.metadata == theirs.metadata and list(ours.labels) == list(theirs.labels)


def test_unreadable_video_is_skipped(video_tree, tmp_path):
    root = tmp_path / "vids"
    shutil.copytree(video_tree, root)
    (root / "walk" / "broken.avi").write_bytes(b"not a video")
    ex = tvideo.VideoFrameSequence(max_frames=4, frame_size=32, device="cpu")
    fs = ex.extract_dataset(tloaders.VideoFolderLoader(root))
    assert fs.features.shape == (4, 4, 32, 32, 3)


def test_video_extractors_without_device_raise_when_cuda_is_absent(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in ("video_classical", "video_frame_seq", "video_mobilenet_v2_seq"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tfeatures.get(name)()
