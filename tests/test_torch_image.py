"""Port parity: the image loaders (``image_folder``, ``birdeep_image``) and the
image extractors (``image_classical``, ``image_pixels``,
``image_mobilenet_v2``) of audio_edge_ml_pipeline_torch against the JAX
package on the CPU: the same samples, order, labels and ``bbox_norm``; both
extraction CLIs on the same trees; the batched path against the per-sample
one, skip-and-continue included."""

from pathlib import Path

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
from audio_edge_ml_pipeline_torch.features import image as timage
from audio_edge_ml_pipeline_torch.features import pipeline as tpipeline

Image = pytest.importorskip("PIL.Image")

EMBED_SIZE = 32  # MobileNetV2 input side: 224 is slow on the CPU


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def image_folder(tmp_path_factory):
    """Two classes x 3 grayscale PNGs of 90x110 and one RGB JPEG, plus a
    text file the loader must pass over."""
    root = tmp_path_factory.mktemp("imgs") / "imgs"
    rng = np.random.default_rng(11)
    for cls in ("a", "b"):
        d = root / cls
        d.mkdir(parents=True)
        for i in range(3):
            Image.fromarray(rng.integers(0, 255, (90, 110), dtype=np.uint8), mode="L").save(d / f"s{i}.png")
        (d / "notes.txt").write_text("not an image")
    Image.fromarray(rng.integers(0, 255, (70, 50, 3), dtype=np.uint8)).save(root / "b" / "rgb.jpg")
    return root


@pytest.fixture(scope="module")
def birdeep_root(tmp_path_factory):
    """A BIRDeep tree of JAX's tests/test_loaders_extended.py layout: CSVs and
    images/<site>/<date>/<stem>.PNG spectrograms with YOLO boxes, plus an
    augmented row, a box under min_bbox_area, a row without a box and a row
    whose PNG is missing; train and validation splits."""
    root = tmp_path_factory.mktemp("birdeep")
    (root / "images" / "SITE1" / "2026_01_01").mkdir(parents=True)
    rng = np.random.default_rng(0)
    header = "path,specie,start_time,end_time,recorder,date,bbox"
    splits = {"train": [header], "validation": [header]}
    for i in range(8):
        rel = f"SITE1/2026_01_01/SITE1_20260101_{i:06d}.WAV"
        img = rng.uniform(0, 255, (64, 128, 3)).astype(np.uint8)
        Image.fromarray(img).save((root / "images" / rel).with_suffix(".PNG"))
        specie = "Cisticola juncidis" if i % 2 == 0 else "Emberiza calandra"
        box = "0.5, 0.5, 0.001, 0.002" if i == 3 else f"{0.3 + 0.05 * i}, 0.5, 0.2, 0.3"
        splits["train" if i < 6 else "validation"].append(
            f'{rel},{specie},0.25,1.25,SITE1,2026_01_01,"[{i % 2}, {box}]"')
    for rows in splits.values():
        rows.append('Data Augmentation/SITE1/2026_01_01/aug.WAV,Cisticola juncidis,0.0,1.0,SITE1,2026_01_01,'
                    '"[0, 0.5, 0.5, 0.2, 0.2]"')
        rows.append("SITE1/2026_01_01/SITE1_20260101_000001.WAV,Emberiza calandra,0.5,0.9,SITE1,2026_01_01,")
        rows.append('SITE1/2026_01_01/missing.WAV,Emberiza calandra,0.5,0.9,SITE1,2026_01_01,'
                    '"[1, 0.5, 0.5, 0.2, 0.2]"')
    for split, rows in splits.items():
        (root / f"{split}_file.csv").write_text("\n".join(rows) + "\n")
    return root


def _items(loader):
    return [(str(p), label, meta) for p, label, meta in loader]


@pytest.mark.parametrize("split", ["all", None])
def test_image_folder_loader_matches_jax(image_folder, split):
    ours = tloaders.build_loader("image_folder", str(image_folder), split)
    theirs = jloaders.build_loader("image_folder", str(image_folder), split)
    assert isinstance(ours, tloaders.ImageFolderLoader)
    assert _items(ours) == _items(theirs) and len(ours) == len(theirs) == 7
    assert ours.class_names == theirs.class_names == ["a", "b"]


@pytest.mark.parametrize("split,species", [("train", None), ("validation", None),
                                           ("train", ["Emberiza calandra"])])
def test_birdeep_image_loader_matches_jax(birdeep_root, split, species):
    """Same samples, order, labels and meta; bbox_norm is the YOLO box with
    its class id dropped, and absent for the box under min_bbox_area."""
    ours = tloaders.build_loader("birdeep_image", str(birdeep_root), split, class_filter=species)
    theirs = jloaders.build_loader("birdeep_image", str(birdeep_root), split, class_filter=species)
    assert isinstance(ours, tloaders.BIRDeepImageLoader)
    items = _items(ours)
    assert items == _items(theirs) and len(ours) == len(theirs)
    assert all(Path(p).suffix == ".PNG" for p, _, _ in items)
    if split == "train" and species is None:
        assert len(items) == 6 and sum("bbox_norm" in m for _, _, m in items) == 5
        assert items[0][2]["bbox_norm"] == [0.3, 0.5, 0.2, 0.3]


def _weights(tmp_path: Path) -> Path:
    """JAX's MobileNetV2 variables at EMBED_SIZE, statistics moved off their
    init, written by JAX's flatten_variables."""
    variables = jbackbones.MobileNetV2().init(jax.random.PRNGKey(3), jnp.zeros((1, EMBED_SIZE, EMBED_SIZE, 3)))
    flat = jbackbones.flatten_variables(variables)
    rng = np.random.default_rng(1)
    for k in flat:
        if k.endswith("/mean"):
            flat[k] = rng.normal(0.0, 0.1, flat[k].shape).astype(np.float32)
        elif k.endswith("/var"):
            flat[k] = rng.uniform(0.5, 1.5, flat[k].shape).astype(np.float32)
    path = tmp_path / "mbv2.npz"
    np.savez(path, **flat)
    return path


EXTRACTORS = {  # name -> (loader, extractor params, expected feature shape)
    "image_classical": ("image_folder", {}, (8196,)),
    "image_classical_bbox": ("birdeep_image", {"image_size": 64}, (1860,)),
    "image_pixels": ("image_folder", {"resize_to": [48, 40]}, (40, 48, 1)),
    "image_pixels_rgb": ("birdeep_image", {"image_size": 32, "as_gray": False}, (32, 32, 3)),
    "image_mobilenet_v2": ("image_folder", {"image_size": EMBED_SIZE}, (1280,)),
    "image_mobilenet_v2_bbox": ("birdeep_image", {"image_size": EMBED_SIZE}, (1280,)),
}


@pytest.mark.parametrize("case", sorted(EXTRACTORS))
def test_image_extractor_cli_matches_jax(case, image_folder, birdeep_root, tmp_path):
    """Each extractor through both extraction CLIs (--config, the port with
    --device cpu): same shape, labels and metadata; classical within 2e-4
    with the LBP and histogram columns bit for bit, pixels equal, the
    embeddings (JAX's variables in a .npz) within 1e-5 of their largest."""
    loader, params, shape = EXTRACTORS[case]
    extractor = case.removesuffix("_bbox").removesuffix("_rgb")
    if extractor == "image_mobilenet_v2":
        params = {**params, "weights": str(_weights(tmp_path))}
    dataset = image_folder if loader == "image_folder" else birdeep_root
    for side in ("jax", "port"):
        doc = {"dataset": str(dataset), "experiments": [{
            "name": case, "extractor": extractor, "loader": loader, "split": "all" if loader == "image_folder"
            else "train", "extractor_params": params, "output": str(tmp_path / side / case)}]}
        (tmp_path / f"{side}.yaml").write_text(yaml.safe_dump(doc))
    for exp in jload_config(tmp_path / "jax.yaml").resolved_experiments():
        jpipeline._run_experiment(exp)
    tpipeline.main(["--config", str(tmp_path / "port.yaml"), "--device", "cpu"])
    ours = tpipeline.FeaturePipeline.load(tmp_path / "port" / case)
    theirs = jpipeline.FeaturePipeline.load(tmp_path / "jax" / case)
    assert ours.features.shape == theirs.features.shape and ours.features.shape[1:] == shape
    assert (ours.feature_type, ours.modality) == (theirs.feature_type, theirs.modality)
    np.testing.assert_array_equal(ours.labels, theirs.labels)
    assert ours.label_names == theirs.label_names and ours.metadata == theirs.metadata
    if extractor == "image_classical":
        d = ours.features.shape[1]
        np.testing.assert_array_equal(ours.features[:, d - 96 : d - 6], theirs.features[:, d - 96 : d - 6])
        assert float(np.max(np.abs(ours.features - theirs.features))) <= 2e-4
    elif extractor == "image_pixels":
        np.testing.assert_array_equal(ours.features, theirs.features)
    else:
        scale = float(np.max(np.abs(theirs.features)))
        assert float(np.max(np.abs(ours.features - theirs.features))) <= 1e-5 * scale


def test_batched_matches_per_sample(image_folder):
    """extract_dataset's batched path (forced on the CPU; one full and one
    zero-padded batch) equals extract() per sample in loader order, and the
    CPU device takes the per-sample path by default."""
    ex = timage.ImageClassicalExtractor(device="cpu")
    ex.batch_size = 4
    loader = tloaders.ImageFolderLoader(image_folder)
    per_sample = np.stack([ex.extract(p) for p, _, _ in loader])
    default = ex.extract_dataset(loader)
    np.testing.assert_array_equal(default.features, per_sample)
    ex.use_device_batch = True
    fs = ex.extract_dataset(loader)
    assert fs.features.shape == (7, 8196) and fs.n_classes == 2
    assert float(np.max(np.abs(fs.features - per_sample))) <= 2e-4
    np.testing.assert_array_equal(fs.features[:, 8100:8190], per_sample[:, 8100:8190])


def test_batched_skip_and_continue(image_folder, tmp_path):
    """A corrupt file inside a device batch is skipped and the remaining
    vectors keep loader order, as in JAX."""
    import shutil

    root = tmp_path / "imgs"
    shutil.copytree(image_folder, root)
    (root / "a" / "s1.png").write_bytes(b"not a png")
    ex = timage.ImageClassicalExtractor(device="cpu")
    ex.batch_size, ex.use_device_batch = 4, True
    jex = jfeatures.get("image_classical")()
    jex.batch_size, jex.use_device_batch = 4, True
    fs = ex.extract_dataset(tloaders.ImageFolderLoader(root))
    jfs = jex.extract_dataset(jloaders.ImageFolderLoader(root))
    good = [p for p, _, _ in tloaders.ImageFolderLoader(root) if p != root / "a" / "s1.png"]
    per_sample = np.stack([ex.extract(p) for p in good])
    assert fs.features.shape == jfs.features.shape == (6, 8196)
    assert float(np.max(np.abs(fs.features - per_sample))) <= 2e-4
    assert fs.metadata == jfs.metadata and fs.n_classes == 2


def test_image_extractors_attributes_match_jax():
    for name, kwargs in (("image_classical", {"image_size": 96, "hog_pixels_per_cell": 16}),
                         ("image_pixels", {"as_gray": False}), ("image_mobilenet_v2", {"input_size": [160, 160]})):
        ours = tfeatures.get(name)(**kwargs, device="cpu")
        theirs = jfeatures.get(name)(**kwargs)
        for attr in ("resize_to", "image_size", "hog_orientations", "hog_pixels_per_cell", "hog_cells_per_block",
                     "lbp_n_points", "lbp_radius", "n_hist_bins", "grayscale", "batch_size", "weights",
                     "feature_type", "modality"):
            assert getattr(ours, attr, None) == getattr(theirs, attr, None), (name, attr)


def test_image_extractors_without_device_raise_when_cuda_is_absent(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in ("image_classical", "image_pixels", "image_mobilenet_v2"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tfeatures.get(name)()
