"""The port's ``birdeep`` loader (``data/loaders.py::BIRDeepLoader``) against
the JAX package's, on a synthetic BIRDeep_AudioAnnotations tree (the layout
of ``tests/test_loaders_extended.py``'s ``birdeep_root``: split CSVs beside
``Audios/<site>/<date>/*.WAV``): the same samples, order and meta; then
``configs/experiments/birdeep-feature-extraction.yaml`` through both
extraction CLIs, FeatureSets within 1e-5 (mel) and 1e-4 relative a
dimension over max(|JAX|, 1) (classical), the gates of PERF.md §2."""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from audio_edge_ml_pipeline_tpu.data import loaders as jloaders
from audio_edge_ml_pipeline_torch.data import loaders as tloaders

REPO = Path(__file__).resolve().parent.parent
MEL_TOL = 1e-5
CLASSICAL_REL = 1e-4
FOCAL = ["Cisticola juncidis", "Emberiza calandra", "Galerida theklae", "Saxicola rubicola", "Luscinia megarhynchos"]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def birdeep_root(tmp_path_factory):
    """Six 3 s recordings at 16 kHz; per split, segments of 0.05-1.5 s of the
    five focal species and of one species the config's class_filter drops,
    an augmented row and a segment under min_segment_duration (both
    dropped), and one row of a missing recording (skipped)."""
    from audio_edge_ml_pipeline_torch.data.audio_io import write_wav

    root = tmp_path_factory.mktemp("birdeep")
    rng = np.random.default_rng(0)
    rels = []
    for i in range(6):
        rel = f"SITE{i % 2 + 1}/2026_01_0{i + 1}/SITE{i % 2 + 1}_2026010{i + 1}_{i:06d}.WAV"
        (root / "Audios" / rel).parent.mkdir(parents=True, exist_ok=True)
        t = np.arange(48000) / 16000
        y = 0.3 * np.sin(2 * np.pi * (900 + 250 * i) * t) + 0.05 * rng.standard_normal(len(t))
        write_wav(root / "Audios" / rel, y.astype(np.float32), 16000)
        rels.append(rel)
    species = [*FOCAL, "Passer domesticus"]
    header = "path,specie,start_time,end_time,low_frequency,high_frequency,recorder,date"
    splits = {}
    for split, n in (("train", 14), ("validation", 7)):
        rows = [header]
        for j in range(n):
            start = float(rng.uniform(0.0, 1.4))
            dur = float(rng.choice([0.05, 0.3, 0.8, 1.5]))
            low = "" if j % 4 == 3 else f"{rng.uniform(500, 2000):.1f}"
            rows.append(f"{rels[j % 6]},{species[j % 6]},{start:.3f},{start + dur:.3f},{low},"
                        f"{rng.uniform(3000, 8000):.1f},SITE{j % 2 + 1},2026_01_0{j % 6 + 1}")
        rows.append(f"Data Augmentation/{rels[0]},{FOCAL[0]},0.0,1.0,,,SITE1,2026_01_01")
        rows.append(f"{rels[1]},{FOCAL[1]},0.50,0.52,,,SITE2,2026_01_02")
        rows.append(f"SITE1/2026_01_09/missing.WAV,{FOCAL[2]},0.1,0.9,,,SITE1,2026_01_09")
        splits[split] = rows
    (root / "train_file.csv").write_text("\n".join(splits["train"]) + "\n")
    (root / "validation_file.csv").write_text("\n".join(splits["validation"]) + "\n")
    (root / "dataset.csv").write_text("\n".join(splits["train"] + splits["validation"][1:]) + "\n")
    return root


@pytest.mark.parametrize("split,species", [("train", None), ("validation", None), ("all", None),
                                           ("train", set(FOCAL[:2])), ("all", set(FOCAL))])
def test_same_samples_order_and_meta(birdeep_root, split, species):
    theirs = jloaders.BIRDeepLoader(birdeep_root, split=split, species_filter=species)
    ours = tloaders.BIRDeepLoader(birdeep_root, split=split, species_filter=species)
    assert len(ours) == len(theirs) and ours.species == theirs.species
    got, want = list(ours), list(theirs)
    present = sum((birdeep_root / "Audios" / p).exists() for p in ours._df["path"])
    assert got == want and len(got) == present      # a missing recording is skipped
    assert all(m["end_time"] - m["start_time"] >= 0.05 for _, _, m in got)
    assert not any("Data Augmentation" in str(p) for p, _, _ in got)
    if species:
        assert {label for _, label, _ in got} <= species


def test_factory_and_refusals(birdeep_root):
    loader = tloaders.build_loader("birdeep", str(birdeep_root), "validation", class_filter=FOCAL)
    assert isinstance(loader, tloaders.BIRDeepLoader)
    assert list(loader) == list(jloaders.build_loader("birdeep", str(birdeep_root), "validation", class_filter=FOCAL))
    with pytest.raises(ValueError, match="split must be one of"):
        tloaders.BIRDeepLoader(birdeep_root, split="dev")
    with pytest.raises(FileNotFoundError, match="test_file.csv"):
        tloaders.BIRDeepLoader(birdeep_root, split="test")


@pytest.fixture(scope="module")
def extracted(birdeep_root, tmp_path_factory):
    """configs/experiments/birdeep-feature-extraction.yaml, its dataset and
    outputs moved, through the JAX CLI and the port's (``--device cpu``)."""
    from audio_edge_ml_pipeline_tpu.features import pipeline as jpipeline
    from audio_edge_ml_pipeline_torch.features import pipeline as tpipeline

    tmp = tmp_path_factory.mktemp("birdeep_cli")
    doc = yaml.safe_load((REPO / "configs" / "experiments" / "birdeep-feature-extraction.yaml").read_text())
    out = {}
    def jax_main(argv):   # the JAX CLI reads sys.argv
        sys.argv = ["pipeline", *argv]
        jpipeline.main()

    argv0 = list(sys.argv)
    for pkg, main, extra in (("jax", jax_main, []), ("torch", tpipeline.main, ["--device", "cpu"])):
        d = json.loads(json.dumps(doc))
        d["dataset"] = str(birdeep_root)
        for exp in d["experiments"]:
            exp["output"] = str(tmp / pkg / exp["name"])
        cfg = tmp / f"{pkg}.yaml"
        cfg.write_text(yaml.safe_dump(d))
        try:
            main(["--config", str(cfg), *extra])
        finally:
            sys.argv = argv0
        out[pkg] = {exp["name"]: (exp["extractor"], tpipeline.FeaturePipeline.load(exp["output"]))
                    for exp in d["experiments"]}
    return out


def test_both_clis_write_the_same_feature_sets(extracted, birdeep_root):
    """Shapes, labels and metadata equal; every port row within its gate of
    the golden feature of the segment as the JAX extractor loads it; the mel
    rows within 1e-5 of JAX's too. The classical rows are not held to JAX's:
    on 16 kHz audio at 22.05 kHz JAX's float32 STFT misses the golden gate
    (ROADMAP §3 d; 2.0e-4 relative here)."""
    from audio_edge_ml_pipeline_tpu.features import get as jget
    from audio_edge_ml_pipeline_torch.ops import golden

    assert sorted(extracted["torch"]) == sorted(extracted["jax"]) and len(extracted["jax"]) == 4
    for name, (extractor, theirs) in extracted["jax"].items():
        ours = extracted["torch"][name][1]
        assert ours.features.shape == theirs.features.shape and len(ours.features) > 0, name
        np.testing.assert_array_equal(ours.labels, theirs.labels)
        assert ours.label_names == theirs.label_names and set(ours.label_names) <= set(FOCAL)
        assert ours.metadata == json.loads(json.dumps(theirs.metadata))
        loader = jget(extractor)(**({"duration": 5.0} if extractor == "audio_mel_spec" else {}))
        classical = extractor == "audio_classical"
        gold_fn = golden.classical_feature_vector if classical else golden.mel_spec_feature
        samples = list(jloaders.BIRDeepLoader(birdeep_root, split="train" if name.endswith("_train") else "validation",
                                              species_filter=set(FOCAL)))
        assert [m for _, _, m in samples] == ours.metadata
        for row, (path, _, meta) in zip(ours.features, samples):
            y = loader._load_clip(path, meta["start_time"], meta["end_time"]).astype(np.float64)
            g = gold_fn(y)
            d = np.abs(row - g)
            err = float((d / np.maximum(np.abs(g), 1.0)).max()) if classical else float(d.max())
            assert err <= (CLASSICAL_REL if classical else MEL_TOL), (name, err)
        assert ours.features.shape[1:] == ((302,) if classical else (40, 501))
        if not classical:
            assert float(np.abs(ours.features - theirs.features).max()) <= MEL_TOL, name


def test_extraction_cli_traces_its_stage(birdeep_root, tmp_path, monkeypatch):
    """The flag-driven extraction CLI with its default loader (birdeep) and
    AEP_PROFILE_DIR set: the extraction runs in stage_timer("extract:<name>")
    as in JAX, so it is timed and its trace lands in
    $AEP_PROFILE_DIR/extract:audio_classical/."""
    from audio_edge_ml_pipeline_torch.features import pipeline as tpipeline
    from audio_edge_ml_pipeline_torch.utils import profiling

    profiling.reset()
    monkeypatch.setenv("AEP_PROFILE_DIR", str(tmp_path / "trace"))
    tpipeline.main(["--dataset", str(birdeep_root), "--split", "validation", "--output", str(tmp_path / "cl"),
                    "--device", "cpu"])
    assert profiling.timing_report()["extract:audio_classical"]["calls"] == 1
    (trace,) = (tmp_path / "trace" / "extract:audio_classical").glob("*.pt.trace.json")
    assert json.loads(trace.read_text())["traceEvents"]
    assert tpipeline.FeaturePipeline.load(tmp_path / "cl").n_samples == len(
        list(tloaders.BIRDeepLoader(birdeep_root, split="validation")))
    profiling.reset()
