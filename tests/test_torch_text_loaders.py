"""Port parity: the text and tabular loaders (``text_folder``, ``text_json``,
``text_csv``, ``tabular``) of audio_edge_ml_pipeline_torch against the JAX
package's on the same files: the same samples, labels, metadata and order.
The cases are the JAX suite's (``tests/test_loaders_extended.py``,
``tests/test_data_plane.py``) run through both packages, and both extraction
CLIs on ``make_synth_dataset``'s ``text.csv`` and ``tabular.csv``."""

import json
import math
import sqlite3
import sys

import numpy as np
import pandas as pd
import pytest
import torch

import make_synth_dataset
from audio_edge_ml_pipeline_tpu.data import loaders as jloaders
from audio_edge_ml_pipeline_tpu.features import pipeline as jpipeline
from audio_edge_ml_pipeline_torch.data import loaders as tloaders
from audio_edge_ml_pipeline_torch.features import pipeline as tpipeline


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _same_value(a, b) -> bool:
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a) and math.isnan(b):
        return True
    return type(a) is type(b) and a == b


def assert_same_samples(jl, tl) -> None:
    """The same (path, label, meta) in the same order, NaN equal to NaN."""
    j, t = list(jl), list(tl)
    assert len(jl) == len(tl) == len(j) == len(t)
    for (jp, jlab, jm), (tp, tlab, tm) in zip(j, t):
        assert (jp, jlab) == (tp, tlab)
        assert list(jm) == list(tm)
        assert all(_same_value(jm[k], tm[k]) for k in jm), (jm, tm)


def both(name: str, *args, **kwargs):
    return getattr(jloaders, name)(*args, **kwargs), getattr(tloaders, name)(*args, **kwargs)


def test_text_folder_and_json_loaders(tmp_path):
    for c, words in [("rivers", "water stream flow"), ("forests", "tree leaf bark")]:
        d = tmp_path / "txt" / c
        d.mkdir(parents=True)
        for i in range(3):
            (d / f"{i}.txt").write_text(f"{words} doc {i}")
    (tmp_path / "txt" / "rivers" / "notes.md").write_text("a markdown note")
    (tmp_path / "txt" / "rivers" / "skip.csv").write_text("not a text file")
    assert_same_samples(*both("TextFolderLoader", tmp_path / "txt"))
    jl, tl = both("TextFolderLoader", tmp_path / "txt", encoding="latin-1")
    assert_same_samples(jl, tl)
    assert all(m["encoding"] == "latin-1" for _, _, m in tl)

    docs = [{"text": f"sample {i}", "label": f"c{i % 2}", "extra": i} for i in range(4)] + [{"no_text": 1}]
    (tmp_path / "docs.json").write_text(json.dumps(docs))
    assert_same_samples(*both("TextJSONLoader", tmp_path / "docs.json"))
    assert_same_samples(*both("TextJSONLoader", tmp_path / "docs.json", label_key=None))
    (tmp_path / "docs.jsonl").write_text("\n".join(json.dumps(d) for d in docs) + "\n\n")
    assert_same_samples(*both("TextJSONLoader", tmp_path / "docs.jsonl"))


def test_text_folder_split_subdirectories(tmp_path):
    for split in ("train", "test"):
        for c in ("a", "b"):
            (tmp_path / split / c).mkdir(parents=True)
            (tmp_path / split / c / f"{split}.txt").write_text(f"{split} {c}")
    for split in ("train", "test"):
        assert_same_samples(*both("TextFolderLoader", tmp_path, split=split))
    for split in ("all", None):
        with pytest.raises(NotADirectoryError):
            jloaders.TextFolderLoader(tmp_path / "missing", split=split)
        with pytest.raises(NotADirectoryError):
            tloaders.TextFolderLoader(tmp_path / "missing", split=split)


def test_text_csv_and_json_loader_extras(tmp_path):
    csv = tmp_path / "docs.tsv"
    csv.write_text("# exported\ndoc\tcat\nriver flows\twater\ntall tree\tforest\n")
    assert_same_samples(*both("TextCSVLoader", csv, text_col=0, label_col=1, skip_header=1))
    semi = tmp_path / "docs.csv"
    semi.write_text("text;label\nriver flows;water\ntall tree;forest\n")
    assert_same_samples(*both("TextCSVLoader", semi, label_col="label"))
    assert_same_samples(*both("TextCSVLoader", semi))   # no label column: unlabelled samples
    for mod in (jloaders, tloaders):
        with pytest.raises(ValueError, match="text column"):
            mod.TextCSVLoader(semi, text_col="body")

    j = tmp_path / "wrapped.json"
    j.write_text(json.dumps({"meta": "x", "records": [{"text": "one", "label": "a"}, {"text": "two", "label": "b"}]}))
    assert_same_samples(*both("TextJSONLoader", j, records_key="records"))
    assert_same_samples(*both("TextJSONLoader", j))   # the first list-valued key
    (tmp_path / "nolist.json").write_text(json.dumps({"meta": "x"}))
    for mod in (jloaders, tloaders):
        with pytest.raises(ValueError, match="No record list"):
            mod.TextJSONLoader(tmp_path / "nolist.json")


def test_tabular_loader_formats(tmp_path):
    df = pd.DataFrame({"a": [1, 2, 3, 4], "b": [0.5, np.nan, 0.7, 0.8],
                       "junk": list("wxyz"), "label": ["p", "q", "p", "q"]})
    jl = tmp_path / "rows.jsonl"
    jl.write_text("\n".join(df.to_json(orient="records", lines=True).splitlines()))
    assert_same_samples(*both("TabularLoader", jl, label_col="label", drop_cols=["junk"], max_rows=3))
    df.to_csv(tmp_path / "rows.csv", index=False)
    df.to_csv(tmp_path / "rows.tsv", index=False, sep="\t")
    df.to_json(tmp_path / "rows.json", orient="records")
    df.to_parquet(tmp_path / "rows.parquet")
    df.to_feather(tmp_path / "rows.feather")
    for name in ("rows.csv", "rows.json", "rows.parquet", "rows.feather"):
        assert_same_samples(*both("TabularLoader", tmp_path / name, label_col="label"))
        assert_same_samples(*both("TabularLoader", tmp_path / name, label_col="label", max_rows=2))
    assert_same_samples(*both("TabularLoader", tmp_path / "rows.tsv", label_col="label",
                              read_kwargs={"sep": "\t"}))

    db = tmp_path / "rows.sqlite"
    con = sqlite3.connect(db)
    df.to_sql("samples", con, index=False)
    con.close()
    assert_same_samples(*both("TabularLoader", db, label_col=3))   # integer label_col -> "label"
    assert_same_samples(*both("TabularLoader", db, label_col="label", max_rows=2))
    assert_same_samples(*both("TabularLoader", db, sql_query="SELECT a, label FROM samples WHERE a > 2",
                              label_col="label"))
    assert_same_samples(*both("TabularLoader", db, sqlite_table="samples"))

    empty = tmp_path / "empty.db"
    sqlite3.connect(empty).close()
    for mod in (jloaders, tloaders):
        with pytest.raises(ValueError, match="no tables"):
            mod.TabularLoader(empty)
        with pytest.raises(ValueError, match="Cannot auto-detect"):
            mod.TabularLoader(tmp_path / "rows.xyz")
        with pytest.raises(ValueError, match="Unsupported tabular format"):
            mod.TabularLoader(tmp_path / "rows.csv", format="xml")


@pytest.mark.parametrize("suffix", [".xlsx", ".h5"])
def test_excel_and_hdf_fail_as_in_jax(tmp_path, suffix):
    """Excel and HDF need pandas' optional engines (openpyxl, PyTables):
    where one is absent both packages raise the same ImportError, and a file
    that is not a table fails alike either way."""
    path = tmp_path / f"rows{suffix}"
    path.write_bytes(b"not a table")
    errors = []
    for mod in (jloaders, tloaders):
        with pytest.raises(Exception) as info:
            mod.TabularLoader(path, label_col="label")
        errors.append((type(info.value), str(info.value)))
    assert errors[0] == errors[1]


def test_synth_text_and_tabular_loaders(tmp_path):
    make_synth_dataset.make_text_csv(tmp_path / "text.csv")
    make_synth_dataset.make_tabular_csv(tmp_path / "tabular.csv")
    assert_same_samples(*both("TextCSVLoader", tmp_path / "text.csv", text_col="text", label_col="label"))
    assert_same_samples(*both("TabularLoader", tmp_path / "tabular.csv", label_col="label"))


def test_build_loader_resolves_the_text_and_tabular_names(tmp_path):
    make_synth_dataset.make_text_csv(tmp_path / "text.csv")
    make_synth_dataset.make_tabular_csv(tmp_path / "tabular.csv")
    (tmp_path / "tree" / "a").mkdir(parents=True)
    (tmp_path / "tree" / "a" / "0.txt").write_text("a doc")
    (tmp_path / "docs.json").write_text(json.dumps([{"text": "x", "label": "y"}]))
    cases = [("text_folder", str(tmp_path / "tree"), {}), ("text_json", str(tmp_path / "docs.json"), {}),
             ("text_csv", str(tmp_path / "text.csv"), {"label_col": "label"}),
             ("tabular", str(tmp_path / "tabular.csv"), {"label_col": "label"})]
    for name, dataset, kw in cases:
        jl = jloaders.build_loader(name, dataset, "all", **kw)
        tl = tloaders.build_loader(name, dataset, "all", **kw)
        assert type(tl).__name__ == type(jl).__name__ and type(tl).__module__.startswith("audio_edge_ml_pipeline_torch")
        assert_same_samples(jl, tl)
    assert set(tloaders.LOADER_NAMES) == {"birdeep", "birdeep_image", "fsc22", "audio_folder", "image_folder",
                                          "video_folder", "text_folder", "text_json", "text_csv", "tabular"}


@pytest.mark.parametrize("loader,dataset,extractor,gate", [
    ("text_csv", "text.csv", "text_tfidf", 1e-7),
    ("text_csv", "text.csv", "text_sentence_embed", 1e-5),
    ("tabular", "tabular.csv", "tabular_polynomial", 1e-6),
    ("tabular", "tabular.csv", "tabular_classical", 1e-6),
])
def test_extraction_cli_matches_jax(tmp_path, monkeypatch, loader, dataset, extractor, gate):
    """Both CLIs with flags on the synth files write equal FeatureSets and the
    same info.json. The JAX CLI reads text as object for the tabular case,
    so that it expands ``when`` as the port does (ROADMAP §3 l)."""
    make_synth_dataset.make_text_csv(tmp_path / "text.csv")
    make_synth_dataset.make_tabular_csv(tmp_path / "tabular.csv")
    argv = ["--loader", loader, "--dataset", str(tmp_path / dataset), "--extractor", extractor,
            "--label-col", "label", "--split", "all"]
    monkeypatch.setattr(sys, "argv", ["pipeline", *argv, "--output", str(tmp_path / "jax")])
    with pd.option_context("future.infer_string", loader != "tabular"):
        jpipeline.main()
    tpipeline.main([*argv, "--output", str(tmp_path / "torch"), "--device", "cpu"])
    j, t = jpipeline.FeaturePipeline.load(tmp_path / "jax"), tpipeline.FeaturePipeline.load(tmp_path / "torch")
    info = [json.loads((tmp_path / side / "info.json").read_text()) for side in ("jax", "torch")]
    assert info[0] == info[1]
    assert sorted(p.name for p in (tmp_path / "jax").iterdir()) == sorted(p.name for p in (tmp_path / "torch").iterdir())
    assert (tmp_path / "jax" / "metadata.json").read_text() == (tmp_path / "torch" / "metadata.json").read_text()
    assert list(j.labels) == list(t.labels) and j.label_names == t.label_names
    assert t.features.shape == j.features.shape and t.features.dtype == j.features.dtype
    scale = np.abs(j.features).max(axis=0) if loader == "tabular" else 1.0
    gap = np.abs(t.features.astype(np.float64) - j.features) / np.where(scale > 0, scale, 1.0)
    assert gap.max() <= gate
    if loader == "tabular":
        assert t.features.shape[1] == (10 if extractor == "tabular_classical" else 38)   # "when" expanded
