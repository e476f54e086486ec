"""Dataset loaders: every loader yields (sample_path | None, label | None,
metadata dict) and implements __len__.

The loaders of the JAX package's ``data/loaders.py``:
fsc22 (flat dir + CSV + deterministic stratified split), audio_folder
(class-per-subfolder + header probe + split-manifest filter), birdeep (one
sample per annotation row, with its segment's start and end),
birdeep_image (the same rows' spectrogram PNGs with their YOLO boxes),
image_folder, video_folder and text_folder (class-per-subfolder), text_json
and text_csv (in-memory documents), and tabular (rows of csv, json, jsonl,
parquet, feather, excel, hdf or sqlite as in-memory samples).
"""

from __future__ import annotations

import ast
import json
import logging
from pathlib import Path
from typing import Optional

import numpy as np

from ..features.base import BaseDatasetLoader
from .audio_io import probe_audio

logger = logging.getLogger(__name__)

_VALID_SPLITS = ("train", "validation", "test", "all")

_AUDIO_SUFFIXES = frozenset({".wav", ".flac", ".ogg", ".mp3", ".aac", ".m4a", ".opus", ".aiff", ".aif"})
_IMAGE_SUFFIXES = frozenset({".png", ".jpg", ".jpeg", ".bmp", ".gif", ".tiff", ".webp"})
_VIDEO_SUFFIXES = frozenset({".mp4", ".avi", ".mov", ".mkv", ".webm", ".mpg", ".mpeg"})
_TEXT_SUFFIXES = frozenset({".txt", ".md"})


def stratified_split_indices(
    labels: list[str], train_ratio: float, val_ratio: float, seed: int
) -> list[str]:
    """Deterministic per-class proportional split -> per-sample split names.

    Serves the role of the reference's two-stage sklearn train_test_split
    (fsc22_loader.py:194-231): seeded, stratified, stable across runs.
    """
    labels = list(labels)
    rng = np.random.default_rng(seed)
    split = ["train"] * len(labels)
    by_class: dict[str, list[int]] = {}
    for i, lab in enumerate(labels):
        by_class.setdefault(lab, []).append(i)
    for lab in sorted(by_class):
        idxs = np.array(by_class[lab])
        perm = rng.permutation(len(idxs))
        n = len(idxs)
        n_train = int(round(train_ratio * n))
        n_val = int(round(val_ratio * n))
        n_train = min(n_train, n)
        n_val = min(n_val, n - n_train)
        for j in perm[:n_train]:
            split[idxs[j]] = "train"
        for j in perm[n_train : n_train + n_val]:
            split[idxs[j]] = "validation"
        for j in perm[n_train + n_val :]:
            split[idxs[j]] = "test"
    return split


def fsc22_metadata(dataset_root):
    """Locate the FSC22 audio dir + parse the metadata CSV with the JAX
    package's parsing contract (column strip, NaN-row drop, name strip).

    Returns ``(audio_dir: Path | None, df)`` with columns incl. 'Dataset
    File Name', 'Class ID', 'Class Name'. ``audio_dir`` is None for a flat
    layout (CSV beside the WAVs, as the device tools use).
    """
    dataset_root = Path(dataset_root)
    audio_matches = list(dataset_root.glob("Audio Wise V1.0-*/Audio Wise V1.0"))
    audio_dir = audio_matches[0] if audio_matches and audio_matches[0].is_dir() else None
    csv_matches = (
        list(dataset_root.glob("Metadata-*/Metadata/*.csv"))
        or sorted(dataset_root.glob("*.csv"))
    )
    if not csv_matches:
        raise FileNotFoundError(f"Could not find FSC22 metadata CSV under {dataset_root}.")

    import pandas as pd

    df = pd.read_csv(csv_matches[0], on_bad_lines="warn")
    df.columns = df.columns.str.strip()
    df = df.dropna(subset=["Dataset File Name", "Class ID", "Class Name"])
    df["Class Name"] = df["Class Name"].str.strip()
    return audio_dir, df


class FSC22Loader(BaseDatasetLoader):
    """FSC22 flat-dir + metadata CSV with a deterministic stratified
    70/15/15 split at construction (seed 42); class_filter support.
    Contract of reference fsc22_loader.py:50-231."""

    def __init__(
        self,
        dataset_root: Path | str,
        split: str = "train",
        class_filter: Optional[set[str]] = None,
        train_ratio: float = 0.70,
        val_ratio: float = 0.15,
        seed: int = 42,
    ) -> None:
        if split not in _VALID_SPLITS:
            raise ValueError(f"split must be one of {list(_VALID_SPLITS)}, got {split!r}.")
        if train_ratio + val_ratio > 1.0:
            raise ValueError(f"train_ratio ({train_ratio}) + val_ratio ({val_ratio}) > 1.0")
        self.dataset_root = Path(dataset_root)
        self.split = split
        self.class_filter = set(class_filter) if class_filter else None

        self._audio_dir, df = fsc22_metadata(self.dataset_root)
        if self._audio_dir is None:
            raise FileNotFoundError(
                f"Could not find 'Audio Wise V1.0' directory under {self.dataset_root}."
            )
        if self.class_filter is not None:
            df = df[df["Class Name"].isin(self.class_filter)]
        df = df.reset_index(drop=True)
        if len(df):
            df["_split"] = stratified_split_indices(
                df["Class Name"].tolist(), train_ratio, val_ratio, seed
            )
            if split != "all":
                df = df[df["_split"] == split].reset_index(drop=True)
        else:
            df["_split"] = []
        self._df = df
        logger.info("FSC22Loader [%s] - %d clips across %d classes.", split, len(df), df["Class Name"].nunique() if len(df) else 0)

    def __len__(self) -> int:
        return len(self._df)

    def __iter__(self):
        for _, row in self._df.iterrows():
            audio_path = self._audio_dir / row["Dataset File Name"]
            if not audio_path.exists():
                logger.warning("Audio file not found, skipping: %s", audio_path)
                continue
            label = str(row["Class Name"])
            yield audio_path, label, {
                "filename": row["Dataset File Name"],
                "class_id": int(row["Class ID"]),
                "class_name": label,
                "split": row["_split"],
            }

    @property
    def class_names(self) -> list[str]:
        return sorted(self._df["Class Name"].unique().tolist())

    @property
    def n_classes(self) -> int:
        return len(self.class_names)


class _FolderLoader(BaseDatasetLoader):
    """Shared class-per-subfolder scanner."""

    suffixes: frozenset[str] = frozenset()

    def __init__(
        self,
        root: Path | str,
        split: Optional[str] = None,
        extensions: Optional[set[str]] = None,
        class_names: Optional[list[str]] = None,
    ) -> None:
        effective_root = Path(root) / split if split else Path(root)
        if not effective_root.is_dir():
            raise NotADirectoryError(f"Dataset root not found: {effective_root}")
        self.root = Path(root)
        exts = frozenset(e.lower() for e in extensions) if extensions else self.suffixes
        if class_names is not None:
            self._class_names = list(class_names)
            class_dirs = [effective_root / c for c in class_names]
        else:
            class_dirs = sorted(p for p in effective_root.iterdir() if p.is_dir())
            self._class_names = [d.name for d in class_dirs]
        self._samples: list[tuple[Path, str, dict]] = []
        for class_dir, label in zip(class_dirs, self._class_names):
            if not class_dir.is_dir():
                logger.warning("Class directory not found: %s (skipping)", class_dir)
                continue
            files = sorted(p for p in class_dir.iterdir() if p.is_file() and p.suffix.lower() in exts)
            for f in files:
                self._samples.append((f, label, self._meta(f, class_dir)))

    def _meta(self, path: Path, class_dir: Path) -> dict:
        return {"filename": path.name, "class_dir": class_dir.name}

    def __len__(self) -> int:
        return len(self._samples)

    def __iter__(self):
        yield from self._samples

    @property
    def class_names(self) -> list[str]:
        return list(self._class_names)

    @property
    def n_classes(self) -> int:
        return len(self._class_names)


class AudioFolderLoader(_FolderLoader):
    """Class-per-subfolder audio tree with a header-only metadata probe and
    optional split_manifest.json leakage guard (reference
    audio_folder_loader.py:106-233)."""

    suffixes = _AUDIO_SUFFIXES

    def __init__(
        self,
        root: Path | str,
        split: Optional[str] = None,
        extensions: Optional[set[str]] = None,
        class_names: Optional[list[str]] = None,
        manifest: Optional[Path | str] = None,
        manifest_split: Optional[str] = None,
    ) -> None:
        super().__init__(root, split=split, extensions=extensions, class_names=class_names)
        if manifest is not None:
            if manifest_split is None:
                raise ValueError("manifest_split must be set when manifest is given")
            allowed = set(json.loads(Path(manifest).read_text()).get(manifest_split, []))
            self._samples = [
                (p, lbl, meta)
                for p, lbl, meta in self._samples
                if str(p.relative_to(self.root)) in allowed
            ]
            logger.info("AudioFolderLoader: manifest filter %r -> %d clips.", manifest_split, len(self._samples))

    def _meta(self, path: Path, class_dir: Path) -> dict:
        return {"filename": path.name, "class_dir": class_dir.name, **probe_audio(path)}


class ImageFolderLoader(_FolderLoader):
    suffixes = _IMAGE_SUFFIXES

    def __init__(self, root, split=None, **kw):
        split = None if split in (None, "all") else split
        super().__init__(root, split=split, **kw)


class VideoFolderLoader(_FolderLoader):
    suffixes = _VIDEO_SUFFIXES

    def __init__(self, root, split=None, **kw):
        split = None if split in (None, "all") else split
        super().__init__(root, split=split, **kw)


class TextFolderLoader(_FolderLoader):
    suffixes = _TEXT_SUFFIXES

    def __init__(self, root, split=None, encoding: str = "utf-8", **kw):
        split = None if split in (None, "all") else split
        self._encoding = encoding
        super().__init__(root, split=split, **kw)

    def _meta(self, path, class_dir):
        meta = super()._meta(path, class_dir)
        if self._encoding != "utf-8":
            meta["encoding"] = self._encoding  # consumed by _doc_text
        return meta


class TextJSONLoader(BaseDatasetLoader):
    """JSON array or JSONL of {"text": ..., "label": ...} documents; yields
    (None, label, {"text": ...}) in-memory samples. With a dict root, the
    record list is found under records_key — or the first list-valued key
    when unset (reference text_loader.py:146-193)."""

    def __init__(self, path: Path | str, text_key: str = "text",
                 label_key: Optional[str] = "label",
                 records_key: Optional[str] = None) -> None:
        p = Path(path)
        raw = p.read_text()
        try:
            docs = json.loads(raw)
            if isinstance(docs, dict):
                key = records_key or next(
                    (k for k, v in docs.items() if isinstance(v, list)), None
                )
                if not (key and isinstance(docs.get(key), list)):
                    raise ValueError(f"No record list under {records_key or '<any key>'!r} in {p}")
                docs = docs[key]
        except json.JSONDecodeError:
            docs = [json.loads(line) for line in raw.splitlines() if line.strip()]
        self._samples = []
        for d in docs:
            if text_key not in d:
                continue
            label = d.get(label_key) if label_key else None
            meta = {"text": d[text_key]}
            meta.update({k: v for k, v in d.items() if k not in (text_key, label_key)})
            self._samples.append((None, None if label is None else str(label), meta))

    def __len__(self):
        return len(self._samples)

    def __iter__(self):
        yield from self._samples


class TextCSVLoader(BaseDatasetLoader):
    """CSV with a text column and optional label column (name or 0-based
    index). delimiter=None sniffs from the header; skip_header drops leading
    junk lines (reference text_loader.py:216-226)."""

    def __init__(self, path: Path | str, text_col: str | int = "text",
                 label_col: Optional[str | int] = None,
                 delimiter: Optional[str] = None, encoding: str = "utf-8",
                 skip_header: int = 0) -> None:
        import pandas as pd

        if delimiter is None:
            import csv as _csv

            with open(path, "r", encoding=encoding, errors="replace") as f:
                for _ in range(skip_header):
                    f.readline()
                sample = f.read(8192)
            try:
                delimiter = _csv.Sniffer().sniff(sample, delimiters=",;\t|").delimiter
            except _csv.Error:
                delimiter = ","
        df = pd.read_csv(path, sep=delimiter, encoding=encoding, skiprows=skip_header)
        df.columns = df.columns.str.strip()

        def _col(spec):
            if isinstance(spec, int):
                return df.columns[spec]
            return spec

        text_col = _col(text_col)
        label_col = _col(label_col) if label_col is not None else None
        if text_col not in df.columns:
            raise ValueError(f"text column {text_col!r} not in CSV columns {list(df.columns)}")
        self._samples = []
        for _, row in df.iterrows():
            label = str(row[label_col]) if label_col and label_col in df.columns else None
            self._samples.append((None, label, {"text": str(row[text_col])}))

    def __len__(self):
        return len(self._samples)

    def __iter__(self):
        yield from self._samples


_TABULAR_FORMAT_MAP = {
    ".csv": "csv", ".tsv": "csv", ".txt": "csv",
    ".json": "json", ".jsonl": "jsonl", ".ndjson": "jsonl",
    ".parquet": "parquet", ".pq": "parquet",
    ".arrow": "feather", ".feather": "feather",
    ".xls": "excel", ".xlsx": "excel",
    ".h5": "hdf", ".hdf": "hdf", ".hdf5": "hdf",
    ".db": "sqlite", ".sqlite": "sqlite", ".sqlite3": "sqlite",
}


class TabularLoader(BaseDatasetLoader):
    """Multi-format tabular rows as in-memory samples: yields
    (None, label, {col: value}). Formats auto-detected by suffix or forced
    with format=: csv/tsv, json, jsonl, parquet, feather, excel, hdf,
    sqlite (table or sql_query) — reference tabular_loader.py:110-260."""

    def __init__(self, path: Path | str, label_col: Optional[str | int] = None,
                 format: Optional[str] = None, sheet_name: str | int = 0,
                 hdf_key: str = "data", sqlite_table: Optional[str] = None,
                 sql_query: Optional[str] = None, read_kwargs: Optional[dict] = None,
                 drop_cols: Optional[list[str]] = None,
                 max_rows: Optional[int] = None) -> None:
        self._path = Path(path)
        fmt = format or _TABULAR_FORMAT_MAP.get(self._path.suffix.lower())
        if fmt is None:
            raise ValueError(
                f"Cannot auto-detect tabular format for {self._path.suffix!r}; "
                f"pass format= (one of {sorted(set(_TABULAR_FORMAT_MAP.values()))})"
            )
        df = self._load(fmt, sheet_name, hdf_key, sqlite_table, sql_query,
                        dict(read_kwargs or {}), max_rows)
        df.columns = df.columns.astype(str).str.strip()
        for c in drop_cols or []:
            if c in df.columns:
                df = df.drop(columns=[c])
        if isinstance(label_col, int):
            label_col = df.columns[label_col]
        self._samples = []
        for _, row in df.iterrows():
            d = row.to_dict()
            label = None
            if label_col and label_col in d:
                label = str(d.pop(label_col))
            self._samples.append((None, label, d))

    def _load(self, fmt, sheet_name, hdf_key, sqlite_table, sql_query, kw, max_rows):
        import pandas as pd

        p = self._path
        if fmt == "csv":
            return pd.read_csv(p, nrows=max_rows, on_bad_lines="warn", **kw)
        if fmt == "json":
            df = pd.read_json(p, **kw)
        elif fmt == "jsonl":
            return pd.read_json(p, lines=True, nrows=max_rows, **kw)
        elif fmt == "parquet":
            df = pd.read_parquet(p, **kw)
        elif fmt == "feather":
            df = pd.read_feather(p, **kw)
        elif fmt == "excel":
            return pd.read_excel(p, sheet_name=sheet_name, nrows=max_rows, **kw)
        elif fmt == "hdf":
            df = pd.read_hdf(p, key=hdf_key, **kw)
        elif fmt == "sqlite":
            import sqlite3

            con = sqlite3.connect(p)
            try:
                if sql_query:
                    query = sql_query
                else:
                    table = sqlite_table
                    if not table:
                        row = con.execute(
                            "SELECT name FROM sqlite_master WHERE type='table' LIMIT 1"
                        ).fetchone()
                        if row is None:
                            raise ValueError(
                                f"{p}: sqlite database has no tables; pass "
                                "sqlite_table= or sql_query="
                            )
                        table = row[0]
                    limit = f" LIMIT {int(max_rows)}" if max_rows else ""
                    query = f'SELECT * FROM "{table}"{limit}'
                df = pd.read_sql_query(query, con, **kw)
            finally:
                con.close()
        else:
            raise ValueError(f"Unsupported tabular format: {fmt!r}")
        return df.head(max_rows) if max_rows else df

    def __len__(self):
        return len(self._samples)

    def __iter__(self):
        yield from self._samples


_SPLIT_FILES = {
    "train": "train_file.csv",
    "test": "test_file.csv",
    "validation": "validation_file.csv",
    "all": "dataset.csv",
}


class BIRDeepLoader(BaseDatasetLoader):
    """BIRDeep_AudioAnnotations: one sample per annotation row with
    start_time/end_time metadata; augmented-row exclusion, min-duration and
    species filters (reference birdeep_loader.py:59-250)."""

    def __init__(
        self,
        dataset_root: Path | str,
        split: str = "train",
        audio_subdir: str = "Audios",
        include_augmented: bool = False,
        min_segment_duration: float = 0.05,
        species_filter: Optional[set[str]] = None,
    ) -> None:
        if split not in _SPLIT_FILES:
            raise ValueError(f"split must be one of {list(_SPLIT_FILES)}, got {split!r}.")
        self.dataset_root = Path(dataset_root)
        self.audio_dir = self.dataset_root / audio_subdir
        csv_path = self.dataset_root / _SPLIT_FILES[split]
        if not csv_path.exists():
            raise FileNotFoundError(f"CSV file not found: {csv_path}.")
        import pandas as pd

        df = pd.read_csv(csv_path, on_bad_lines="warn")
        df.columns = df.columns.str.strip()
        for col in ("start_time", "end_time", "low_frequency", "high_frequency"):
            if col in df.columns:
                df[col] = pd.to_numeric(df[col], errors="coerce")
        df = df.dropna(subset=["path", "specie", "start_time", "end_time"])
        if not include_augmented:
            df = df[~df["path"].str.startswith("Data Augmentation")]
        if min_segment_duration > 0.0:
            df = df[(df["end_time"] - df["start_time"]) >= min_segment_duration]
        if species_filter is not None:
            df = df[df["specie"].isin(set(species_filter))]
        self._df = df.reset_index(drop=True)

    def __len__(self) -> int:
        return len(self._df)

    def __iter__(self):
        import pandas as pd

        for _, row in self._df.iterrows():
            audio_path = self.audio_dir / row["path"]
            if not audio_path.exists():
                logger.warning("Audio file not found, skipping: %s", audio_path)
                continue
            meta = {
                "start_time": float(row["start_time"]),
                "end_time": float(row["end_time"]),
                "recorder": str(row.get("recorder", "")),
                "date": str(row.get("date", "")),
            }
            for c in ("low_frequency", "high_frequency"):
                if c in row and pd.notna(row[c]):
                    meta[c] = float(row[c])
            yield audio_path, str(row["specie"]), meta

    @property
    def species(self) -> list[str]:
        return sorted(self._df["specie"].unique().tolist())


class BIRDeepImageLoader(BaseDatasetLoader):
    """BIRDeep spectrogram PNGs (``images/<row path>.PNG``) with the row's
    normalized YOLO box (class id dropped) as ``bbox_norm`` when its area is
    at least ``min_bbox_area`` (reference birdeep_loader.py:259-388)."""

    def __init__(
        self,
        dataset_root: Path | str,
        split: str = "train",
        image_subdir: str = "images",
        include_augmented: bool = False,
        min_bbox_area: float = 1e-5,
        species_filter: Optional[set[str]] = None,
    ) -> None:
        if split not in _SPLIT_FILES:
            raise ValueError(f"split must be one of {list(_SPLIT_FILES)}, got {split!r}.")
        self.dataset_root = Path(dataset_root)
        self.image_dir = self.dataset_root / image_subdir
        self.min_bbox_area = min_bbox_area
        csv_path = self.dataset_root / _SPLIT_FILES[split]
        if not csv_path.exists():
            raise FileNotFoundError(f"CSV file not found: {csv_path}.")
        import pandas as pd

        df = pd.read_csv(csv_path, on_bad_lines="warn")
        df.columns = df.columns.str.strip()
        df = df.dropna(subset=["path", "specie", "bbox"])
        if not include_augmented:
            df = df[~df["path"].str.startswith("Data Augmentation")]
        if species_filter is not None:
            df = df[df["specie"].isin(set(species_filter))]
        self._df = df.reset_index(drop=True)

    @staticmethod
    def _parse_bbox(raw: str) -> Optional[list[float]]:
        try:
            vals = ast.literal_eval(raw)
            if len(vals) >= 5:
                return [float(v) for v in vals[1:5]]  # drop class id
        except Exception:
            pass
        return None

    def __len__(self) -> int:
        return len(self._df)

    def __iter__(self):
        for _, row in self._df.iterrows():
            img_path = self.image_dir / Path(row["path"]).with_suffix(".PNG")
            if not img_path.exists():
                logger.warning("Image not found, skipping: %s", img_path)
                continue
            meta = {"recorder": str(row.get("recorder", ""))}
            bbox = self._parse_bbox(str(row.get("bbox", "")))
            if bbox is not None and bbox[2] * bbox[3] >= self.min_bbox_area:
                meta["bbox_norm"] = bbox
            yield img_path, str(row["specie"]), meta


LOADER_NAMES = (
    "birdeep", "birdeep_image", "fsc22", "audio_folder", "image_folder",
    "video_folder", "text_folder", "text_json", "text_csv", "tabular",
)


def build_loader(
    loader_name: str,
    dataset: str,
    split: str,
    label_col: Optional[str] = None,
    text_col: str = "text",
    audio_folder: Optional[str] = None,
    image_folder: Optional[str] = None,
    text_folder: Optional[str] = None,
    video_folder: Optional[str] = None,
    class_filter: Optional[list[str]] = None,
    manifest: Optional[str] = None,
    manifest_split: Optional[str] = None,
) -> BaseDatasetLoader:
    """Loader factory shared by flag- and config-driven CLIs; the same
    arguments as the JAX package's ``build_loader``."""
    cf = set(class_filter) if class_filter else None
    if loader_name == "birdeep":
        return BIRDeepLoader(dataset, split=split, species_filter=cf)
    if loader_name == "birdeep_image":
        return BIRDeepImageLoader(dataset, split=split, species_filter=cf)
    if loader_name == "fsc22":
        return FSC22Loader(dataset, split=split, class_filter=cf)
    if loader_name == "audio_folder":
        root = audio_folder or dataset
        folder_split = None if (manifest or not split or split == "all") else split
        return AudioFolderLoader(root, split=folder_split, manifest=manifest, manifest_split=manifest_split)
    if loader_name == "image_folder":
        return ImageFolderLoader(image_folder or dataset, split=split)
    if loader_name == "text_folder":
        return TextFolderLoader(text_folder or dataset, split=split)
    if loader_name == "text_json":
        return TextJSONLoader(dataset)
    if loader_name == "text_csv":
        return TextCSVLoader(dataset, text_col=text_col, label_col=label_col)
    if loader_name == "tabular":
        return TabularLoader(dataset, label_col=label_col)
    if loader_name == "video_folder":
        return VideoFolderLoader(video_folder or dataset, split=split)
    raise ValueError(f"Unknown loader: {loader_name!r}. Valid choices: {', '.join(LOADER_NAMES)}.")
