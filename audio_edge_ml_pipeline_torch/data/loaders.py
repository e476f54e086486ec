"""Dataset loaders: every loader yields (sample_path | None, label | None,
metadata dict) and implements __len__.

The audio, image and video loaders of the JAX package's ``data/loaders.py``:
fsc22 (flat dir + CSV + deterministic stratified split), audio_folder
(class-per-subfolder + header probe + split-manifest filter), birdeep (one
sample per annotation row, with its segment's start and end),
birdeep_image (the same rows' spectrogram PNGs with their YOLO boxes),
image_folder and video_folder (class-per-subfolder). The text and tabular
loader names raise a "not yet ported" error from ``build_loader``.
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
PORTED_LOADERS = ("birdeep", "birdeep_image", "fsc22", "audio_folder", "image_folder", "video_folder")


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
    if loader_name == "video_folder":
        return VideoFolderLoader(video_folder or dataset, split=split)
    if loader_name in LOADER_NAMES:
        raise NotImplementedError(
            f"loader {loader_name!r} is not yet ported to audio_edge_ml_pipeline_torch "
            f"(ported: {', '.join(PORTED_LOADERS)}); use audio_edge_ml_pipeline_tpu for it."
        )
    raise ValueError(f"Unknown loader: {loader_name!r}. Valid choices: {', '.join(LOADER_NAMES)}.")
