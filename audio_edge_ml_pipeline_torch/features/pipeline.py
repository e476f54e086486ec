"""FeaturePipeline: loader x extractor orchestration + FeatureSet
persistence + the feature-extraction CLI.

On-disk format and CLI flags match the JAX package's ``features/pipeline.py``:
features.npy / labels.npy / label_names.json / metadata.json / info.json /
optional cluster_assignments.npy + archived config.yaml. One flag is added:
``--device`` (default: the first CUDA card; ``cpu`` runs the plain versions
of the kernels).

CLI:
    python -m audio_edge_ml_pipeline_torch.features.pipeline --config cfg.yaml
    python -m audio_edge_ml_pipeline_torch.features.pipeline \\
        --loader fsc22 --dataset data/raw/fsc22 --extractor audio_mel_spec \\
        --split train --output data/processed/fsc22_mel_train
"""

from __future__ import annotations

import argparse
import json
import logging
import shutil
from pathlib import Path
from typing import Optional

import numpy as np

from ..data.loaders import LOADER_NAMES, build_loader
from ..utils.logging import setup_logging
from ..utils.profiling import log_timing_report, stage_timer
from .base import BaseDatasetLoader, BaseFeatureExtractor, FeatureSet
from .registry import get

logger = logging.getLogger(__name__)


def _json_out(path: Path, obj) -> None:
    path.write_text(json.dumps(obj, indent=2, default=str))


def _json_in(path: Path, default=None):
    return json.loads(path.read_text()) if path.exists() else default


class FeaturePipeline:
    """Ties a loader to an extractor; owns FeatureSet persistence.

    Directory layout: features.npy + info.json always; labels.npy /
    label_names.json / cluster_assignments.npy when present; metadata.json.
    """

    def __init__(self, loader: BaseDatasetLoader, extractor: BaseFeatureExtractor) -> None:
        self.loader = loader
        self.extractor = extractor

    def run(self, max_samples: Optional[int] = None) -> FeatureSet:
        logger.info(
            "extracting %d samples: %s -> %s",
            len(self.loader), type(self.loader).__name__, self.extractor.name,
        )
        with stage_timer(f"extract:{self.extractor.name}"):
            fs = self.extractor.extract_dataset(self.loader, max_samples=max_samples)
        logger.info("extraction finished: %s", fs)
        return fs

    @staticmethod
    def save(fs: FeatureSet, output_dir: Path | str) -> None:
        out = Path(output_dir)
        out.mkdir(parents=True, exist_ok=True)
        np.save(out / "features.npy", fs.features)
        for stem, arr in (("labels", fs.labels), ("cluster_assignments", fs.cluster_assignments)):
            if arr is not None:
                np.save(out / f"{stem}.npy", arr)
        if fs.label_names is not None:
            _json_out(out / "label_names.json", fs.label_names)
        _json_out(out / "metadata.json", fs.metadata)
        _json_out(
            out / "info.json",
            {
                "feature_type": fs.feature_type,
                "modality": fs.modality,
                "n_samples": fs.n_samples,
                "feature_shape": list(fs.feature_shape),
                "n_classes": fs.n_classes,
                "is_supervised": fs.is_supervised,
            },
        )
        logger.info("FeatureSet saved to %s", out)

    @staticmethod
    def load(output_dir: Path | str) -> FeatureSet:
        out = Path(output_dir)
        missing = [n for n in ("features.npy", "info.json") if not (out / n).exists()]
        if missing:
            raise FileNotFoundError(
                f"{out} is not a FeatureSet directory — missing {', '.join(missing)} "
                "(expected a directory written by FeaturePipeline.save)"
            )

        def optional_npy(stem: str):
            p = out / f"{stem}.npy"
            return np.load(p) if p.exists() else None

        info = _json_in(out / "info.json")
        return FeatureSet(
            features=np.load(out / "features.npy"),
            feature_type=info["feature_type"],
            modality=info["modality"],
            metadata=_json_in(out / "metadata.json", []),
            labels=optional_npy("labels"),
            label_names=_json_in(out / "label_names.json"),
            cluster_assignments=optional_npy("cluster_assignments"),
        )


def apply_label_map(fs: FeatureSet, label_map: dict[str, str]) -> FeatureSet:
    """Rename/collapse classes via a name->name map; new names are numbered
    in first-occurrence order."""
    if fs.labels is None or fs.label_names is None:
        return fs
    renamed = [label_map.get(name, name) for name in fs.label_names]
    per_sample = [renamed[code] for code in fs.labels]
    merged_names = list(dict.fromkeys(per_sample))  # dedupe, keep first-seen order
    code_of = {name: j for j, name in enumerate(merged_names)}
    if len(merged_names) != len(fs.label_names):
        logger.info(
            "label_map collapsed %d classes -> %d classes: %s",
            len(fs.label_names), len(merged_names), merged_names,
        )
    return FeatureSet(
        features=fs.features,
        feature_type=fs.feature_type,
        modality=fs.modality,
        metadata=fs.metadata,
        labels=np.array([code_of[n] for n in per_sample], dtype=np.int32),
        label_names=merged_names,
        cluster_assignments=fs.cluster_assignments,
    )


# loader-construction fields forwarded verbatim from the experiment config
_LOADER_FIELDS = (
    "split", "label_col", "text_col", "audio_folder", "image_folder",
    "text_folder", "video_folder", "class_filter", "manifest", "manifest_split",
)


def _run_experiment(exp, config_path: Optional[Path] = None, device: Optional[str] = None) -> None:
    loader = build_loader(
        loader_name=exp.loader,
        dataset=exp.dataset or "data/raw/BIRDeep_AudioAnnotations",
        **{field: getattr(exp, field) for field in _LOADER_FIELDS},
    )
    params = dict(exp.extractor_params)
    if device is not None:
        params["device"] = device
    extractor = get(exp.extractor)(**params)
    output_dir = Path(exp.resolved_output())
    pipeline = FeaturePipeline(loader, extractor)
    fs = pipeline.run(max_samples=exp.max_samples)
    if exp.label_map:
        fs = apply_label_map(fs, exp.label_map)
    FeaturePipeline.save(fs, output_dir)
    if config_path is not None:
        shutil.copy2(config_path, output_dir / "config.yaml")
    print(f"[{exp.resolved_name()}] {fs}\n  -> {output_dir}")


def _build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Run the batched feature extraction pipeline (flags for a single run, or --config YAML).",
    )
    p.add_argument("--config", default=None, metavar="YAML")
    p.add_argument("--dataset", default="data/raw/BIRDeep_AudioAnnotations")
    p.add_argument("--loader", default="birdeep", choices=LOADER_NAMES)
    p.add_argument("--audio-folder", default=None)
    p.add_argument("--image-folder", default=None)
    p.add_argument("--text-folder", default=None)
    p.add_argument("--video-folder", default=None)
    p.add_argument("--label-col", default=None)
    p.add_argument("--text-col", default="text")
    p.add_argument("--split", default="train", choices=["train", "test", "validation", "all"])
    p.add_argument("--extractor", default="audio_classical")
    p.add_argument("--output", default=None)
    p.add_argument("--max-samples", type=int, default=None)
    p.add_argument("--classes", nargs="+", default=None, metavar="CLASS")
    p.add_argument("--device", default=None,
                   help="torch device for the extractor (default: the first CUDA card; 'cpu' runs the plain versions)")
    return p


def main(argv: Optional[list[str]] = None) -> None:
    setup_logging()
    args = _build_arg_parser().parse_args(argv)
    if args.config:
        from .config import load_config

        experiments = load_config(args.config).resolved_experiments()
        print(f"{len(experiments)} experiment(s) from {args.config}")
        for exp in experiments:
            print(f"\n=== {exp.resolved_name()} ===")
            _run_experiment(exp, config_path=Path(args.config), device=args.device)
        log_timing_report()
        print("\ndone — all experiments written.")
    else:
        from .config import ExperimentConfig

        flags = {
            k: getattr(args, k)
            for k in ("extractor", "loader", "dataset", "split", "output", "max_samples",
                      "label_col", "text_col", "audio_folder", "image_folder",
                      "text_folder", "video_folder")
        }
        _run_experiment(ExperimentConfig(class_filter=args.classes, **flags), device=args.device)
        log_timing_report()


if __name__ == "__main__":
    main()
