"""YAML pipeline configuration: top-level defaults merged into per-experiment
overrides, species_filter legacy alias, unknown-key tolerance.

Schema-compatible with the JAX package's ``features/config.py`` so existing
feature_extraction.yaml files work unchanged.
"""

from __future__ import annotations

from dataclasses import dataclass, field, fields as dc_fields
from pathlib import Path


@dataclass
class ExperimentConfig:
    extractor: str
    loader: str
    name: str | None = None
    dataset: str | None = None
    split: str | None = None
    output: str | None = None
    max_samples: int | None = None
    label_col: str | None = None
    text_col: str = "text"
    audio_folder: str | None = None
    image_folder: str | None = None
    text_folder: str | None = None
    video_folder: str | None = None
    extractor_params: dict[str, object] = field(default_factory=dict)
    class_filter: list[str] | None = None
    label_map: dict[str, str] | None = None
    manifest: str | None = None
    manifest_split: str | None = None

    def resolved_name(self) -> str:
        default = f"{self.loader}_{self.extractor}_{self.split}"
        return self.name or default

    def resolved_output(self) -> str:
        default = f"data/processed/{self.resolved_name()}"
        return self.output or default


@dataclass
class PipelineConfig:
    dataset: str = "data/raw/BIRDeep_AudioAnnotations"
    split: str = "train"
    extractor: str | None = None
    loader: str | None = None
    output: str | None = None
    max_samples: int | None = None
    label_col: str | None = None
    text_col: str = "text"
    audio_folder: str | None = None
    image_folder: str | None = None
    text_folder: str | None = None
    video_folder: str | None = None
    extractor_params: dict[str, object] = field(default_factory=dict)
    class_filter: list[str] | None = None
    label_map: dict[str, str] | None = None
    manifest: str | None = None
    manifest_split: str | None = None
    experiments: list[ExperimentConfig] = field(default_factory=list)

    # Fields where a falsy experiment value (0, [], {}) is still an explicit
    # override — only literal None falls through to the top-level default.
    # Everything else (strings/paths) inherits on any falsy value.
    _NONE_FALLTHROUGH = frozenset(
        {"split", "max_samples", "class_filter", "label_map"}
    )

    def _shared_field_names(self) -> list[str]:
        exp_only = {"name"}
        return [f.name for f in dc_fields(ExperimentConfig) if f.name not in exp_only]

    def resolved_experiments(self) -> list[ExperimentConfig]:
        """Merge top-level defaults into each experiment; synthesize a single
        experiment in single-run mode. Raises ValueError on missing
        extractor/loader."""
        shared = self._shared_field_names()
        if len(self.experiments) == 0:
            if not (self.extractor and self.loader):
                raise ValueError(
                    "single-run mode needs both 'extractor' and 'loader' at "
                    "the top level (or define an 'experiments' list)."
                )
            return [ExperimentConfig(**{k: getattr(self, k) for k in shared})]

        out: list[ExperimentConfig] = []
        for i, e in enumerate(self.experiments):
            kw: dict = {"name": e.name}
            for k in shared:
                v = getattr(e, k)
                inherit = (v is None) if k in self._NONE_FALLTHROUGH else (not v)
                kw[k] = getattr(self, k) if inherit else v
            merged = ExperimentConfig(**kw)
            for required in ("extractor", "loader"):
                if not getattr(merged, required):
                    raise ValueError(f"Experiment #{i} is missing {required!r}.")
            out.append(merged)
        return out


def _alias_species_filter(d: dict) -> dict:
    if "species_filter" in d and "class_filter" not in d:
        d["class_filter"] = d.pop("species_filter")
    else:
        d.pop("species_filter", None)
    return d


def load_config(path: Path | str) -> PipelineConfig:
    """Parse YAML -> validated PipelineConfig (unknown keys tolerated,
    species_filter aliased to class_filter)."""
    import yaml

    path = Path(path)
    if not path.exists():
        raise FileNotFoundError(f"no such pipeline config: {path}")
    doc = yaml.safe_load(path.read_text()) or {}
    exp_docs = doc.pop("experiments", []) or []
    doc = _alias_species_filter(doc)
    top_keys = {f.name for f in dc_fields(PipelineConfig)}
    cfg = PipelineConfig(**{k: v for k, v in doc.items() if k in top_keys})
    exp_keys = {f.name for f in dc_fields(ExperimentConfig)}
    for exp_doc in exp_docs:
        kw = {k: v for k, v in _alias_species_filter(dict(exp_doc)).items() if k in exp_keys}
        cfg.experiments.append(
            ExperimentConfig(extractor=kw.pop("extractor", ""), loader=kw.pop("loader", ""), **kw)
        )
    cfg.resolved_experiments()  # validate
    return cfg
