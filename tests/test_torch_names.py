"""Name parity: every public name a module of the JAX package defines (its
top-level functions, classes and assigned names; for an ``__init__.py`` the
names it re-exports) is defined by the port's counterpart module, so that
an import or attribute that works on the JAX package works on the port.
The repository's tools and scripts that the port carries in its
``tools/`` package are held to the same rule.

Both packages are read with ``ast``; neither is imported. A name the port
renamed on purpose maps to its new name (checked there); a name that exists
only for JAX is allowed, with its reason. Each allowance must still name a
JAX definition the port lacks, so that a stale entry fails."""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
JAX = REPO / "audio_edge_ml_pipeline_tpu"
PORT = REPO / "audio_edge_ml_pipeline_torch"

# modules the port renamed (ROADMAP §1): JAX path -> port path(s), relative to the packages
RENAMED_MODULES = {
    "models/classical_jax.py": ("models/classical_core.py",),
    "ops/effects_jax.py": ("ops/effects_device.py",),
    "train/search_jax.py": ("train/search_cv.py",),
    "ops/pallas_mel.py": ("ops/mel_kernel.py", "ops/mel_unfolded.py"),
}

# the repository's tools and scripts the port carries: repo path -> port path
TOOLS = {
    **{f"tools/{n}.py": f"tools/{n}.py" for n in (
        "serial_proto", "make_synth_dataset", "generate_split", "receive_wav", "record_dataset",
        "evaluate_device", "convert_backbone_weights")},
    **{f"scripts/{n}.py": f"tools/{n}.py" for n in (
        "diagnose_data", "diagnose_training", "verify_training_data", "test_model", "load_sample_data",
        "test_dashboard")},
}

# (JAX module, name) -> (port module, port name): renamed on purpose, defined there
RENAMED = {
    ("models/deep.py", "FlaxTrainer"): ("models/deep.py", "TorchTrainer"),
    ("train/search_jax.py", "JAX_TUNABLE"): ("train/search_cv.py", "DEVICE_TUNABLE"),
    ("train/search_jax.py", "grid_search_cv_jax"): ("train/search_cv.py", "grid_search_cv_device"),
    ("ops/pallas_mel.py", "mel_power_pallas_folded"): ("ops/mel_kernel.py", "mel_power_folded"),
    ("ops/pallas_mel.py", "mel_spec_feature_pallas"): ("ops/mel_kernel.py", "mel_spec_feature"),
    ("ops/pallas_mel.py", "mel_power_pallas"): ("ops/mel_unfolded.py", "mel_power_unfolded"),
    # JAX's one-line wrapper; the port's module imports the function it wraps
    ("optimize/quantize.py", "save_model_bundle_from_flat"): ("optimize/quantize.py", "save_model_bundle_flat"),
    # dsp's composite features live beside the kernels that compute them
    ("ops/dsp.py", "mel_spec_feature"): ("ops/mel_kernel.py", "mel_spec_feature"),
    ("ops/dsp.py", "mfcc"): ("ops/audio_features.py", "mfcc"),
    ("ops/dsp.py", "mfcc_seq_feature"): ("ops/audio_features.py", "mfcc_seq_feature"),
    ("ops/dsp.py", "classical_feature_vector"): ("ops/audio_features.py", "classical_feature_vector"),
}

# (module, name) -> why the port has no counterpart
JAX_ONLY = {
    ("ops/dsp.py", "HIGHEST"): "lax.Precision.HIGHEST; the port pins float32 / float64 products itself",
    ("ops/dsp.py", "cqt_magnitude_multirate"): "the closed multirate-CQT experiment (ROADMAP §1)",
    ("ops/pallas_mel.py", "TILE_T"): "the Pallas grid's frame tile; the CUDA kernels size their own tiles",
    ("models/classical_jax.py", "kernels"): "the lazily built namespace of jitted XLA programs",
    ("models/backbones.py", "flatten_variables"): "flattens a flax variables tree; the port has no flax trees",
    ("models/deep.py", "save_model_bundle"): "saves a flax params tree; the port saves flat arrays "
                                             "(save_model_bundle_flat, the same file)",
    ("utils/logging.py", "enable_compilation_cache"): "JAX's persistent XLA compilation cache",
    **{(tool, "REPO"): "the repository root the JAX tool puts on sys.path; the port edits no sys.path"
       for tool in ("tools/make_synth_dataset.py", "tools/generate_split.py", "tools/receive_wav.py",
                    "tools/record_dataset.py", "tools/evaluate_device.py")},
}


def _top_level(tree: ast.Module) -> list[ast.stmt]:
    """Statements at module level, those under if / try blocks included."""
    out = []
    for node in tree.body:
        out.append(node)
        if isinstance(node, (ast.If, ast.Try)):
            for sub in (node.body, node.orelse, getattr(node, "handlers", []), getattr(node, "finalbody", [])):
                for child in sub:
                    out.extend(_top_level(ast.Module(body=child.body, type_ignores=[]))
                               if isinstance(child, ast.ExceptHandler) else [child])
    return out


def _assigned(node: ast.stmt) -> set[str]:
    targets = node.targets if isinstance(node, ast.Assign) else [node.target]
    return {n.id for t in targets for n in ast.walk(t) if isinstance(n, ast.Name)}


def public_names(path: Path) -> set[str]:
    """What the module exports: defs, classes, assigned names; for an
    ``__init__.py`` also the names it imports."""
    names = set()
    for node in _top_level(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            names |= _assigned(node)
        elif isinstance(node, ast.ImportFrom) and path.name == "__init__.py" and node.level:
            names |= {a.asname or a.name for a in node.names}
    return {n for n in names if not n.startswith("_") and n != "logger"}


def defined_names(path: Path) -> set[str]:
    """Every name the module binds at its top level, imports included."""
    names = set()
    for node in _top_level(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            names |= _assigned(node)
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            names |= {(a.asname or a.name).split(".")[0] for a in node.names}
    return names


def _counterparts(rel: str) -> tuple[str, ...]:
    return (TOOLS[rel],) if rel in TOOLS else RENAMED_MODULES.get(rel, (rel,))


def _source(rel: str) -> Path:
    return REPO / rel if rel in TOOLS else JAX / rel


JAX_MODULES = sorted(str(p.relative_to(JAX)) for p in JAX.rglob("*.py"))


@pytest.mark.parametrize("rel", JAX_MODULES + sorted(TOOLS))
def test_the_port_defines_every_public_name(rel):
    ports = [PORT / c for c in _counterparts(rel)]
    missing_modules = [str(p.relative_to(PORT)) for p in ports if not p.exists()]
    assert not missing_modules, f"{rel}: no counterpart {missing_modules}"
    port_names = set().union(*(defined_names(p) for p in ports))
    missing = []
    for name in sorted(public_names(_source(rel))):
        if (rel, name) in JAX_ONLY:
            continue
        if (rel, name) in RENAMED:
            target, new = RENAMED[(rel, name)]
            assert new in defined_names(PORT / target), f"{rel}:{name} -> {target}:{new} is not defined"
            continue
        if name not in port_names:
            missing.append(name)
    assert not missing, f"the port's {list(_counterparts(rel))} lacks {missing} of {rel}"


@pytest.mark.parametrize("key", sorted(JAX_ONLY) + sorted(RENAMED), ids=lambda k: f"{k[0]}:{k[1]}")
def test_every_allowance_names_a_jax_definition_the_port_lacks(key):
    rel, name = key
    assert name in public_names(_source(rel)), f"{rel} no longer defines {name}: drop the entry"
    reason = JAX_ONLY.get(key)
    assert reason is None or len(reason) > 20
    if key in JAX_ONLY:
        assert name not in set().union(*(defined_names(PORT / c) for c in _counterparts(rel))), \
            f"the port defines {name} now: drop the allowance"


def test_the_scan_sees_what_fault_q_left_out():
    """The names the port once lacked are in the scan's view of the JAX
    package, so that the parity test would have caught them."""
    assert {"active_run", "end_run", "log_params", "log_metric", "log_metrics", "log_artifact",
            "set_tag"} <= public_names(JAX / "utils/tracking.py")
    assert {"TextCSVLoader", "TabularLoader", "build_loader"} <= public_names(JAX / "data/__init__.py")
    assert "setup_logging" in public_names(JAX / "utils/__init__.py")
    assert "apply_class_filter" in public_names(JAX / "train/train.py")
    assert "stft_complex_fft" in public_names(JAX / "ops/dsp.py")
