"""Everything the harness runs is found by name: a cell, a configuration,
a traffic mix, its generator, an entry and a metric each have a file of
their own, so that a later change adds a file and an entry in
``BENCHMARK.json`` and edits nothing that is there."""

from __future__ import annotations

import importlib.util
import json
import re
import sys
import types
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")


def _name(name: str) -> str:
    if not NAME.fullmatch(name):
        raise ValueError(f"not a benchmark name: {name!r}")
    return name


def spec(root: Path = ROOT) -> dict:
    """``BENCHMARK.json``."""
    return json.loads((root / "BENCHMARK.json").read_text())


def load_json(kind: str, name: str, bench: Path = BENCH) -> dict:
    """``<bench>/<kind>/<name>.json``: kind is configs, workloads or traffic."""
    path = bench / kind / f"{_name(name)}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file for {name!r}: {path}")
    return json.loads(path.read_text())


def load_module(kind: str, name: str, bench: Path = BENCH) -> types.ModuleType:
    """``<bench>/<kind>/<name>.py`` as a module (names may hold dots and
    dashes, so it is loaded from its path, not imported by name)."""
    path = bench / kind / f"{_name(name)}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} module for {name!r}: {path}")
    key = f"benchmark_{kind}_{re.sub(r'[^A-Za-z0-9_]', '_', name)}_{abs(hash(str(path)))}"
    if key in sys.modules:
        return sys.modules[key]
    mod_spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(mod_spec)
    sys.modules[key] = mod
    mod_spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench_spec: dict, cell: str, group: str) -> list[dict]:
    """The metrics of ``group`` (end_to_end or per_layer) that ``cell`` reports."""
    return [m for m in bench_spec[group] if "workloads" not in m or cell in m["workloads"]]
