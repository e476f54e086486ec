"""Each cell at its own size on a card: a short run is correct, and the
control fails the limit the program meets. Skips without the cards a cell
asks for; imports neither jax nor the JAX package:

    python -m pytest -m cuda benchmark/tests/test_bench_cuda.py
"""

from __future__ import annotations

import pytest
import torch

from benchmark import calibrate, run
from benchmark.harness import files
from benchmark.tests import tiny


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the program's mel kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    """The benchmark at full size, with the held-out cells listed."""
    return tiny.copy(tmp_path_factory.mktemp("full"))


def _cards(cell: str) -> None:
    chips = files.load_json("workloads", cell)["chips"]
    if torch.cuda.device_count() < chips:
        pytest.skip(f"{cell} needs {chips} CUDA cards; {torch.cuda.device_count()} visible")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", tiny.CELLS)
def test_cell_runs_correct_on_the_card(card, bench, cell):
    _cards(cell)
    for trace in (0, 1):
        args = tiny.args(cell, 2_900_000_123, trace, seconds=2.0)
        result = run.run_cell(args, card, 0.0, bench, bench.parent).result
        assert result["correct"] and result["device"]["platform"] == "gpu", result["checks"]
        if trace:
            assert "mel_roofline" in result["metrics"] and 0 < result["metrics"]["mel_roofline"]["value"] < 100


@pytest.mark.cuda
@pytest.mark.parametrize("cell", tiny.CELLS)
def test_control_fails_on_the_card(card, bench, cell):
    _cards(cell)
    (key, limit), = files.load_json("workloads", cell)["limits"].items()
    program, control, *tf32 = calibrate.readings(cell, 2_900_000_321, 1.0, True, card, bench, bench.parent)
    assert program[key] <= limit < control[key]
    assert all(limit < r[key] for r in tf32)
