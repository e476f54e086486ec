"""The port's search engine (audio_edge_ml_pipeline_torch/train/search.py)
against the JAX package's train/search.py: for the same seed and the same
reported values, the TPE and random samplers draw the same parameters and
the median, successive-halving and Hyperband pruners take the same
decisions, bit for bit; ``optimize(catch=...)`` marks the same states."""

import math

import numpy as np
import pytest

from audio_edge_ml_pipeline_tpu.train import search as jsearch
from audio_edge_ml_pipeline_torch.train import search as tsearch

SPACES = {
    "categorical": lambda t: {"c": t.suggest_categorical("c", ["a", "b", "c", "d"])},
    "int": lambda t: {"n": t.suggest_int("n", 2, 40, step=2)},
    "float": lambda t: {"x": t.suggest_float("x", -3.0, 5.0)},
    "float_step": lambda t: {"x": t.suggest_float("x", 0.0, 1.0, step=0.05)},
    "log": lambda t: {"lr": t.suggest_float("lr", 1e-5, 1e-1, log=True)},
    "mixed": lambda t: {"c": t.suggest_categorical("c", ["[16, 32]", "[32, 64]"]),
                        "lr": t.suggest_float("lr", 2e-4, 1e-2, log=True),
                        "d": t.suggest_float("d", 0.1, 0.5), "bs": t.suggest_int("bs", 16, 64, step=16)},
}


def _value(params: dict) -> float:
    """A deterministic objective of any drawn parameters."""
    v = 0.0
    for k, p in sorted(params.items()):
        v += -((p - 0.3) ** 2) if isinstance(p, float) else (sum(map(ord, str(p))) % 7) / 7.0
    return v


def _run(pkg, space: str, sampler: str, seed: int, n_trials: int = 30):
    cls = pkg.TPESampler if sampler == "tpe" else pkg.RandomSampler
    study = pkg.create_study(sampler=cls(seed=seed, n_startup_trials=5), pruner=pkg.NopPruner())
    study.optimize(lambda t: _value(SPACES[space](t)), n_trials=n_trials)
    return [(t.params, t.value, t.state) for t in study.trials]


@pytest.mark.parametrize("sampler", ["tpe", "random"])
@pytest.mark.parametrize("space", sorted(SPACES))
@pytest.mark.parametrize("seed", [0, 7])
def test_sampler_draws_equal_jax(space, sampler, seed):
    assert _run(tsearch, space, sampler, seed) == _run(jsearch, space, sampler, seed)


@pytest.mark.parametrize("direction", ["maximize", "minimize"])
def test_batch_ask_tell_draws_equal_jax(direction):
    """Rounds of asks before any tell (the batched path's batch TPE)."""
    out = {}
    for name, pkg in (("jax", jsearch), ("port", tsearch)):
        study = pkg.create_study(direction=direction, sampler=pkg.TPESampler(seed=3, n_startup_trials=4))
        drawn = []
        for _ in range(4):
            trials = [study.ask() for _ in range(3)]
            for t in trials:
                p = SPACES["mixed"](t)
                drawn.append(p)
                study.tell(t, value=_value(p))
        out[name] = (drawn, study.best_trial.number)
    assert out["port"] == out["jax"]


def _reports(seed: int, n_trials: int, n_steps: int) -> np.ndarray:
    """Seeded learning curves: trial means spread, noise, a slow starter."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(0.2, 0.8, n_trials)
    curves = base[:, None] * (1 - np.exp(-np.arange(1, n_steps + 1) / rng.uniform(2, 20, n_trials)[:, None]))
    return curves + 0.02 * rng.standard_normal((n_trials, n_steps))


PRUNERS = {
    "median": lambda pkg: pkg.MedianPruner(n_startup_trials=3, n_warmup_steps=2),
    "successive_halving": lambda pkg: pkg.SuccessiveHalvingPruner(min_resource=2, eta=3),
    "hyperband": lambda pkg: pkg.HyperbandPruner(min_resource=1, max_resource=27, eta=3),
}


def _prune_decisions(pkg, pruner: str, seed: int, direction: str):
    reports = _reports(seed, 24, 30)
    if direction == "minimize":
        reports = -reports
    study = pkg.create_study(direction=direction, sampler=pkg.RandomSampler(seed=seed), pruner=PRUNERS[pruner](pkg))
    decisions = []

    def objective(trial):
        for step, v in enumerate(reports[trial.number]):
            trial.report(float(v), step)
            if trial.should_prune():
                decisions.append((trial.number, step))
                raise pkg.TrialPruned()
        return float(reports[trial.number, -1])

    study.optimize(objective, n_trials=len(reports))
    return decisions, [t.state for t in study.trials]


@pytest.mark.parametrize("direction", ["maximize", "minimize"])
@pytest.mark.parametrize("pruner", sorted(PRUNERS))
@pytest.mark.parametrize("seed", [1, 2])
def test_pruner_decisions_equal_jax(pruner, seed, direction):
    port = _prune_decisions(tsearch, pruner, seed, direction)
    assert port == _prune_decisions(jsearch, pruner, seed, direction)
    assert port[0], "the seeded curves must make every pruner prune"


def test_hyperband_brackets_equal_jax():
    for kw in ({}, {"min_resource": 1, "max_resource": 40, "eta": 2}, {"min_resource": 9, "max_resource": 3}):
        j, t = jsearch.HyperbandPruner(**kw), tsearch.HyperbandPruner(**kw)
        assert t.n_brackets == j.n_brackets
        assert [t.bracket_of(n) for n in range(60)] == [j.bracket_of(n) for n in range(60)]


def test_catch_marks_the_states_jax_marks():
    def objective_for(pkg):
        def objective(trial):
            x = trial.suggest_float("x", 0.0, 1.0)
            if trial.number % 4 == 1:
                raise ValueError("boom")
            if trial.number % 4 == 2:
                raise pkg.TrialPruned()
            return x
        return objective

    out = {}
    for name, pkg in (("jax", jsearch), ("port", tsearch)):
        study = pkg.create_study(sampler=pkg.TPESampler(seed=5, n_startup_trials=3))
        study.optimize(objective_for(pkg), n_trials=12, catch=(ValueError,))
        out[name] = [(t.state, t.value, t.params) for t in study.trials]
    assert out["port"] == out["jax"]
    assert [s for s, _, _ in out["port"]].count("FAIL") == 3
    # outside `catch`, the error propagates, as in JAX
    study = tsearch.create_study(sampler=tsearch.TPESampler(seed=5))
    with pytest.raises(ValueError, match="boom"):
        study.optimize(lambda t: (_ for _ in ()).throw(ValueError("boom")), n_trials=1)


def test_best_trial_and_no_completed_trials():
    study = tsearch.create_study(direction="minimize")
    with pytest.raises(ValueError, match="No completed trials"):
        study.best_trial
    study.optimize(lambda t: math.cos(t.suggest_float("x", 0, 6)), n_trials=5)
    assert study.best_value == min(t.value for t in study.trials)


def test_grid_search_cv_names_scikit_learn_where_it_is_missing(monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "sklearn.model_selection", None)
    with pytest.raises(ImportError, match="scikit-learn"):
        tsearch.grid_search_cv(lambda: None, {}, np.zeros((4, 2)), np.array([0, 1, 0, 1]), cv=2)
