"""Hyperparameter search engine: TPE sampler + median / successive-halving /
Hyperband pruners with an Optuna-compatible surface (create_study /
Trial.suggest_* / report / should_prune / TrialPruned).

The port's own copy of the JAX package's ``train/search.py`` (numpy only):
for the same seed and the same reported values it draws the same parameters
and takes the same pruning decisions, bit for bit.

The TPE implementation follows Bergstra et al. (2011): after n_startup
random trials, observations are split at the gamma quantile into good/bad
sets; numeric parameters are modeled by Parzen (Gaussian-mixture) estimators
over each set and candidates drawn from l(x) are ranked by l(x)/g(x);
categorical parameters use smoothed category frequencies. Parameters are
modeled independently (Optuna's default univariate TPE).

``grid_search_cv`` stays on scikit-learn, as in JAX; only the tree trainers
(``decision_tree``, ``random_forest``) reach it. Where scikit-learn is not
installed it raises an ImportError naming it.
"""

from __future__ import annotations

import logging
import math
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np

logger = logging.getLogger(__name__)


class TrialPruned(Exception):
    """Raised inside an objective to mark the trial as pruned."""


@dataclass
class _ParamSpec:
    kind: str  # "categorical" | "float" | "int"
    choices: Optional[list] = None
    low: float = 0.0
    high: float = 1.0
    step: Optional[float] = None
    log: bool = False


class TrialState:
    RUNNING = "RUNNING"
    COMPLETE = "COMPLETE"
    PRUNED = "PRUNED"
    FAIL = "FAIL"


@dataclass
class FrozenTrial:
    number: int
    state: str = TrialState.RUNNING
    value: Optional[float] = None
    params: dict = field(default_factory=dict)
    intermediate: dict = field(default_factory=dict)  # step -> value


class Trial:
    """Handle passed to the objective; lazily samples via the study sampler."""

    def __init__(self, study: "Study", record: FrozenTrial):
        self._study = study
        self._record = record

    @property
    def number(self) -> int:
        return self._record.number

    @property
    def params(self) -> dict:
        return dict(self._record.params)

    def _suggest(self, name: str, spec: _ParamSpec):
        if name in self._record.params:
            return self._record.params[name]
        value = self._study.sampler.sample(self._study, name, spec)
        self._record.params[name] = value
        self._study._param_specs[name] = spec
        return value

    def suggest_categorical(self, name: str, choices):
        return self._suggest(name, _ParamSpec("categorical", choices=list(choices)))

    def suggest_float(self, name: str, low: float, high: float, step=None, log: bool = False):
        return float(self._suggest(name, _ParamSpec("float", low=float(low), high=float(high), step=step, log=log)))

    def suggest_int(self, name: str, low: int, high: int, step: int = 1):
        return int(self._suggest(name, _ParamSpec("int", low=float(low), high=float(high), step=float(step))))

    def report(self, value: float, step: int) -> None:
        self._record.intermediate[int(step)] = float(value)

    def should_prune(self) -> bool:
        return self._study.pruner.should_prune(self._study, self._record)


class TPESampler:
    def __init__(self, seed: Optional[int] = None, n_startup_trials: int = 10,
                 gamma: float = 0.25, n_candidates: int = 24):
        self._rng = np.random.default_rng(seed)
        self.n_startup_trials = n_startup_trials
        self.gamma = gamma
        self.n_candidates = n_candidates

    # -- helpers ---------------------------------------------------------
    def _observations(self, study: "Study", name: str):
        obs = []
        for t in study.trials:
            if t.state == TrialState.COMPLETE and name in t.params and t.value is not None:
                obs.append((t.params[name], t.value))
        return obs

    def _to_internal(self, v, spec: _ParamSpec) -> float:
        return math.log(v) if spec.log else float(v)

    def _from_internal(self, x: float, spec: _ParamSpec):
        v = math.exp(x) if spec.log else x
        v = min(max(v, spec.low), spec.high)
        if spec.kind == "int":
            step = spec.step or 1.0
            v = spec.low + round((v - spec.low) / step) * step
            return int(min(max(v, spec.low), spec.high))
        if spec.step:
            v = spec.low + round((v - spec.low) / spec.step) * spec.step
            v = min(max(v, spec.low), spec.high)
        return float(v)

    def _random(self, spec: _ParamSpec):
        if spec.kind == "categorical":
            return spec.choices[int(self._rng.integers(len(spec.choices)))]
        lo = self._to_internal(spec.low, spec)
        hi = self._to_internal(spec.high, spec)
        return self._from_internal(float(self._rng.uniform(lo, hi)), spec)

    @staticmethod
    def _parzen_logpdf(x: np.ndarray, centers: np.ndarray, sigma: float, lo: float, hi: float) -> np.ndarray:
        # Gaussian mixture with a uniform prior component over [lo, hi]
        diffs = (x[:, None] - centers[None, :]) / sigma
        comp = np.exp(-0.5 * diffs**2) / (sigma * math.sqrt(2 * math.pi))
        prior = 1.0 / max(hi - lo, 1e-12)
        mix = (comp.sum(axis=1) + prior) / (len(centers) + 1)
        return np.log(np.maximum(mix, 1e-300))

    def sample(self, study: "Study", name: str, spec: _ParamSpec):
        obs = self._observations(study, name)
        if len(obs) < self.n_startup_trials:
            return self._random(spec)
        # split: higher value = better (studies maximize internally)
        obs.sort(key=lambda p: p[1], reverse=study.direction == "maximize")
        n_good = max(1, int(np.ceil(self.gamma * len(obs))))
        good = [v for v, _ in obs[:n_good]]
        bad = [v for v, _ in obs[n_good:]] or good

        if spec.kind == "categorical":
            k = len(spec.choices)
            gcounts = np.ones(k)
            bcounts = np.ones(k)
            index = {self._key(c): i for i, c in enumerate(spec.choices)}
            for v in good:
                gcounts[index[self._key(v)]] += 1
            for v in bad:
                bcounts[index[self._key(v)]] += 1
            gp = gcounts / gcounts.sum()
            bp = bcounts / bcounts.sum()
            # sample candidates from the good distribution, rank by gp/bp
            cand = self._rng.choice(k, size=min(self.n_candidates, 4 * k), p=gp)
            best = cand[np.argmax(gp[cand] / bp[cand])]
            return spec.choices[int(best)]

        lo = self._to_internal(spec.low, spec)
        hi = self._to_internal(spec.high, spec)
        g_centers = np.array([self._to_internal(v, spec) for v in good])
        b_centers = np.array([self._to_internal(v, spec) for v in bad])
        span = max(hi - lo, 1e-12)
        g_sigma = max(span / max(len(g_centers), 1), 1e-3 * span)
        b_sigma = max(span / max(len(b_centers), 1), 1e-3 * span)
        # draw candidates from the good mixture
        picks = self._rng.integers(len(g_centers), size=self.n_candidates)
        cand = g_centers[picks] + self._rng.normal(0, g_sigma, size=self.n_candidates)
        cand = np.clip(cand, lo, hi)
        score = self._parzen_logpdf(cand, g_centers, g_sigma, lo, hi) - self._parzen_logpdf(
            cand, b_centers, b_sigma, lo, hi
        )
        return self._from_internal(float(cand[int(np.argmax(score))]), spec)

    @staticmethod
    def _key(v):
        return str(v)


class RandomSampler(TPESampler):
    def sample(self, study, name, spec):
        return self._random(spec)


class MedianPruner:
    """Prune when the trial's latest reported value is below the median of
    completed trials' values at the same step."""

    def __init__(self, n_startup_trials: int = 5, n_warmup_steps: int = 10):
        self.n_startup_trials = n_startup_trials
        self.n_warmup_steps = n_warmup_steps

    def should_prune(self, study: "Study", record: FrozenTrial) -> bool:
        if not record.intermediate:
            return False
        step = max(record.intermediate)
        if step < self.n_warmup_steps:
            return False
        completed = [t for t in study.trials if t.state == TrialState.COMPLETE and t.intermediate]
        if len(completed) < self.n_startup_trials:
            return False
        peers = []
        for t in completed:
            usable = {s: v for s, v in t.intermediate.items() if s <= step}
            if usable:
                peers.append(usable[max(usable)])
        if not peers:
            return False
        median = float(np.median(peers))
        value = record.intermediate[step]
        return value < median if study.direction == "maximize" else value > median


class SuccessiveHalvingPruner:
    """Rung-based successive halving (a single Hyperband bracket): at rungs
    r0*eta^k a trial survives only in the top 1/eta of peers. HyperbandPruner
    below runs several of these brackets with staggered first rungs."""

    def __init__(self, min_resource: int = 5, eta: int = 3):
        self.min_resource = min_resource
        self.eta = eta

    def should_prune(self, study: "Study", record: FrozenTrial) -> bool:
        if not record.intermediate:
            return False
        step = max(record.intermediate)
        # cull only AT the geometric rungs r0 * eta^k — any multiple of
        # min_resource is NOT a rung (that earlier reading made the cut
        # fire at steps 10, 20, 25... for r0=5, eta=3 instead of 5, 15, 45,
        # pruning slow starters the schedule meant to spare)
        rung = self.min_resource
        while rung < step:
            rung *= self.eta
        if rung != step:
            return False
        peers = []
        for t in study.trials:
            if t.number == record.number or not t.intermediate:
                continue
            usable = {s: v for s, v in t.intermediate.items() if s <= step}
            if usable:
                peers.append(usable[max(usable)])
        if len(peers) < self.eta:
            return False
        value = record.intermediate[step]
        if study.direction == "maximize":
            cutoff = float(np.quantile(peers, 1.0 - 1.0 / self.eta))
            return value < cutoff
        cutoff = float(np.quantile(peers, 1.0 / self.eta))
        return value > cutoff


class HyperbandPruner:
    """Bracketed Hyperband (Li et al. 2018, JMLR 18:185) in the role of
    Optuna's HyperbandPruner (reference tune.py:497-510): several
    successive-halving brackets run side by side, where bracket ``s`` holds
    its first cull until step ``min_resource * eta**s``. Aggressive brackets
    (early first rung) admit many trials; lenient brackets admit few but let
    slow starters train long enough to show their worth — a trial that would
    die at step ``min_resource`` in bracket 0 survives untouched in a
    lenient bracket until its (much later) first rung.

    Trials are assigned to brackets deterministically by trial number,
    proportionally to Hyperband's allocation weights (bracket ``s`` gets
    ``eta**(s_max - s)`` of every ``sum`` consecutive trials), mirroring
    Optuna's budget-weighted assignment. Culling within a bracket compares
    only against same-bracket peers.
    """

    def __init__(self, min_resource: int = 5, max_resource: int = 81, eta: int = 3):
        self.min_resource = int(min_resource)
        self.max_resource = int(max_resource)
        self.eta = int(eta)
        # bracket s's first rung is min_resource * eta^s; brackets whose
        # first rung would exceed max_resource never get to cull anything
        # and are not created
        self._first_rungs: list[int] = []
        r = self.min_resource
        while r <= self.max_resource:
            self._first_rungs.append(r)
            r *= self.eta
        if not self._first_rungs:
            self._first_rungs = [self.min_resource]
        n = len(self._first_rungs)
        self._weights = [self.eta ** (n - 1 - s) for s in range(n)]
        self._cum = np.cumsum(self._weights)

    @property
    def n_brackets(self) -> int:
        return len(self._first_rungs)

    def bracket_of(self, trial_number: int) -> int:
        """Deterministic weighted round-robin bracket assignment."""
        slot = trial_number % int(self._cum[-1])
        return int(np.searchsorted(self._cum, slot, side="right"))

    def should_prune(self, study: "Study", record: FrozenTrial) -> bool:
        if not record.intermediate:
            return False
        step = max(record.intermediate)
        bracket = self.bracket_of(record.number)
        # cull only AT this bracket's geometric rungs (first_rung * eta^k)
        rung = self._first_rungs[bracket]
        while rung < step:
            rung *= self.eta
        if rung != step:
            return False
        peers = []
        for t in study.trials:
            if t.number == record.number or not t.intermediate:
                continue
            if self.bracket_of(t.number) != bracket:
                continue
            usable = {s: v for s, v in t.intermediate.items() if s <= step}
            if usable:
                peers.append(usable[max(usable)])
        if len(peers) < self.eta:
            return False
        value = record.intermediate[step]
        if study.direction == "maximize":
            return value < float(np.quantile(peers, 1.0 - 1.0 / self.eta))
        return value > float(np.quantile(peers, 1.0 / self.eta))


class NopPruner:
    def should_prune(self, study, record) -> bool:
        return False


class Study:
    def __init__(self, direction: str = "maximize", sampler: Optional[TPESampler] = None,
                 pruner=None, study_name: str = ""):
        self.direction = direction
        self.sampler = sampler or TPESampler()
        self.pruner = pruner or MedianPruner()
        self.study_name = study_name
        self.trials: list[FrozenTrial] = []
        self._param_specs: dict[str, _ParamSpec] = {}

    @property
    def best_trial(self) -> FrozenTrial:
        completed = [t for t in self.trials if t.state == TrialState.COMPLETE and t.value is not None]
        if not completed:
            raise ValueError("No completed trials.")
        key = (lambda t: t.value) if self.direction == "maximize" else (lambda t: -t.value)
        return max(completed, key=key)

    @property
    def best_value(self) -> float:
        return self.best_trial.value

    def ask(self) -> Trial:
        """Batch-mode API (tune_parallel): open a trial whose parameters are
        drawn from the CURRENT posterior. Running trials are invisible to
        the sampler (_observations filters on COMPLETE), so asking k trials
        before telling any yields k independent draws — standard batch TPE."""
        record = FrozenTrial(number=len(self.trials))
        self.trials.append(record)
        return Trial(self, record)

    def tell(self, trial: Trial, value: Optional[float] = None,
             state: str = TrialState.COMPLETE) -> None:
        record = trial._record
        record.value = float(value) if value is not None else None
        record.state = state

    def optimize(self, objective: Callable[[Trial], float], n_trials: int, catch: tuple = ()) -> None:
        for _ in range(n_trials):
            record = FrozenTrial(number=len(self.trials))
            self.trials.append(record)
            trial = Trial(self, record)
            try:
                value = objective(trial)
                record.value = float(value)
                record.state = TrialState.COMPLETE
            except TrialPruned:
                record.state = TrialState.PRUNED
            except catch as exc:  # noqa: B030 — caller opts in (reference tune.py:580)
                record.state = TrialState.FAIL
                logger.warning("Trial %d failed: %s", record.number, exc)


def create_study(direction: str = "maximize", sampler=None, pruner=None, study_name: str = "") -> Study:
    return Study(direction=direction, sampler=sampler, pruner=pruner, study_name=study_name)


def grid_search_cv(estimator_factory, param_grid: dict, X, y, cv: int = 5,
                   scoring: str = "f1_macro", seed: int = 42, n_jobs: int = -1):
    """GridSearchCV wrapper (the tree trainers' path) returning
    (best_estimator, best_params, best_score). Uses sklearn under the hood."""
    try:
        from sklearn.model_selection import GridSearchCV, StratifiedKFold
    except ImportError as exc:
        raise ImportError(
            "grid_search_cv (the decision_tree / random_forest tuning path) needs scikit-learn, "
            "which is not installed here; the port has no other implementation of it"
        ) from exc

    splitter = StratifiedKFold(n_splits=cv, shuffle=True, random_state=seed)
    gs = GridSearchCV(estimator_factory(), param_grid, cv=splitter, scoring=scoring,
                      n_jobs=n_jobs, refit=True, verbose=1)
    gs.fit(X, y)
    return gs.best_estimator_, gs.best_params_, float(gs.best_score_)
