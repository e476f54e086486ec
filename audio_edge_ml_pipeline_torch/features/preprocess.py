"""The tabular transforms of scikit-learn (1.9) that the tabular extractors
stack, without scikit-learn: numeric statistics and transforms in float64 on
the device, string categories on the host.

- ``SimpleImputer`` (numeric block, a float64 tensor with NaN for missing):
  ``mean``, ``median`` (the average of the two middle values, as
  ``np.ma.median``: ``torch.median`` would take the lower one),
  ``most_frequent`` (the smallest value among ties) and ``constant`` (0); a
  column with no observed value is dropped (scikit-learn's
  ``keep_empty_features=False``).
- ``CategoricalImputer`` (categorical block, an object array on the host,
  NaN for missing): ``most_frequent`` (the smallest value among ties, by
  Python's ordering) and ``constant`` (``"missing_value"``); an empty column
  is dropped likewise.
- ``StandardScaler`` (population variance by the corrected two-pass sum, a
  column constant up to roundoff scaled by 1), ``MinMaxScaler`` to [0, 1]
  and ``RobustScaler`` (median, 25th to 75th percentile by linear
  interpolation); a zero scale is mapped to 1 as ``_handle_zeros_in_scale``
  does.
- ``OneHotEncoder(handle_unknown="ignore")``: each column's categories
  sorted; a value unseen in the fit gives a row of zeros. Values are coded
  on the host, the one-hot rows scattered on the device.
- ``PolynomialFeatures``: scikit-learn's column order for ``degree``,
  ``interaction_only`` and ``include_bias``.
- ``ColumnStack``: the extractors' ``ColumnTransformer``, the numeric block
  (impute, scale, polynomial) first, then the categorical block (impute,
  one-hot); a block without columns contributes nothing.
"""

from __future__ import annotations

from collections import Counter
from itertools import chain, combinations, combinations_with_replacement
from typing import Optional

import numpy as np
import torch

_EPS = float(np.finfo(np.float64).eps)


def _missing(values: np.ndarray) -> np.ndarray:
    """scikit-learn's missing values of object data: NaN (``x != x``)."""
    return np.asarray(values != values, dtype=bool)


def _smallest_most_common(values) -> object:
    """The most frequent value, the smallest among ties."""
    counter = Counter(values)
    top = max(counter.values())
    return min(v for v, c in counter.items() if c == top)


def _sorted_columns(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Each column sorted ascending with its missing values (NaN) last, and
    the count of observed values a column."""
    observed = ~torch.isnan(x)
    filled = torch.where(observed, x, torch.full_like(x, float("inf")))
    return torch.sort(filled, dim=0).values, observed.sum(dim=0)


def _take(sorted_x: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``sorted_x[index[j], j]`` for each column j (indices clamped to the
    rows)."""
    index = index.clamp(0, max(sorted_x.shape[0] - 1, 0)).to(torch.int64)
    return sorted_x.gather(0, index[None, :])[0]


def column_median(x: torch.Tensor) -> torch.Tensor:
    """The median of each column's observed values: the average of the two
    middle ones when their count is even; NaN for a column with none."""
    s, n = _sorted_columns(x)
    high = n // 2
    low = torch.where(n % 2 == 1, high, high - 1)
    med = (_take(s, low) + _take(s, high)) / 2
    return torch.where(n > 0, med, torch.full_like(med, float("nan")))


def column_percentile(x: torch.Tensor, q: float) -> torch.Tensor:
    """numpy's ``percentile(..., method="linear")`` of each column (no
    missing values)."""
    s = torch.sort(x, dim=0).values
    virtual = (x.shape[0] - 1) * (q / 100.0)
    lo = int(np.floor(virtual))
    gamma = virtual - lo
    a, b = s[lo], s[min(lo + 1, x.shape[0] - 1)]
    diff = b - a
    # numpy's _lerp: from the nearer end
    return b - diff * (1 - gamma) if gamma >= 0.5 else a + diff * gamma


class SimpleImputer:
    """Missing values (NaN) of a float64 tensor filled with a statistic a
    column; columns with no observed value dropped."""

    STRATEGIES = ("mean", "median", "most_frequent", "constant")

    def __init__(self, strategy: str = "mean") -> None:
        if strategy not in self.STRATEGIES:
            raise ValueError(f"strategy must be one of {list(self.STRATEGIES)}, got {strategy!r}")
        self.strategy = strategy
        self.statistics_: Optional[torch.Tensor] = None
        self.keep_: Optional[torch.Tensor] = None

    def fit(self, x: torch.Tensor) -> "SimpleImputer":
        observed = ~torch.isnan(x)
        n = observed.sum(dim=0)
        if self.strategy == "mean":
            stats = torch.where(observed, x, 0.0).sum(dim=0) / n
        elif self.strategy == "median":
            stats = column_median(x)
        elif self.strategy == "most_frequent":
            stats = torch.zeros(x.shape[1], dtype=x.dtype, device=x.device)
            for j in range(x.shape[1]):
                col = x[observed[:, j], j]
                if len(col):
                    values, counts = torch.unique(col, return_counts=True)  # sorted: argmax takes the smallest
                    stats[j] = values[torch.argmax(counts)]
        else:
            stats = torch.zeros(x.shape[1], dtype=x.dtype, device=x.device)
        self.keep_ = n > 0
        self.statistics_ = stats[self.keep_]
        return self

    def transform(self, x: torch.Tensor) -> torch.Tensor:
        x = x[:, self.keep_]
        return torch.where(torch.isnan(x), self.statistics_, x)

    def fit_transform(self, x: torch.Tensor) -> torch.Tensor:
        return self.fit(x).transform(x)


class CategoricalImputer:
    """Missing values (NaN) of an object array filled on the host with the
    most frequent value or ``"missing_value"``; columns with no observed
    value dropped."""

    STRATEGIES = ("most_frequent", "constant")

    def __init__(self, strategy: str = "most_frequent") -> None:
        if strategy not in self.STRATEGIES:
            raise ValueError(f"Cannot use {strategy} strategy with non-numeric data")
        self.strategy = strategy
        self.statistics_: Optional[list] = None
        self.keep_: Optional[np.ndarray] = None

    def fit(self, values: np.ndarray) -> "CategoricalImputer":
        missing = _missing(values)
        self.keep_ = ~missing.all(axis=0)
        self.statistics_ = []
        for j in np.flatnonzero(self.keep_):
            observed = values[~missing[:, j], j]
            self.statistics_.append(_smallest_most_common(observed) if self.strategy == "most_frequent"
                                    else "missing_value")
        return self

    def transform(self, values: np.ndarray) -> np.ndarray:
        out = values[:, self.keep_].copy()
        missing = _missing(out)
        for j, fill in enumerate(self.statistics_):
            out[missing[:, j], j] = fill
        return out

    def fit_transform(self, values: np.ndarray) -> np.ndarray:
        return self.fit(values).transform(values)


def _handle_zeros(scale: torch.Tensor, constant: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Scales that are (near) zero set to 1: those ``constant`` marks, else
    those under 10 eps."""
    if constant is None:
        constant = scale < 10 * _EPS
    return torch.where(constant, torch.ones_like(scale), scale)


class StandardScaler:
    """(x - mean) / std with the population variance."""

    def fit(self, x: torch.Tensor) -> "StandardScaler":
        n = x.shape[0]
        total = x.sum(dim=0)
        self.mean_ = total / n
        temp = x - total / n
        correction = temp.sum(dim=0)
        self.var_ = ((temp * temp).sum(dim=0) - correction**2 / n) / n
        constant = self.var_ <= n * _EPS * self.var_ + (n * self.mean_ * _EPS) ** 2
        self.scale_ = _handle_zeros(torch.sqrt(self.var_), constant)
        return self

    def transform(self, x: torch.Tensor) -> torch.Tensor:
        return (x - self.mean_) / self.scale_


class MinMaxScaler:
    """Each column mapped onto [0, 1] by its fitted minimum and maximum."""

    def fit(self, x: torch.Tensor) -> "MinMaxScaler":
        data_min = x.min(dim=0).values
        self.scale_ = 1.0 / _handle_zeros(x.max(dim=0).values - data_min)
        self.min_ = 0.0 - data_min * self.scale_
        return self

    def transform(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.scale_ + self.min_


class RobustScaler:
    """(x - median) / (75th - 25th percentile)."""

    def fit(self, x: torch.Tensor) -> "RobustScaler":
        self.center_ = column_median(x)
        self.scale_ = _handle_zeros(column_percentile(x, 75.0) - column_percentile(x, 25.0))
        return self

    def transform(self, x: torch.Tensor) -> torch.Tensor:
        return (x - self.center_) / self.scale_


SCALERS = {"standard": StandardScaler, "minmax": MinMaxScaler, "robust": RobustScaler}


class OneHotEncoder:
    """One column a fitted category (sorted per input column); values
    unseen in the fit give zeros (``handle_unknown="ignore"``)."""

    def __init__(self, device: torch.device) -> None:
        self.device = device
        self.categories_: Optional[list[list]] = None

    def fit(self, values: np.ndarray) -> "OneHotEncoder":
        self.categories_ = [sorted(set(values[:, j])) for j in range(values.shape[1])]
        return self

    def transform(self, values: np.ndarray) -> torch.Tensor:
        codes = np.full(values.shape, -1, np.int64)
        offset = 0
        for j, cats in enumerate(self.categories_):
            index = {c: offset + k for k, c in enumerate(cats)}
            codes[:, j] = [index.get(v, -1) for v in values[:, j]]
            offset += len(cats)
        codes_d = torch.from_numpy(codes).to(self.device)
        rows = torch.arange(len(codes), device=self.device)[:, None].expand_as(codes_d)
        seen = codes_d >= 0
        out = torch.zeros((len(codes), offset), dtype=torch.float64, device=self.device)
        out[rows[seen], codes_d[seen]] = 1.0
        return out

    def fit_transform(self, values: np.ndarray) -> torch.Tensor:
        return self.fit(values).transform(values)


class PolynomialFeatures:
    """Products of the columns up to ``degree``, in scikit-learn's order:
    the bias column, then each degree's combinations (with replacement
    unless ``interaction_only``) in itertools order."""

    def __init__(self, degree: int = 2, interaction_only: bool = False, include_bias: bool = True) -> None:
        self.degree = degree
        self.interaction_only = interaction_only
        self.include_bias = include_bias

    def combinations(self, n_features: int) -> list[tuple[int, ...]]:
        comb = combinations if self.interaction_only else combinations_with_replacement
        terms = chain.from_iterable(comb(range(n_features), d) for d in range(1, self.degree + 1))
        return ([()] if self.include_bias else []) + list(terms)

    def transform(self, x: torch.Tensor) -> torch.Tensor:
        blocks = []
        by_degree: dict[int, list[tuple[int, ...]]] = {}
        for term in self.combinations(x.shape[1]):
            by_degree.setdefault(len(term), []).append(term)
        for d, terms in by_degree.items():  # degrees ascend, as the terms do
            if d == 0:
                blocks.append(torch.ones((x.shape[0], 1), dtype=x.dtype, device=x.device))
            else:
                index = torch.tensor(terms, dtype=torch.int64, device=x.device)
                blocks.append(x[:, index].prod(dim=-1))
        return torch.cat(blocks, dim=1) if blocks else x[:, :0]


class ColumnStack:
    """The tabular extractors' column transformer: numeric columns imputed,
    scaled (``scaler`` a key of SCALERS, or None) and optionally expanded by
    ``poly``; categorical columns imputed and one-hot encoded; the numeric
    block first. ``fit_transform`` / ``transform`` take a DataFrame holding
    both column lists and return float64 rows on ``device``."""

    def __init__(self, num_cols: list[str], cat_cols: list[str], impute_numerical: str,
                 impute_categorical: str, scaler: Optional[str], poly: Optional[PolynomialFeatures],
                 device: torch.device) -> None:
        self.num_cols = list(num_cols)
        self.cat_cols = list(cat_cols)
        self.device = device
        self.num_imputer = SimpleImputer(impute_numerical)
        self.scaler = SCALERS[scaler]() if scaler else None
        self.poly = poly
        self.cat_imputer = CategoricalImputer(impute_categorical)
        self.encoder = OneHotEncoder(device)

    def _numeric(self, df) -> torch.Tensor:
        x = df[self.num_cols].to_numpy(dtype=np.float64, na_value=np.nan)
        return torch.tensor(x, dtype=torch.float64, device=self.device)  # a copy: pandas may hand out a read-only view

    def _blocks(self, df, fit: bool) -> torch.Tensor:
        blocks = []
        if self.num_cols:
            x = self._numeric(df)
            x = self.num_imputer.fit_transform(x) if fit else self.num_imputer.transform(x)
            if self.scaler is not None:
                if fit:
                    self.scaler.fit(x)
                x = self.scaler.transform(x)
            if self.poly is not None:
                x = self.poly.transform(x)
            blocks.append(x)
        if self.cat_cols:
            values = df[self.cat_cols].to_numpy(dtype=object)
            values = self.cat_imputer.fit_transform(values) if fit else self.cat_imputer.transform(values)
            blocks.append(self.encoder.fit_transform(values) if fit else self.encoder.transform(values))
        if not blocks:
            return torch.zeros((len(df), 0), dtype=torch.float64, device=self.device)
        return torch.cat(blocks, dim=1)

    def fit_transform(self, df) -> torch.Tensor:
        return self._blocks(df, fit=True)

    def transform(self, df) -> torch.Tensor:
        return self._blocks(df, fit=False)
