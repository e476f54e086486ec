"""Registered tabular extractors: ``tabular_classical`` and
``tabular_polynomial``.

Same names, parameters, defaults and column order as the JAX package's
``features/tabular.py``, plus a ``device`` argument, without scikit-learn:
the fitted column transform (impute and scale the numeric columns, impute
and one-hot encode the categorical ones, degree-2 products of the numeric
block for ``tabular_polynomial``) is ``features/preprocess.py::ColumnStack``,
its statistics in float64 on the device. Datetime-like columns become
year / month / day / day-of-week / hour columns first.

Unlike the JAX package, a date column read as pandas' string dtype (the
default for text columns since pandas 3) is expanded too: the JAX package
tests ``dtype == object`` alone, so under pandas 3 it one-hot encodes such a
column as strings.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..utils.device import resolve_device
from .base import BaseFeatureExtractor, _collect
from .preprocess import ColumnStack, PolynomialFeatures
from .registry import register


def _expand_datetimes(df):
    """Replace datetime-like columns with year/month/day/dayofweek/hour."""
    import pandas as pd

    out = df.copy()
    for col in list(out.columns):
        s = out[col]
        if s.dtype == object or isinstance(s.dtype, pd.StringDtype):
            try:
                parsed = pd.to_datetime(s, errors="raise", format="mixed")
                if parsed.notna().mean() > 0.9:
                    out[col + "__year"] = parsed.dt.year
                    out[col + "__month"] = parsed.dt.month
                    out[col + "__day"] = parsed.dt.day
                    out[col + "__dow"] = parsed.dt.dayofweek
                    out[col + "__hour"] = parsed.dt.hour
                    out = out.drop(columns=[col])
            except Exception:
                pass
        elif str(s.dtype).startswith("datetime"):
            out[col + "__year"] = s.dt.year
            out[col + "__month"] = s.dt.month
            out[col + "__day"] = s.dt.day
            out[col + "__dow"] = s.dt.dayofweek
            out[col + "__hour"] = s.dt.hour
            out = out.drop(columns=[col])
    return out


@register
class TabularClassicalExtractor(BaseFeatureExtractor):
    """Impute+scale numerics, impute+OHE categoricals, datetime expansion.
    Stateful: fitted on the full dataset in extract_dataset; extract() valid
    post-fit only."""

    name = "tabular_classical"
    feature_type = "classical"
    modality = "tabular"

    _SCALERS = ("standard", "minmax", "robust", "none")

    def __init__(self, numerical_cols: Optional[list] = None,
                 categorical_cols: Optional[list] = None,
                 label_col: Optional[str] = None, scaler: str = "standard",
                 impute_numerical: str = "median",
                 impute_categorical: str = "most_frequent",
                 max_ohe_categories: Optional[int] = None,
                 max_onehot_cardinality: int = 50,
                 device: torch.device | str | None = None) -> None:
        # max_onehot_cardinality kept as an alias of max_ohe_categories
        if scaler not in self._SCALERS:
            raise ValueError(f"scaler must be one of {list(self._SCALERS)}, got {scaler!r}.")
        self.numerical_cols = list(numerical_cols) if numerical_cols else None
        self.categorical_cols = list(categorical_cols) if categorical_cols else None
        self.label_col = label_col
        self.scaler = scaler
        self.impute_numerical = impute_numerical
        self.impute_categorical = impute_categorical
        self.max_onehot_cardinality = (
            max_ohe_categories if max_ohe_categories is not None else max_onehot_cardinality
        )
        self.max_ohe_categories = self.max_onehot_cardinality
        self.device = resolve_device(device)
        self._transformer: Optional[ColumnStack] = None
        self._columns: Optional[list[str]] = None

    def _split_columns(self, df):
        from pandas.api.types import is_numeric_dtype

        if self.numerical_cols is not None:
            num_cols = [c for c in self.numerical_cols if c in df.columns]
        else:
            num_cols = [c for c in df.columns if is_numeric_dtype(df[c]) and c != self.label_col]
        if self.categorical_cols is not None:
            cat_cols = [c for c in self.categorical_cols if c in df.columns]
        else:
            cat_cols = [
                c for c in df.columns
                if c not in num_cols and c != self.label_col
                and df[c].nunique() <= self.max_onehot_cardinality
            ]
        return num_cols, cat_cols

    def _poly(self) -> Optional[PolynomialFeatures]:
        return None

    def _build_transformer(self, df):
        num_cols, cat_cols = self._split_columns(df)
        stack = ColumnStack(num_cols, cat_cols, self.impute_numerical, self.impute_categorical,
                            None if self.scaler == "none" else self.scaler, self._poly(), self.device)
        return stack, num_cols, cat_cols

    def _row_frame(self, kwargs):
        import pandas as pd

        row = {k: v for k, v in kwargs.items() if not k.startswith("_")}
        return _expand_datetimes(pd.DataFrame([row]))

    def extract(self, sample_path, **kwargs) -> np.ndarray:
        if self._transformer is None:
            raise RuntimeError(f"{self.name}: not fitted. Run extract_dataset() first.")
        df = self._row_frame(kwargs)
        for c in self._columns:
            if c not in df.columns:
                df[c] = np.nan
        return self._transformer.transform(df[self._columns]).to(torch.float32)[0].cpu().numpy()

    def extract_dataset(self, loader, max_samples=None):
        import pandas as pd

        rows, labels, metas = [], [], []
        label_to_idx: dict[str, int] = {}
        for i, (path, label, meta) in enumerate(loader):
            if max_samples is not None and i >= max_samples:
                break
            rows.append({k: v for k, v in meta.items() if not k.startswith("_")})
            metas.append(meta)
            if label is not None:
                if label not in label_to_idx:
                    label_to_idx[label] = len(label_to_idx)
                labels.append(label_to_idx[label])
        if not rows:
            raise RuntimeError("No features were successfully extracted.")
        df = _expand_datetimes(pd.DataFrame(rows))
        self._transformer, num_cols, cat_cols = self._build_transformer(df)
        self._columns = num_cols + cat_cols
        X = self._transformer.fit_transform(df[self._columns]).to(torch.float32).cpu().numpy()
        return _collect(list(X), labels, metas, label_to_idx, self.feature_type, self.modality)


@register
class TabularPolynomialExtractor(TabularClassicalExtractor):
    """Adds degree-2 PolynomialFeatures on the numeric block only."""

    name = "tabular_polynomial"
    feature_type = "deep"

    def __init__(self, degree: int = 2, interaction_only: bool = False,
                 include_bias: bool = False, **kwargs) -> None:
        # the shared column/impute/scaler/device knobs pass through to the base class
        super().__init__(**kwargs)
        self.degree = degree
        self.interaction_only = interaction_only
        self.include_bias = include_bias

    def _poly(self) -> Optional[PolynomialFeatures]:
        return PolynomialFeatures(degree=self.degree, interaction_only=self.interaction_only,
                                  include_bias=self.include_bias)
