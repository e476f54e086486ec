"""Port parity: the tabular extractors (``tabular_classical``,
``tabular_polynomial``) and the transforms under them
(``features/preprocess.py``) of audio_edge_ml_pipeline_torch against the JAX
package, which stacks scikit-learn's, on the same seeded rows (CPU).

Gate: every value within 1e-6 of its column's largest |value|, the same
columns in the same order. The JAX package's ``_expand_datetimes`` expands
a date column only when pandas reads it as ``object``; pandas 3 reads text
as its string dtype, so the date cases run the JAX side under
``pd.option_context("future.infer_string", False)`` (ROADMAP §3 l).
"""

import numpy as np
import pandas as pd
import pytest
import torch

import make_synth_dataset
from audio_edge_ml_pipeline_tpu import features as jfeatures
from audio_edge_ml_pipeline_tpu.data import loaders as jloaders
from audio_edge_ml_pipeline_torch import features as tfeatures
from audio_edge_ml_pipeline_torch.data import loaders as tloaders
from audio_edge_ml_pipeline_torch.features import preprocess, tabular

TOL = 1e-6


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def object_strings():
    """The JAX package's date expansion as intended: text read as object."""
    return pd.option_context("future.infer_string", False)


def rows_loader(frame: pd.DataFrame, label: str = "label"):
    """An in-memory tabular loader: (None, label, {col: value})."""
    out = []
    for row in frame.to_dict(orient="records"):
        lab = row.pop(label, None)
        out.append((None, None if lab is None else str(lab), row))
    return out


def seeded_frame(seed: int = 0, n: int = 60) -> pd.DataFrame:
    """Numeric columns with missing cells (an even count of observed values
    in one), a constant column, categorical columns with missing cells and
    a most-frequent tie on strings, and a label."""
    rng = np.random.default_rng(seed)
    df = pd.DataFrame({
        "x": rng.normal(3.0, 2.0, n),
        "count": rng.integers(0, 9, n).astype(float),
        "flat": np.full(n, 7.25),
        "big": rng.lognormal(10.0, 1.0, n),
        "color": rng.choice(["red", "green", "blue", "teal"], n),
        "size": rng.choice(["S", "M", "L"], n),
        "label": [f"c{i % 3}" for i in range(n)],
    })
    df.loc[rng.choice(n, 9, replace=False), "x"] = np.nan          # 51 observed: odd
    df.loc[rng.choice(n, 10, replace=False), "count"] = np.nan     # 50 observed: even, a median between two values
    df.loc[rng.choice(n, 7, replace=False), "color"] = np.nan
    # a tie on strings for most_frequent: "L" and "M" equally often, more than "S"
    df["size"] = (["L", "M"] * n)[:n]
    df.loc[[0, 1], "size"] = "S"
    return df


def compare(jfs, tfs) -> None:
    assert tfs.features.shape == jfs.features.shape and tfs.features.dtype == jfs.features.dtype
    assert list(tfs.labels) == list(jfs.labels) and tfs.label_names == jfs.label_names
    scale = np.abs(jfs.features).max(axis=0)
    gap = np.abs(tfs.features.astype(np.float64) - jfs.features) / np.where(scale > 0, scale, 1.0)
    assert gap.max() <= TOL, gap.max()
    assert (tfs.feature_type, tfs.modality) == (jfs.feature_type, jfs.modality)


def run_both(name: str, loader, kwargs: dict):
    jex = jfeatures.get(name)(**kwargs)
    jfs = jex.extract_dataset(loader)
    tex = tfeatures.get(name)(**kwargs, device="cpu")
    tfs = tex.extract_dataset(loader)
    compare(jfs, tfs)
    assert tex._columns == jex._columns
    return jex, tex


@pytest.mark.parametrize("name", ["tabular_classical", "tabular_polynomial"])
@pytest.mark.parametrize("scaler", ["standard", "minmax", "robust", "none"])
@pytest.mark.parametrize("impute_numerical", ["median", "mean", "most_frequent", "constant"])
def test_extractor_matches_jax(name, scaler, impute_numerical):
    loader = rows_loader(seeded_frame())
    run_both(name, loader, {"scaler": scaler, "impute_numerical": impute_numerical})


@pytest.mark.parametrize("impute_categorical", ["most_frequent", "constant"])
def test_categorical_imputation_and_the_string_tie(impute_categorical):
    jex, tex = run_both("tabular_classical", rows_loader(seeded_frame(1)), {"impute_categorical": impute_categorical})
    fill = tex._transformer.cat_imputer.statistics_
    if impute_categorical == "most_frequent":
        assert fill[1] == "L"  # "L" and "M" tie: the smaller wins, as in scikit-learn
    else:
        assert fill == ["missing_value", "missing_value"]


def test_even_count_median_is_the_average_of_the_two_middle_values():
    x = torch.tensor([[1.0, 5.0], [float("nan"), 2.0], [4.0, 9.0], [10.0, float("nan")], [2.0, float("nan")]],
                     dtype=torch.float64)
    np.testing.assert_array_equal(preprocess.column_median(x).numpy(), [3.0, 5.0])  # (2 + 4) / 2; odd 2 5 9
    assert float(torch.nanmedian(x[:, 0])) == 2.0  # torch takes the lower middle value
    jex, tex = run_both("tabular_classical", rows_loader(seeded_frame(2)), {"scaler": "none"})
    np.testing.assert_allclose(tex._transformer.num_imputer.statistics_.numpy(),
                               jex._transformer.named_transformers_["num"]["impute"].statistics_, rtol=0, atol=1e-12)


def test_all_missing_numeric_column_is_dropped_and_a_zero_variance_column_scaled_by_one():
    df = seeded_frame(3)
    df["empty"] = np.nan
    for scaler in ("standard", "minmax", "robust"):
        jex, tex = run_both("tabular_classical", rows_loader(df), {"scaler": scaler})
        assert "empty" in tex._columns and tex._transformer.num_imputer.keep_.tolist() == [True] * 4 + [False]
        assert float(tex._transformer.scaler.scale_[2]) == 1.0   # "flat", after "x" and "count"
    run_both("tabular_polynomial", rows_loader(df), {"degree": 3})


def test_an_unseen_category_at_extract_gives_zeros():
    df = seeded_frame(4)
    jex, tex = run_both("tabular_classical", rows_loader(df), {})
    row = {"x": 1.5, "count": np.nan, "flat": 7.25, "big": 30000.0, "color": "purple", "size": "M"}
    j, t = jex.extract(None, **row), tex.extract(None, **row)
    assert t.dtype == j.dtype == np.float32
    np.testing.assert_allclose(t, j, rtol=0, atol=TOL * max(1.0, float(np.abs(j).max())))
    n_num = 4
    assert not t[n_num : n_num + 4].any()   # the four colors: purple is none of them
    with pytest.raises(RuntimeError, match="not fitted"):
        tfeatures.get("tabular_classical")(device="cpu").extract(None, **row)


def test_datetime_column_is_expanded_where_jax_reads_object_strings(tmp_path):
    """make_tabular_csv's ``when``: the port expands it under pandas 3's
    string dtype; the JAX package does the same only with text read as
    object (ROADMAP §3 l)."""
    path = tmp_path / "tabular.csv"
    make_synth_dataset.make_tabular_csv(path)
    tl = tloaders.TabularLoader(path, label_col="label")
    tex = tfeatures.get("tabular_classical")(device="cpu")
    tfs = tex.extract_dataset(tl)
    assert [c for c in tex._columns if c.startswith("when")] == [
        "when__year", "when__month", "when__day", "when__dow", "when__hour"]
    with object_strings():
        jl = jloaders.TabularLoader(path, label_col="label")
        jex = jfeatures.get("tabular_classical")()
        jfs = jex.extract_dataset(jl)
    compare(jfs, tfs)
    assert tex._columns == jex._columns
    # without the option the JAX package one-hot encodes the date strings
    jex3 = jfeatures.get("tabular_classical")()
    jex3.extract_dataset(jloaders.TabularLoader(path, label_col="label"))
    assert "when" in jex3._columns and "when__year" not in jex3._columns
    # the port reads object strings the same way
    with object_strings():
        tex_obj = tfeatures.get("tabular_classical")(device="cpu")
        np.testing.assert_array_equal(tex_obj.extract_dataset(tloaders.TabularLoader(path, label_col="label")).features,
                                      tfs.features)
    row = {"f1": 1.0, "f2": -0.5, "category": "green", "when": "2026-02-14 01:00:00"}
    with object_strings():
        j = jex.extract(None, **row)
    np.testing.assert_allclose(tex.extract(None, **row), j, rtol=0, atol=TOL * float(np.abs(j).max()))


@pytest.mark.parametrize("degree,interaction_only,include_bias", [
    (2, False, False), (3, False, False), (2, True, False), (3, True, True), (2, False, True), (1, False, True),
])
def test_polynomial_knobs(degree, interaction_only, include_bias):
    kw = {"degree": degree, "interaction_only": interaction_only, "include_bias": include_bias}
    run_both("tabular_polynomial", rows_loader(seeded_frame(5)), kw)
    from sklearn.preprocessing import PolynomialFeatures as SkPolynomialFeatures

    sk = SkPolynomialFeatures(**kw).fit(np.zeros((1, 4)))
    assert preprocess.PolynomialFeatures(**kw).combinations(4) == [
        tuple(int(i) for i in np.repeat(np.arange(4), p)) for p in sk.powers_]


@pytest.mark.parametrize("cols", [{"numerical_cols": ["x", "big"]}, {"categorical_cols": ["size"]},
                                  {"numerical_cols": ["x"], "categorical_cols": []},
                                  {"max_onehot_cardinality": 3}, {"max_ohe_categories": 2}])
def test_column_knobs_and_an_empty_block(cols):
    run_both("tabular_classical", rows_loader(seeded_frame(6)), cols)
    run_both("tabular_polynomial", rows_loader(seeded_frame(6)), cols)


def test_scalers_match_scikit_learn_on_hard_columns():
    from sklearn.preprocessing import MinMaxScaler, RobustScaler, StandardScaler

    rng = np.random.default_rng(9)
    x = np.stack([rng.normal(1e6, 1e-3, 200), np.full(200, 3.0), rng.integers(0, 4, 200).astype(float),
                  rng.standard_cauchy(200), np.r_[np.zeros(199), 1.0]], axis=1)
    for sk_cls, port_cls in ((StandardScaler, preprocess.StandardScaler), (MinMaxScaler, preprocess.MinMaxScaler),
                             (RobustScaler, preprocess.RobustScaler)):
        want = sk_cls().fit_transform(x)
        t = torch.from_numpy(x)
        got = port_cls().fit(t).transform(t).numpy()
        # the first column's mean cancels 1e6 against a spread of 1e-3: sums in another order move it by ~1e-7
        assert (np.abs(got - want) <= TOL * np.abs(want).max(axis=0)).all(), sk_cls.__name__
        assert got[:, 1].tolist() == want[:, 1].tolist()   # the constant column, scaled by 1


def test_tabular_extractors_without_a_card_raise_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name, cls in (("tabular_classical", tabular.TabularClassicalExtractor),
                      ("tabular_polynomial", tabular.TabularPolynomialExtractor)):
        assert tfeatures.get(name) is cls
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cls()
        assert cls(device="cpu").device.type == "cpu"
    with pytest.raises(ValueError, match="scaler must be one of"):
        tabular.TabularClassicalExtractor(scaler="log", device="cpu")
