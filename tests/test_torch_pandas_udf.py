"""The pandas UDF family of the PyTorch port, on the CPU, against the JAX
package and pandas.

``mapInPandas``, ``groupBy().applyInPandas``, grouped-aggregate pandas UDFs
(keyed, keyless, and keyless over no rows: one row, as Spark), window
pandas UDFs over the frames of ``tests/test_window_in_pandas.py`` (the
whole partition, the running range frame with ties and null peers, rows
frames including an empty one at the partition start, no partition; the
input row order kept), and ``cogroup().applyInPandas`` (null keys pair
with null keys).  The same seeded inputs go through both packages; keys,
counts and row order must be equal exactly, doubles within a relative
1e-12 of the JAX package's and of pandas' own computation.  The refused
forms (a mixed pandas and built-in aggregate, mixed null orders, a
bounded range frame, a range frame without an order) raise as in the JAX
package.
"""

import numpy as np
import pandas as pd
import pytest

from spark_rapids_tpu.api import functions as JF
from spark_rapids_tpu.api.session import TpuSession as JaxSession
from spark_rapids_tpu_torch.api import functions as TF
from spark_rapids_tpu_torch.api.session import TpuSession

RTOL = 1e-12


def smean(s: pd.Series) -> float:
    return float(s.mean()) if len(s) else float("nan")


def p90(s: pd.Series) -> float:
    return float(s.quantile(0.9))


def total(s: pd.Series) -> float:
    return float(s.sum())


def _frame(n=60, seed=4):
    rng = np.random.default_rng(seed)
    return pd.DataFrame({"k": rng.integers(0, 5, n),
                         "o": rng.integers(0, 20, n),
                         "v": rng.normal(size=n).round(4)})


@pytest.fixture(scope="module")
def sessions():
    return TpuSession({}, device="cpu"), JaxSession()


def _run(sessions, data, build):
    out = []
    for F, s in zip((TF, JF), sessions):
        out.append(build(F, s.create_dataframe(data)).to_pandas())
    return out


def _close(got, want, cols):
    pd.testing.assert_frame_equal(
        got[cols].reset_index(drop=True), want[cols].reset_index(drop=True),
        check_dtype=False, rtol=RTOL)


def doubler(it):
    for pdf in it:
        pdf = pdf.copy()
        pdf["v"] = pdf["v"] * 2
        pdf["n"] = len(pdf)
        yield pdf[["k", "v", "n"]]


def test_map_in_pandas(sessions):
    data = _frame()
    got, want = _run(sessions, data, lambda F, df: df.mapInPandas(
        doubler, "k bigint, v double, n bigint"))
    _close(got, want, ["k", "v", "n"])
    np.testing.assert_array_equal(got["v"], data["v"] * 2)


def center(g):
    g = g.copy()
    g["v"] = g["v"] - g["v"].mean()
    return g[["k", "v"]]


def test_apply_in_pandas(sessions):
    data = _frame()

    def build(F, df):
        return df.groupBy("k").applyInPandas(center, "k bigint, v double")
    got, want = _run(sessions, data, build)
    key = ["k", "v"]
    _close(got.sort_values(key), want.sort_values(key), key)
    ref = data.assign(v=data["v"] - data.groupby("k")["v"].transform(
        "mean"))[key].sort_values(key)
    _close(got.sort_values(key), ref, key)


@pytest.mark.parametrize("keyed", [True, False])
def test_grouped_agg(sessions, keyed):
    data = _frame(200, seed=5)

    def build(F, df):
        q = F.pandas_agg_udf(p90, "double")
        t = F.pandas_agg_udf(total, "double")
        g = df.groupBy("k") if keyed else df
        return g.agg(q("v").alias("q"), t("v").alias("t"))
    got, want = _run(sessions, data, build)
    cols = ["k", "q", "t"] if keyed else ["q", "t"]
    if keyed:
        got, want = got.sort_values("k"), want.sort_values("k")
    _close(got, want, cols)
    if keyed:
        ref = data.groupby("k")["v"].quantile(0.9).to_numpy()
        np.testing.assert_allclose(got["q"], ref, rtol=RTOL)
    else:
        assert got["t"][0] == pytest.approx(data["v"].sum(), rel=RTOL)


def test_grouped_agg_keyless_over_no_rows(sessions):
    def build(F, df):
        t = F.pandas_agg_udf(total, "double")
        return df.filter(F.col("v") > 100).agg(t("v").alias("t"))
    got, want = _run(sessions, _frame(), build)
    assert len(got) == 1 == len(want)
    assert got["t"][0] == 0.0 == want["t"][0]


def test_grouped_agg_mixing_rejected(sessions):
    s = sessions[0]
    df = s.create_dataframe(_frame(10))
    with pytest.raises(ValueError, match="cannot mix"):
        df.groupBy("k").agg(TF.pandas_agg_udf(total, "double")("v"),
                            TF.sum("v"))


def _sliding(data):
    w = data.sort_values(["o", "v"], kind="stable")
    w["m"] = w.groupby("k")["v"].transform(
        lambda s: s.rolling(3, min_periods=1).mean())
    return w


# frame name -> (window over F, the input, pandas' answer or None)
FRAMES = {
    "whole_partition": (
        lambda F: F.Window.partitionBy("k"), _frame(),
        lambda d: d.assign(m=d.groupby("k")["v"].transform("mean"))),
    "running_with_ties": (
        lambda F: F.Window.partitionBy("k").orderBy("o"),
        pd.DataFrame({"k": [1, 1, 1, 1, 2, 2], "o": [10, 20, 20, 30, 5, 5],
                      "v": [1.0, 2.0, 3.0, 4.0, 10.0, 20.0]}),
        lambda d: d.assign(m=[1.0, 2.0, 2.0, 2.5, 15.0, 15.0])),
    "sliding_rows": (
        lambda F: F.Window.partitionBy("k").orderBy("o", "v")
        .rowsBetween(-2, 0), _frame(40, seed=9), _sliding),
    "centered_rows": (
        lambda F: F.Window.partitionBy("k").orderBy("o", "v")
        .rowsBetween(-2, 2), _frame(40, seed=3), None),
    "unpartitioned": (
        lambda F: F.Window.partitionBy(), _frame(20, seed=2),
        lambda d: d.assign(m=d["v"].mean())),
    "empty_at_start": (
        lambda F: F.Window.partitionBy("k").orderBy("o").rowsBetween(-3, -2),
        pd.DataFrame({"k": [1] * 5, "o": range(5),
                      "v": [1.0, 2.0, 3.0, 4.0, 5.0]}),
        lambda d: d.assign(m=[np.nan, np.nan, 1.0, 1.5, 2.5])),
    "null_order_peers": (
        lambda F: F.Window.partitionBy("k").orderBy("o"),
        pd.DataFrame({"k": [1] * 4, "o": [1.0, None, None, 2.0],
                      "v": [1.0, 2.0, 3.0, 4.0]}),
        lambda d: d.assign(m=[2.0, 2.5, 2.5, 2.5])),
    "row_order_kept": (
        lambda F: F.Window.partitionBy("k"),
        pd.DataFrame({"k": [2, 1, 2, 1], "o": [4, 3, 2, 1],
                      "v": [1.0, 2.0, 3.0, 4.0]}),
        lambda d: d.assign(m=[2.0, 3.0, 2.0, 3.0])),
}


@pytest.mark.parametrize("frame", list(FRAMES))
def test_window_pandas_udf(sessions, frame):
    window, data, oracle = FRAMES[frame]

    def build(F, df):
        m = F.pandas_agg_udf(smean, "double")
        return df.withColumn("m", m("v").over(window(F)))
    got, want = _run(sessions, data, build)
    assert list(got.columns) == ["k", "o", "v", "m"]
    # the input row order is kept
    np.testing.assert_array_equal(got["o"], data["o"])
    _close(got, want, ["k", "o", "v", "m"])
    if oracle is not None:
        ref = oracle(data.copy()).sort_index()
        np.testing.assert_allclose(got["m"], ref["m"], rtol=RTOL)


def test_window_pandas_udf_in_select(sessions):
    data = _frame(15)

    def build(F, df):
        m = F.pandas_agg_udf(smean, "double")
        return df.select("k", m("v").over(F.Window.partitionBy("k"))
                         .alias("m"), (F.col("v") * 2).alias("v2"))
    got, want = _run(sessions, data, build)
    assert list(got.columns) == ["k", "m", "v2"]
    _close(got, want, ["k", "m", "v2"])
    tree = sessions[0].create_dataframe(data).select(
        "k", TF.pandas_agg_udf(smean, "double")("v").over(
            TF.Window.partitionBy("k")).alias("m"))
    assert "TpuWindowInPandasExec" in \
        tree.session.plan(tree.plan).tree_string()


def test_window_pandas_udf_refusals(sessions):
    df = sessions[0].create_dataframe(_frame(10))
    m = TF.pandas_agg_udf(smean, "double")
    W = TF.Window
    with pytest.raises(ValueError, match="nulls"):
        df.withColumn("m", m("v").over(W.partitionBy("k").orderBy(
            TF.col("o").asc_nulls_first(), TF.col("v").asc_nulls_last())))
    with pytest.raises(ValueError, match="range"):
        df.withColumn("m", m("v").over(
            W.partitionBy("k").rangeBetween(-5, 5)))
    with pytest.raises(ValueError, match="orderBy"):
        df.withColumn("m", m("v").over(
            W.partitionBy("k").rangeBetween(None, 0)))


def pair(lg, rg):
    key = lg["k"].iloc[0] if len(lg) else rg["k2"].iloc[0]
    return pd.DataFrame({"k": [key], "nl": [len(lg)], "nr": [len(rg)],
                         "sx": [float(lg["x"].sum())],
                         "sy": [float(rg["y"].sum())]})


def pair_nulls(lg, rg):
    return pd.DataFrame({"nl": [len(lg)], "nr": [len(rg)]})


def test_cogroup(sessions):
    rng = np.random.default_rng(8)
    left = {"k": rng.integers(0, 6, 40), "x": rng.normal(size=40)}
    right = {"k2": rng.integers(3, 9, 30), "y": rng.normal(size=30)}
    out = []
    for F, s in zip((TF, JF), sessions):
        lg = s.create_dataframe(left).groupBy("k")
        rg = s.create_dataframe(right).groupBy("k2")
        out.append(lg.cogroup(rg).applyInPandas(
            pair, "k bigint, nl bigint, nr bigint, sx double, sy double")
            .to_pandas().sort_values("k").reset_index(drop=True))
    got, want = out
    _close(got, want, ["k", "nl", "nr", "sx", "sy"])
    keys = sorted(set(left["k"]) | set(right["k2"]))
    assert got["k"].tolist() == keys
    assert got["nl"].tolist() == [int((left["k"] == k).sum()) for k in keys]


def test_cogroup_null_keys_pair(sessions):
    out = []
    for F, s in zip((TF, JF), sessions):
        lg = s.create_dataframe({"k": [1, None], "x": [1.0, 2.0]})
        rg = s.create_dataframe({"k2": [None], "y": [9.0]})
        out.append(lg.groupBy("k").cogroup(rg.groupBy("k2")).applyInPandas(
            pair_nulls, "nl bigint, nr bigint").to_pandas())
    got, want = out
    assert sorted(zip(got["nl"], got["nr"])) == [(1, 0), (1, 1)] == \
        sorted(zip(want["nl"], want["nr"]))
