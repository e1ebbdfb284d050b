"""The PyTorch port's TPC-H slice against the JAX package's, on the CPU.

``gen_tables`` must give the JAX package's frames; q3 and q6 run through
both engines on those frames, with the hash path on and off; string
columns survive filters (``compact``) and joins (the gather); a
string-literal filter matches.  Tolerances: keys, counts, dates and
strings exactly; float sums to a relative 1e-12 (the port adds in another
order).
"""

import numpy as np
import pandas as pd
import pytest
import torch

from spark_rapids_tpu.api import functions as JF
from spark_rapids_tpu.api.session import TpuSession as JaxSession
from spark_rapids_tpu.models import tpch as jax_tpch
from spark_rapids_tpu_torch.api import functions as TF
from spark_rapids_tpu_torch.api.session import TpuSession
from spark_rapids_tpu_torch.interop import batch_from_arrays
from spark_rapids_tpu_torch.models import tpch

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers on one host: keep this module's
    torch ops on one thread so they do not crowd the other workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


SF = 0.002
RTOL = 1e-12
CONFS = {
    "default": {},
    "hash": {"spark.rapids.tpu.pallas.hash.enabled": True,
             "spark.rapids.tpu.pallas.hash.tableSlots": 1 << 14},
    "small_batches_unfused": {"spark.rapids.sql.tpu.maxBatchRows": 2000,
                              "spark.rapids.tpu.fusion.enabled": False},
}


@pytest.fixture(scope="module")
def tables():
    return jax_tpch.gen_tables(sf=SF)


def _jax(conf, query, tables):
    s = JaxSession(conf)
    try:
        return query(jax_tpch.load(s, tables)).to_pandas()
    finally:
        s.stop()


def _port(conf, query, tables):
    return query(tpch.load(TpuSession(conf, device="cpu"),
                           tables)).to_pandas()


def _close(got, want, floats=()):
    """Frames equal in order; ``floats`` columns to rtol."""
    assert list(got.columns) == list(want.columns)
    assert len(got) == len(want)
    for c in got.columns:
        if c in floats:
            np.testing.assert_allclose(got[c].to_numpy(), want[c].to_numpy(),
                                       rtol=RTOL, atol=0)
        else:
            pd.testing.assert_series_equal(got[c], want[c])


def test_gen_tables_equals_jax():
    want = jax_tpch.gen_tables(sf=SF)
    got = tpch.gen_tables(sf=SF)
    assert list(got) == list(want)
    for name in want:
        pd.testing.assert_frame_equal(got[name], want[name])


@pytest.mark.parametrize("sf", [SF, 0.01])
def test_gen_q3_columns_equal_gen_tables(sf, tables):
    full = tables if sf == SF else jax_tpch.gen_tables(sf=sf)
    cols = tpch.gen_q3_columns(sf)
    for table, columns in cols.items():
        for name, (type_name, values, validity) in columns.items():
            assert validity is None
            want = full[table][name]
            if type_name == "string":
                offsets, chars = values
                got = [bytes(chars[offsets[i]:offsets[i + 1]]).decode()
                       for i in range(len(offsets) - 1)]
                assert got == list(want)
            elif type_name == "date":
                np.testing.assert_array_equal(
                    values, want.to_numpy().astype("datetime64[D]")
                    .astype(np.int64))
            else:
                np.testing.assert_array_equal(values, want.to_numpy())


@pytest.mark.parametrize("conf", list(CONFS))
def test_q3_matches_jax(conf, tables):
    got = _port(CONFS[conf], tpch.q3, tables)
    want = _jax(CONFS[conf], jax_tpch.q3, tables)
    assert len(got) == 10
    _close(got, want, floats=["revenue"])


@pytest.mark.parametrize("conf", list(CONFS))
def test_q6_matches_jax(conf, tables):
    got = _port(CONFS[conf], tpch.q6, tables)
    want = _jax(CONFS[conf], jax_tpch.q6, tables)
    _close(got, want, floats=["revenue"])


def test_q3_over_date_columns_matches_pandas():
    """q3 over ``gen_q3_columns`` (DATE32 columns and a string column
    from raw buffers, as the chip check loads them) equals a pandas
    oracle on the same arrays: order exact, revenue to rtol."""
    cols = tpch.gen_q3_columns(0.01)
    s = TpuSession({"spark.rapids.tpu.pallas.hash.enabled": True,
                    "spark.rapids.tpu.pallas.hash.tableSlots": 1 << 14},
                   device="cpu")
    t = {name: s.create_dataframe(batch_from_arrays(c, device="cpu"))
         for name, c in cols.items()}
    got = tpch.q3(t).to_pandas()
    host = {name: {k: v for k, (_, v, _) in c.items()}
            for name, c in cols.items()}
    offsets, chars = host["customer"]["c_mktsegment"]
    seg = np.array([bytes(chars[offsets[i]:offsets[i + 1]]).decode()
                    for i in range(len(offsets) - 1)])
    cutoff = (np.datetime64("1995-03-15") - np.datetime64("1970-01-01")) \
        .astype(np.int64)
    c = pd.DataFrame({"o_custkey": host["customer"]["c_custkey"][
        seg == "BUILDING"]})
    o = pd.DataFrame({k: host["orders"][k] for k in host["orders"]})
    o = o[o.o_orderdate < cutoff].rename(columns={"o_orderkey":
                                                  "l_orderkey"})
    li = pd.DataFrame({k: host["lineitem"][k] for k in host["lineitem"]})
    li = li[li.l_shipdate > cutoff]
    j = c.merge(o, on="o_custkey").merge(li, on="l_orderkey")
    j["rev"] = j.l_extendedprice * (1 - j.l_discount)
    want = (j.groupby(["l_orderkey", "o_orderdate", "o_shippriority"],
                      as_index=False)["rev"].sum()
            .sort_values(["rev", "o_orderdate"], ascending=[False, True],
                         kind="stable").head(10))
    assert got["l_orderkey"].tolist() == want["l_orderkey"].tolist()
    assert [d.toordinal() - 719163 for d in got["o_orderdate"]] == \
        want["o_orderdate"].tolist()
    np.testing.assert_allclose(got["revenue"], want["rev"], rtol=RTOL)


# ---------------------------------------------------------------- strings --

def test_string_literal_filter_keeps_every_column(tables):
    """c_mktsegment = 'BUILDING' and != 'BUILDING' over the whole customer
    table: the filter compacts every string column."""
    def q(t, F, eq):
        c = t["customer"]
        cond = (F.col("c_mktsegment") == F.lit("BUILDING")) if eq else \
            (F.col("c_mktsegment") != "BUILDING")
        return c.filter(cond)
    for eq in (True, False):
        got = _port({}, lambda t: q(t, TF, eq), tables)
        want = _jax({}, lambda t: q(t, JF, eq), tables)
        pd.testing.assert_frame_equal(got, want)
        assert (got["c_mktsegment"] == "BUILDING").all() == eq


@pytest.mark.parametrize("conf", ["default", "small_batches_unfused"])
def test_string_columns_through_filter_and_join(conf, tables):
    """Filtered orders (three string columns) joined to filtered customers
    (four): strings go through compact, the build side's concat and the
    join's gather on both sides."""
    def q(t, F):
        c = t["customer"].filter(F.col("c_acctbal") > 1000.0)
        o = t["orders"].filter(F.col("o_orderstatus") == "O") \
            .withColumnRenamed("o_custkey", "c_custkey")
        return o.join(c, on="c_custkey", how="left")
    got = _port(CONFS[conf], lambda t: q(t, TF), tables)
    want = _jax(CONFS[conf], lambda t: q(t, JF), tables)
    pd.testing.assert_frame_equal(got, want)
    assert got["c_name"].isna().any() and got["c_name"].notna().any()


def test_string_equality_column_vs_column():
    data = {"a": ["x", "yy", None, "zz", "", "abc", "abd", "ab"],
            "b": ["x", "y", "q", None, "", "abc", "abc", "abc"],
            "c": ["c0", "c1", "c2", "c3", "c4", "c5", "c6", "c7"],
            "i": np.arange(8)}

    def run(F, df):
        return df.select(F.col("i"), (F.col("a") == F.col("b")).alias("eq"),
                         (F.col("a") != F.col("b")).alias("ne"),
                         (F.col("b") == "abc").alias("lit"),
                         F.col("a").isNull().alias("null"),
                         F.col("c").isNull().alias("c_null"),
                         F.col("c").isNotNull().alias("c_nn"))
    s = JaxSession({})
    try:
        want = run(JF, s.create_dataframe(data)).to_pandas()
    finally:
        s.stop()
    got = run(TF, TpuSession({}, device="cpu")
              .create_dataframe(data)).to_pandas()
    pd.testing.assert_frame_equal(got, want)
    assert got["eq"].tolist()[:2] == [True, False]
