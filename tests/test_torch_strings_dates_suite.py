"""SD1-SD10 (``models/strings_dates.py``) through the PyTorch port on the
CPU at SF0.01, against the JAX package.

The TPC-H tables come from ``models/tpch.gen_tables`` with their dates
as DATE columns (arrow ``date32``, as the card's tables hold them), the
same tables in both engines.  Each query runs in strict test mode with
only its pinned fallback nodes allowed (``FALLBACK_NODES``: SD9's outer
projection), and its ``CpuFallbackExec`` nodes are exactly the JAX
package's.  Each answer equals the JAX package's (keys, counts, strings
and order exactly, float sums within 1e-12 relative) except where the
JAX package departs from Spark (``ROADMAP.md`` queue 3): SD2's
``locate(..., 4)`` column (the JAX package reads two arguments), SD6's
``months_between`` sums, and SD9 (its ``hash`` is not Spark's, and
over a string column it fails at this scale), which pandas computes by
Spark's rules instead (Python's Murmur3, ``hashlib``,
``re``).  Then the sharded path: SD2, SD5 and SD9 over 8 logical shards
equal one device's, each plan that stays on one device with its reason
on ``last_dist_explain``; and SD1, SD4 and SD6 give the same answer with
the hash kernels' path on and off.
"""

import hashlib
import math
import re

import numpy as np
import pandas as pd
import pyarrow as pa
import pytest
import torch

from test_torch_datetime_functions import months_between
from test_torch_misc_exprs import spark_hash
from spark_rapids_tpu.api import functions as JF
from spark_rapids_tpu.api.session import TpuSession as JaxSession
from spark_rapids_tpu.models import tpch_sql as jax_tpch_sql
from spark_rapids_tpu_torch.api import functions as TF
from spark_rapids_tpu_torch.api.session import TpuSession
from spark_rapids_tpu_torch.models import strings_dates as SD
from spark_rapids_tpu_torch.models import tpch, tpch_sql

SF = 0.01
RTOL = 1e-12


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def date_tables(frames):
    """pandas TPC-H frames as arrow tables with DATE columns."""
    out = {}
    for name, df in frames.items():
        t = pa.Table.from_pandas(df, preserve_index=False)
        out[name] = pa.table(
            [c.cast(pa.date32()) if pa.types.is_timestamp(c.type) else c
             for c in t.columns], names=t.column_names)
    return out


@pytest.fixture(scope="module")
def tables():
    return date_tables(tpch.gen_tables(sf=SF))


def strict(name, extra=None):
    conf = {"spark.rapids.sql.test.enabled": True,
            "spark.rapids.sql.test.allowedNonTpu":
                ",".join(SD.FALLBACK_NODES[name]) or "none"}
    conf.update(extra or {})
    return conf


def port_session(tables, conf):
    s = TpuSession(conf, device="cpu")
    tpch_sql.register(s, {k: s.create_dataframe(v)
                          for k, v in tables.items()})
    return s


@pytest.fixture(scope="module")
def jax_answers(tables):
    s = JaxSession({})
    jax_tpch_sql.register(s, {k: s.create_dataframe(v)
                              for k, v in tables.items()})
    out = {}
    try:
        for name in SD.QUERIES:
            df = SD.run(JF, s, name)
            nodes = [m.group(1) for m in re.finditer(
                r"CpuFallbackExec\[(\w+)", s.plan(df.plan).tree_string())]
            # the JAX package's hash() meets a string column by its chars
            # and fails at this scale (queue 3); pandas holds SD9
            out[name] = (None if name == "sd9" else df.to_pandas(), nodes)
    finally:
        s.stop()
    return out


def fallback_nodes(df):
    return re.findall(r"CpuFallbackExec\[(\w+)\]",
                      df.explain().split("== Logical Plan ==")[0])


def same(got, want, skip=()):
    assert list(got.columns) == list(want.columns)
    assert len(got) == len(want)
    for c in got.columns:
        if c in skip:
            continue
        if got[c].dtype.kind == "f":
            np.testing.assert_allclose(got[c].to_numpy(),
                                       want[c].to_numpy(), rtol=RTOL,
                                       atol=0, equal_nan=True, err_msg=c)
        else:
            assert got[c].tolist() == want[c].tolist(), c


def _sd2_dash(tables):
    # locate('-', c_phone, 4): the first '-' from character 4 on
    phones = tables["customer"].column("c_phone").to_pylist()
    cc = [int(p.split("-")[0]) for p in phones]
    dash = [p.find("-", 3) + 1 for p in phones]
    return pd.DataFrame({"cc": cc, "d": dash}).groupby("cc")["d"].max()


def _sd6_months(tables):
    li = tables["lineitem"].select(["l_orderkey", "l_shipmode",
                                    "l_shipdate", "l_receiptdate"]) \
        .to_pandas()
    o = tables["orders"].select(["o_orderkey", "o_orderdate"]).to_pandas()
    j = li.merge(o, left_on="l_orderkey", right_on="o_orderkey")
    us = 86_400_000_000

    def days(s):
        return (pd.to_datetime(s) - pd.Timestamp("1970-01-01")).dt.days

    def add2(d):
        m = d.month + 1
        y, m = d.year + m // 12, m % 12 + 1
        import calendar
        return d.replace(year=y, month=m,
                         day=min(d.day, calendar.monthrange(y, m)[1]))
    j["late"] = [add2(a) < b for a, b in zip(j["o_orderdate"],
                                             j["l_shipdate"])]
    j["mb"] = [months_between(a * us, b * us) for a, b in
               zip(days(j["l_receiptdate"]), days(j["o_orderdate"]))]
    return j.groupby(["l_shipmode", "late"])["mb"].sum()


def _java_double(v):
    """Java's Double.toString for the two-decimal balances here."""
    return repr(float(v))


def _sd9(tables):
    s = tables["supplier"].to_pandas()
    n = tables["nation"].to_pandas()
    j = s.merge(n, left_on="s_nationkey", right_on="n_nationkey")
    b = [int(math.fmod(spark_hash([name, key], ["string", "bigint"]), 32))
         for name, key in zip(j["s_name"], j["s_suppkey"])]
    rx = re.compile("Customer (Complaints|Recommends)")
    x = pd.DataFrame({
        "b": b, "m": [hashlib.md5(v.encode()).hexdigest()
                      for v in j["s_name"]],
        "c": [len(rx.sub("C", v)) for v in j["s_comment"]],
        "a": [_java_double(v) for v in j["s_acctbal"]],
        "code": [ord(v[0]) for v in j["s_name"]],
        "ch": [chr((65 + k) % 256) for k in j["s_nationkey"]]})
    g = x.groupby("b")
    return pd.DataFrame({
        "b": g.size().index.astype(np.int32), "n": g.size().values,
        "min_md5": g["m"].min().values, "max_comment": g["c"].max().values,
        "min_balance": g["a"].min().values,
        "max_ascii": g["code"].max().values,
        "min_chr": g["ch"].min().values})


@pytest.mark.parametrize("name", list(SD.QUERIES))
def test_sd_query(name, tables, jax_answers):
    s = port_session(tables, strict(name))
    df = SD.run(TF, s, name)
    assert fallback_nodes(df) == SD.FALLBACK_NODES[name] == \
        jax_answers[name][1]
    got = df.to_pandas()
    want = jax_answers[name][0]
    if name == "sd2":
        same(got, want, skip=("max_dash",))
        assert got["max_dash"].tolist() == _sd2_dash(tables).tolist() == \
            [7] * len(got)
    elif name == "sd6":
        same(got, want, skip=("months",))
        oracle = _sd6_months(tables)
        np.testing.assert_allclose(
            got["months"].to_numpy(),
            [oracle[(m, bool(l))] for m, l in zip(got["l_shipmode"],
                                                   got["late"])],
            rtol=RTOL, atol=0)
    elif name == "sd9":
        oracle = _sd9(tables)
        assert list(got.columns) == list(oracle.columns)
        for c in got.columns:
            assert got[c].tolist() == oracle[c].tolist(), c
    else:
        same(got, want)


@pytest.mark.parametrize("name", ["sd2", "sd5", "sd9"])
def test_sd_sharded(name, tables):
    """Over 8 logical shards each query equals one device's; a plan the
    shard group cannot lower runs on one device with its reason."""
    one = SD.run(TF, port_session(tables, {}), name).to_pandas()
    s = port_session(tables, {
        "spark.rapids.sql.distributed.numShards": 8})
    got = SD.run(TF, s, name).to_pandas()
    explain = s.last_dist_explain
    assert explain == "distributed" or explain.startswith("fallback: "), \
        explain
    if name == "sd2":
        assert explain == "distributed"
    same(got.reset_index(drop=True), one.reset_index(drop=True))


@pytest.mark.parametrize("name", ["sd1", "sd4", "sd6"])
def test_sd_hash_on_off(name, tables):
    answers = []
    for on in (True, False):
        s = port_session(tables, strict(name, {
            "spark.rapids.tpu.pallas.hash.enabled": on,
            "spark.rapids.tpu.pallas.hash.tableSlots": 1 << 14}))
        answers.append(SD.run(TF, s, name).to_pandas())
    same(*answers)
