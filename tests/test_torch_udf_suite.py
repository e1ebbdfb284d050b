"""UD1-UD9 (``models/udf.py``) through the PyTorch port on the CPU at
SF0.002, against the JAX package and numpy / pandas.

The TPC-H tables come from ``models/tpch.gen_tables`` with their dates as
DATE columns, the same tables in both engines; the references read
``gen_table_columns``' buffers (the same values).  Each query runs in
strict test mode, where any CPU fallback raises: the Python execs are
device-side nodes, as in the JAX planner.  Each answer equals the
reference (``udf.check``: keys, counts and order exactly, float sums
within a relative 1e-9) and the JAX package's (float sums within a
relative 1e-12; UD8 is held against its uncached plan instead, and
``test_torch_cache_pivot.py`` holds the cache against the JAX package's).
Besides: UD1 equals TPC-H q6 bit for bit and runs no
Python node; UD2 gives the same answer with the hash path off; UD3's plans
hold exactly one ``TpuArrowEvalPythonExec``; UD4's torch function equals
the same query written with columns bit for bit; the pandas queries hold
their pandas exec; UD8's cached answers equal the uncached plan's (keys
and counts exactly, float sums within a relative 1e-12: a float sum adds
in an order its batches' layout fixes, and the cache holds the slice
compacted where the uncached plan masks lineitem's rows), a second read
of the cache equals the first bit for bit, the first query materializes
the cache and the others read it (no lineitem scan), and ``unpersist``
drops the node.  On a session with 2
logical shards a plan with user code or a cached node runs on one device,
with its reason on ``last_dist_explain``, and gives the single-device
answer.
"""

import numpy as np
import pyarrow as pa
import pytest
import torch

from test_torch_strings_dates_suite import date_tables
from spark_rapids_tpu.api import functions as JF
from spark_rapids_tpu.api.session import TpuSession as JaxSession
from spark_rapids_tpu.models import tpch_sql as jax_tpch_sql
from spark_rapids_tpu_torch.api import functions as TF
from spark_rapids_tpu_torch.api.session import TpuSession
from spark_rapids_tpu_torch.models import tpch, tpch_sql
from spark_rapids_tpu_torch.models import udf as UD

SF = 0.002
RTOL = 1e-12
STRICT = {"spark.rapids.sql.test.enabled": True,
          "spark.rapids.sql.test.allowedNonTpu": "none"}
PANDAS_EXEC = {"ud5m": "TpuMapInPandasExec",
               "ud5g": "TpuFlatMapGroupsInPandasExec",
               "ud6a": "TpuAggregateInPandasExec",
               "ud6k": "TpuAggregateInPandasExec",
               "ud6w": "TpuWindowInPandasExec",
               "ud7": "TpuFlatMapCoGroupsInPandasExec"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def tables():
    return date_tables(tpch.gen_tables(sf=SF))


@pytest.fixture(scope="module")
def refs():
    return UD.references(UD.host_columns(tpch.gen_table_columns(SF)))


def port_session(tables, extra=None):
    s = TpuSession(dict(STRICT, **(extra or {})), device="cpu")
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
        for name in UD.NAMES:
            if name not in UD.UD8:
                out[name] = UD.build(JF, s, name).to_arrow()
    finally:
        s.stop()
    return out


def same(got, want, rtol=RTOL):
    assert got.column_names == want.column_names
    for c in want.column_names:
        g, w = got.column(c), want.column(c)
        if pa.types.is_floating(w.type):
            np.testing.assert_allclose(
                g.to_numpy(), w.to_numpy(), rtol=rtol, atol=0, err_msg=c)
        else:
            assert g.to_pylist() == w.cast(g.type).to_pylist(), c


def _tree(df):
    return df.session.plan(df.plan).tree_string()


@pytest.mark.parametrize("name", [n for n in UD.NAMES if n not in UD.UD8])
def test_query_equals_jax_and_reference(name, tables, refs, jax_answers):
    s = port_session(tables)
    df = UD.build(TF, s, name)
    got = df.to_arrow()
    ok, why = UD.check(name, got, refs)
    assert ok, why
    same(got, jax_answers[name])
    tree = _tree(df)
    assert tree.count("TpuArrowEvalPythonExec") == \
        (1 if name in UD.ARROW_EVAL else 0)
    if name in PANDAS_EXEC:
        assert PANDAS_EXEC[name] in tree
    s.stop()


def test_ud1_equals_q6_bit_for_bit(tables):
    s = port_session(tables)
    got = UD.build(TF, s, "ud1").to_pandas()
    want = tpch.q6({"lineitem": s.table("lineitem")}).to_pandas()
    assert got["revenue"][0].hex() == want["revenue"][0].hex()
    s.stop()


def test_ud2_hash_off_equals_hash_on(tables):
    got = {}
    for on in (True, False):
        s = port_session(tables, {"spark.rapids.tpu.pallas.hash.enabled": on})
        got[on] = UD.build(TF, s, "ud2").to_arrow()
        s.stop()
    same(got[False], got[True], rtol=RTOL)


def test_ud4_torch_function_equals_columns(tables):
    s = port_session(tables)
    a = UD.build(TF, s, "ud4").to_arrow()
    b = UD.build(TF, s, "ud4c").to_arrow()
    assert a.equals(b)
    s.stop()


def test_ud8_cache(tables, refs):
    s = port_session(tables)
    base = UD.lineitem_1995(TF, s).cache()
    plain = UD.lineitem_1995(TF, s)
    for i, name in enumerate(UD.UD8):
        df = UD.build(TF, s, name, base)
        tree = _tree(df)
        if i == 0:
            assert "TpuMaterializeCacheExec" in tree
        else:
            assert "TpuCachedScanExec" in tree
            assert "TpuMaterializeCacheExec" not in tree
            # the lineitem scan is gone; UD8c's orders scan stays
            assert tree.count("TpuScanExec") == (name == "ud8c")
        got = df.to_arrow()
        # a float sum adds in an order its batches' layout fixes: the
        # cache holds the slice compacted where the uncached plan masks
        # lineitem's rows, so only the last bits may differ; a second
        # read of the cache is bit for bit the first
        same(got, UD.build(TF, s, name, plain).to_arrow())
        if i:
            assert got.equals(df.to_arrow()), name
        ok, why = UD.check(name, got, refs)
        assert ok, why
    entry = s.cache_manager.lookup(base.plan)
    assert entry.materialized and 0 < entry.cached_bytes < entry.raw_bytes
    base.unpersist()
    tree = _tree(UD.build(TF, s, "ud8b", base))
    assert "Cache" not in tree
    s.stop()


@pytest.mark.parametrize("name,reason", [
    ("ud3x", "user code (PythonUDF)"), ("ud4", "user code (TorchUDF)"),
    ("ud5m", "pandas UDF node"), ("ud8b", "a cached plan")])
def test_user_code_runs_on_one_device(name, reason, tables):
    single = port_session(tables)
    want = UD.build(TF, single, name).to_arrow()
    single.stop()
    s = port_session(tables, {
        "spark.rapids.sql.distributed.numShards": 2})
    base = UD.lineitem_1995(TF, s).cache() if name in UD.UD8 else None
    got = UD.build(TF, s, name, base).to_arrow()
    assert s.last_dist_explain.startswith("fallback") and \
        reason in s.last_dist_explain, s.last_dist_explain
    same(got, want)
    s.stop()
