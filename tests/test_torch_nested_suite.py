"""ND1-ND7 (``models/nested.py``) through the PyTorch port on the CPU at
SF0.005, against the JAX package and numpy.

The TPC-H tables come from ``models/tpch.gen_tables`` with their dates as
DATE columns (arrow ``date32``, as the card's tables hold them), the same
tables in both engines; the numpy references read
``gen_table_columns``' buffers (the same values).  Each query runs in
strict test mode with only its pinned fallback nodes allowed (ND7's
``get_json_object`` projection and ``split`` explode), and its
``CpuFallbackExec`` nodes are exactly the JAX package's, except ND5's
map projection, which the JAX package tags off the device (its
``array()`` over a nullable column) and the port runs there.  Each answer
equals numpy's (``nested.check``: integers, keys, arrays and order
exactly, float sums within a relative 1e-9) and the JAX package's (keys,
counts, arrays, struct fields and order exactly, float sums within a
relative 1e-12).  The SQL forms of ND1, ND4, ND5 and ND6 equal their
DataFrame forms column for column (the JAX resolver cannot run ND4's,
ND5's and ND6's: it knows no shredded column by its name), and ND2 and
ND3 give the same answer with the hash path off.
"""

import re

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
from spark_rapids_tpu_torch.models import nested as ND
from spark_rapids_tpu_torch.models import tpch, tpch_sql

SF = 0.005
RTOL = 1e-12


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
    return ND.references(ND.host_columns(tpch.gen_table_columns(SF)))


# the JAX package tags create_map's arrays over a nullable column off
# the device; the port runs them and refuses a null element at run time
JAX_FALLBACK = {"nd5": ["Project"], "nd5x": ["Project"]}


def strict(name, extra=None):
    conf = {"spark.rapids.sql.test.enabled": True,
            "spark.rapids.sql.test.allowedNonTpu":
                ",".join(ND.FALLBACK_NODES[name]) or "none"}
    conf.update(extra or {})
    return conf


def port_session(tables, conf):
    s = TpuSession(conf, device="cpu")
    tpch_sql.register(s, {k: s.create_dataframe(v)
                          for k, v in tables.items()})
    ND.register_map_view(TF, s)
    return s


@pytest.fixture(scope="module")
def jax_answers(tables):
    s = JaxSession({})
    jax_tpch_sql.register(s, {k: s.create_dataframe(v)
                              for k, v in tables.items()})
    out = {}
    try:
        for name in ND.NAMES:
            df = ND.build(JF, s, name)
            nodes = re.findall(r"CpuFallbackExec\[(\w+)",
                               s.plan(df.plan).tree_string())
            out[name] = (df.to_arrow(), nodes)
    finally:
        s.stop()
    return out


def same(got, want):
    assert got.column_names == want.column_names
    for c in want.column_names:
        g, w = got.column(c), want.column(c)
        if pa.types.is_floating(w.type):
            np.testing.assert_allclose(
                g.to_numpy(), w.to_numpy(), rtol=RTOL, atol=0, err_msg=c)
        else:
            assert g.to_pylist() == w.cast(g.type).to_pylist(), c


@pytest.mark.parametrize("name", ND.NAMES)
def test_query_equals_jax_and_numpy(name, tables, refs, jax_answers):
    s = port_session(tables, strict(name))
    df = ND.build(TF, s, name)
    got = df.to_arrow()
    ok, why = ND.check(name, got, refs)
    assert ok, why
    want, jnodes = jax_answers[name]
    nodes = re.findall(r"CpuFallbackExec\[(\w+)\]",
                       df.explain().split("== Logical Plan ==")[0])
    assert sorted(nodes) == sorted(ND.FALLBACK_NODES[name])
    assert sorted(jnodes) == sorted(JAX_FALLBACK.get(
        name, ND.FALLBACK_NODES[name]))
    same(got, want)
    s.stop()


@pytest.mark.parametrize("name", sorted(ND.SQL))
def test_sql_equals_dataframe(name, tables):
    s = port_session(tables, strict(name))
    got = s.sql(ND.SQL[name]).to_arrow()
    want = ND.build(TF, s, name).to_arrow()
    assert got.column_names and set(got.column_names) <= \
        set(want.column_names)
    for c in got.column_names:
        assert got.column(c).equals(want.column(c)), c
    s.stop()


@pytest.mark.parametrize("name", ["nd2", "nd3"])
def test_hash_off_equals_hash_on(name, tables):
    on = port_session(tables, strict(name, {
        "spark.rapids.tpu.pallas.hash.enabled": True}))
    off = port_session(tables, strict(name, {
        "spark.rapids.tpu.pallas.hash.enabled": False}))
    same(ND.build(TF, off, name).to_arrow(),
         ND.build(TF, on, name).to_arrow())
    on.stop()
    off.stop()
