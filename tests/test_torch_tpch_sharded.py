"""The TPC-H queries on the port's sharded path at ``sf=0.002``.

All 22 as DataFrames (``models/tpch.py``) and all 22 as SQL
(``models/tpch_sql.py``) on ``LocalShards(8)`` (numShards=8 on the CPU),
each of which must run distributed and equal the port's single-device
answer (which ``tests/test_torch_tpch22.py`` and
``tests/test_torch_tpch_sql.py`` hold against the JAX package); q1, q3,
q5 and q6 as SQL also against the JAX session on ``make_mesh(8)`` (the
JAX package's ``test_tpch_headline_queries_distributed``); the 22 over
parquet files the port wrote (lineitem and orders as 4 files each), the
file list sharded; and TPC-DS q3, q55 and q96.  Keys, counts, strings and
order must be equal; float columns within 1e-12 relative.
"""

import os

import numpy as np
import pandas as pd
import pytest
import torch

from spark_rapids_tpu.models import tpch as jax_tpch
from spark_rapids_tpu_torch.api.session import TpuSession
from spark_rapids_tpu_torch.models import tpcds, tpch, tpch_sql

SF = 0.002
RTOL = 1e-12
MESH_CONF = {"spark.rapids.sql.distributed.numShards": 8}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test workers share the host: one torch thread here."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _same(got, want):
    assert list(got.columns) == list(want.columns)
    assert len(got) == len(want)
    for c in got.columns:
        g, w = got[c].reset_index(drop=True), want[c].reset_index(drop=True)
        if g.dtype.kind == "f":
            np.testing.assert_allclose(g.to_numpy(), w.to_numpy(),
                                       rtol=RTOL, atol=0, equal_nan=True)
        else:
            pd.testing.assert_series_equal(g, w)


@pytest.fixture(scope="module")
def data():
    return jax_tpch.gen_tables(sf=SF)


@pytest.fixture(scope="module")
def sessions(data):
    """(single-device session, 8-shard session), each with the tables as
    DataFrames and as SQL views."""
    out = []
    for conf in ({}, MESH_CONF):
        s = TpuSession(conf, device="cpu")
        tables = tpch.load(s, data)
        tpch_sql.register(s, tables)
        out.append((s, tables))
    return out


@pytest.fixture(scope="module")
def single_answers(sessions):
    """(form, query) -> the single-device answer, computed on first use."""
    cache = {}
    s, tables = sessions[0]

    def get(form, name):
        if (form, name) not in cache:
            cache[form, name] = (tpch.QUERIES[name](tables) if form == "df"
                                 else s.sql(tpch_sql.QUERIES[name])) \
                .to_pandas()
        return cache[form, name]
    return get


@pytest.mark.parametrize("name", list(tpch.QUERIES))
@pytest.mark.parametrize("form", ["df", "sql"])
def test_query_sharded_matches_single_device(form, name, sessions,
                                             single_answers):
    s, tables = sessions[1]
    got = (tpch.QUERIES[name](tables) if form == "df"
           else s.sql(tpch_sql.QUERIES[name])).to_pandas()
    assert s.last_dist_explain == "distributed", (form, name,
                                                  s.last_dist_explain)
    _same(got, single_answers(form, name))


@pytest.mark.parametrize("name", ["q1", "q3", "q5", "q6"])
def test_headline_sql_matches_jax_mesh(name, data, sessions):
    from spark_rapids_tpu.api.session import TpuSession as JaxSession
    from spark_rapids_tpu.models import tpch_sql as jax_tpch_sql
    from spark_rapids_tpu.parallel.mesh import make_mesh
    js = JaxSession(mesh=make_mesh(8))
    try:
        jax_tpch_sql.register(js, jax_tpch.load(js, data))
        want = js.sql(jax_tpch_sql.QUERIES[name]).to_pandas()
        assert js.last_dist_explain == "distributed"
    finally:
        js.stop()
    s, _ = sessions[1]
    got = s.sql(tpch_sql.QUERIES[name]).to_pandas()
    assert s.last_dist_explain == "distributed"
    _same(got, want)


@pytest.fixture(scope="module")
def parquet_root(data, tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tpch"))
    for name, df in data.items():
        parts = 4 if name in ("lineitem", "orders") else 1
        s = TpuSession({"spark.rapids.sql.writer.maxRowsPerFile":
                        -(-len(df) // parts)}, device="cpu")
        s.create_dataframe(df).write.parquet(os.path.join(root, name))
    return root


@pytest.mark.parametrize("name", list(tpch.QUERIES))
def test_query_over_sharded_parquet(name, parquet_root, single_answers):
    s = TpuSession(MESH_CONF, device="cpu")
    got = tpch.QUERIES[name](tpch.read_parquet(s, parquet_root)).to_pandas()
    assert s.last_dist_explain == "distributed", s.last_dist_explain
    st = s.last_scan_stats
    assert st["sharded_files"], st
    assert st["peak_host_rows"] <= st["shard_bound_rows"], st
    _same(got, single_answers("df", name))


@pytest.fixture(scope="module")
def tpcds_sessions():
    data = tpcds.gen_tables(sf=0.01)
    out = []
    for conf in ({}, MESH_CONF):
        s = TpuSession(conf, device="cpu")
        tpcds.load(s, data)
        out.append(s)
    return out


@pytest.mark.parametrize("name", ["q3", "q55", "q96"])
def test_tpcds_query_sharded_matches_single_device(name, tpcds_sessions):
    single, dist = tpcds_sessions
    got = dist.sql(tpcds.QUERIES[name]).to_pandas()
    assert dist.last_dist_explain == "distributed", dist.last_dist_explain
    _same(got, single.sql(tpcds.QUERIES[name]).to_pandas())
