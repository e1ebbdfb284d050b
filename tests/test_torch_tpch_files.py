"""All 22 TPC-H queries of the PyTorch port over parquet files against
the JAX package's answers over the same files, on the CPU at
``sf=0.002``.

The tables (``models/tpch.gen_tables``, numpy-seeded) are written with
pyarrow into ``tmp_path``: lineitem and orders as four files each, so the
multi-file readers engage, every other table as one file.  The JAX
package reads them with ``session.read.parquet`` under its default conf;
the port reads them with the pipeline on and off and under two reader
strategies.  Keys, strings, dates, counts and row order must be equal;
float columns within a relative 1e-12 (the port sums in another order).

q8 reads ``nation`` twice, for two sets of columns.  The JAX package's
pushdown pass keeps only the last set on the shared relation, so over
files its q8 reads ``n_name`` as nulls and returns no row (its own
in-memory answer has two).  There the reference is the JAX package's
answer over the same tables in memory.
"""

import os

import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from spark_rapids_tpu.api.session import TpuSession as JaxSession
from spark_rapids_tpu.models import tpch as jax_tpch
from spark_rapids_tpu_torch.api.session import TpuSession
from spark_rapids_tpu_torch.models import tpch

SF = 0.002
RTOL = 1e-12
SPLIT = {"lineitem": 4, "orders": 4}
# queries whose JAX answer over files is wrong (see above): held against
# the JAX package's in-memory answer on the same tables
REFERENCE_IN_MEMORY = {"q8"}
CONFS = {
    "pipeline_multithreaded": {
        "spark.rapids.sql.format.parquet.reader.type": "MULTITHREADED",
        "spark.rapids.sql.reader.batchSizeRows": 1 << 12},
    "sequential_perfile_hash": {
        "spark.rapids.tpu.pipeline.enabled": False,
        "spark.rapids.sql.format.parquet.reader.type": "PERFILE",
        "spark.rapids.tpu.pallas.hash.enabled": True,
        "spark.rapids.tpu.pallas.hash.tableSlots": 1 << 14},
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test workers share the host: one torch thread here."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def data():
    return jax_tpch.gen_tables(sf=SF)


@pytest.fixture(scope="module")
def root(tmp_path_factory, data):
    d = tmp_path_factory.mktemp("tpch_files")
    for name, df in data.items():
        os.makedirs(d / name)
        table = pa.Table.from_pandas(df, preserve_index=False)
        parts = SPLIT.get(name, 1)
        step = -(-table.num_rows // parts)
        for i in range(parts):
            pq.write_table(table.slice(i * step, step),
                           str(d / name / f"part-{i:05d}.parquet"))
    return str(d)


@pytest.fixture(scope="module")
def jax_answers(root, data):
    cache = {}

    def get(name):
        if name not in cache:
            s = JaxSession({})
            try:
                tables = {t: s.read.parquet(*sorted(
                    os.path.join(root, t, f)
                    for f in os.listdir(os.path.join(root, t))))
                    for t in os.listdir(root)}
                if name in REFERENCE_IN_MEMORY:
                    tables = jax_tpch.load(s, data)
                cache[name] = jax_tpch.QUERIES[name](tables).to_pandas()
            finally:
                s.stop()
        return cache[name]
    return get


@pytest.fixture(scope="module")
def port_tables(root):
    return {conf: tpch.read_parquet(TpuSession(c, device="cpu"), root)
            for conf, c in CONFS.items()}


def test_files_split_for_the_multifile_readers(root, port_tables):
    t = port_tables["pipeline_multithreaded"]
    assert len(t["lineitem"].plan.paths) == 4
    assert len(t["region"].plan.paths) == 1


@pytest.mark.parametrize("conf", list(CONFS))
@pytest.mark.parametrize("name", list(jax_tpch.QUERIES))
def test_query_over_files_matches_jax(name, conf, port_tables, jax_answers):
    want = jax_answers(name)
    got = tpch.QUERIES[name](port_tables[conf]).to_pandas()
    assert list(got.columns) == list(want.columns)
    assert len(got) == len(want)
    for c in got.columns:
        if got[c].dtype.kind == "f":
            np.testing.assert_allclose(got[c].to_numpy(), want[c].to_numpy(),
                                       rtol=RTOL, atol=0, equal_nan=True)
        else:
            pd.testing.assert_series_equal(got[c], want[c])
