"""Rollup, cube and grouping sets in the PyTorch port (Expand, then the
hash aggregate keyed on the keys and the grouping id), against the JAX
package, on the CPU.

Keys are an int column and a string column with nulls in the data, so a
rolled-up null and a null key are told apart only by ``grouping()``.
Each case runs on the aggregate's three paths: the coded directory (a
small key space), the sort path (an int key spread over 2^50 with the
hash path off) and the hash table (the same keys, hash on; its launches
are counted).  Outputs are sorted by every column before comparing (the
paths emit groups in different orders); then keys, strings, counts and
``grouping``/``grouping_id`` must be equal and float sums within a
relative 1e-12.
"""

import numpy as np
import pandas as pd
import pytest
import torch

from spark_rapids_tpu.api import functions as JF
from spark_rapids_tpu.api.session import TpuSession as JaxSession
from spark_rapids_tpu_torch.api import functions as TF
from spark_rapids_tpu_torch.api.session import TpuSession
from spark_rapids_tpu_torch.exec.fusion import fusion_metrics

RTOL = 1e-12
HASH_ON = {"spark.rapids.tpu.pallas.hash.enabled": True,
           "spark.rapids.tpu.pallas.hash.tableSlots": 1 << 12}
# path -> (the int key column, conf)
PATHS = {"coded": ("k", {}),
         "sort": ("kw", {"spark.rapids.sql.tpu.maxBatchRows": 128}),
         "hash": ("kw", dict(HASH_ON,
                             **{"spark.rapids.sql.tpu.maxBatchRows": 128}))}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _data(n=500):
    rng = np.random.default_rng(3)
    words = ["alpha", "beta", "gamma", "", "délta", "zeta"]
    s = [words[i] for i in rng.integers(0, len(words), n)]
    k = rng.integers(-3, 5, n).tolist()
    for i in rng.choice(n, 30, replace=False):
        s[i] = None
    for i in rng.choice(n, 30, replace=False):
        k[i] = None
    kw = [None if x is None else x * (1 << 50) + 7 for x in k]
    return {"s": s, "k": k, "kw": kw,
            "v": rng.uniform(-50, 50, n).round(4),
            "q": rng.integers(0, 100, n)}


# name -> make(F, df, int key name) -> DataFrame
CASES = {
    "rollup": lambda F, df, ik: df.rollup("s", ik).agg(
        F.sum("v").alias("sv"), F.count("*").alias("n"),
        F.grouping("s").alias("gs"), F.grouping_id().alias("gid")),
    "cube": lambda F, df, ik: df.cube(ik, "s").agg(
        F.sum("q").alias("sq"), F.max("v").alias("mv"),
        F.grouping(ik).alias("gk"), F.grouping_id().alias("gid")),
    "grouping_sets": lambda F, df, ik: df.groupingSets(
        [["s"], [ik], []], "s", ik).agg(
        F.avg("v").alias("av"), F.min("q").alias("mq"),
        F.grouping_id().alias("gid")),
    # an aggregate over a grouping column sees its real values
    "rollup_sum_of_key": lambda F, df, ik: df.rollup(ik).agg(
        F.count(ik).alias("nk"), F.sum(ik).alias("sk"),
        F.grouping(ik).alias("g")),
    "rollup_computed_key": lambda F, df, ik: df.rollup(
        (F.col("q") % 3).alias("r"), ik).agg(
        F.sum("v").alias("sv"), F.grouping("r").alias("gr")),
}


@pytest.fixture(scope="module")
def jax_answers():
    cache = {}

    def get(name, ik):
        if (name, ik) not in cache:
            s = JaxSession({})
            try:
                df = CASES[name](JF, s.create_dataframe(_data()), ik)
                cache[name, ik] = df.to_pandas()
            finally:
                s.stop()
        return cache[name, ik]
    return get


def _sorted(df):
    return df.sort_values(list(df.columns), ignore_index=True,
                          na_position="last")


@pytest.mark.parametrize("path", list(PATHS))
@pytest.mark.parametrize("name", list(CASES))
def test_grouping_sets_match_jax(name, path, jax_answers):
    ik, conf = PATHS[path]
    s = TpuSession(conf, device="cpu")
    before = fusion_metrics.snapshot()["hashKernelLaunches"]
    got = CASES[name](TF, s.create_dataframe(_data()), ik).to_pandas()
    launched = fusion_metrics.snapshot()["hashKernelLaunches"] - before
    want = jax_answers(name, ik)
    assert list(got.columns) == list(want.columns)
    assert len(got) == len(want)
    got, want = _sorted(got), _sorted(want)
    for c in got.columns:
        if got[c].dtype.kind == "f":
            np.testing.assert_allclose(got[c].to_numpy(), want[c].to_numpy(),
                                       rtol=RTOL, atol=0, equal_nan=True)
        else:
            pd.testing.assert_series_equal(got[c], want[c])
    if path == "hash":
        assert launched > 0
    else:
        assert launched == 0


def test_rolled_up_keys_are_typed_nulls():
    """A rolled-up key keeps its column's type (a string stays a string,
    an int an int) and is null; ``grouping`` is int32 and the grouping
    id int64, as in the JAX package."""
    s = TpuSession({}, device="cpu")
    df = s.create_dataframe(_data()).rollup("s", "k").agg(
        TF.count("*").alias("n"), TF.grouping("k").alias("g"),
        TF.grouping_id().alias("gid"))
    assert [(n, dt.name) for n, dt in df.schema] == [
        ("s", "string"), ("k", "bigint"), ("n", "bigint"), ("g", "int"),
        ("gid", "bigint")]
    got = df.to_pandas()
    total = got[got.gid == 3]
    assert len(total) == 1 and total.s.isna().all() and \
        total.k.isna().all() and int(total.n.iloc[0]) == 500
    assert sorted(got.gid.unique().tolist()) == [0, 1, 3]
    assert "TpuExpandExec[3 projections]" in df.explain()


def test_expand_emits_one_batch_per_projection_and_input_batch():
    from spark_rapids_tpu_torch.exec.expand import TpuExpandExec
    s = TpuSession({"spark.rapids.sql.tpu.maxBatchRows": 128},
                   device="cpu")
    df = s.create_dataframe(_data()).rollup("s", "k").agg(
        TF.count("*").alias("n"))
    plan = s.plan(df.plan)
    node = plan
    while not isinstance(node, TpuExpandExec):
        node = node.children[0]
    sizes = [b.nrows for b in node.execute()]
    assert sizes == [128] * 3 + [128] * 3 + [128] * 3 + [116] * 3
