"""explode / posexplode (the Generate operator) and collect_list /
collect_set (the single-pass aggregate) of the PyTorch port against the
JAX package, on the CPU.

Numpy-seeded data (a few hundred rows) goes through both packages: an
explode and a posexplode of an array with string and number columns
passing through, an explode of a map into key and value, an explode of
``split`` (the CPU fallback's Generate), and a collect per group beside
``sum`` and ``count``, keyless, over no rows, over several input batches
and over nulls.  Answers are equal exactly: keys, counts, array contents
and order, row order (the collected arrays in input order for
``collect_list``, ascending for ``collect_set``); float sums within a
relative 1e-12.  A collect beside a string ``min`` runs in the CPU
fallback in both packages, with the same answer.  A collect grouped by
a string key is held to Python: the JAX package groups string keys
wrongly there (``ROADMAP.md`` queue 3).
"""

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.api import functions as JF
from spark_rapids_tpu.api.session import TpuSession as JaxSession
from spark_rapids_tpu_torch.api import functions as TF
from spark_rapids_tpu_torch.api.session import TpuSession

RTOL = 1e-12
N = 400


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(21)
    arr = [None if i % 10 == 7 else
           [int(x) for x in rng.integers(0, 30, int(rng.integers(0, 5)))]
           for i in range(N)]
    words = ["ab", "c", "", "de f", "g  h"]
    return {
        "id": list(range(N)),
        "k": [int(x) for x in rng.integers(0, 12, N)],
        "v": [None if i % 9 == 2 else int(x)
              for i, x in enumerate(rng.integers(-3, 6, N))],
        "f": [float(x) for x in rng.normal(size=N)],
        "name": [None if i % 17 == 1 else words[i % 5] for i in range(N)],
        "arr": arr,
    }


@pytest.fixture(scope="module")
def sessions(data):
    js, ps = JaxSession(), TpuSession({}, device="cpu")
    yield js.create_dataframe(data), ps.create_dataframe(data), js, ps
    js.stop()
    ps.stop()


def _same(got, want):
    assert got.column_names == want.column_names
    for c in want.column_names:
        g, w = got.column(c).to_pylist(), want.column(c).to_pylist()
        if pa.types.is_floating(want.column(c).type):
            np.testing.assert_allclose(
                np.array(g, dtype=float), np.array(w, dtype=float),
                rtol=RTOL, atol=0)
        else:
            assert g == w, c


GEN_CASES = {
    "explode": lambda F, d: d.select("id", "name", F.explode("arr")),
    "explode_alias": lambda F, d: d.select(F.explode("arr").alias("e")),
    "posexplode": lambda F, d: d.select("id", F.posexplode("arr")),
    "explode_then_group": lambda F, d: d.select("k", F.explode("arr"))
    .groupBy("k").agg(F.sum("col").alias("s"), F.count("*").alias("n"))
    .orderBy("k"),
    "explode_computed": lambda F, d: d.select(
        "id", F.explode(F.sort_array("arr", False)).alias("e")),
    "explode_split": lambda F, d: d.select(
        "id", F.explode(F.split("name", " ")).alias("w")),
}

COLLECT_CASES = {
    "grouped": lambda F, d: d.groupBy("k").agg(
        F.collect_list("v").alias("l"), F.collect_set("v").alias("st"),
        F.sum("f").alias("s"), F.count("v").alias("c")).orderBy("k"),
    "keyless": lambda F, d: d.agg(F.collect_list("v").alias("l"),
                                  F.collect_set("k").alias("st")),
    "empty_keyless": lambda F, d: d.filter(F.col("id") > 10 ** 6).agg(
        F.collect_list("v").alias("l"), F.sum("f").alias("s"),
        F.count("v").alias("c")),
    "empty_grouped": lambda F, d: d.filter(F.col("id") > 10 ** 6)
    .groupBy("k").agg(F.collect_list("v").alias("l")),
    "floats": lambda F, d: d.groupBy("k").agg(
        F.collect_set("f").alias("st")).orderBy("k"),
    "then_explode": lambda F, d: d.groupBy("k").agg(
        F.collect_list("id").alias("ids")).select("k", F.explode("ids"))
    .orderBy("k", "col"),
}


@pytest.mark.parametrize("case", sorted(GEN_CASES))
def test_generate_equals_jax(case, sessions):
    jd, pd_, _, _ = sessions
    _same(GEN_CASES[case](TF, pd_).to_arrow(),
          GEN_CASES[case](JF, jd).to_arrow())


@pytest.mark.parametrize("case", sorted(COLLECT_CASES))
def test_collect_equals_jax(case, sessions):
    jd, pd_, _, _ = sessions
    _same(COLLECT_CASES[case](TF, pd_).to_arrow(),
          COLLECT_CASES[case](JF, jd).to_arrow())


def test_generate_plans(sessions):
    _, d, _, _ = sessions
    assert "TpuGenerateExec" in GEN_CASES["posexplode"](TF, d).explain()
    assert "CpuFallbackExec[Generate]" in \
        GEN_CASES["explode_split"](TF, d).explain()


def test_map_explode_equals_jax(sessions):
    _, _, js, ps = sessions
    t = pa.table({"m": pa.array([[(1, 10), (2, 20)], [], [(3, 30)],
                                 [(2, 99)]],
                                type=pa.map_(pa.int64(), pa.int64())),
                  "v": [1, 2, 3, 4]})

    def build(F, s):
        return s.create_dataframe(t).select(F.explode(F.col("m")), "v")
    _same(build(TF, ps).to_arrow(), build(JF, js).to_arrow())


def test_collect_over_batches(sessions):
    _, _, js, ps = sessions

    def build(F, s):
        d1 = s.create_dataframe({"k": [1, 2], "v": [10, 20]})
        d2 = s.create_dataframe({"k": [1, 2], "v": [30, 40]})
        return d1.union(d2).groupBy("k").agg(
            F.collect_list("v").alias("l")).orderBy("k")
    _same(build(TF, ps).to_arrow(), build(JF, js).to_arrow())


def test_collect_by_string_key(sessions, data):
    """Grouped by a string key, against Python: the JAX package's
    single pass groups string keys wrongly (rows of one key land in
    several groups), so the port is held to Python's grouping here."""
    _, d, _, _ = sessions
    out = d.filter(TF.col("name").isNotNull()).groupBy("name").agg(
        TF.collect_list("id").alias("ids"),
        TF.collect_set("k").alias("ks")).orderBy("name").to_arrow()
    want = {}
    for i, name, k in zip(data["id"], data["name"], data["k"]):
        if name is not None:
            want.setdefault(name, ([], set()))
            want[name][0].append(i)
            want[name][1].add(k)
    names = sorted(want)
    assert out.column("name").to_pylist() == names
    assert out.column("ids").to_pylist() == [want[n][0] for n in names]
    assert out.column("ks").to_pylist() == [sorted(want[n][1])
                                            for n in names]


def test_collect_set_null_lane():
    """A null row's value lane (zero) must not hide a real 0."""
    s = TpuSession({}, device="cpu")
    out = s.create_dataframe({"k": [1, 1], "v": [None, 0]}).groupBy("k") \
        .agg(TF.collect_set("v").alias("s")).to_arrow()
    assert out.column("s").to_pylist() == [[0]]


def test_collect_beside_string_min_falls_back(sessions):
    _, _, js, ps = sessions
    rows = {"k": [0, 0, 1, 1], "x": [1, 2, 3, 3], "s": ["b", "a", "c", "d"]}

    def build(F, s):
        return s.create_dataframe(rows).groupBy("k").agg(
            F.collect_list("x").alias("xs"), F.collect_set("x").alias("st"),
            F.min("s").alias("lo"), F.count("*").alias("n")).orderBy("k")
    q = build(TF, ps)
    assert "CpuFallbackExec[Aggregate]" in q.explain()
    _same(q.to_arrow(), build(JF, js).to_arrow())


def test_explode_name_collision_raises(sessions):
    _, _, _, ps = sessions
    d = ps.create_dataframe({"col": [1, 2], "a": [[1], [2]]})
    with pytest.raises(ValueError, match="collide"):
        d.select("col", TF.explode("a"))


def test_explode_of_non_array_falls_back_and_raises(sessions):
    _, _, _, ps = sessions
    d = ps.create_dataframe({"x": [1, 2]})
    q = d.select(TF.explode("x"))
    assert "explode needs an array column" in q.explain()
