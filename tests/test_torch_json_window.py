"""Time windows, ``get_json_object``, ``split`` to an array and the SQL
names of the nested functions in the PyTorch port, against the JAX
package on the CPU.

* ``window()``: tumbling and sliding windows (with a start offset) over
  timestamps and dates, grouped and summed, equal the JAX package's
  (start, end) structs, counts and sums exactly (the sums are of
  integers).
* ``get_json_object`` (fields, nested fields, array indexes, a string
  value, a non-string value as JSON text, a missing path, bad JSON, a
  null) and ``split`` to an ``array<string>`` run in the CPU fallback and
  equal the JAX package's answers.
* Every SQL function the port's front end took out of its unported list
  resolves, and so do ``collect_list`` / ``collect_set``: the answers
  equal the JAX package's where its resolver runs the statement.  Struct
  field access, the map functions over a map column and GROUP BY
  window(...) in SQL are held to the DataFrame forms: the JAX resolver
  fails on all three (``ROADMAP.md`` queue 3).
* A plan with an array column or an explode runs on one device of a
  sharded session, with its reason on ``last_dist_explain``.
"""

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.api import functions as JF
from spark_rapids_tpu.api.session import TpuSession as JaxSession
from spark_rapids_tpu_torch.api import functions as TF
from spark_rapids_tpu_torch.api.session import TpuSession

N = 500


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def table():
    rng = np.random.default_rng(31)
    base = np.datetime64("2024-03-01T00:00:00", "us")
    ts = base + rng.integers(0, 40 * 86_400_000_000, N).astype(
        "timedelta64[us]")
    days = (ts.astype("datetime64[D]") - np.datetime64("1970-01-01", "D")
            ).astype(np.int32)
    docs = [None if i % 23 == 5 else "{not json" if i % 29 == 3 else
            f'{{"id":{i},"tag":"t{i % 4}","n":{{"x":{i % 7}}},'
            f'"xs":[{i},{i + 1}],"ok":{str(i % 2 == 0).lower()}}}'
            for i in range(N)]
    words = ["a b", "c", "", "d  e", "f,g h"]
    return pa.table({
        "ts": pa.array(ts, pa.timestamp("us", tz="UTC")),
        "d": pa.array(days, pa.date32()),
        "q": rng.integers(1, 50, N), "doc": docs,
        "text": [None if i % 19 == 2 else words[i % 5] for i in range(N)],
        "arr": [[int(x) for x in rng.integers(0, 9, 3)] for _ in range(N)],
        "k": rng.integers(0, 6, N)})


@pytest.fixture(scope="module")
def sessions(table):
    js, ps = JaxSession(), TpuSession({}, device="cpu")
    jd, pd_ = js.create_dataframe(table), ps.create_dataframe(table)
    jd.createOrReplaceTempView("t")
    pd_.createOrReplaceTempView("t")
    yield js, ps, jd, pd_
    js.stop()
    ps.stop()


def _windowed(F, d, col, *durations, start=None):
    w = F.window(col, *durations) if start is None else \
        F.window(col, *durations, start_time=start)
    return d.groupBy(w).agg(F.sum("q").alias("s"),
                            F.count("*").alias("n")).orderBy("window.start")


WINDOW_CASES = {
    "tumbling": ("ts", ("1 day",), None),
    "tumbling_hours_offset": ("ts", ("6 hours",), "90 minutes"),
    "sliding": ("ts", ("3 days", "1 day"), None),
    "sliding_uneven": ("ts", ("10 days", "3 days"), "2 hours"),
    "tumbling_dates": ("d", ("1 week",), None),
}


@pytest.mark.parametrize("case", sorted(WINDOW_CASES))
def test_window_equals_jax(case, sessions):
    _, _, jd, pd_ = sessions
    col, durations, start = WINDOW_CASES[case]
    want = _windowed(JF, jd, col, *durations, start=start).to_arrow()
    got = _windowed(TF, pd_, col, *durations, start=start).to_arrow()
    assert got.to_pylist() == want.to_pylist()
    assert "CpuFallbackExec" not in _windowed(
        TF, pd_, col, *durations, start=start).explain()


JSON_PATHS = ["$.id", "$.tag", "$.n.x", "$.n", "$.xs[1]", "$.xs", "$.ok",
              "$.missing", "$['tag']", "bad path"]


def test_get_json_object_equals_jax(sessions):
    _, _, jd, pd_ = sessions

    def build(F, d):
        return d.select(*[F.get_json_object("doc", p).alias(f"p{i}")
                          for i, p in enumerate(JSON_PATHS)])
    q = build(TF, pd_)
    assert q.explain().splitlines()[0] == "CpuFallbackExec[Project]"
    assert q.to_arrow().to_pylist() == build(JF, jd).to_arrow().to_pylist()


def test_split_to_array_equals_jax(sessions):
    _, _, jd, pd_ = sessions

    def build(F, d):
        return d.select("k", F.split("text", " ").alias("parts"),
                        F.split("text", ",| ", 2).alias("two"))
    assert build(TF, pd_).to_arrow().to_pylist() == \
        build(JF, jd).to_arrow().to_pylist()


def test_split_array_between_fallback_nodes(sessions):
    """An array<string> made by one fallback node and read by another
    travels as host-table codes; every node that reads it is tagged."""
    _, _, jd, pd_ = sessions

    def build(F, d):
        return d.select("k", F.split("text", " ").alias("p")) \
            .filter(F.col("k") > 2).select(F.size("p").alias("n"), "p")
    q = build(TF, pd_)
    assert "array<string>" in (q.explain() or "")
    assert q.to_arrow().to_pylist() == build(JF, jd).to_arrow().to_pylist()


SQL_CASES = [
    "SELECT size(arr) AS a, element_at(arr, 2) AS b, array_min(arr) AS c,"
    " array_max(arr) AS e, reverse(arr) AS f, slice(arr, 2, 2) AS g,"
    " array_repeat(k, 2) AS h, array(k, q) AS i FROM t",
    "SELECT k, collect_list(q) AS l, collect_set(q) AS s FROM t "
    "GROUP BY k ORDER BY k",
    "SELECT get_json_object(doc, '$.tag') AS tag, split(text, ' ') AS p "
    "FROM t",
    "SELECT struct(k, q) AS st FROM t",
]


@pytest.mark.parametrize("text", SQL_CASES)
def test_sql_names_equal_jax(text, sessions):
    js, ps, _, _ = sessions
    assert ps.sql(text).to_arrow().to_pylist() == \
        js.sql(text).to_arrow().to_pylist()


def test_sql_struct_map_fields_and_window(sessions):
    """Struct field access over a subquery's struct, the map functions
    over a map column and GROUP BY window(...): the JAX resolver fails on
    all three (it knows no shredded column by its name), so the port's
    SQL is held to its own DataFrame forms."""
    _, ps, _, pd_ = sessions
    maps = ps.create_dataframe(pa.table({"m": pa.array(
        [[(1, 2), (3, 4)], [], [(1, 9)]],
        type=pa.map_(pa.int64(), pa.int64()))}))
    maps.createOrReplaceTempView("maps")
    got = ps.sql("SELECT map_keys(m) AS ks, map_values(m) AS vs, "
                 "size(m) AS n, element_at(m, 1) AS one FROM maps")
    want = maps.select(TF.map_keys("m").alias("ks"),
                       TF.map_values("m").alias("vs"),
                       TF.size("m").alias("n"),
                       TF.element_at("m", 1).alias("one"))
    assert got.to_arrow().to_pylist() == want.to_arrow().to_pylist() == [
        {"ks": [1, 3], "vs": [2, 4], "n": 2, "one": 2},
        {"ks": [], "vs": [], "n": 0, "one": None},
        {"ks": [1], "vs": [9], "n": 1, "one": 9}]
    got = ps.sql("SELECT st.k AS k, st.q AS q FROM (SELECT struct(k, q) "
                 "AS st FROM t) x WHERE st.q > 25 ORDER BY st.k, st.q")
    want = pd_.select(TF.struct("k", "q").alias("st")) \
        .filter(TF.col("st").getField("q") > 25) \
        .select(TF.col("st").getField("k").alias("k"),
                TF.col("st").getField("q").alias("q")).orderBy("k", "q")
    assert got.to_arrow().to_pylist() == want.to_arrow().to_pylist()
    for dur in ("'2 days'", "'4 days', '1 day'"):
        got = ps.sql(f"SELECT * FROM (SELECT window(ts, {dur}) AS window, "
                     f"sum(q) AS s, count(*) AS n FROM t "
                     f"GROUP BY window(ts, {dur})) x ORDER BY window.start")
        want = _windowed(TF, pd_, "ts", *[x.strip(" '") for x in
                                          dur.split(",")])
        assert got.to_arrow().to_pylist() == want.to_arrow().to_pylist()


def test_nested_plans_stay_on_one_device(table):
    s = TpuSession({"spark.rapids.sql.distributed.numShards": 8},
                   device="cpu")
    d = s.create_dataframe(table)
    one = TpuSession({}, device="cpu").create_dataframe(table)
    for build in (lambda F, x: x.select("k", F.explode("arr")),
                  lambda F, x: x.groupBy("k").agg(
                      F.collect_list("q").alias("l")).orderBy("k")):
        got = build(TF, d).to_arrow()
        assert s.last_dist_explain.startswith("fallback: ") and \
            "runs on one device" in s.last_dist_explain
        assert got.equals(build(TF, one).to_arrow())
    d.groupBy("k").agg(TF.sum("q").alias("s")).collect()
    assert s.last_dist_explain == "distributed"
