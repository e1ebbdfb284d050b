"""Structs and maps in the PyTorch port against the JAX package, on the
CPU.

The port's ``columnar/nested.py`` is a copy of the JAX package's: both
shred the same arrow tables into the same flat columns and assemble them
back alike.  Through the DataFrame API, struct field access
(``getField``, ``[]``, a filter and a sort on a field, a whole struct
through a sort, ``struct()`` and a field of it) and the map functions
(``map_keys``, ``map_values``, ``size``, ``element_at``, ``m[k]``, a
per-row key, ``create_map``, a map through a filter) give the JAX
package's answers exactly.  A parquet file with an array, a struct (one
field a map) and a map column goes through the port's writer and reader
and comes back equal, on the device path and through the CPU fallback's
scan.  Every struct and map expression class has a planner rule.
"""

import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from spark_rapids_tpu.api import functions as JF
from spark_rapids_tpu.api.session import TpuSession as JaxSession
from spark_rapids_tpu.columnar import nested as JN
from spark_rapids_tpu_torch.api import functions as TF
from spark_rapids_tpu_torch.api.session import TpuSession
from spark_rapids_tpu_torch.columnar import nested as TN


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def struct_table(n=200, seed=3):
    rng = np.random.default_rng(seed)
    a = rng.integers(-50, 50, n)
    b = rng.normal(size=n)
    rows = [None if i % 9 == 4 else {"a": int(a[i]), "b": float(b[i]),
                                     "c": {"d": int(i)}}
            for i in range(n)]
    return pa.table({"s": pa.array(rows), "v": rng.normal(size=n),
                     "k": rng.integers(0, 5, n)})


def map_table(n=200, seed=4):
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        keys = rng.choice(8, int(rng.integers(0, 5)), replace=False)
        rows.append([(int(k), int(rng.integers(-100, 100))) for k in keys])
    return pa.table({"m": pa.array(rows, type=pa.map_(pa.int64(),
                                                     pa.int64())),
                     "v": rng.integers(0, 8, n)})


@pytest.fixture(scope="module")
def sessions():
    js, ps = JaxSession(), TpuSession({}, device="cpu")
    yield js, ps
    js.stop()
    ps.stop()


@pytest.mark.parametrize("make", [struct_table, map_table],
                         ids=["struct", "map"])
def test_shred_and_assemble_equal_jax(make):
    t = make()
    flat = TN.shred_table(t)
    assert flat.equals(JN.shred_table(t))
    assert TN.assemble_table(flat).equals(JN.assemble_table(flat))
    assert TN.assemble_table(flat).column(0).to_pylist() == [
        r if r is not None else
        {"a": None, "b": None, "c": {"d": None}}
        for r in t.column(0).to_pylist()] if make is struct_table else \
        t.column(0).to_pylist()


STRUCT_CASES = {
    "get_field": lambda F, d: d.select(
        F.col("s").getField("a").alias("a"), "v"),
    "nested_field": lambda F, d: d.select(
        F.col("s").getField("c").getField("d").alias("d")),
    "getitem_field": lambda F, d: d.select(F.col("s")["b"].alias("b")),
    "filter_on_field": lambda F, d: d.filter(
        F.col("s").getField("a") >= 10).select("v"),
    "whole_struct": lambda F, d: d.select("s", "v"),
    "struct_through_sort": lambda F, d: d.filter(F.col("v") > 0)
    .orderBy(F.col("v").desc()).select("s", "v"),
    "sort_on_field": lambda F, d: d.filter(F.col("s").getField("a") > 0)
    .orderBy(F.col("s").getField("a"), F.col("v")).select("s"),
    "create_struct": lambda F, d: d.select(
        F.struct("k", (F.col("v") * 2).alias("w")).alias("st")),
    "field_of_created": lambda F, d: d.select(
        F.struct((F.col("k") * 3).alias("t")).getField("t").alias("t3")),
    "group_by_field": lambda F, d: d.groupBy(
        F.col("s").getField("a").alias("a")).agg(F.count("*").alias("n"))
    .orderBy("a"),
}

MAP_CASES = {
    "keys_values_size": lambda F, d: d.select(
        F.map_keys(F.col("m")).alias("k"),
        F.map_values(F.col("m")).alias("w"), F.size(F.col("m")).alias("n")),
    "element_at": lambda F, d: d.select(
        F.element_at(F.col("m"), 2).alias("got")),
    "getitem_is_lookup": lambda F, d: d.select(F.col("m")[3].alias("got")),
    "per_row_key": lambda F, d: d.select(
        F.get_map_value(F.col("m"), F.col("v")).alias("got")),
    "float_probe_misses": lambda F, d: d.select(
        F.get_map_value(F.col("m"), F.lit(2.5)).alias("got")),
    "through_filter": lambda F, d: d.filter(F.col("v") <= 3),
    "create_map": lambda F, d: d.select(F.create_map(
        F.col("v"), F.col("v") * 10, F.lit(99), F.lit(1)).alias("mm")),
}


def _arrow(build, F, session, table):
    return build(F, session.create_dataframe(table)).to_arrow()


@pytest.mark.parametrize("case", sorted(STRUCT_CASES))
def test_struct_equals_jax(case, sessions):
    js, ps = sessions
    want = _arrow(STRUCT_CASES[case], JF, js, struct_table())
    got = _arrow(STRUCT_CASES[case], TF, ps, struct_table())
    assert got.to_pylist() == want.to_pylist()


@pytest.mark.parametrize("case", sorted(MAP_CASES))
def test_map_equals_jax(case, sessions):
    js, ps = sessions
    want = _arrow(MAP_CASES[case], JF, js, map_table())
    got = _arrow(MAP_CASES[case], TF, ps, map_table())
    assert got.to_pylist() == want.to_pylist()


def test_struct_field_stays_on_device(sessions):
    _, ps = sessions
    a = TF.col("s").getField("a")
    q = ps.create_dataframe(struct_table()).filter(a > 0) \
        .select(a.alias("a"))
    assert "CpuFallbackExec" not in q.explain()


def test_reserved_and_refused(sessions):
    _, ps = sessions
    with pytest.raises(ValueError, match="reserved"):
        ps.create_dataframe(pd.DataFrame({"a.b": [1, 2]}))
    t = pa.table({"m": pa.array([[("k", 1)]],
                                type=pa.map_(pa.string(), pa.int64()))})
    with pytest.raises(ValueError, match="fixed-width"):
        ps.create_dataframe(t)
    d = ps.create_dataframe({"x": [1, 2]})
    with pytest.raises(ValueError, match="fixed-width"):
        d.select(TF.create_map(TF.lit("a"), TF.col("x")).alias("m"))
    with pytest.raises(KeyError, match="shredded struct"):
        ps.create_dataframe(struct_table()).filter(TF.col("s") > 1)
    with pytest.raises(ValueError, match="ambiguous"):
        TN.assemble_table(pa.table({"s": [1, 2], "s.a": [3, 4]}))


def test_nested_rules_registered():
    from spark_rapids_tpu_torch.ops import collections_ops as C
    from spark_rapids_tpu_torch.ops import datetime_ops as D
    from spark_rapids_tpu_torch.ops import json_ops as J
    from spark_rapids_tpu_torch.ops import nested_ops as NO
    from spark_rapids_tpu_torch.plan.overrides import (
        _EXPR_RULES, valid_op_names)
    classes = (NO.GetStructField, NO.CreateNamedStruct, NO.CreateMap,
               NO.MapKeys, NO.MapValues, NO.GetMapValue, C.CreateArray,
               C.Size, C.ArrayContains, C.GetArrayItem, C.ElementAt,
               C.SortArray, C.ArrayMin, C.ArrayMax, C.Reverse, C.Slice,
               C.ArrayRepeat, D.TimeWindow, J.GetJsonObject, J.StringSplit)
    for cls in classes:
        assert cls in _EXPR_RULES, cls.__name__
        assert cls.__name__ in valid_op_names()
    assert "Generate" in valid_op_names()


def test_expression_switch_sends_node_to_cpu(sessions):
    s = TpuSession({"spark.rapids.sql.expression.GetMapValue": "false"},
                   device="cpu")
    q = s.create_dataframe(map_table()).select(
        TF.element_at(TF.col("m"), 2).alias("got"))
    assert q.explain().splitlines()[0] == "CpuFallbackExec[Project]"
    js, _ = sessions
    want = _arrow(MAP_CASES["element_at"], JF, js, map_table())
    assert q.to_arrow().to_pylist() == want.to_pylist()


def _nested_file_table(n=4096, seed=9):
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, 5, n)
    arr = [None if i % 13 == 0 else [int(x) for x in rng.integers(0, 99, k)]
           for i, k in enumerate(lens)]
    st = [{"x": int(i), "y": float(rng.normal()),
           "m": [(1, int(i)), (2, int(-i))]} for i in range(n)]
    mp = [[(int(k), float(k) / 2) for k in range(int(lens[i]))]
          for i in range(n)]
    return pa.table({
        "id": np.arange(n, dtype=np.int64), "arr": pa.array(arr),
        "st": pa.array(st, type=pa.struct(
            [("x", pa.int64()), ("y", pa.float64()),
             ("m", pa.map_(pa.int64(), pa.int64()))])),
        "mp": pa.array(mp, type=pa.map_(pa.int64(), pa.float64()))})


@pytest.mark.parametrize("conf", [{}, {
    "spark.rapids.sql.format.parquet.read.enabled": "false"}],
    ids=["device_scan", "cpu_scan"])
def test_parquet_round_trip(tmp_path, conf):
    t = _nested_file_table()
    s = TpuSession(conf, device="cpu")
    out = str(tmp_path / "nested")
    s.create_dataframe(t).write.parquet(out)
    back = s.read.parquet(out)
    assert [n for n, _ in back.schema][:3] == ["id", "arr", "st.x"]
    got = back.orderBy("id").to_arrow()
    assert got.to_pylist() == t.to_pylist()
    # pyarrow reads what the port wrote as the same nested table
    assert pq.read_table(out).sort_by("id").to_pylist() == t.to_pylist()
    # a pruned read decodes only the columns the query reads
    sel = back.select(TF.col("st").getField("y").alias("y"), "id") \
        .orderBy("id").to_arrow()
    assert sel.column("y").to_pylist() == [r["y"] for r in
                                           t.column("st").to_pylist()]
