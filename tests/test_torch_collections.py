"""The array type and the collection expressions of the PyTorch port
against the JAX package, on the CPU.

The same numpy-seeded array columns (a few hundred rows, arrays of 0 to
6 elements, some rows null) go through both packages' DataFrame API:
every collection expression (``size``, ``element_at``, ``getItem``,
``array_contains``, ``sort_array`` both ways, ``array_min`` /
``array_max`` over integers and over floats with NaN and -0.0,
``reverse``, ``slice``, ``array_repeat``, ``array()``) must equal the
JAX package's answer exactly (integers, array contents and order, row
order; NaN in the same places), and the array columns survive a filter,
a union, a concatenation and the spill catalog's disk tier.  Where the
JAX package departs from Spark the test holds the port to Spark's rule
and says why (``array_contains`` of a null value).
"""

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.api import functions as JF
from spark_rapids_tpu.api.session import TpuSession as JaxSession
from spark_rapids_tpu_torch.api import functions as TF
from spark_rapids_tpu_torch.api.session import TpuSession
from spark_rapids_tpu_torch.columnar import dtypes as tdts
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.columnar.column import Column

ROWS = 300


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _arrays(rng, n, gen, null_every=7):
    out = []
    for i in range(n):
        if i % null_every == 3:
            out.append(None)
        else:
            out.append(gen(int(rng.integers(0, 7))))
    return out


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(11)
    ints = _arrays(rng, ROWS, lambda k: [int(x) for x in
                                         rng.integers(-20, 20, k)])
    special = [np.nan, -0.0, 0.0, 1.5, -2.25, np.inf]

    def floats(k):
        return [float(special[j]) if rng.random() < 0.3 else
                float(rng.normal()) for j in rng.integers(0, 6, k)]
    return {"id": list(range(ROWS)), "a": ints,
            "f": _arrays(rng, ROWS, floats, null_every=11),
            "x": [int(v) for v in rng.integers(-5, 5, ROWS)]}


@pytest.fixture(scope="module")
def sessions(data):
    js, ps = JaxSession(), TpuSession({}, device="cpu")
    yield js.create_dataframe(data), ps.create_dataframe(data)
    js.stop()
    ps.stop()


def _rows(table):
    """Rows as Python values with NaN made comparable."""
    def norm(v):
        if isinstance(v, float) and np.isnan(v):
            return "NaN"
        if isinstance(v, float) and v == 0.0:
            return ("zero", np.copysign(1.0, v))
        if isinstance(v, list):
            return [norm(x) for x in v]
        return v
    return {c: [norm(v) for v in table.column(c).to_pylist()]
            for c in table.column_names}


def both(sessions, build):
    jdf, pdf = sessions
    return (_rows(build(JF, jdf).to_arrow()),
            _rows(build(TF, pdf).to_arrow()))


CASES = {
    "size": lambda F, d: d.select("id", F.size("a").alias("o")),
    "element_at_first": lambda F, d: d.select(
        "id", F.element_at("a", 1).alias("o")),
    "element_at_last": lambda F, d: d.select(
        "id", F.element_at("a", -2).alias("o")),
    "get_item": lambda F, d: d.select("id", F.col("a")[2].alias("o")),
    "get_array_item": lambda F, d: d.select(
        "id", F.get_array_item("a", 0).alias("o")),
    "sort_array_asc": lambda F, d: d.select(
        "id", F.sort_array("a").alias("o")),
    "sort_array_desc": lambda F, d: d.select(
        "id", F.sort_array("a", False).alias("o")),
    "sort_array_floats": lambda F, d: d.select(
        "id", F.sort_array("f").alias("o"),
        F.sort_array("f", False).alias("p")),
    "array_min_max": lambda F, d: d.select(
        "id", F.array_min("a").alias("lo"), F.array_max("a").alias("hi")),
    "array_min_max_floats": lambda F, d: d.select(
        "id", F.array_min("f").alias("lo"), F.array_max("f").alias("hi")),
    "reverse": lambda F, d: d.select("id", F.reverse("a").alias("o")),
    "slice_positive": lambda F, d: d.select(
        "id", F.slice("a", 2, 3).alias("o")),
    "slice_negative": lambda F, d: d.select(
        "id", F.slice("a", -3, 2).alias("o")),
    "array_repeat": lambda F, d: d.select(
        "id", F.array_repeat("x", 3).alias("o")),
    "array_of_columns": lambda F, d: d.select(
        "id", F.array(F.col("id"), F.col("x"), F.lit(7)).alias("o")),
    "array_contains": lambda F, d: d.select(
        "id", F.array_contains("a", 5).alias("o")),
    "filter_then_arrays": lambda F, d: d.filter(F.col("x") > 0).select(
        "id", "a", "f"),
    "union_of_arrays": lambda F, d: d.select("a").union(d.select("a")),
    "nested_calls": lambda F, d: d.select(
        "id", F.size(F.slice(F.sort_array("a", False), 1, 2)).alias("o"),
        F.element_at(F.reverse("a"), 1).alias("p")),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_collection_expression_equals_jax(case, sessions):
    want, got = both(sessions, CASES[case])
    assert got == want


def test_array_column_roundtrip(data):
    s = TpuSession({}, device="cpu")
    got = s.create_dataframe(data).select("a").to_arrow()
    assert got.column("a").to_pylist() == data["a"]
    assert got.schema.field("a").type == pa.list_(pa.int64())


def test_array_contains_null_value_is_null(sessions):
    """Spark: array_contains(arr, NULL) is null.  The JAX package reads
    only the array's validity and answers False, so the port is held to
    Spark's rule here."""
    _, d = sessions
    out = d.select(TF.array_contains("a", TF.lit(None, tdts.INT64))
                   .alias("o")).to_arrow().column("o").to_pylist()
    assert out == [None] * ROWS


def test_non_array_argument_is_a_type_error():
    s = TpuSession({}, device="cpu")
    d = s.create_dataframe({"t": ["ab", "c"]})
    with pytest.raises(TypeError, match="Size needs an array"):
        d.select(TF.size("t"))


def test_null_element_raises():
    """A null element has no device representation (the JAX package's
    CPU fallback raises on it too)."""
    s = TpuSession({}, device="cpu")
    d = s.create_dataframe({"x": [1, None, 3]})
    with pytest.raises(ValueError, match="null"):
        d.select(TF.array("x").alias("o")).collect()


def test_arrays_gather_concat_and_spill(data, tmp_path):
    from spark_rapids_tpu_torch.memory.spill import SpillableBatchCatalog
    from spark_rapids_tpu_torch.ops.concat import concat_batches
    col = Column.from_arrays(data["a"], tdts.INT64)
    batch = ColumnarBatch({"a": col, "x": Column.from_numpy(
        np.asarray(data["x"]))}, ROWS)
    both_ = concat_batches([batch, batch])
    assert both_.to_arrow().column("a").to_pylist() == data["a"] * 2
    cat = SpillableBatchCatalog(device_budget=1, host_budget=1,
                                spill_dir=str(tmp_path))
    h = cat.register(batch)
    assert h.tier == "DISK"
    assert h.materialize().column("a").to_pylist() == data["a"]
    h.close()


def test_offsets_bound_names_the_column(monkeypatch):
    from spark_rapids_tpu_torch.columnar import column as C
    monkeypatch.setattr(C, "OFFSETS_LIMIT", 4)
    t = pa.table({"big": pa.array([[1, 2], [3, 4, 5]])})
    with pytest.raises(ValueError, match="'big'.*int32 offsets"):
        ColumnarBatch.from_arrow(t)


def test_array_sort_key_falls_back():
    s = TpuSession({}, device="cpu")
    d = s.create_dataframe({"a": [[2], [1]], "k": [1, 2]})
    assert "CpuFallbackExec" in d.groupBy("a").count().explain()
    assert "array group-by keys" in s.overrides.last_explain


def test_array_functions_stay_on_device(sessions):
    _, d = sessions
    for name in ("array_min_max", "reverse", "sort_array_asc", "size",
                 "slice_positive", "array_contains"):
        assert "CpuFallbackExec" not in CASES[name](TF, d).explain()
