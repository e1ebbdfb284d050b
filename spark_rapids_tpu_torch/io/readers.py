"""File scans (parquet, ORC, CSV) with column pruning and filter pushdown.

Counterpart of ``spark_rapids_tpu/io/readers.py``.  The host side
(pyarrow) reads footers, prunes row groups by the pushed filter, applies
that filter exactly, discovers hive partition values and decodes to host
Arrow tables; ``ColumnarBatch.from_arrow`` then uploads each table to the
session's device through pinned staging buffers.  The multi-file
strategies live in ``multifile.py``.

Pushdown: the supported parts of the filters above a scan translate to
pyarrow expressions (``to_arrow_filter``); the engine's own filter still
runs above the scan on the device.  Columns a query does not read are
not decoded: the scan emits them as all-null placeholders, so the
relation's column positions stay valid for bound references.

Each scan counts the host time it waited for decoded tables
(``decodeTime``), the host time of their uploads (``uploadTime``: staging
copies and enqueued device copies) and the bytes arrow decoded
(``bytesDecoded``).
"""

from __future__ import annotations

import math
import os
import time
from typing import Iterator, List, Optional

import torch

from spark_rapids_tpu_torch.columnar import dtypes as dts
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.columnar.column import Column
from spark_rapids_tpu_torch.exec.base import (
    BYTES_DECODED, DECODE_TIME, NUM_INPUT_BATCHES, UPLOAD_TIME, Schema,
    TpuExec)
from spark_rapids_tpu_torch.ops import predicates as P
from spark_rapids_tpu_torch.ops.expressions import (
    BoundReference, Expression, Literal, UnresolvedColumn)
from spark_rapids_tpu_torch.plan.logical import FileRelation

META_COLUMN_NAMES = frozenset(
    (FileRelation.INPUT_FILE_COL,) + FileRelation.META_COLUMNS)


def _dataset(paths, file_format):
    import pyarrow.dataset as ds
    fmt = ds.CsvFileFormat() if file_format == "csv" else file_format
    # a single path may be a directory (a hive-partitioned dataset root);
    # pyarrow takes a directory only as a bare string
    src = paths[0] if len(paths) == 1 else paths
    return ds.dataset(src, format=fmt, partitioning="hive")


def scan_input_meta(paths: List[str]) -> List[tuple]:
    """Sorted ``(path, size_bytes, mtime_ns)`` triples of a scan's files,
    without opening one: the identity of what a FileRelation reads
    (``robustness/checkpoint.input_fingerprint``).  Appending a file, a
    new size or a same-size rewrite (which only the mtime shows) changes
    it; a path that cannot be statted reads (-1, -1), so a vanished file
    changes it too."""
    def stat(p):
        try:
            st = os.stat(p)
            return (p, st.st_size, st.st_mtime_ns)
        except OSError:
            return (p, -1, -1)

    out = []
    for p in paths:
        if os.path.isdir(p):
            # a partitioned table's root: its file set is the input
            for root, _dirs, names in sorted(os.walk(p)):
                out.extend(stat(os.path.join(root, name))
                           for name in sorted(names))
            continue
        out.append(stat(p))
    return sorted(out)


def input_signature(meta: List[tuple]) -> str:
    """The one string form of a ``scan_input_meta`` result."""
    return ";".join(f"{p}={s}@{m}" for p, s, m in meta)


def infer_file_schema(paths: List[str], file_format: str) -> Schema:
    """The files' columns under the port's types, struct and map columns
    shredded into their flat columns (``columnar/nested.py``); an arrow
    type the port does not carry raises naming it."""
    dataset = _dataset(paths, file_format)
    out: Schema = []
    for f in dataset.schema:
        out.extend(_flat_fields(f.name, dts.from_arrow_type(f.type)))
    return out


def _flat_fields(name: str, dt) -> Schema:
    """A column's shredded (name, type) pairs."""
    from spark_rapids_tpu_torch.columnar.nested import (
        MAP_KEY_SUFFIX, MAP_VALUE_SUFFIX)
    if dt.is_struct:
        return [p for fn, ft in dt.fields
                for p in _flat_fields(f"{name}.{fn}", ft)]
    if dt.is_map:
        return [(name + MAP_KEY_SUFFIX, dts.ArrayType(dt.key_type)),
                (name + MAP_VALUE_SUFFIX, dts.ArrayType(dt.value_type))]
    return [(name, dt)]


def _file_column(name: str) -> str:
    """The top-level file column a flat column comes from (a struct field
    or a map half shreds from its column)."""
    return name.split(".", 1)[0]


def _column_name(e: Expression) -> Optional[str]:
    if isinstance(e, BoundReference):
        return e.name
    if isinstance(e, UnresolvedColumn):
        return e.col_name
    return None


def _arrow_literal(value, lit_dtype, col_dtype):
    """The pyarrow scalar value a column of ``col_dtype`` compares with,
    or None when the pair is left to the engine: a null, a NaN, a
    timestamp (arrow refuses to compare zoned and naive timestamps), or
    kinds that arrow would compare otherwise than the engine."""
    import datetime
    import numpy as np
    if value is None:
        return None
    if col_dtype.is_string:
        return value if lit_dtype.is_string else None
    if col_dtype.is_boolean:
        return bool(value) if lit_dtype.is_boolean else None
    if col_dtype.is_date:
        if not lit_dtype.is_date:
            return None
        if isinstance(value, (int, np.integer)):
            return datetime.date(1970, 1, 1) + datetime.timedelta(
                days=int(value))
        return value if isinstance(value, datetime.date) and \
            not isinstance(value, datetime.datetime) else None
    if col_dtype.is_integral or col_dtype.is_floating:
        if not (lit_dtype.is_integral or lit_dtype.is_floating):
            return None
        if isinstance(value, (float, np.floating)):
            return None if math.isnan(value) else float(value)
        return int(value)
    return None


def _decimal_compare(f, method: str, lit_e, col_dtype):
    """A decimal column's comparison with a literal as an arrow filter
    that keeps every row the engine keeps.  An integer or decimal literal
    compares exactly, as the engine compares it (both rescale to one
    decimal).  A float literal meets the column as a double, which arrow
    may round otherwise than the engine's ``v / 10^s``: the filter then
    compares with a decimal bound moved outward past any rounding (one
    unit of the column's scale, or 2^-50 of the literal, whichever is
    larger), and the engine's filter above decides the rows near it."""
    import decimal
    import pyarrow as pa
    if not isinstance(lit_e, Literal) or lit_e.value is None:
        return None
    value, ldt = lit_e.value, lit_e.dtype
    if ldt.is_integral or ldt.is_decimal:
        return getattr(f, method)(pa.scalar(decimal.Decimal(value)))
    if not ldt.is_floating or not math.isfinite(value) or \
            abs(value) >= 1e18:
        return None
    x = decimal.Decimal(float(value))
    unit = decimal.Decimal(1).scaleb(-col_dtype.scale)
    slack = max(unit, abs(x) * decimal.Decimal(2) ** -50)
    at = pa.decimal128(38, col_dtype.scale)
    lo = pa.scalar((x - slack).quantize(unit, decimal.ROUND_FLOOR), at)
    hi = pa.scalar((x + slack).quantize(unit, decimal.ROUND_CEILING), at)
    if method in ("__gt__", "__ge__"):
        return f >= lo
    if method in ("__lt__", "__le__"):
        return f <= hi
    return (f >= lo) & (f <= hi)


def to_arrow_filter(expr: Expression, file_columns=None):
    """Translate a predicate to a pyarrow expression, or None when no
    part of it translates.  A conjunct that does not translate drops out
    of an AND (the engine's filter above still applies it); an OR needs
    both sides.  ``file_columns``: the names the files hold (partition
    columns included); other names never translate.

    Float comparisons keep the engine's NaN order (NaN is the largest
    value and equals itself): ``>`` and ``>=`` also pass a NaN row."""
    import pyarrow.dataset as ds

    def field(e):
        name = _column_name(e)
        if name is None or (file_columns is not None
                            and name not in file_columns):
            return None
        return ds.field(name)

    def lit(col_e, lit_e):
        if not isinstance(lit_e, Literal):
            return None
        return _arrow_literal(lit_e.value, lit_e.dtype, col_e.dtype)

    flip = {P.LessThan: "__gt__", P.LessThanOrEqual: "__ge__",
            P.GreaterThan: "__lt__", P.GreaterThanOrEqual: "__le__",
            P.EqualTo: "__eq__"}
    ops = {P.EqualTo: "__eq__", P.LessThan: "__lt__",
           P.LessThanOrEqual: "__le__", P.GreaterThan: "__gt__",
           P.GreaterThanOrEqual: "__ge__"}

    def compare(col_e, method, lit_e):
        f = field(col_e)
        if f is not None and col_e.dtype.is_decimal:
            return _decimal_compare(f, method, lit_e, col_e.dtype)
        v = lit(col_e, lit_e)
        if f is None or v is None:
            return None
        out = getattr(f, method)(v)
        if col_e.dtype.is_floating and method in ("__gt__", "__ge__"):
            out = out | f.is_nan()
        return out

    def rec(e):
        if isinstance(e, P.And):
            l, r = rec(e.left), rec(e.right)
            if l is None or r is None:
                return l if r is None else r
            return l & r
        if isinstance(e, P.Or):
            l, r = rec(e.left), rec(e.right)
            return (l | r) if l is not None and r is not None else None
        cls = type(e)
        if cls in ops:
            got = compare(e.left, ops[cls], e.right)
            if got is None:
                got = compare(e.right, flip[cls], e.left)
            return got
        if isinstance(e, P.IsNull):
            f = field(e.children[0])
            return f.is_null() if f is not None else None
        if isinstance(e, P.IsNotNull):
            f = field(e.children[0])
            return f.is_valid() if f is not None else None
        if isinstance(e, P.In):
            col_e = e.children[0]
            f = field(col_e)
            vals = [lit(col_e, o) for o in e.children[1:]]
            if f is not None and vals and all(v is not None for v in vals):
                return f.isin(vals)
            return None
        if isinstance(e, P.InSet):
            col_e = e.children[0]
            f = field(col_e)
            vals = [_arrow_literal(v, col_e.dtype, col_e.dtype)
                    for v in e.table.tolist()]
            if f is not None and not e.has_null and vals and \
                    all(v is not None for v in vals):
                return f.isin(vals)
            return None
        return None

    return rec(expr)


def null_column(dt, nrows: int, device) -> Column:
    """An all-null column of ``nrows`` rows made on the device: zero
    values (for strings and arrays, zero offsets and no values) under a false
    validity."""
    validity = torch.zeros(nrows, dtype=torch.bool, device=device)
    if dt.has_offsets:
        return Column(dt, torch.zeros(0, dtype=dts.torch_dtype(dt),
                                      device=device),
                      nrows, validity=validity,
                      offsets=torch.zeros(nrows + 1, dtype=torch.int32,
                                          device=device))
    return Column(dt, torch.zeros(nrows, dtype=dts.torch_dtype(dt),
                                  device=device), nrows, validity=validity)


def constant_string_column(text: str, nrows: int, device) -> Column:
    """``nrows`` copies of ``text``, repeated on the device."""
    raw = text.encode("utf-8")
    if nrows * len(raw) >= (1 << 31):
        raise ValueError("string offsets are int32: a column holds less "
                         "than 2 GiB of chars")
    one = torch.tensor(list(raw), dtype=torch.uint8, device=device)
    offsets = torch.arange(nrows + 1, dtype=torch.int32,
                           device=device) * len(raw)
    return Column(dts.STRING, one.repeat(nrows), nrows, offsets=offsets)


class TpuFileScanExec(TpuExec):
    def __init__(self, paths: List[str], file_format: str, schema: Schema,
                 device, batch_rows: int = 1 << 20,
                 columns: Optional[List[str]] = None,
                 arrow_filter=None, reader_type: str = "AUTO",
                 num_threads: int = 8, max_files_parallel: int = 4,
                 file_meta=()):
        super().__init__()
        self.paths = list(paths)
        self.file_format = file_format
        self._schema = list(schema)
        self.device = torch.device(device)
        # per-file metadata columns requested (input_file_name, the
        # _metadata fields); these never read from the files themselves
        self.file_meta = set(file_meta)
        # the columns decoded; the rest become null placeholders
        self.columns = [n for n, _ in schema
                        if (columns is None or n in columns)
                        and n not in META_COLUMN_NAMES]
        # the file columns read: a shredded column's whole top-level one
        self.read_columns = list(dict.fromkeys(
            _file_column(n) for n in self.columns))
        self.batch_rows = int(batch_rows)
        self.arrow_filter = arrow_filter
        self.reader_type = reader_type
        self.num_threads = num_threads
        self.max_files_parallel = max_files_parallel
        for name in (NUM_INPUT_BATCHES, DECODE_TIME, UPLOAD_TIME,
                     BYTES_DECODED):
            self._register_metric(name)

    @property
    def schema(self) -> Schema:
        return self._schema

    def describe(self):
        extra = ", pushdown" if self.arrow_filter is not None else ""
        return (f"TpuFileScanExec[{self.file_format}, {len(self.paths)} "
                f"files, {self.reader_type}{extra}]")

    def _upload(self, table, n: int,
                path: Optional[str] = None) -> ColumnarBatch:
        """``n`` rows of a host table as a device batch in the relation's
        column order: the decoded columns, null placeholders for the
        pruned ones, and the requested metadata columns of ``path``.
        (``n`` is given: arrow's slice of a table without columns keeps
        the slice's requested length, not its rows.)"""
        t0 = time.perf_counter_ns()
        self.metrics[BYTES_DECODED] += table.nbytes
        batch = ColumnarBatch.from_arrow(table, device=self.device)
        meta = self._meta_columns(path, n) if self.file_meta else {}
        cols = {}
        for name, dt in self._schema:
            if name in batch.columns:
                cols[name] = batch.columns[name]
            elif name in meta:
                cols[name] = meta[name]
            else:
                cols[name] = null_column(dt, n, self.device)
        self.metrics[UPLOAD_TIME] += time.perf_counter_ns() - t0
        return ColumnarBatch(cols, n)

    def _meta_columns(self, path: str, n: int) -> dict:
        cols = {}
        dev = self.device
        if "input_file" in self.file_meta:
            cols[FileRelation.INPUT_FILE_COL] = constant_string_column(
                path, n, dev)
        if "metadata" in self.file_meta:
            st = os.stat(path)
            fp, fn, fs, fm = FileRelation.META_COLUMNS
            cols[fp] = constant_string_column(os.path.abspath(path), n, dev)
            cols[fn] = constant_string_column(os.path.basename(path), n,
                                              dev)
            cols[fs] = Column(dts.INT64, torch.full(
                (n,), st.st_size, dtype=torch.int64, device=dev), n)
            cols[fm] = Column(dts.TIMESTAMP_US, torch.full(
                (n,), int(st.st_mtime * 1e6), dtype=torch.int64,
                device=dev), n)
        return cols

    def _timed(self, it):
        """``it``'s items, the host time spent waiting on each added to
        decodeTime."""
        while True:
            t0 = time.perf_counter_ns()
            item = next(it, None)
            self.metrics[DECODE_TIME] += time.perf_counter_ns() - t0
            if item is None:
                return
            yield item

    def _chunks(self, table, path=None) -> Iterator[ColumnarBatch]:
        total = table.num_rows
        for off in range(0, total, self.batch_rows):
            n = min(self.batch_rows, total - off)
            yield self._upload(table.slice(off, n), n, path)

    def do_execute(self) -> Iterator[ColumnarBatch]:
        # "io.read" fires once per produced batch, so a fault can kill a
        # scan mid-stream; recovery is query-level (the recovery driver
        # re-drives the plan and the scan reads again).  Each pull runs
        # in an "io.reader" watchdog section: a stalled decode overruns
        # its deadline and becomes a retryable TimeoutFault at the next
        # checkpoint
        from spark_rapids_tpu_torch.robustness import watchdog
        from spark_rapids_tpu_torch.robustness.inject import fire
        it = self._scan_batches()
        try:
            while True:
                with watchdog.section("io.reader"):
                    batch = next(it, None)
                    if batch is not None:
                        fire("io.read")
                if batch is None:
                    return
                yield batch
        finally:
            # a fault mid-scan stops the reader's pool now, not when
            # the traceback that holds this frame is dropped
            it.close()

    def _scan_batches(self) -> Iterator[ColumnarBatch]:
        if not self.paths:
            return  # bucket pruning removed every file
        if self.file_meta:
            yield from self._per_file_scan()
            return
        if self.file_format == "csv" or len(self.paths) == 1:
            yield from self._simple_scan()
            return
        from spark_rapids_tpu_torch.io.multifile import iter_file_tables
        # None: every column, which lets the reader take whole files
        columns = None if len(self.columns) == len(self._schema) \
            else self.read_columns
        for table in self._timed(iter_file_tables(
                self.paths, self.file_format, columns,
                self.arrow_filter, self.reader_type, self.batch_rows,
                self.num_threads, self.max_files_parallel)):
            self.metrics[NUM_INPUT_BATCHES] += 1
            yield from self._chunks(table)

    def _per_file_scan(self) -> Iterator[ColumnarBatch]:
        """Metadata columns are per file: each dataset fragment reads
        on its own (hive partition columns kept) and its constant
        metadata columns ride every chunk."""
        dataset = _dataset(self.paths, self.file_format)

        def tables():
            for frag in dataset.get_fragments(filter=self.arrow_filter):
                yield frag.path, frag.to_table(
                    schema=dataset.schema, columns=self.read_columns,
                    filter=self.arrow_filter)

        for path, table in self._timed(tables()):
            self.metrics[NUM_INPUT_BATCHES] += 1
            yield from self._chunks(table, path)

    def _simple_scan(self) -> Iterator[ColumnarBatch]:
        """One dataset streamed in record batches (a row group or less
        each, fewer rows still after the pushed filter), gathered into
        device batches of up to ``batch_rows`` rows."""
        import pyarrow as pa
        dataset = _dataset(self.paths, self.file_format)
        kwargs = {"columns": self.read_columns,
                  "batch_size": self.batch_rows}
        if self.arrow_filter is not None:
            kwargs["filter"] = self.arrow_filter
        pending, rows = [], 0
        for record_batch in self._timed(iter(dataset.to_batches(**kwargs))):
            if record_batch.num_rows == 0:
                continue
            self.metrics[NUM_INPUT_BATCHES] += 1
            if pending and rows + record_batch.num_rows > self.batch_rows:
                yield self._upload(pa.Table.from_batches(pending), rows)
                pending, rows = [], 0
            pending.append(record_batch)
            rows += record_batch.num_rows
        if pending:
            yield self._upload(pa.Table.from_batches(pending), rows)


def bucket_pruned_paths(node: FileRelation) -> List[str]:
    """Bucket pruning: an equality filter on the bucket column narrows
    the scan to that bucket's file (the spec comes from the
    ``_bucket_spec.json`` sidecar)."""
    from spark_rapids_tpu_torch.io import bucketing as B
    spec = node.bucket_spec
    if not spec:
        return node.paths
    col = spec["column"]
    for f in node.pushed_filters:
        if not isinstance(f, P.EqualTo):
            continue
        for a, b in ((f.left, f.right), (f.right, f.left)):
            if _column_name(a) == col and isinstance(b, Literal) \
                    and b.value is not None:
                pruned, _ = B.prune_paths(node.paths, spec,
                                          node.file_format, b.value)
                return pruned
    return node.paths


def make_file_scan_exec(node: FileRelation, conf,
                        device) -> TpuFileScanExec:
    from spark_rapids_tpu_torch.config import rapids_conf as rc
    # a shredded column's flat name is no file column: filters on it stay
    # in the engine
    file_columns = {n for n, _ in node.schema
                    if "." not in n} - META_COLUMN_NAMES
    arrow_filter = None
    for f in node.pushed_filters:
        af = to_arrow_filter(f, file_columns)
        if af is not None:
            arrow_filter = af if arrow_filter is None else \
                (arrow_filter & af)
    fmt = node.file_format
    return TpuFileScanExec(
        bucket_pruned_paths(node), fmt, node.schema, device,
        columns=sorted(node.required_columns)
        if node.required_columns is not None else None,
        arrow_filter=arrow_filter,
        file_meta=node.file_meta,
        batch_rows=conf.get(rc.READER_BATCH_SIZE_ROWS),
        reader_type=conf.get(rc.READER_TYPE[fmt]),
        num_threads=conf.get(rc.READ_NUM_THREADS[fmt]),
        max_files_parallel=conf.get(rc.MAX_NUM_FILES_PARALLEL[fmt]))
