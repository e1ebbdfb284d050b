"""File writers: parquet, ORC and CSV, with hive-style partitioning and
bucketing.

Counterpart of ``spark_rapids_tpu/io/writers.py``: batches leave the
device once, through the counted fetch (``ColumnarBatch.to_arrow``), and
are encoded on the host by pyarrow, with write statistics (files, bytes,
rows, partitions).  Files keep the rows in the order the query produced
them, and their names carry a zero-padded sequence number, so a
directory read (whose files pyarrow lists in name order) sees the rows
in written order.
"""

from __future__ import annotations

import dataclasses
import os
import re
import uuid
from typing import Iterable, List, Optional

from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch

_EXT = {"parquet": "parquet", "orc": "orc", "csv": "csv"}


@dataclasses.dataclass
class WriteStats:
    """numFiles / numBytes / numRows / numPartitions of one write."""
    num_files: int = 0
    num_bytes: int = 0
    num_rows: int = 0
    num_partitions: int = 0


def write_batches(batches: Iterable[ColumnarBatch], path: str,
                  file_format: str, mode: str = "error",
                  partition_by: Optional[List[str]] = None,
                  bucket_by: Optional[tuple] = None,
                  max_rows_per_file: int = 1 << 22) -> WriteStats:
    import pyarrow as pa
    import pyarrow.dataset as ds

    if file_format not in _EXT:
        raise ValueError(f"unknown file format {file_format!r}")
    exists = os.path.isdir(path) and bool(os.listdir(path)) or \
        os.path.isfile(path)
    if exists:
        if mode == "error":
            raise FileExistsError(f"path {path} already exists")
        if mode == "ignore":
            return WriteStats()
        if mode == "overwrite":
            import shutil
            if os.path.isdir(path):
                shutil.rmtree(path)
            else:
                os.unlink(path)
        # mode == "append": write more files beside the old ones

    from spark_rapids_tpu_torch.columnar.nested import assemble_table
    # shredded struct and map columns are written whole
    tables = [assemble_table(b.to_arrow()) for b in batches]
    if not tables:
        os.makedirs(path, exist_ok=True)
        return WriteStats()
    table = pa.concat_tables(tables)
    stats = WriteStats(num_rows=table.num_rows)

    if bucket_by is not None:
        if partition_by:
            raise ValueError("bucketBy cannot combine with partitionBy")
        if mode == "append" and exists:
            # bucket files have fixed names: appending would replace them
            raise ValueError(
                "append mode is unsupported for bucketed tables")
        return _write_bucketed(table, path, file_format, bucket_by, stats)

    tag = uuid.uuid4().hex[:8]
    if file_format == "orc":
        # pyarrow's dataset writer has no ORC support: files directly
        _write_orc(table, path, partition_by, tag, stats)
        return stats

    partitioning = None
    if partition_by:
        partitioning = ds.partitioning(
            pa.schema([table.schema.field(c) for c in partition_by]),
            flavor="hive")
    # row groups of up to 2^20 rows, gathered from the writer's smaller
    # input batches: a scan reads a row group as a unit
    group_rows = min(1 << 20, max_rows_per_file)
    ds.write_dataset(
        table, path, format=file_format, partitioning=partitioning,
        max_rows_per_file=max_rows_per_file,
        min_rows_per_group=group_rows, max_rows_per_group=group_rows,
        basename_template=f"part-{tag}-{{i}}.{_EXT[file_format]}",
        existing_data_behavior="overwrite_or_ignore", preserve_order=True)
    _pad_sequence_numbers(path, tag)
    _count_files(path, partition_by, stats)
    return stats


def _pad_sequence_numbers(path: str, tag: str) -> None:
    """``part-<tag>-<i>.<ext>`` -> ``part-<tag>-<i:05d>.<ext>``."""
    pattern = re.compile(rf"^part-{tag}-(\d+)\.(\w+)$")
    for root, _dirs, files in os.walk(path):
        for f in files:
            m = pattern.match(f)
            if m:
                os.rename(os.path.join(root, f), os.path.join(
                    root, f"part-{tag}-{int(m.group(1)):05d}.{m.group(2)}"))


def _count_files(path: str, partition_by, stats: WriteStats) -> None:
    parts = set()
    for root, dirs, files in os.walk(path):
        for f in files:
            stats.num_files += 1
            stats.num_bytes += os.path.getsize(os.path.join(root, f))
        if partition_by:
            parts.update(os.path.join(root, d) for d in dirs if "=" in d)
    stats.num_partitions = len(parts)


def _write_table(table, f: str, file_format: str) -> None:
    if file_format == "parquet":
        import pyarrow.parquet as pq
        pq.write_table(table, f)
    elif file_format == "orc":
        import pyarrow.orc as orc
        orc.write_table(table, f)
    else:
        raise ValueError(f"bucketed write unsupported for {file_format}")


def _write_bucketed(table, path: str, file_format: str, bucket_by,
                    stats: WriteStats) -> WriteStats:
    """Hash-route rows to ``part-bucket-N`` files plus the
    ``_bucket_spec.json`` sidecar (``io/bucketing.py`` prunes on read)."""
    import numpy as np
    from spark_rapids_tpu_torch.io import bucketing as B
    num_buckets, column = bucket_by
    if column not in table.column_names:
        raise KeyError(f"bucketBy column {column!r} not in output")
    if file_format not in ("parquet", "orc"):
        raise ValueError(f"bucketed write unsupported for {file_format}")
    os.makedirs(path, exist_ok=True)
    vals = table.column(column).to_pandas().to_numpy()
    ids = B.bucket_ids(vals, num_buckets)
    for b in range(num_buckets):
        rows = np.nonzero(ids == b)[0]
        if not len(rows):
            continue
        f = B.bucket_file(path, b, file_format)
        _write_table(table.take(rows), f, file_format)
        stats.num_files += 1
        stats.num_bytes += os.path.getsize(f)
    B.write_spec(path, column, num_buckets)
    stats.num_partitions = num_buckets
    return stats


def _write_orc(table, path: str, partition_by, tag: str,
               stats: WriteStats) -> None:
    os.makedirs(path, exist_ok=True)
    if not partition_by:
        f = os.path.join(path, f"part-{tag}-00000.orc")
        _write_table(table, f, "orc")
        stats.num_files = 1
        stats.num_bytes = os.path.getsize(f)
        return
    # hive-style split: each distinct partition tuple is a subdirectory
    import pyarrow.compute as pc
    keys = table.select(partition_by).group_by(
        partition_by, use_threads=False).aggregate([]).to_pylist()
    rest = [c for c in table.column_names if c not in partition_by]
    for key in keys:
        cond = None
        for c in partition_by:
            v = key[c]
            term = pc.is_null(table.column(c)) if v is None else \
                pc.equal(table.column(c), v)
            cond = term if cond is None else pc.and_(cond, term)
        sub = os.path.join(path, *[f"{c}={key[c]}" for c in partition_by])
        os.makedirs(sub, exist_ok=True)
        f = os.path.join(sub, f"part-{tag}-00000.orc")
        _write_table(table.filter(cond).select(rest), f, "orc")
        stats.num_files += 1
        stats.num_bytes += os.path.getsize(f)
    stats.num_partitions = len(keys)


class DataFrameWriter:
    """``df.write.mode(...).partitionBy(...).parquet(path)``."""

    def __init__(self, df):
        self.df = df
        self._mode = "error"
        self._partition_by: Optional[List[str]] = None
        self._bucket_by: Optional[tuple] = None

    def mode(self, m: str) -> "DataFrameWriter":
        if m not in ("error", "errorifexists", "overwrite", "append",
                     "ignore"):
            raise ValueError(f"unknown save mode {m!r}")
        self._mode = "error" if m == "errorifexists" else m
        return self

    def partitionBy(self, *cols: str) -> "DataFrameWriter":
        self._partition_by = list(cols)
        return self

    def bucketBy(self, num_buckets: int, col: str) -> "DataFrameWriter":
        self._bucket_by = (int(num_buckets), col)
        return self

    def _write(self, path: str, file_format: str) -> WriteStats:
        from spark_rapids_tpu_torch.config import rapids_conf as rc
        return write_batches(
            self.df._execute_batches(), path, file_format,
            mode=self._mode, partition_by=self._partition_by,
            bucket_by=self._bucket_by,
            max_rows_per_file=self.df.session.conf.get(
                rc.WRITER_MAX_ROWS_PER_FILE))

    def parquet(self, path: str) -> WriteStats:
        return self._write(path, "parquet")

    def orc(self, path: str) -> WriteStats:
        return self._write(path, "orc")

    def csv(self, path: str) -> WriteStats:
        return self._write(path, "csv")
