"""Multi-file reader strategies.

Counterpart of ``spark_rapids_tpu/io/multifile.py`` (the reference's
``GpuMultiFileReader`` and the ``spark.rapids.sql.format.<fmt>.reader.type``
strategies):

* PERFILE       -- one file at a time, host decode then device upload;
* MULTITHREADED -- a thread pool decodes files to host Arrow tables ahead
  of the consumer, at most ``max_files_parallel`` in flight, so host
  decode overlaps device work;
* COALESCING    -- many small files decode in the pool and are stitched
  into one host table of about ``coalesce_target_bytes`` before a single
  upload;
* AUTO          -- COALESCING for many small local files, MULTITHREADED
  for several large ones, PERFILE for one.

Every strategy hands column pruning and the pyarrow filter to the format
reader.  The JAX package's MULTITHREADED reader reads whole files through
its native prefetcher when that library is built.  The port binds the
same prefetcher (``native.FilePrefetcher``) but does not read through
it: a whole-file read of SF10 lineitem for TPC-H q6's four columns took
its parquet run from 0.432 s to 1.866 s (NVIDIA H100 80GB HBM3,
700.00 W, ``chip_smoke.py``), and no query of the port reads every
column of a file.  The thread-pool path is also the JAX package's path
without the library; the tables are the same either way.
"""

from __future__ import annotations

import concurrent.futures
import os
from typing import Iterator, List, Optional, Sequence

import pyarrow as pa


def read_file_to_table(path: str, file_format: str,
                       columns: Optional[List[str]], filter_expr,
                       batch_rows: int) -> pa.Table:
    """One file's pruned, filtered rows as a host Arrow table, in chunks
    of up to ``batch_rows`` rows (a row group at most): the upload copies
    a chunk at a time, and pyarrow's default of 2^17 rows made four times
    the copies (half the rate, measured on the H100 machine's host)."""
    import pyarrow.dataset as ds
    dataset = ds.dataset([path], format=file_format)
    return dataset.to_table(columns=columns, filter=filter_expr,
                            batch_size=batch_rows)


def iter_file_tables(paths: Sequence[str], file_format: str,
                     columns: Optional[List[str]], filter_expr,
                     reader_type: str, batch_rows: int,
                     num_threads: int = 8,
                     max_files_parallel: int = 4,
                     coalesce_target_bytes: int = 128 << 20
                     ) -> Iterator[pa.Table]:
    """Host Arrow tables, in file order, per strategy; the caller uploads
    them."""
    if reader_type == "AUTO":
        small = all(_safe_size(p) < 32 << 20 for p in paths[:16])
        reader_type = "COALESCING" if len(paths) > 1 and small else \
            ("MULTITHREADED" if len(paths) > 1 else "PERFILE")
    if reader_type == "PERFILE" or len(paths) == 1:
        for p in paths:
            yield read_file_to_table(p, file_format, columns, filter_expr,
                                     batch_rows)
        return
    if reader_type == "MULTITHREADED":
        with concurrent.futures.ThreadPoolExecutor(num_threads) as pool:
            pending = []
            try:
                for p in paths:
                    pending.append(pool.submit(
                        read_file_to_table, p, file_format, columns,
                        filter_expr, batch_rows))
                    if len(pending) >= max_files_parallel:
                        yield pending.pop(0).result()
                while pending:
                    yield pending.pop(0).result()
            finally:
                # an early close (LIMIT, a consumer error) decodes no
                # more files than those already started
                for f in pending:
                    f.cancel()
        return
    if reader_type == "COALESCING":
        acc: List[pa.Table] = []
        acc_bytes = 0
        with concurrent.futures.ThreadPoolExecutor(num_threads) as pool:
            futures = [pool.submit(read_file_to_table, p, file_format,
                                   columns, filter_expr, batch_rows)
                       for p in paths]
            try:
                for f in futures:
                    t = f.result()
                    if t.num_rows == 0:
                        continue
                    acc.append(t)
                    acc_bytes += t.nbytes
                    if acc_bytes >= coalesce_target_bytes:
                        yield concat_tables(acc)
                        acc, acc_bytes = [], 0
            finally:
                for f in futures:
                    f.cancel()
        if acc:
            yield concat_tables(acc)
        return
    raise ValueError(f"unknown reader type {reader_type}")


def concat_tables(tables: List[pa.Table]) -> pa.Table:
    """``pa.concat_tables``, keeping the row count of tables without
    columns (a scan that decodes no column, as ``count()`` does), which
    arrow's concatenation drops."""
    if tables[0].num_columns:
        return pa.concat_tables(tables)
    total = sum(t.num_rows for t in tables)
    return pa.table({"_": pa.nulls(total)}).drop_columns(["_"])


def _safe_size(path: str) -> int:
    try:
        return os.path.getsize(path)
    except OSError:
        return 1 << 40
