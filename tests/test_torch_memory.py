"""The PyTorch port's spill catalog (``memory/spill.py``) and coalesce
(``memory/coalesce.py``), on the CPU: the cases of ``tests/test_memory.py``
with tiny budgets, temporary directories and real tiers, plus the port's
own: a flipped bit caught on the host and on disk (the batch dropped,
never returned), byte counts of views and zero-stride columns, and a disk
frame byte for byte the JAX package's for the same buffers.
"""

import os
import threading
import time

import numpy as np
import pytest
import torch

from spark_rapids_tpu_torch.columnar import dtypes as dts
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.columnar.column import Column
from spark_rapids_tpu_torch.memory.coalesce import (
    RequireSingleBatch, TargetSize, coalesce_iterator)
from spark_rapids_tpu_torch.memory.spill import (
    DEVICE, DISK, HOST, SpillableBatchCatalog, SpillCorruptionError,
    SpillIOError, TpuSemaphore, batch_bytes)


def make_batch(n=1000, seed=0):
    rng = np.random.default_rng(seed)
    return ColumnarBatch.from_pydict({
        "a": rng.integers(0, 100, n),
        "s": [f"row-{i}" for i in range(n)],
    })


def rows(batch):
    return batch.to_arrow().to_pydict()


def _spill_by_hand(cat, h):
    """Move ``h`` to the host outside the catalog's own loop, keeping its
    counters right."""
    cat.device_bytes -= h.spill_to_host()
    cat.host_bytes += h.host_size


def test_register_and_materialize_device(tmp_path):
    cat = SpillableBatchCatalog(device_budget=1 << 30,
                                spill_dir=str(tmp_path))
    b = make_batch()
    h = cat.register(b)
    assert h.tier == DEVICE
    assert rows(h.materialize()) == rows(b)
    h.close()
    assert cat.stats()["num_handles"] == 0


def test_spill_to_host_and_back(tmp_path):
    b = make_batch()
    size = batch_bytes(b)
    cat = SpillableBatchCatalog(device_budget=size + 100,
                                host_budget=1 << 30,
                                spill_dir=str(tmp_path))
    h1 = cat.register(b)
    h2 = cat.register(make_batch(seed=1))  # pushes h1 over the budget
    assert h1.tier == HOST                # least recently used goes first
    assert h2.tier == DEVICE
    assert cat.spilled_to_host_total == size
    out = h1.materialize()
    assert h1.tier == DEVICE
    assert rows(out) == rows(b)
    assert cat.stats()["restored_from_host_total"] == size


def test_spill_cascades_to_disk(tmp_path):
    size = batch_bytes(make_batch())
    cat = SpillableBatchCatalog(device_budget=size + 100,
                                host_budget=size + 100,
                                spill_dir=str(tmp_path))
    handles = [cat.register(make_batch(seed=i)) for i in range(3)]
    cat.wait_for_writes()
    assert sorted(h.tier for h in handles) == sorted([DISK, HOST, DEVICE])
    disk_h = next(h for h in handles if h.tier == DISK)
    want = rows(make_batch(seed=handles.index(disk_h)))
    out = disk_h.materialize()
    assert rows(out) == want
    assert cat.stats()["spilled_to_disk_total"] >= size


def test_priority_order(tmp_path):
    size = batch_bytes(make_batch())
    cat = SpillableBatchCatalog(device_budget=2 * size + 100,
                                spill_dir=str(tmp_path))
    cold = cat.register(make_batch(seed=1), priority=-1000)
    hot = cat.register(make_batch(seed=2), priority=1000)
    cat.register(make_batch(seed=3), priority=0)
    assert cold.tier == HOST
    assert hot.tier == DEVICE


def test_demote_moves_one_handle_down(tmp_path):
    """demote() pushes one handle to the host or straight to disk,
    whatever the budgets, and the restore brings the same rows back."""
    cat = SpillableBatchCatalog(device_budget=1 << 30, host_budget=1 << 30,
                                spill_dir=str(tmp_path))
    a, b = cat.register(make_batch(seed=1)), cat.register(make_batch(seed=2))
    cat.demote(a, HOST)
    cat.demote(b, DISK)
    assert (a.tier, b.tier) == (HOST, DISK)
    st = cat.stats()
    assert st["host_bytes"] == a.host_size and \
        st["disk_bytes"] == b.host_size and st["device_bytes"] == 0
    assert rows(b.materialize()) == rows(make_batch(seed=2))
    assert rows(a.materialize()) == rows(make_batch(seed=1))
    assert cat.stats()["device_bytes"] == a.size_bytes + b.size_bytes


def test_coalesce_iterator(tmp_path):
    cat = SpillableBatchCatalog(spill_dir=str(tmp_path))
    batches = [make_batch(100, seed=i) for i in range(5)]
    out = list(coalesce_iterator(iter(batches), RequireSingleBatch(),
                                 catalog=cat))
    assert len(out) == 1 and out[0].nrows == 500
    assert cat.stats()["num_handles"] == 0
    small = TargetSize(batches[0].device_size_bytes() * 2 + 1)
    out2 = list(coalesce_iterator(iter(batches), small, catalog=cat))
    assert len(out2) >= 2
    assert sum(b.nrows for b in out2) == 500


def test_coalesce_pending_batches_spill(tmp_path):
    """Pending batches sit in the catalog: a small budget moves them to
    the host and they come back for the concatenation."""
    batches = [make_batch(100, seed=i) for i in range(5)]
    cat = SpillableBatchCatalog(device_budget=batch_bytes(batches[0]) + 1,
                                spill_dir=str(tmp_path))
    out = list(coalesce_iterator(iter(batches), RequireSingleBatch(),
                                 catalog=cat))
    assert cat.spilled_to_host_total > 0
    want = {k: sum((rows(b)[k] for b in batches), []) for k in ("a", "s")}
    assert rows(out[0]) == want


def test_coalesce_early_close_leaves_nothing(tmp_path):
    cat = SpillableBatchCatalog(spill_dir=str(tmp_path))
    gen = coalesce_iterator(iter([make_batch(10, i) for i in range(4)]),
                            TargetSize(1), catalog=cat)
    next(gen)
    gen.close()
    assert cat.stats()["num_handles"] == 0


def test_host_bitflip_caught_on_restore(tmp_path):
    cat = SpillableBatchCatalog(device_budget=1 << 30,
                                spill_dir=str(tmp_path))
    b = make_batch()
    h = cat.register(b)
    _spill_by_hand(cat, h)
    h._host["a.data"].view(np.uint8)[3] ^= 0x10
    with pytest.raises(SpillCorruptionError):
        h.materialize()
    assert h.closed and cat.stats()["num_handles"] == 0
    assert cat.stats()["integrity_failures"] == 1
    # the spill copied: the batch the caller still holds is untouched
    assert rows(b) == rows(make_batch())


def test_disk_bitflip_caught_on_restore(tmp_path):
    size = batch_bytes(make_batch())
    cat = SpillableBatchCatalog(device_budget=size + 100,
                                host_budget=size + 100,
                                spill_dir=str(tmp_path), frame_codec=0)
    handles = [cat.register(make_batch(seed=i)) for i in range(3)]
    cat.wait_for_writes()
    disk_h = next(h for h in handles if h.tier == DISK)
    path = disk_h._disk_path
    blob = bytearray(open(path, "rb").read())
    blob[-5] ^= 0x01          # inside the last buffer's raw bytes
    with open(path, "wb") as f:
        f.write(bytes(blob))
    with pytest.raises(SpillCorruptionError):
        disk_h.materialize()
    assert disk_h.closed
    assert not os.path.exists(path)  # dropped with its file


def test_disk_frame_that_no_longer_decodes(tmp_path):
    size = batch_bytes(make_batch())
    cat = SpillableBatchCatalog(device_budget=size + 100,
                                host_budget=size + 100,
                                spill_dir=str(tmp_path))
    handles = [cat.register(make_batch(seed=i)) for i in range(3)]
    cat.wait_for_writes()
    disk_h = next(h for h in handles if h.tier == DISK)
    with open(disk_h._disk_path, "r+b") as f:
        f.truncate(60)
    with pytest.raises(SpillCorruptionError):
        disk_h.materialize()
    assert disk_h.closed


def test_clean_restores_verify_checksums(tmp_path):
    size = batch_bytes(make_batch())
    cat = SpillableBatchCatalog(device_budget=size + 100,
                                host_budget=size + 100,
                                spill_dir=str(tmp_path))
    assert cat.integrity_check
    handles = [cat.register(make_batch(seed=i)) for i in range(3)]
    cat.wait_for_writes()
    for h in handles:
        assert h.tier == DEVICE or h._integrity_crc is not None
    for i, h in enumerate(handles):
        assert rows(h.materialize()) == rows(make_batch(seed=i))
    assert cat.stats()["integrity_failures"] == 0


def test_disk_write_is_atomic(tmp_path, monkeypatch):
    cat = SpillableBatchCatalog(device_budget=1 << 30,
                                spill_dir=str(tmp_path))
    h = cat.register(make_batch())
    _spill_by_hand(cat, h)

    def crash(*a):
        raise OSError("simulated crash at rename")

    monkeypatch.setattr(os, "replace", crash)
    with pytest.raises(SpillIOError):
        h.spill_to_disk()
    # intact at the host tier, no partial file
    assert h.tier == HOST
    assert not os.listdir(tmp_path)
    monkeypatch.undo()
    h.spill_to_disk()
    assert h.tier == DISK
    names = os.listdir(tmp_path)
    assert names and all(n.endswith(".tcf") for n in names)
    assert rows(h.materialize()) == rows(make_batch())


def test_close_sweeps_orphaned_spill_files(tmp_path):
    size = batch_bytes(make_batch())
    cat = SpillableBatchCatalog(device_budget=size + 100,
                                host_budget=size + 100,
                                spill_dir=str(tmp_path))
    handles = [cat.register(make_batch(seed=i)) for i in range(3)]
    cat.wait_for_writes()
    disk_h = next(h for h in handles if h.tier == DISK)
    orphan = disk_h._disk_path
    torn = orphan + ".tmp"
    with open(torn, "wb") as f:
        f.write(b"torn")
    cat._handles.pop(disk_h.id)
    foreign = os.path.join(tmp_path, "buf-999983.tcf")
    with open(foreign, "wb") as f:
        f.write(b"another catalog's live frame")
    cat.close()
    assert cat.stats()["num_handles"] == 0
    assert not os.path.exists(orphan)
    assert not os.path.exists(torn)
    assert os.path.exists(foreign)
    os.unlink(foreign)
    h = cat.register(make_batch(seed=9))
    _spill_by_hand(cat, h)
    h.spill_to_disk()
    assert h.tier == DISK


def test_catalog_makes_and_removes_its_own_directory():
    size = batch_bytes(make_batch())
    cat = SpillableBatchCatalog(device_budget=size + 100, host_budget=1)
    assert cat._spill_dir is None          # nothing on disk yet
    cat.register(make_batch(seed=1))
    cat.register(make_batch(seed=2))
    cat.wait_for_writes()
    d = cat._spill_dir
    assert d is not None and os.listdir(d)
    cat.close()
    assert not os.path.exists(d)


def test_disk_writes_run_behind_the_spilling_thread(tmp_path):
    """A registration hands its disk moves to the writers and returns
    while they run (payloads in flight up to the host budget); a restore
    of a batch still being written waits for its write."""
    size = batch_bytes(make_batch())
    cat = SpillableBatchCatalog(device_budget=size + 100,
                                host_budget=4 * size,
                                spill_dir=str(tmp_path))
    release = threading.Event()
    write = cat._write_frame

    def slow(path, blob):
        release.wait(30)
        write(path, blob)

    cat._write_frame = slow
    handles = [cat.register(make_batch(seed=i)) for i in range(7)]
    moving = [h for h in handles if h._moving]
    assert moving and all(h.tier == HOST for h in moving)
    got = []
    t = threading.Thread(target=lambda: got.append(
        rows(moving[0].materialize())))
    t.start()
    t.join(0.2)
    assert t.is_alive()            # waits for its write
    release.set()
    t.join(10)
    assert not t.is_alive()
    assert got == [rows(make_batch(seed=handles.index(moving[0])))]
    cat.wait_for_writes()
    assert not any(h._moving for h in handles)
    assert cat.stats()["spilled_to_disk_total"] > 0


def test_failed_disk_write_keeps_the_batch_on_the_host(tmp_path):
    size = batch_bytes(make_batch())
    cat = SpillableBatchCatalog(device_budget=size + 100,
                                host_budget=size + 100,
                                spill_dir=str(tmp_path))

    def broken(path, blob):
        raise OSError("disk full")

    cat._write_frame = broken
    with pytest.raises(SpillIOError):
        for i in range(3):
            cat.register(make_batch(seed=i))
        cat.wait_for_writes()
    st = cat.stats()
    assert st["disk_bytes"] == 0 and st["spilled_to_disk_total"] == 0
    assert st["host_bytes"] > 0
    assert not os.listdir(tmp_path)


def test_wedged_disk_writer_is_recoverable(tmp_path):
    """A writer that never returns must not hang the spilling thread: the
    pool wait gives up at its deadline and raises."""
    cat = SpillableBatchCatalog(device_budget=1 << 30, host_budget=1 << 30,
                                spill_dir=str(tmp_path),
                                disk_write_threads=2,
                                disk_write_timeout_s=0.3)
    hs = [cat.register(make_batch(seed=i)) for i in range(2)]
    for h in hs:
        _spill_by_hand(cat, h)
    release = threading.Event()

    def wedged(path, blob):
        release.wait(30)

    cat._write_frame = wedged
    cat.host_budget = 0   # both to disk in one pass: the pool path
    t0 = time.monotonic()
    try:
        with pytest.raises(SpillIOError):
            cat.ensure_budget()
        assert time.monotonic() - t0 < 5
    finally:
        release.set()


def test_handle_close_survives_unlink_failure(tmp_path, monkeypatch):
    size = batch_bytes(make_batch())
    cat = SpillableBatchCatalog(device_budget=size + 100,
                                host_budget=size + 100,
                                spill_dir=str(tmp_path))
    handles = [cat.register(make_batch(seed=i)) for i in range(3)]
    cat.wait_for_writes()
    disk_h = next(h for h in handles if h.tier == DISK)

    def denied(*a):
        raise OSError("unlink denied")

    monkeypatch.setattr(os, "unlink", denied)
    disk_h.close()
    monkeypatch.undo()
    assert disk_h.closed
    assert disk_h.id not in cat._handles
    assert cat.disk_bytes == 0


def test_views_count_their_own_bytes(tmp_path):
    """A batch of views of a larger tensor counts and spills its own rows
    only, and a zero-stride column one element, restored as a zero-stride
    view of the same values."""
    base = torch.arange(1 << 16, dtype=torch.int64)
    view = base[100:200]
    const = torch.tensor([7], dtype=torch.int64).expand(100)
    b = ColumnarBatch({"v": Column(dts.INT64, view, 100),
                       "c": Column(dts.INT64, const, 100)}, 100)
    assert batch_bytes(b) == 100 * 8 + 8
    cat = SpillableBatchCatalog(device_budget=1, host_budget=1,
                                spill_dir=str(tmp_path))
    h = cat.register(b)
    cat.wait_for_writes()
    assert h.tier == DISK
    assert h._disk_stored < 100 * 8 + 200
    out = h.materialize()
    assert out.column("c").data.stride(0) == 0
    assert out.column("v").data.tolist() == list(range(100, 200))
    assert out.column("c").data.tolist() == [7] * 100


def test_spill_copies_live_rows_only(tmp_path):
    """A count still on the device (and the string columns' char counts)
    comes first in one counted fetch, the buffers in one more; only the
    live rows leave, so the restored batch has no padding."""
    from spark_rapids_tpu_torch.utils import hostsync
    vals = torch.arange(64, dtype=torch.float64)
    s = Column.from_strings([f"s{i}" for i in range(64)])
    n = torch.tensor(40)
    b = ColumnarBatch({"x": Column(dts.FLOAT64, vals, n),
                       "s": Column(dts.STRING, s.data, n,
                                   offsets=s.offsets)}, n)
    cat = SpillableBatchCatalog(device_budget=1, spill_dir=str(tmp_path))
    before = hostsync.host_sync_metrics.snapshot()
    h = cat.register(b)
    assert h.tier == HOST
    assert hostsync.host_sync_metrics.snapshot() - before == 2
    assert h.nrows == 40 and h.size_bytes == batch_bytes(b)
    assert h.host_size == 40 * 8 + 41 * 4 + len("".join(
        f"s{i}" for i in range(40)))
    out = h.materialize()
    assert out.capacity == 40
    assert out.column("x").data.tolist() == list(range(40))
    assert rows(out)["s"] == [f"s{i}" for i in range(40)]


def test_disk_frame_equals_jax_frame(tmp_path):
    """The catalog's disk frame is byte for byte the JAX package's
    ``serialize_batch`` of the same host buffers, at each codec level."""
    from spark_rapids_tpu import native as jax_native
    b = ColumnarBatch.from_pydict({
        "i": np.arange(300, dtype=np.int32) % 7,
        "d": np.linspace(0, 1, 300),
        "s": ["ab" * (i % 5) for i in range(300)],
        "n": [None if i % 3 else i for i in range(300)]})
    for level in (0, 1, 2):
        d = tmp_path / str(level)
        d.mkdir()
        cat = SpillableBatchCatalog(device_budget=1, host_budget=1,
                                    spill_dir=str(d), frame_codec=level)
        h = cat.register(b)
        cat.wait_for_writes()
        got = open(h._disk_path, "rb").read()
        cols = []
        for name, c in b.columns.items():
            cols.append((jax_native.dtype_code(c.dtype), c.data.numpy(),
                         None if c.validity is None else c.validity.numpy(),
                         None if c.offsets is None else c.offsets.numpy()))
        assert got == jax_native.serialize_batch(300, cols, compress=level)
        h.close()


def test_semaphore():
    sem = TpuSemaphore(permits=1)
    with sem:
        with sem:  # re-entrant on one thread
            pass
    acquired = []

    def worker():
        with sem:
            acquired.append(1)

    with sem:
        t = threading.Thread(target=worker)
        t.start()
        t.join(timeout=0.2)
        assert not acquired  # blocked while held
    t.join(timeout=2)
    assert acquired


def test_session_budget(tmp_path):
    """On the CPU the budget is the conf's limit, or the sizing contract
    over CPU_DEVICE_BYTES; below minAllocFraction the session fails."""
    from spark_rapids_tpu_torch.api import session as S
    s = S.TpuSession({"spark.rapids.memory.tpu.deviceLimitBytes": 12345,
                      "spark.rapids.memory.host.spillStorageSize": 777,
                      "spark.rapids.memory.oomRetry.maxRetries": 4},
                     device="cpu")
    cat = s.memory_catalog
    assert (cat.device_budget, cat.host_budget, cat.max_retries) == \
        (12345, 777, 4)
    s2 = S.TpuSession({}, device="cpu")
    usable = S.CPU_DEVICE_BYTES - (640 << 20)
    assert s2.memory_catalog.device_budget == int(usable * 0.9)
    with pytest.raises(ValueError):
        S.TpuSession({"spark.rapids.memory.tpu.allocFraction": 0.1},
                     device="cpu")
    with pytest.raises(ValueError):
        S.TpuSession({"spark.rapids.memory.bogus": 1}, device="cpu")
    s.stop()
    s2.stop()


def test_pipeline_registers_in_flight_batches(tmp_path):
    """The pipeline's worker registers each batch before it queues it, at
    the hottest priority; the consumer restores and closes it, and an
    early close leaves no registration behind."""
    from spark_rapids_tpu_torch.exec.pipeline import PipelineStats, pipelined
    from spark_rapids_tpu_torch.memory.spill import ACTIVE_ON_DECK_PRIORITY
    size = batch_bytes(make_batch())
    cat = SpillableBatchCatalog(device_budget=size + 100,
                                spill_dir=str(tmp_path))
    seen = []
    register = cat.register

    def spy(batch, priority=0):
        seen.append(priority)
        return register(batch, priority)

    cat.register = spy
    stats = PipelineStats(2)
    out = list(pipelined(iter([make_batch(seed=i) for i in range(4)]), 2,
                         stats, catalog=cat))
    assert [rows(b) for b in out] == \
        [rows(make_batch(seed=i)) for i in range(4)]
    assert stats.registered == stats.batches == 4
    assert seen == [ACTIVE_ON_DECK_PRIORITY] * 4
    assert cat.stats()["num_handles"] == 0
    gen = pipelined(iter([make_batch(seed=i) for i in range(6)]), 3,
                    catalog=cat)
    next(gen)
    gen.close()
    assert cat.stats()["num_handles"] == 0


def test_concurrent_register_restore_close_keeps_counters(tmp_path):
    """Threads registering, restoring and closing batches at once, with
    budgets that keep every tier moving and a short switch interval: every
    restore returns its own rows, and once all handles are closed every
    counter is back at zero."""
    import sys
    size = batch_bytes(make_batch(200))
    cat = SpillableBatchCatalog(device_budget=3 * size, host_budget=2 * size,
                                spill_dir=str(tmp_path),
                                disk_write_threads=3)
    errors = []

    def worker(k):
        try:
            mine = [(cat.register(make_batch(200, seed=10 * k + i)),
                     10 * k + i) for i in range(6)]
            for _ in range(3):
                for h, seed in mine:
                    assert rows(h.materialize()) == \
                        rows(make_batch(200, seed=seed))
            for h, _ in mine:
                h.close()
        except BaseException as e:  # noqa: BLE001 - reported below
            errors.append(e)

    before = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, args=(k,))
                   for k in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(before)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[:1]
    cat.wait_for_writes()
    st = cat.stats()
    assert (st["device_bytes"], st["host_bytes"], st["disk_bytes"],
            st["num_handles"]) == (0, 0, 0, 0), st
    assert st["spilled_to_disk_total"] > 0
    cat.close()
    assert not os.listdir(tmp_path)
