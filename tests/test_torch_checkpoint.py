"""Stage checkpoints and resume of the PyTorch port
(``robustness/checkpoint.py``, the lineage wiring in
``robustness/driver.py`` and ``parallel/dist_planner.py``, the
checkpoint floor and compressed host tier of ``memory/spill.py``)
against the JAX package's, on the CPU.

The port runs over ``numShards=8`` logical shards, the reference over
``make_mesh(8)``.  Under the same injected fault both resume the same
number of stages and skip the same number of exchanges, with answers
that agree (keys exact, float sums within a relative 1e-12: the packages
add in different orders) and, in the port, equal its clean run bit for
bit.  Stage ids are held stable within each package, never across.
"""

import numpy as np
import pandas as pd
import pytest
import torch

from spark_rapids_tpu.api import functions as JF
from spark_rapids_tpu.api.session import TpuSession as JaxSession
from spark_rapids_tpu.parallel.mesh import make_mesh as jax_make_mesh
from spark_rapids_tpu.robustness import inject as JI
from spark_rapids_tpu.robustness.checkpoint import (
    checkpoint_metrics as jmetrics)
from spark_rapids_tpu.robustness.driver import (
    recovery_metrics as jrecovery)
from spark_rapids_tpu_torch.api import functions as F
from spark_rapids_tpu_torch.api.session import TpuSession
from spark_rapids_tpu_torch.parallel.mesh import LocalShards
from spark_rapids_tpu_torch.robustness import checkpoint as cp
from spark_rapids_tpu_torch.robustness import inject as I
from spark_rapids_tpu_torch.robustness.checkpoint import checkpoint_metrics
from spark_rapids_tpu_torch.robustness.driver import recovery_metrics

NSHARDS = 8
BASE = {"spark.rapids.sql.recovery.backoffMs": 1}
MESH_CONF = dict(BASE, **{"spark.rapids.sql.distributed.numShards":
                          NSHARDS})
REL = 1e-12


@pytest.fixture(autouse=True)
def _clean_registry():
    for inj, rec, met in ((I, recovery_metrics, checkpoint_metrics),
                          (JI, jrecovery, jmetrics)):
        inj.clear()
        rec.reset()
        met.reset()
    with I.scoped_rules(), JI.scoped_rules():
        yield
    I.clear()
    JI.clear()


@pytest.fixture(scope="module")
def jmesh():
    return jax_make_mesh(NSHARDS)


def _pdf(n=4096):
    rng = np.random.default_rng(3)
    return pd.DataFrame({"k": rng.integers(0, 40, n),
                         "v": rng.normal(size=n)})


def _two_stage(F_, session):
    """aggregate -> sort: two exchange stages, the least resume shape."""
    return (session.create_dataframe(_pdf()).groupBy("k")
            .agg(F_.sum(F_.col("v")).alias("sv")).orderBy("k"))


def _session(**conf):
    return TpuSession(dict(MESH_CONF, **conf), device="cpu")


def _jsession(jmesh, **conf):
    return JaxSession(dict(BASE, **conf), mesh=jmesh)


def _count_rule(inj, point):
    """A rule that never raises: each fire consumes one ``skip``."""
    return inj.inject(point, count=1, skip=1_000_000, all_threads=True)


def _hits(rule):
    return 1_000_000 - rule.skip


def _agree(got, want, keys):
    got = got.sort_values(keys, ignore_index=True)
    want = want.sort_values(keys, ignore_index=True)
    assert list(got.columns) == list(want.columns)
    for c in got.columns:
        if c in keys or got[c].dtype.kind not in "f":
            np.testing.assert_array_equal(got[c].to_numpy(),
                                          want[c].to_numpy())
        else:
            np.testing.assert_allclose(got[c], want[c], rtol=REL)


def test_stage_id_stable_and_layout_sensitive():
    s = _session()
    try:
        df = _two_stage(F, s)
        group = s.shards
        a = cp.stage_id(df.plan, group, inputs=False)
        assert a == cp.stage_id(df.plan, group, inputs=False)
        assert cp.stage_id(df.plan, LocalShards(4, "cpu"),
                           inputs=False) != a
        assert cp.stage_id(df.plan.child, group, inputs=False) != a
        # the shared store's ids fold the inputs in
        assert cp.stage_id(df.plan, group) != a
        assert cp.stage_id(df.plan, group) == cp.stage_id(df.plan, group)
        other = (s.create_dataframe(_pdf()).groupBy("k")
                 .agg(F.sum(F.col("v")).alias("sv")).orderBy("k"))
        # equal structure over other batches: apart
        assert cp.stage_id(other.plan, group, inputs=False) != a
    finally:
        s.stop()


def _faulted_run(inj, session, df, fault_kw, corrupt=False):
    launches = _count_rule(inj, "shuffle.exchange")
    want = df.to_pandas()
    clean = _hits(launches)
    inj.remove(launches)
    session.recovery_log.clear()
    launches = _count_rule(inj, "shuffle.exchange")
    rules = [inj.inject("shuffle.exchange", **fault_kw)]
    if corrupt:
        rules.append(inj.inject("checkpoint.restore", kind="corrupt",
                                count=1))
    try:
        got = df.to_pandas()
    finally:
        for r in rules:
            inj.remove(r)
    faulted = _hits(launches)
    inj.remove(launches)
    return want, got, clean, faulted


@pytest.mark.parametrize("corrupt", [False, True],
                         ids=["resume", "corrupt_restore"])
def test_partial_recovery_matches_the_reference(jmesh, corrupt):
    """A fault in the sort's exchange: the aggregate's checkpoint
    resumes (one extra exchange launch, not a full re-run), or, with a
    corrupt restore, drops and re-runs; both packages agree on every
    counter and the answer."""
    out = {}
    for name, inj, met, sess in (
            ("torch", I, checkpoint_metrics, _session()),
            ("jax", JI, jmetrics, _jsession(jmesh))):
        try:
            df = _two_stage(F if name == "torch" else JF, sess)
            met.reset()
            want, got, clean, faulted = _faulted_run(
                inj, sess, df, dict(count=1, skip=1), corrupt=corrupt)
            out[name] = (want, got, clean, faulted, met.snapshot(),
                         [r["action"] for r in sess.recovery_log])
        finally:
            sess.stop()
    t, j = out["torch"], out["jax"]
    pd.testing.assert_frame_equal(t[1], t[0])   # the port: bit for bit
    _agree(t[1], j[1], ["k"])
    assert t[5] == j[5] == ["retry"]
    assert t[2] == j[2] and t[3] == j[3]
    for key in ("resumes", "stagesSkipped", "writes"):
        assert t[4][key] == j[4][key], (key, t[4], j[4])
    if corrupt:
        assert t[4]["invalid"] >= 1 and t[4]["resumes"] == 0
        assert t[3] == 2 * t[2]
    else:
        assert t[4]["resumes"] >= 1 and t[4]["stagesSkipped"] >= 1
        assert t[3] == t[2] + 1


@pytest.fixture(scope="module")
def tpch_parquet(tmp_path_factory):
    from spark_rapids_tpu.models import tpch as jtpch
    data = jtpch.gen_tables(sf=0.002)
    d = tmp_path_factory.mktemp("tpch_ckpt")
    paths = {}
    for t in ("customer", "orders", "lineitem"):
        p = d / f"{t}.parquet"
        data[t].to_parquet(p, index=False)
        paths[t] = str(p)
    return paths


def test_tpch_q3_resume_pulls_no_source_again(jmesh, tpch_parquet):
    """Sharded TPC-H q3 over parquet, a fault at its first exchange
    launch: the resume re-reads no file, and both packages' counters and
    answers agree."""
    from spark_rapids_tpu.models import tpch as jtpch
    from spark_rapids_tpu_torch.models import tpch
    out = {}
    for name, inj, met, sess, mod in (
            ("torch", I, checkpoint_metrics, _session(), tpch),
            ("jax", JI, jmetrics, _jsession(jmesh), jtpch)):
        try:
            df = mod.q3({k: sess.read.parquet(p)
                         for k, p in tpch_parquet.items()})
            reads = _count_rule(inj, "io.read")
            want = df.to_pandas()
            clean_reads = _hits(reads)
            inj.remove(reads)
            assert sess.last_dist_explain == "distributed"
            met.reset()
            sess.recovery_log.clear()
            reads = _count_rule(inj, "io.read")
            with inj.injected("shuffle.exchange", count=1):
                got = df.to_pandas()
            faulted_reads = _hits(reads)
            inj.remove(reads)
            out[name] = (want, got, clean_reads, faulted_reads,
                         met.snapshot())
        finally:
            sess.stop()
    t, j = out["torch"], out["jax"]
    pd.testing.assert_frame_equal(t[1], t[0])
    _agree(t[1], j[1], ["l_orderkey"])
    assert t[3] == t[2]          # no file read twice
    assert j[3] == j[2]
    assert t[4]["resumes"] >= 1 and t[4]["stagesSkipped"] >= 2
    assert (t[4]["resumes"], t[4]["stagesSkipped"]) == \
        (j[4]["resumes"], j[4]["stagesSkipped"])


def test_checkpoint_disabled_behavior_unchanged():
    s = _session(**{"spark.rapids.sql.recovery.checkpoint.enabled": False})
    try:
        df = _two_stage(F, s)
        want, got, clean, faulted = _faulted_run(I, s, df,
                                                 dict(count=1, skip=1))
        pd.testing.assert_frame_equal(got, want)
        m = checkpoint_metrics.snapshot()
        assert m["writes"] == 0 and m["resumes"] == 0
        assert faulted == 2 * clean
        assert [r["action"] for r in s.recovery_log] == ["retry"]
    finally:
        s.stop()


def test_corrupt_restore_lands_on_the_event_trail(tmp_path):
    from spark_rapids_tpu_torch.tools.eventlog import load_logs
    s = _session(**{"spark.rapids.tpu.eventLog.dir": str(tmp_path)})
    try:
        df = _two_stage(F, s)
        want, got, _, _ = _faulted_run(I, s, df, dict(count=1, skip=1),
                                       corrupt=True)
        pd.testing.assert_frame_equal(got, want)
    finally:
        s.stop()
    apps = load_logs(str(tmp_path))
    events = [c for a in apps for c in
              a.checkpoint + [c for q in a.queries for c in q.checkpoint]]
    kinds = {c["kind"] for c in events}
    assert "write" in kinds and "invalid" in kinds
    assert any(c["kind"] == "invalid" and "stamp" in c.get("reason", "")
               for c in events)
    # the sharded QueryEnd carries the log's counters
    stats = [q.checkpoint_stats for a in apps for q in a.queries
             if q.checkpoint_stats]
    assert stats and any(st["invalid"] >= 1 for st in stats)


def test_spill_tier_corruption_drops_the_checkpoint():
    """Checkpoints kept off the card (tiers=host,disk) pass the catalog's
    own crc32: a host bit flip drops the checkpoint, the subtree re-runs,
    and the corruption never reaches the ladder."""
    s = _session(**{"spark.rapids.sql.recovery.checkpoint.tiers":
                    "host,disk"})
    try:
        df = _two_stage(F, s)
        want = df.to_pandas()
        checkpoint_metrics.reset()
        s.recovery_log.clear()
        with I.injected("spill.corrupt.host", kind="corrupt", count=1,
                        all_threads=True), \
                I.injected("shuffle.exchange", count=1, skip=1):
            got = df.to_pandas()
        pd.testing.assert_frame_equal(got, want)
        assert checkpoint_metrics.snapshot()["invalid"] >= 1
        assert {r["fault"] for r in s.recovery_log} == {"shuffle"}
    finally:
        s.stop()


def test_eviction_over_max_bytes_reruns_in_full():
    s = _session(**{"spark.rapids.sql.recovery.checkpoint.maxBytes": 1})
    try:
        df = _two_stage(F, s)
        want, got, clean, faulted = _faulted_run(I, s, df,
                                                 dict(count=1, skip=1))
        pd.testing.assert_frame_equal(got, want)
        m = checkpoint_metrics.snapshot()
        assert m["evictions"] >= 1 and m["resumes"] == 0
        assert faulted == 2 * clean
    finally:
        s.stop()


def test_layout_changing_rung_clears_the_log(jmesh):
    """Every exchange after the aggregate's fails until the plan leaves
    the shards: the retry rungs splice the aggregate back each time,
    then the split rung (a single-device re-plan) clears the log, in
    both packages alike."""
    out = {}
    for name, inj, met, sess in (
            ("torch", I, checkpoint_metrics, _session()),
            ("jax", JI, jmetrics, _jsession(jmesh))):
        try:
            df = _two_stage(F if name == "torch" else JF, sess)
            want = df.to_pandas()
            met.reset()
            sess.recovery_log.clear()
            with inj.injected("shuffle.exchange", count=10_000, skip=1):
                got = df.to_pandas()
            out[name] = (want, got, met.snapshot(),
                         [r["action"] for r in sess.recovery_log],
                         sess.last_dist_explain)
        finally:
            sess.stop()
    t, j = out["torch"], out["jax"]
    assert t[3] == j[3] and t[3][-1] == "split"
    assert t[4].startswith("demoted") and j[4].startswith("demoted")
    for key in ("writes", "resumes", "invalid"):
        assert t[2][key] == j[2][key], (key, t[2], j[2])
    assert t[2]["resumes"] >= 1 and t[2]["invalid"] >= 1
    got = t[1].sort_values("k", ignore_index=True)
    want = t[0].sort_values("k", ignore_index=True)
    np.testing.assert_array_equal(got.k, want.k)
    np.testing.assert_allclose(got.sv, want.sv, rtol=REL)


def test_one_device_session_keeps_no_log():
    s = TpuSession(dict(BASE), device="cpu")
    try:
        _two_stage(F, s).to_pandas()
        assert checkpoint_metrics.snapshot()["writes"] == 0
        assert s.checkpoints is None
    finally:
        s.stop()


def test_fatal_query_flushes_the_log_snapshot(tmp_path):
    from spark_rapids_tpu_torch.tools.eventlog import load_logs
    s = _session(**{"spark.rapids.tpu.eventLog.dir": str(tmp_path)})
    try:
        df = _two_stage(F, s)
        with I.injected("shuffle.exchange", count=1, skip=1,
                        exc=NotImplementedError), \
                pytest.raises(NotImplementedError):
            df.to_pandas()
    finally:
        s.stop()
    apps = load_logs(str(tmp_path))
    fatals = [q.fatal for a in apps for q in a.queries if q.fatal] + \
        [f for a in apps for f in a.fatal]
    assert fatals and fatals[0]["checkpoint"]["writes"] >= 1


@pytest.mark.parametrize("chunk", [None, 8], ids=["whole", "chunked"])
def test_payload_stamp_catches_every_single_bit_flip(chunk, monkeypatch):
    if chunk is not None:
        monkeypatch.setattr(cp, "_FOLD_CHUNK", chunk)
        monkeypatch.setattr(cp, "_weights_cache", {})
    rng = np.random.default_rng(5)
    bufs = [torch.from_numpy(rng.normal(size=37)),
            torch.from_numpy(rng.integers(0, 9, 13).astype(np.int32)),
            torch.from_numpy(rng.random(11) < 0.5), None,
            torch.zeros((), dtype=torch.int64).expand(6)]
    counts = [37, 13]

    def stamp(b, c=counts):
        return int(cp.payload_stamp(b, c, "cpu"))
    base = stamp(bufs)
    assert stamp(bufs) == base
    for b in (0, 1, 2):
        flat = bufs[b].contiguous().view(torch.uint8).reshape(-1)
        for byte in range(0, flat.numel(), 5):
            for bit in range(8):
                rot = flat.clone()
                rot[byte] ^= 1 << bit
                bad = list(bufs)
                bad[b] = rot.view(bufs[b].dtype).reshape(bufs[b].shape)
                assert stamp(bad) != base
    # a swap of two buffers, another count, another length: all seen
    assert stamp([bufs[1], bufs[0]] + bufs[2:]) != base
    assert stamp(bufs, [37, 12]) != base
    assert stamp(bufs[:4] + [torch.zeros((), dtype=torch.int64)
                             .expand(7)]) != base


def test_checkpoint_floor_protects_another_querys_checkpoint():
    """Pressure from query A moves A's own batches and may not take B's
    checkpoint below the floor; without the floor the checkpoint, the
    coldest priority, moves first (the reference's case)."""
    from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
    from spark_rapids_tpu_torch.columnar.column import Column
    from spark_rapids_tpu_torch.columnar import dtypes as dts
    from spark_rapids_tpu_torch.memory.spill import (
        ACTIVE_ON_DECK_PRIORITY, DEVICE, HOST, SpillableBatchCatalog)

    def mk():
        return ColumnarBatch({"v": Column(
            dts.INT64, torch.arange(1024, dtype=torch.int64), 1024)})
    sz = mk().columns["v"].data.numel() * 8
    cat = SpillableBatchCatalog(device_budget=3 * sz + sz // 2,
                                checkpoint_floor=sz)
    try:
        b_ckpt = cat.register(mk(), cp.CHECKPOINT_PRIORITY, owner=2)
        a = [cat.register(mk(), ACTIVE_ON_DECK_PRIORITY, owner=1)
             for _ in range(3)]
        assert b_ckpt.tier == DEVICE
        assert sum(h.tier == HOST for h in a) >= 1
    finally:
        cat.close()
    cat2 = SpillableBatchCatalog(device_budget=3 * sz + sz // 2)
    try:
        b2 = cat2.register(mk(), cp.CHECKPOINT_PRIORITY)
        for _ in range(3):
            cat2.register(mk(), ACTIVE_ON_DECK_PRIORITY)
        assert b2.tier == HOST
    finally:
        cat2.close()


def test_tiny_query_budget_keeps_checkpoints_and_the_answer():
    """A no-copy checkpoint is aliased: under a per-query memory budget
    smaller than one shard's frame it is neither rejected nor spilled
    (moving it would free nothing the query could use), the write lands,
    and a retry still resumes from it."""
    s = _session(**{"spark.rapids.tpu.serving.queryMemoryBudgetBytes": 64})
    try:
        df = _two_stage(F, s)
        checkpoint_metrics.reset()
        want, got, clean, faulted = _faulted_run(I, s, df,
                                                 dict(count=1, skip=1))
        pd.testing.assert_frame_equal(got, want)
        m = checkpoint_metrics.snapshot()
        assert m["writes"] >= 2 and m["invalid"] == 0
        assert m["resumes"] >= 1 and faulted < 2 * clean
        cat = s.memory_catalog
        assert cat.spilled_to_host_total == 0 and cat.device_bytes == 0
    finally:
        s.stop()


def test_aliased_registration_stays_out_of_the_device_counts():
    """The catalog counts an aliased batch in neither the device tier nor
    its owner's bytes, pressure never picks it, and an explicit demote
    turns it into an ordinary host batch."""
    from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
    from spark_rapids_tpu_torch.columnar.column import Column
    from spark_rapids_tpu_torch.columnar import dtypes as dts
    from spark_rapids_tpu_torch.memory.spill import (
        DEVICE, HOST, SpillableBatchCatalog)

    def mk():
        return ColumnarBatch({"v": Column(
            dts.INT64, torch.arange(1024, dtype=torch.int64), 1024)})
    sz = 1024 * 8
    cat = SpillableBatchCatalog(device_budget=sz // 2)
    try:
        cat.set_owner_budget(7, sz // 4)
        h = cat.register(mk(), cp.CHECKPOINT_PRIORITY, owner=7,
                         aliased=True)
        assert h.tier == DEVICE and h.aliased
        assert cat.device_bytes == 0 and cat.owner_device_bytes(7) == 0
        cat.ensure_budget(extra_needed=sz)
        assert h.tier == DEVICE and cat.spilled_to_host_total == 0
        counted = cat.register(mk(), cp.CHECKPOINT_PRIORITY)
        assert counted.tier == HOST  # past the device budget: it moves
        cat.demote(h, HOST)
        assert h.tier == HOST and not h.aliased
        assert cat.device_bytes == 0 and cat.host_bytes == 2 * sz
        np.testing.assert_array_equal(
            h.materialize().columns["v"].data.numpy(), np.arange(1024))
        h.close()
        counted.close()
        assert (cat.device_bytes, cat.host_bytes) == (0, 0)
    finally:
        cat.close()


def test_compressed_host_tier_round_trips_and_catches_rot():
    """Host frames through the native codec: exact round trips
    (device -> compressed host -> disk -> back), fewer stored bytes than
    raw on repetitive data, and a flipped bit in the frame is dropped as
    corruption."""
    from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
    from spark_rapids_tpu_torch.memory.spill import (
        DISK, HOST, SpillableBatchCatalog)
    from spark_rapids_tpu_torch.robustness.faults import CorruptionFault
    import pyarrow as pa
    rng = np.random.default_rng(0)
    table = pa.table({"s": [f"dim_value_{i % 9}" for i in range(4096)],
                      "i": (np.arange(4096) % 7).astype(np.int64),
                      "f": rng.normal(size=4096)})
    cat = SpillableBatchCatalog(host_codec=2)
    try:
        h = cat.register(ColumnarBatch.from_arrow(table, "cpu"))
        cat.demote(h, HOST)
        assert h.stored_bytes * 2 < h.size_bytes
        assert cat.stats()["host_encoded_bytes_total"] == h.stored_bytes
        assert h.materialize().to_arrow().equals(table)
        cat.demote(h, HOST)
        cat.demote(h, DISK)
        assert h.materialize().to_arrow().equals(table)
        cat.demote(h, HOST)
        with I.injected("spill.corrupt.host", kind="corrupt", count=1):
            with pytest.raises(CorruptionFault):
                h.materialize()
    finally:
        cat.close()


def test_flipped_frame_header_bit_is_a_bad_frame():
    """Each single bit flip in a frame's first 64 bytes (its header and
    length fields) decodes or raises ValueError, which the catalog reads
    as corruption: a length no real frame has is not an allocation."""
    from spark_rapids_tpu_torch import native
    from spark_rapids_tpu_torch.columnar import dtypes as dts
    vals = np.arange(512, dtype=np.int64)
    blob = native.serialize_batch(
        512, [(native.dtype_code(dts.INT64), vals.view(np.uint8), None,
               None)], 2)
    _, cols = native.deserialize_batch(blob)
    np.testing.assert_array_equal(cols[0][1].view(np.int64), vals)
    for pos in range(min(64, len(blob))):
        for bit in range(8):
            bad = bytearray(blob)
            bad[pos] ^= 1 << bit
            try:
                native.deserialize_batch(bytes(bad))
            except ValueError:
                pass


def test_compressed_host_tier_answers_like_numpy_payloads():
    """A sort that spills out of core answers alike with host frames
    compressed and with numpy payloads, and the catalog counts the raw
    and encoded bytes."""
    rng = np.random.default_rng(11)
    frames = [pd.DataFrame({
        "k": rng.integers(0, 50, 4096), "v": rng.normal(size=4096),
        "s": np.array(["r%04d" % i for i in rng.integers(0, 3000, 4096)]),
    }) for _ in range(4)]

    def run(codec):
        s = TpuSession({
            "spark.rapids.tpu.encoding.storage.hostCodec": codec,
            "spark.rapids.memory.tpu.deviceLimitBytes": 200_000,
            "spark.rapids.sql.sort.outOfCoreThresholdBytes": 50_000,
            "spark.rapids.sql.sort.outOfCoreWindowRows": 1000},
            device="cpu")
        try:
            df = s.create_dataframe(frames[0])
            for f in frames[1:]:
                df = df.union(s.create_dataframe(f))
            out = df.orderBy(F.col("v").desc()).to_pandas()
            return out, s.memory_catalog.stats()
        finally:
            s.stop()

    got, on = run("lz4")
    want, off = run("none")
    pd.testing.assert_frame_equal(got, want)
    assert on["spilled_to_host_total"] > 0
    assert 0 < on["host_encoded_bytes_total"] < on["host_raw_bytes_total"]
    assert off["host_encoded_bytes_total"] == 0
