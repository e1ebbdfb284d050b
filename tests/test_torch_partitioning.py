"""The PyTorch port's partitioning against the JAX package's, on the CPU.

``partition_histogram`` (its plain version, which the wrapper runs for CPU
tensors) against the JAX package's Pallas kernel in interpret mode, its
XLA oracle and its ``histogram`` dispatcher; the row hash against the JAX
package's device hash and both packages' host copies; and
``layout_by_partition``'s counts and row order.  All of it is integer
arithmetic, so every comparison is exact.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spark_rapids_tpu.columnar import dtypes as jdts
from spark_rapids_tpu.ops import pallas_kernels as pk
from spark_rapids_tpu.ops.expressions import ColVal as JaxColVal
from spark_rapids_tpu.parallel import partitioning as JP
from spark_rapids_tpu_torch.columnar import dtypes as tdts
from spark_rapids_tpu_torch.ops import kernels as K
from spark_rapids_tpu_torch.ops.expressions import ColVal
from spark_rapids_tpu_torch.parallel import partitioning as TP


# ------------------------------------------------------ partition histogram --

def _hist_inputs(n, parts, case, seed):
    rng = np.random.default_rng(seed)
    pids = rng.integers(0, parts, n).astype(np.int32)
    mask = rng.random(n) < 0.7
    if case == "all_masked":
        mask[:] = False
    elif case == "out_of_range":
        bad = rng.random(n) < 0.2
        pids[bad] = rng.choice(np.array([-7, -1, parts, parts + 5, 1 << 30],
                                        dtype=np.int32), int(bad.sum()))
    elif case == "all_live":
        mask[:] = True
    return pids, mask


@pytest.mark.parametrize("case", ["mixed", "all_masked", "out_of_range",
                                  "all_live"])
@pytest.mark.parametrize("n,parts", [(0, 8), (1, 8), (1000, 8), (2049, 32),
                                     (4096, 3)])
def test_partition_histogram_matches_jax(n, parts, case):
    pids, mask = _hist_inputs(n, parts, case, seed=n + parts)
    jp, jm = jnp.asarray(pids), jnp.asarray(mask)
    want = [np.asarray(pk.partition_histogram_xla(jp, jm, parts)),
            np.asarray(pk.histogram(jp, jm, parts))]
    if n:
        want.append(np.asarray(pk.partition_histogram(jp, jm, parts,
                                                      interpret=True)))
    tp, tm = torch.from_numpy(pids), torch.from_numpy(mask)
    got = [K.partition_histogram_plain(tp, tm, parts),
           K.partition_histogram(tp, tm, parts),
           K.histogram(tp, tm, parts)]
    for g in got:
        assert g.dtype == torch.int32 and g.shape == (parts,)
        for w in want:
            np.testing.assert_array_equal(g.numpy(), w)


def test_partition_histogram_counts_no_launch_on_cpu():
    K.launches.reset()
    K.partition_histogram(torch.zeros(5, dtype=torch.int32),
                          torch.ones(5, dtype=torch.bool), 4)
    assert K.launches.snapshot()["partition_histogram"] == 0
    with pytest.raises(ValueError):
        K.partition_histogram(torch.zeros(5, dtype=torch.int32),
                              torch.ones(5, dtype=torch.bool), 0)


# ----------------------------------------------------------------- hashing --

def _key_columns(n, seed):
    """(name, jax dtype, port dtype, values, validity or None)."""
    rng = np.random.default_rng(seed)
    f = rng.normal(size=n) * 1e6
    f[rng.random(n) < 0.1] = -0.0
    f[rng.random(n) < 0.1] = 0.0
    f[rng.random(n) < 0.1] = np.nan
    f[rng.random(n) < 0.05] = 1e-300
    f32 = (rng.normal(size=n) * 100).astype(np.float32)
    f32[::13] = -0.0
    f32[::17] = np.nan
    return [
        ("int64", jdts.INT64, tdts.INT64,
         rng.integers(-(1 << 62), 1 << 62, n), None),
        ("int32", jdts.INT32, tdts.INT32,
         rng.integers(-(1 << 31), 1 << 31, n).astype(np.int32), None),
        ("float64", jdts.FLOAT64, tdts.FLOAT64, f, None),
        ("float32", jdts.FLOAT32, tdts.FLOAT32, f32, None),
        ("bool", jdts.BOOL, tdts.BOOL, rng.random(n) < 0.5, None),
        ("nullable_int64", jdts.INT64, tdts.INT64,
         rng.integers(0, 50, n), rng.random(n) < 0.7),
        ("nullable_float64", jdts.FLOAT64, tdts.FLOAT64, f.copy(),
         rng.random(n) < 0.6),
    ]


def _jax_cv(jdt, values, validity):
    return JaxColVal(jdt, jnp.asarray(values),
                     None if validity is None else jnp.asarray(validity))


def _torch_cv(tdt, values, validity):
    return ColVal(tdt, torch.from_numpy(np.ascontiguousarray(values)),
                  None if validity is None else torch.from_numpy(validity))


@pytest.mark.parametrize("parts", [8, 32, 5])
@pytest.mark.parametrize("which", ["int64", "int32", "float64", "float32",
                                   "bool", "nullable_int64",
                                   "nullable_float64", "all"])
def test_hash_partition_ids_bit_identical(which, parts):
    cols = _key_columns(3000, seed=parts)
    if which != "all":
        cols = [c for c in cols if c[0] == which]
    jcols = [_jax_cv(jdt, v, ok) for _, jdt, _, v, ok in cols]
    tcols = [_torch_cv(tdt, v, ok) for _, _, tdt, v, ok in cols]
    want = np.asarray(JP.hash_partition_ids(jcols, parts))
    got = TP.hash_partition_ids(tcols, parts)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    host = [(v, ok) for _, _, _, v, ok in cols]
    np.testing.assert_array_equal(TP.host_hash_partition_ids(host, parts),
                                  want)
    np.testing.assert_array_equal(JP.host_hash_partition_ids(host, parts),
                                  want)
    # the full 32-bit hash too, not only its residue
    np.testing.assert_array_equal(
        TP.hash_columns(tcols).numpy(),
        np.asarray(JP.hash_columns(jcols)).astype(np.int64))


def test_equal_values_hash_equal():
    v = torch.tensor([0.0, -0.0, float("nan"), -float("nan"), 1.5, 1.5],
                     dtype=torch.float64)
    h = TP.hash_columns([ColVal(tdts.FLOAT64, v)]).tolist()
    assert h[0] == h[1] and h[2] == h[3] and h[4] == h[5]
    ids = TP.hash_partition_ids([ColVal(tdts.INT64,
                                        torch.full((64,), 7))], 8)
    assert len(set(ids.tolist())) == 1


# ---------------------------------------------------------------- layout --

@pytest.mark.parametrize("nrows", [0, 1, 177, 256])
def test_layout_by_partition_matches_jax(nrows):
    cap, parts = 256, 4
    rng = np.random.default_rng(nrows)
    vals = rng.integers(0, 1 << 40, cap)
    fv = rng.normal(size=cap)
    ok = rng.random(cap) < 0.8
    pids = rng.integers(0, parts, cap).astype(np.int32)
    jcols, jcounts, jstarts = jax.jit(
        lambda v, f, o, p: JP.layout_by_partition(
            [JaxColVal(jdts.INT64, v), JaxColVal(jdts.FLOAT64, f, o)], p,
            jnp.int32(nrows), parts))(jnp.asarray(vals), jnp.asarray(fv),
                                       jnp.asarray(ok), jnp.asarray(pids))
    tcols, tcounts, tstarts = TP.layout_by_partition(
        [ColVal(tdts.INT64, torch.from_numpy(vals)),
         ColVal(tdts.FLOAT64, torch.from_numpy(fv), torch.from_numpy(ok))],
        torch.from_numpy(pids), nrows, parts)
    np.testing.assert_array_equal(tcounts.numpy(), np.asarray(jcounts))
    np.testing.assert_array_equal(tstarts.numpy(), np.asarray(jstarts))
    assert int(tcounts.sum()) == nrows
    # the live prefix of the JAX layout, row for row
    for t, j in zip(tcols, jcols):
        assert t.values.shape[0] == nrows
        np.testing.assert_array_equal(t.values.numpy(),
                                      np.asarray(j.values)[:nrows])
        if j.validity is not None:
            np.testing.assert_array_equal(
                t.validity.numpy(), np.asarray(j.validity)[:nrows])


# ------------------------------------------------ the other partitionings --

def test_round_robin_single_and_range_ids_match_jax():
    for start in (0, 5):
        np.testing.assert_array_equal(
            TP.round_robin_partition_ids(100, 7, start, device="cpu").numpy(),
            np.asarray(JP.round_robin_partition_ids(100, 7, start)))
    np.testing.assert_array_equal(
        TP.single_partition_ids(33, device="cpu").numpy(),
        np.asarray(JP.single_partition_ids(33)))
    rng = np.random.default_rng(1)
    keys = rng.integers(-50, 50, 500)
    bounds = np.array([-20, 0, 0, 13, 40], dtype=np.int64)
    got = TP.range_partition_ids(ColVal(tdts.INT64, torch.from_numpy(keys)),
                                 torch.from_numpy(bounds))
    want = JP.range_partition_ids(JaxColVal(jdts.INT64, jnp.asarray(keys)),
                                  jnp.asarray(bounds))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
