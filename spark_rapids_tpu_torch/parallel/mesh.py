"""Shard groups: the port's counterpart of the JAX package's device mesh.

Counterpart of ``spark_rapids_tpu/parallel/mesh.py`` (its ``make_mesh``;
the fleet, logical hosts, membership and link kinds are not ported).  The
JAX package runs one SPMD program per device of a ``jax.sharding.Mesh``.
The port runs the same per-shard steps as Python loops over the shards
this process holds, behind one small interface with two implementations:

- :class:`LocalShards` holds all ``n`` shards in one process on one
  device (the counterpart of the JAX package's single-device virtual
  mesh).  Its exchange is a device-local copy.
- :class:`ProcessGroupShards` holds one shard per rank of a
  ``torch.distributed`` process group: NCCL for CUDA tensors, gloo for
  CPU tensors.

Every shard's columns are tensors of exactly its row count.  The
collectives:

- ``all_to_all(sends, counts)``: each local shard's rows laid out by
  destination, with ``counts[d]`` rows for destination ``d``.  The counts
  (and which columns carry validity) travel first, in one small
  exchange fetched to the host in one counted sync; then each column's
  values and validity move with exact split sizes.  Returns each local
  shard's received rows, in source-shard order.
- ``all_gather(cols)``: every shard's rows, concatenated in shard order,
  on every local shard.
- ``host_sync(per_shard)``: one small tensor (or a tuple of them) per
  local shard, each stacked over all shards into a numpy array, through
  ``utils/hostsync.fetch_all`` (one counted sync).  Every process gets
  the same arrays, so every rank makes the same decision from them.
- ``all_counts(ints)``: host row counts of every shard.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch.ops.expressions import ColVal
from spark_rapids_tpu_torch.utils import hostsync

# an exchanged shard: its columns (exact length) in the schema's order
Shard = List[ColVal]


class ShardGroup:
    """``nshards`` shards; this process holds ``local_shards`` of them
    (shard indices, ascending) on ``device``."""

    nshards: int
    device: torch.device
    local_shards: List[int]

    def all_to_all(self, sends: Sequence[Shard],
                   counts: Sequence[torch.Tensor]
                   ) -> Tuple[List[Shard], np.ndarray]:
        """``sends[i]``: local shard i's rows sorted by destination;
        ``counts[i]``: int32[nshards] rows per destination.  Returns the
        received shards and the host counts matrix ``[local, src]`` of
        rows each local shard received from each source."""
        raise NotImplementedError

    def all_gather(self, shards: Sequence[Shard]) -> Shard:
        raise NotImplementedError

    def host_sync(self, per_shard):
        """``per_shard[i]``: a tensor, or a tuple of tensors, of local
        shard i (same shapes on every shard).  Returns the numpy stack
        over all shards (shard first), or a tuple of them."""
        raise NotImplementedError

    def all_counts(self, counts: Sequence[int]) -> np.ndarray:
        raise NotImplementedError

    def __repr__(self) -> str:
        return (f"{type(self).__name__}(nshards={self.nshards}, "
                f"local={self.local_shards}, device={self.device})")


def _validity_flags(shards: Sequence[Shard], ncols: int) -> List[bool]:
    return [any(s[j].validity is not None for s in shards)
            for j in range(ncols)]


def _validity_or_ones(c: ColVal) -> torch.Tensor:
    if c.validity is not None:
        return c.validity
    return torch.ones(c.values.shape[0], dtype=torch.bool,
                      device=c.values.device)


def _check_fixed_width(shards: Sequence[Shard]) -> None:
    for s in shards:
        for c in s:
            if c.offsets is not None:
                raise ValueError(
                    "a string column reached the exchange: the sharded "
                    "path moves strings only as dictionary codes")


class LocalShards(ShardGroup):
    """All ``n`` shards in this process, on one device."""

    def __init__(self, n: int, device):
        if n < 1:
            raise ValueError(f"a shard group needs at least one shard, "
                             f"got {n}")
        self.nshards = int(n)
        self.device = torch.device(device)
        self.local_shards = list(range(self.nshards))

    def all_to_all(self, sends, counts):
        n = self.nshards
        if len(sends) != n or len(counts) != n:
            raise ValueError(f"all_to_all needs {n} local shards")
        _check_fixed_width(sends)
        cnt = hostsync.fetch(torch.stack(
            [c.to(torch.int64) for c in counts])).astype(np.int64)
        ncols = len(sends[0])
        flags = _validity_flags(sends, ncols)
        out: List[Shard] = [[] for _ in range(n)]
        for j in range(ncols):
            splits = [torch.split(sends[s][j].values, cnt[s].tolist())
                      for s in range(n)]
            vsplits = None
            if flags[j]:
                vsplits = [torch.split(_validity_or_ones(sends[s][j]),
                                       cnt[s].tolist()) for s in range(n)]
            for d in range(n):
                vals = torch.cat([splits[s][d] for s in range(n)])
                valid = None if vsplits is None else \
                    torch.cat([vsplits[s][d] for s in range(n)])
                out[d].append(ColVal(sends[0][j].dtype, vals, valid))
        return out, cnt.T.copy()

    def all_gather(self, shards):
        if len(shards) != self.nshards:
            raise ValueError(f"all_gather needs {self.nshards} shards")
        _check_fixed_width(shards)
        ncols = len(shards[0])
        flags = _validity_flags(shards, ncols)
        out = []
        for j in range(ncols):
            vals = torch.cat([s[j].values for s in shards])
            valid = torch.cat([_validity_or_ones(s[j]) for s in shards]) \
                if flags[j] else None
            out.append(ColVal(shards[0][j].dtype, vals, valid))
        return out

    def host_sync(self, per_shard):
        tup = isinstance(per_shard[0], tuple)
        parts = [list(t) if tup else [t] for t in per_shard]
        got = hostsync.fetch_all([torch.stack([p[k] for p in parts])
                                  for k in range(len(parts[0]))])
        return tuple(got) if tup else got[0]

    def all_counts(self, counts):
        return np.asarray(list(counts), dtype=np.int64)


def _wire(t: torch.Tensor) -> torch.Tensor:
    """bool travels as its bytes: not every backend reduces or moves bool."""
    return t.view(torch.uint8) if t.dtype == torch.bool else t


class ProcessGroupShards(ShardGroup):
    """One shard per rank of a ``torch.distributed`` process group; the
    backend follows the device (NCCL for CUDA, gloo for the CPU)."""

    def __init__(self, group=None, device="cpu"):
        import torch.distributed as dist
        if not dist.is_initialized():
            raise RuntimeError("ProcessGroupShards needs an initialised "
                               "torch.distributed process group")
        self._dist = dist
        self.group = group if group is not None else dist.group.WORLD
        self.nshards = dist.get_world_size(self.group)
        self.rank = dist.get_rank(self.group)
        self.device = torch.device(device)
        self.local_shards = [self.rank]

    def all_to_all(self, sends, counts):
        dist = self._dist
        n = self.nshards
        if len(sends) != 1 or len(counts) != 1:
            raise ValueError("a process holds exactly one shard")
        _check_fixed_width(sends)
        send = sends[0]
        ncols = len(send)
        # row counts and validity flags first: row d goes to rank d
        msg = torch.zeros(n, 1 + ncols, dtype=torch.int64,
                          device=self.device)
        msg[:, 0] = counts[0].to(torch.int64)
        for j, c in enumerate(send):
            msg[:, 1 + j] = int(c.validity is not None)
        got = torch.empty_like(msg)
        dist.all_to_all_single(got, msg, group=self.group)
        host = hostsync.fetch(torch.stack([msg, got]))
        send_cnt = host[0][:, 0].tolist()
        recv_cnt = host[1][:, 0].tolist()
        # every rank received every rank's flags: the union agrees
        flags = host[1][:, 1:].any(axis=0).tolist()
        total = int(sum(recv_cnt))
        out: Shard = []
        for j, c in enumerate(send):
            vals = torch.empty(total, dtype=c.values.dtype,
                               device=self.device)
            dist.all_to_all_single(
                _wire(vals), _wire(c.values.contiguous()),
                output_split_sizes=recv_cnt, input_split_sizes=send_cnt,
                group=self.group)
            valid = None
            if flags[j]:
                valid = torch.empty(total, dtype=torch.bool,
                                    device=self.device)
                dist.all_to_all_single(
                    _wire(valid), _wire(_validity_or_ones(c).contiguous()),
                    output_split_sizes=recv_cnt,
                    input_split_sizes=send_cnt, group=self.group)
            out.append(ColVal(c.dtype, vals, valid))
        return [out], np.asarray([recv_cnt], dtype=np.int64)

    def _gather_equal(self, t: torch.Tensor) -> List[torch.Tensor]:
        parts = [torch.empty_like(t) for _ in range(self.nshards)]
        self._dist.all_gather(parts, t.contiguous(), group=self.group)
        return parts

    def all_gather(self, shards):
        if len(shards) != 1:
            raise ValueError("a process holds exactly one shard")
        _check_fixed_width(shards)
        mine = shards[0]
        ncols = len(mine)
        n_mine = mine[0].values.shape[0] if mine else 0
        head = torch.tensor(
            [n_mine] + [int(c.validity is not None) for c in mine],
            dtype=torch.int64, device=self.device)
        heads = hostsync.fetch(torch.stack(self._gather_equal(head)))
        lens = heads[:, 0].tolist()
        flags = heads[:, 1:].any(axis=0).tolist()
        width = max(max(lens), 1)
        out = []
        for j in range(ncols):
            c = mine[j]
            cols = [(c.values, False)]
            if flags[j]:
                cols.append((_validity_or_ones(c), True))
            got = []
            for t, _ in cols:
                padded = torch.zeros(width, dtype=t.dtype,
                                     device=self.device)
                padded[:n_mine] = t
                parts = self._gather_equal(_wire(padded))
                whole = torch.cat([p[:k] for p, k in zip(parts, lens)])
                got.append(whole.view(torch.bool) if t.dtype == torch.bool
                           else whole)
            out.append(ColVal(c.dtype, got[0],
                              got[1] if flags[j] else None))
        return out

    def host_sync(self, per_shard):
        if len(per_shard) != 1:
            raise ValueError("a process holds exactly one shard")
        tup = isinstance(per_shard[0], tuple)
        mine = list(per_shard[0]) if tup else [per_shard[0]]
        got = hostsync.fetch_all([torch.stack(self._gather_equal(_wire(t)))
                                  for t in mine])
        got = [g.view(np.bool_) if t.dtype == torch.bool else g
               for g, t in zip(got, mine)]
        return tuple(got) if tup else got[0]

    def all_counts(self, counts):
        t = torch.tensor(list(counts), dtype=torch.int64,
                         device=self.device)
        return self.host_sync([t]).reshape(-1)


def make_mesh(n_devices: int, device=None) -> LocalShards:
    """``n_devices`` logical shards on one device (``cuda:0`` unless the
    caller asks for another): the port's counterpart of the JAX package's
    ``make_mesh``, whose virtual CPU devices this mirrors."""
    from spark_rapids_tpu_torch.api.session import resolve_device
    return LocalShards(n_devices, resolve_device(device))
