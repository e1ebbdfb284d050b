"""Exchange: move rows between shards by destination id.

Counterpart of ``spark_rapids_tpu/parallel/shuffle.py``, cut to what
exact-length shards need.  The JAX package's exchange is a padded
all-to-all with static slots, which is why it carries a slot planner, a
speculative warm path, ragged plans, lane packing, wire encoding and host
staging.  Here every shard's columns hold exactly its rows and the shard
group moves them with exact split sizes, so no slot exists to size and none
of that machinery is needed.

- :func:`exchange`: per local shard, ``layout_by_partition`` (rows sorted
  by destination and counted by the ``partition_histogram`` kernel), then
  one ``all_to_all``.
- :func:`all_gather_cols`: every shard's rows on every shard.
- :class:`ShuffleMetrics`: rows and bytes moved per exchange, process
  wide.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Sequence

import numpy as np
import torch

from spark_rapids_tpu_torch.ops.expressions import ColVal
from spark_rapids_tpu_torch.parallel.mesh import Shard, ShardGroup
from spark_rapids_tpu_torch.parallel.partitioning import layout_by_partition


class ShuffleMetrics:
    """Process-wide exchange counters: exchanges and all-gathers, and the
    rows and bytes (values plus validity bytes) each moved."""

    FIELDS = ("exchanges", "rowsMoved", "bytesMoved", "gathers",
              "rowsGathered", "bytesGathered")

    def __init__(self):
        self._lock = threading.Lock()
        self.counters: Dict[str, int] = {k: 0 for k in self.FIELDS}

    def record_exchange(self, rows: int, nbytes: int) -> None:
        with self._lock:
            self.counters["exchanges"] += 1
            self.counters["rowsMoved"] += int(rows)
            self.counters["bytesMoved"] += int(nbytes)

    def record_gather(self, rows: int, nbytes: int) -> None:
        with self._lock:
            self.counters["gathers"] += 1
            self.counters["rowsGathered"] += int(rows)
            self.counters["bytesGathered"] += int(nbytes)

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self.counters)

    def reset(self) -> None:
        with self._lock:
            for k in self.counters:
                self.counters[k] = 0


shuffle_metrics = ShuffleMetrics()


def _shard_bytes(cols: Sequence[ColVal]) -> int:
    total = 0
    for c in cols:
        total += c.values.numel() * c.values.element_size()
        if c.validity is not None:
            total += c.validity.numel()
    return total


def exchange(shards: Sequence[Shard], pids: Sequence[torch.Tensor],
             nrows: Sequence[int], num_parts: int,
             group: ShardGroup) -> List[Shard]:
    """Send every live row of each local shard to shard ``pids[row]``.

    ``shards[i]``, ``pids[i]`` and ``nrows[i]`` belong to local shard
    ``group.local_shards[i]``; its columns may be longer than ``nrows[i]``
    (padding is dropped).  Returns each local shard's received rows in
    source-shard order, each source's rows in their original order."""
    if num_parts != group.nshards:
        raise ValueError(f"exchange over {group.nshards} shards got "
                         f"{num_parts} partitions")
    sends, counts = [], []
    for cols, p, n in zip(shards, pids, nrows):
        sorted_cols, cnt, _ = layout_by_partition(cols, p, n, num_parts)
        sends.append(sorted_cols)
        counts.append(cnt)
    recv, recv_counts = group.all_to_all(sends, counts)
    shuffle_metrics.record_exchange(
        int(np.asarray(recv_counts).sum()),
        sum(_shard_bytes(r) for r in recv))
    return recv


def all_gather_cols(shards: Sequence[Shard], group: ShardGroup) -> Shard:
    """Every shard's rows, concatenated in shard order (the broadcast of a
    join's build side, and the grand-total merge)."""
    got = group.all_gather(shards)
    rows = got[0].values.shape[0] if got else 0
    shuffle_metrics.record_gather(rows, _shard_bytes(got))
    return got
