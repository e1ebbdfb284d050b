"""Device -> host fetches, counted.

Counterpart of ``spark_rapids_tpu/utils/hostsync.py``.  Every value the
host needs from the device on the query path (a row count, the key ranges
that pick a group-by path, a hash-overflow flag, the final result) comes
through :func:`fetch`, which counts one sync per call, so a run can say how
often the host waited for the card.
"""

from __future__ import annotations

import threading
from typing import Sequence

import numpy as np
import torch


class HostSyncMetrics:
    """Process-wide count of device->host synchronisations."""

    def __init__(self):
        self._lock = threading.Lock()
        self.count = 0

    def bump(self, n: int = 1) -> None:
        with self._lock:
            self.count += n

    def snapshot(self) -> int:
        with self._lock:
            return self.count

    def reset(self) -> None:
        with self._lock:
            self.count = 0


host_sync_metrics = HostSyncMetrics()


def _to_host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def fetch(*tensors):
    """Copy tensors to the host as numpy arrays, counted as ONE sync: the
    first copy waits for the stream, the rest find their data ready.
    Returns the arrays in input order (a single tensor returns the bare
    array)."""
    host_sync_metrics.bump(1)
    got = [_to_host(t) for t in tensors]
    return got[0] if len(tensors) == 1 else got


def fetch_all(tensors: Sequence) -> list:
    """List form of :func:`fetch` (always returns a list)."""
    if not tensors:
        return []
    host_sync_metrics.bump(1)
    return [_to_host(t) for t in tensors]
