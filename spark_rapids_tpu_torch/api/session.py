"""TpuSession: the entry point of the PyTorch engine.

Counterpart of ``spark_rapids_tpu/api/session.py``.  A session owns its
configuration and one device.  ``TpuSession(conf)`` runs on ``cuda:0``
and raises when no CUDA device is present: it never carries on quietly on
the CPU.  Pass ``device="cpu"`` to run on the CPU on purpose (the tests
do); the hand-written kernels' plain versions then run instead.
"""

from __future__ import annotations

from typing import Dict, Optional, Union

import torch

from spark_rapids_tpu_torch.api.dataframe import DataFrame
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.config.rapids_conf import RapidsConf
from spark_rapids_tpu_torch.plan import logical as L
from spark_rapids_tpu_torch.plan.overrides import TpuOverrides


def resolve_device(device=None) -> torch.device:
    """``None`` means ``cuda:0``; a CUDA device must exist."""
    dev = torch.device("cuda:0" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; the PyTorch engine runs on the "
            "GPU unless the caller asks for the CPU with device='cpu'")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


class TpuSession:
    def __init__(self, conf: Optional[Union[RapidsConf, Dict]] = None,
                 device=None):
        self.conf = conf if isinstance(conf, RapidsConf) else \
            RapidsConf(conf)
        self.device = resolve_device(device)
        self.overrides = TpuOverrides(self.conf, self.device)
        self.stopped = False

    def create_dataframe(self, data) -> DataFrame:
        """A DataFrame over a dict of numpy arrays (or lists with None
        for nulls), a pandas DataFrame, or a ColumnarBatch already on the
        session's device.  The data is copied to the device once, here."""
        import pandas as pd
        if isinstance(data, pd.DataFrame):
            batch = ColumnarBatch.from_pandas(data, device=self.device)
        elif isinstance(data, dict):
            batch = ColumnarBatch.from_pydict(data, device=self.device)
        elif isinstance(data, ColumnarBatch):
            if data.device != self.device:
                raise ValueError(f"batch is on {data.device}, session on "
                                 f"{self.device}")
            batch = data
        else:
            raise TypeError(f"cannot create a DataFrame from {type(data)}")
        return DataFrame(self, L.InMemoryRelation([batch], batch.schema))

    def plan(self, logical: L.LogicalPlan):
        if self.stopped:
            raise RuntimeError("session is stopped")
        return self.overrides.apply(logical)

    def stop(self) -> None:
        self.stopped = True
