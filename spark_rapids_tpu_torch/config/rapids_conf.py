"""Typed configuration: the keys this port reads, under the JAX package's
names, defaults and validation (``spark_rapids_tpu/config/rapids_conf.py``).

A conf dict written for the JAX engine passes unchanged as long as it only
sets these keys; any other ``spark.rapids.*`` key is rejected, because a
knob the port does not read must fail loudly rather than silently no-op.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional


class ConfEntry:
    """One typed config entry."""

    def __init__(self, key: str, default: Any, doc: str, conv: Callable,
                 validator: Optional[Callable[[Any], Optional[str]]] = None):
        self.key = key
        self.default = default
        self.doc = doc
        self.conv = conv
        self.validator = validator

    def get(self, settings: Dict[str, Any]) -> Any:
        raw = settings.get(self.key)
        if raw is None:
            return self.default
        value = self.conv(raw) if isinstance(raw, str) else raw
        if self.validator is not None:
            err = self.validator(value)
            if err:
                raise ValueError(f"{self.key}={value!r}: {err}")
        return value


def _to_bool(s: str) -> bool:
    return s.strip().lower() in ("1", "true", "yes", "on")


def _to_int(s: str) -> int:
    return int(s)


def _positive(v):
    return None if v > 0 else "must be positive"


_REGISTRY: Dict[str, ConfEntry] = {}


def conf(key, default, doc, conv=str, validator=None) -> ConfEntry:
    assert key not in _REGISTRY, f"duplicate conf {key}"
    entry = ConfEntry(key, default, doc, conv, validator)
    _REGISTRY[key] = entry
    return entry


BATCH_SIZE_BYTES = conf(
    "spark.rapids.sql.batchSizeBytes", 1 << 31,
    "Target size in bytes for columnar batches; hard-capped at 2 GiB.  "
    "The in-memory scan cuts its input into batches of at most this many "
    "bytes.", _to_int,
    lambda v: None if 0 < v <= (1 << 31) else "must be in (0, 2GiB]")

BATCH_ROW_CAPACITY = conf(
    "spark.rapids.sql.tpu.maxBatchRows", 1 << 22,
    "Maximum rows per device batch: the in-memory scan cuts its input "
    "into batches of at most this many rows, so a large table runs "
    "partial aggregation per batch and then one merge.", _to_int,
    _positive)

FUSION_ENABLED = conf(
    "spark.rapids.tpu.fusion.enabled", True,
    "Whole-stage fusion (exec/fusion.py): the planner collapses maximal "
    "Filter/Project chains, and the chain feeding an aggregate, into one "
    "stage whose predicates travel as a row mask and whose rows compact "
    "once at the stage boundary.  False runs one stage per operator; "
    "results are identical either way.", _to_bool)

PALLAS_HASH_ENABLED = conf(
    "spark.rapids.tpu.pallas.hash.enabled", False,
    "Hash-table group-by (ops/kernels.py hash_insert): where the dense "
    "coded directory cannot hold the key space, an open-addressing table "
    "over the 64-bit coded key replaces the sort path.  A probe chain "
    "past 256 steps, or more groups than slots, raises the overflow flag: "
    "the stage discards the hash output and re-runs the exact sort path, "
    "counted in hashOverflowFallbacks.  Results are identical either "
    "way.", _to_bool)

PALLAS_HASH_TABLE_SLOTS = conf(
    "spark.rapids.tpu.pallas.hash.tableSlots", 1 << 16,
    "Slot count of the hash group-by table (power of two).  Bounds the "
    "distinct groups per launch: more groups than slots overflow to the "
    "sort path.", _to_int,
    lambda v: None if v >= 64 and (v & (v - 1)) == 0
    else "must be a power of two >= 64")


class RapidsConf:
    """Immutable view over a settings dict."""

    def __init__(self, settings: Optional[Dict[str, Any]] = None):
        self.settings = dict(settings or {})
        for k in self.settings:
            if k.startswith("spark.rapids.") and k not in _REGISTRY:
                raise ValueError(
                    f"unknown configuration key {k!r}: the PyTorch port "
                    f"reads only {sorted(_REGISTRY)}")
        for entry in _REGISTRY.values():
            entry.get(self.settings)  # validate eagerly

    def get(self, entry: ConfEntry) -> Any:
        return entry.get(self.settings)
