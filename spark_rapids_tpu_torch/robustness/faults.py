"""Fault taxonomy: classify every failure the engine can see.

Counterpart of ``spark_rapids_tpu/robustness/faults.py``.  ``classify``
turns any exception into a ``Fault`` with a *kind* (what broke) and a
*severity* (what recovery may do about it):

- ``RETRYABLE``  — transient; re-running the same work can succeed
  (a device OOM after a spill, a reader hiccup, a watchdog timeout).
- ``DEGRADABLE`` — deterministic at this plan shape; only *changing*
  the plan can succeed (smaller batches, one device, a UDF inline).
- ``FATAL``      — a real error (a user bug, corrupted input, host
  memory exhaustion, a broken kernel); recovery must re-raise, never
  mask it.

Anything unrecognized is FATAL by default: the ladder never eats an
exception it cannot name.

CUDA: the JAX package names XLA runtime errors by class; their CUDA
counterparts are FATAL here, every one of them.  A CUDA runtime error
(``torch.AcceleratorError``, or a ``RuntimeError`` whose text starts
with "CUDA error") may be sticky (an illegal address poisons the
context), so no retry in the process can succeed, and the ``cpu`` rung
would answer a broken kernel quietly from pandas.  So are a failed
``nvcc`` build or launch in ``ops/kernels.py`` (the ``RuntimeError`` a
CUDA wrapper raises), a failed build of the host runtime, and
``NotImplementedError``.  Only ``torch.OutOfMemoryError`` (and the
injected OOM) is ``device_oom`` RETRYABLE, through ``memory/retry.is_oom``.

NCCL: an error raised by a ``torch.distributed`` collective
(``DistBackendError``, or a ``RuntimeError`` naming NCCL) is FATAL with
kind ``nccl``, on a one-rank group as on any other.  NCCL aborts its
communicator on an asynchronous error and the port never rebuilds its
process group, so re-driving the query would run on a dead
communicator; on one rank there is no peer whose loss could explain the
error either.  The engine's own phase-boundary failure stays the typed,
retryable ``HostSyncError``.
"""

from __future__ import annotations

from dataclasses import dataclass

# severities (ordered by how much the recovery path may change the plan)
RETRYABLE = "RETRYABLE"
DEGRADABLE = "DEGRADABLE"
FATAL = "FATAL"


@dataclass(frozen=True)
class Fault:
    """One classified failure: ``kind`` names the subsystem/failure
    mode, ``severity`` bounds what recovery may do."""

    kind: str
    severity: str

    @property
    def retryable(self) -> bool:
        return self.severity == RETRYABLE

    @property
    def fatal(self) -> bool:
        return self.severity == FATAL


# ---------------------------------------------------------- fault types --
class InjectedFault(Exception):
    """Base for faults raised by the injection registry (inject.py).
    Subclasses pin the kind/severity the real failure would have, so
    the recovery path under test is exactly the production one."""

    kind = "injected"
    severity = RETRYABLE

    def __init__(self, point: str, note: str = ""):
        super().__init__(f"injected fault at {point!r}"
                         + (f": {note}" if note else ""))
        self.point = point


class InjectedReaderFault(InjectedFault, OSError):
    """Synthetic transient I/O error in a file scan."""
    kind = "io_read"


class InjectedShuffleFault(InjectedFault):
    """Synthetic failure inside the all-to-all shuffle exchange."""
    kind = "shuffle"


class InjectedHostSyncFault(InjectedFault):
    """Synthetic phase-boundary sync failure of the sharded path."""
    kind = "host_sync"


class InjectedSpillFault(InjectedFault, OSError):
    """Synthetic disk-tier spill I/O error."""
    kind = "spill_io"


class InjectedWorkerFault(InjectedFault):
    """Synthetic UDF worker-pool death (BrokenProcessPool analog)."""
    kind = "udf_worker"
    severity = DEGRADABLE


class TimeoutFault(Exception):
    """A watchdog deadline fired: a monitored section (reader decode,
    shuffle exchange, the pipeline worker's heartbeat, a query's wall
    time) overran its budget, and the overrun was delivered at the
    driving thread's next cooperative checkpoint
    (robustness/watchdog.py).  Retryable: re-driving the query
    re-establishes the stuck reader or worker."""

    kind = "timeout"
    severity = RETRYABLE

    def __init__(self, point: str, deadline_ms: float,
                 elapsed_ms: float):
        super().__init__(
            f"watchdog deadline exceeded at {point!r}: "
            f"{elapsed_ms:.0f}ms elapsed > {deadline_ms:.0f}ms deadline")
        self.point = point
        self.deadline_ms = deadline_ms
        self.elapsed_ms = elapsed_ms


class CorruptionFault(Exception):
    """A spill payload failed checksum verification on restore (or its
    disk frame no longer decodes).  The corrupt batch is dropped by the
    raising site before this propagates: wrong bytes never reach an
    operator.  Degradable: the stored copy is gone, so only re-running
    from source (a re-planned attempt re-reads its inputs) can produce
    the data again."""

    kind = "spill_corruption"
    severity = DEGRADABLE

    def __init__(self, tier: str, detail: str = ""):
        super().__init__(
            f"spill payload corruption detected at {tier} tier"
            + (f": {detail}" if detail else ""))
        self.tier = tier


class AdmissionFault(Exception):
    """The serving layer rejected this query at (or after) admission:
    the admission queue was full or its wait timed out, or the query
    ran through a per-query budget after the in-query degradations
    (queue, then spill) were spent.  FATAL for this query by design: a
    rejection is a typed answer the client must see, and re-driving it
    down the ladder would take again the very capacity the admission
    layer protects.  Other queries on the session are untouched
    (serving/admission.py)."""

    kind = "admission"
    severity = FATAL

    def __init__(self, reason: str, detail: str = ""):
        super().__init__(
            f"query rejected by admission control ({reason})"
            + (f": {detail}" if detail else ""))
        self.reason = reason


class BudgetExhaustedFault(AdmissionFault):
    """A per-query budget (memory bytes, host syncs) ran out and the
    budget ladder (queue, spill own batches, reject) reached its last
    rung.  Carries which budget died, so the BudgetExhausted event and
    the client's error say what to raise."""

    kind = "budget"

    def __init__(self, budget: str, used, limit):
        super().__init__(
            "budget", f"{budget} budget exhausted ({used} > {limit})")
        self.budget = budget
        self.used = used
        self.limit = limit


class HostSyncError(RuntimeError):
    """A phase boundary of the sharded path failed: the stats exchange
    timed out or the ranks diverged.  Retryable."""


class SpillIOError(OSError):
    """Disk-tier spill I/O failed (write or read-back).  Retryable: a
    failed write leaves the batch at the host tier, nothing is lost,
    and the disk may only be transiently full."""


# CUDA runtime errors the caching allocator or a launch surfaces as
# RuntimeError text (older torch has no AcceleratorError class)
_CUDA_MARKERS = ("CUDA error", "CUDA driver error", "cuda runtime error")
# the RuntimeError texts ops/kernels.py raises for a build or a launch
_KERNEL_MARKERS = ("nvcc", "CUDA launch failed")


def _is_cuda_runtime_error(exc: BaseException) -> bool:
    # by name, not import: torch moved this class between releases
    if any(c.__name__ == "AcceleratorError" for c in type(exc).__mro__):
        return True
    return isinstance(exc, RuntimeError) and \
        str(exc).lstrip().startswith(_CUDA_MARKERS)


def _is_nccl_error(exc: BaseException) -> bool:
    if any(c.__name__ == "DistBackendError" for c in type(exc).__mro__):
        return True
    return isinstance(exc, RuntimeError) and "NCCL" in str(exc)


def classify(exc: BaseException) -> Fault:
    """Map an exception to the taxonomy.  Precedence: injected faults
    declare themselves; the engine's typed failures next; device OOM
    (via ``memory/retry.is_oom``); then the CUDA and kernel failures,
    all FATAL; unknown -> FATAL."""
    if isinstance(exc, InjectedFault):
        return Fault(exc.kind, exc.severity)
    if isinstance(exc, (TimeoutFault, AdmissionFault, CorruptionFault)):
        # AdmissionFault covers BudgetExhaustedFault: a typed per-query
        # rejection the ladder must hand back, never absorb
        return Fault(exc.kind, exc.severity)
    from spark_rapids_tpu_torch.memory.retry import SplitAndRetryOOM, is_oom
    if isinstance(exc, SplitAndRetryOOM):
        # operator-level split already bottomed out at the 1-row floor;
        # only a plan change (smaller scan batches) can help
        return Fault("device_oom", DEGRADABLE)
    if is_oom(exc):
        return Fault("device_oom", RETRYABLE)
    if isinstance(exc, HostSyncError):
        return Fault("host_sync", RETRYABLE)
    if isinstance(exc, SpillIOError):
        return Fault("spill_io", RETRYABLE)
    try:
        from concurrent.futures.process import BrokenProcessPool
        if isinstance(exc, BrokenProcessPool):
            # pool infrastructure death; the worker pool usually
            # degrades inline before this escapes to a query
            return Fault("udf_worker", DEGRADABLE)
    except ImportError:  # torn-down interpreter only
        pass
    if isinstance(exc, NotImplementedError):
        return Fault("not_implemented", FATAL)
    if _is_cuda_runtime_error(exc):
        return Fault("cuda_runtime", FATAL)
    if _is_nccl_error(exc):
        return Fault("nccl", FATAL)
    if type(exc).__name__ == "NativeBuildError":
        return Fault("native_build", FATAL)
    if isinstance(exc, RuntimeError) and \
            any(m in str(exc) for m in _KERNEL_MARKERS):
        return Fault("cuda_kernel", FATAL)
    return Fault("unknown", FATAL)
