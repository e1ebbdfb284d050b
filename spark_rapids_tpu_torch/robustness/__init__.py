"""Robustness subsystem: fault taxonomy, scoped fault injection, the
query-level recovery driver and the hang watchdog.

Counterpart of ``spark_rapids_tpu/robustness/``:

- ``faults``  — classify every failure the engine can see into
  retryable / degradable / fatal (absorbing ``memory/retry.is_oom``);
  CUDA runtime errors, kernel build failures and unported features are
  FATAL.
- ``inject``  — named injection points threaded through the reader,
  the sharded path's exchange and host syncs, the spill tiers and the
  UDF worker pool, generalizing ``memory/retry.inject_oom(n)``; rules
  can raise, delay/hang, or corrupt payload bits.
- ``driver``  — ``QueryRetryDriver``: wraps plan execution with a
  bounded degradation ladder (retry -> spill -> split-batch ->
  single-device replan -> CPU) and records every recovery action.
- ``watchdog`` — deadlines over monitored engine sections with a
  heartbeat from the pipeline worker; overruns become retryable
  ``TimeoutFault``s delivered at cooperative cancellation checkpoints.
"""

from spark_rapids_tpu_torch.robustness.faults import (  # noqa: F401
    DEGRADABLE, FATAL, RETRYABLE, CorruptionFault, Fault,
    HostSyncError, InjectedFault, SpillIOError, TimeoutFault, classify)
# NOTE: the ``inject`` submodule is imported as a module (its main
# entry point is also named ``inject``, which would shadow it here);
# use ``from spark_rapids_tpu_torch.robustness import inject`` and call
# ``inject.inject(...)`` / ``inject.injected(...)``.
from spark_rapids_tpu_torch.robustness.inject import (  # noqa: F401
    fire, injected, injection_points)
