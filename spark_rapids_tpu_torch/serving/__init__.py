"""Session-level serving layer: admission control, query isolation and
fair interleaving.

Counterpart of ``spark_rapids_tpu/serving/``.  Concurrent queries share
one session and one card, and the robustness contract tightens from
"this query recovers" to "this query's failure cannot become another
query's wrong answer or crash":

- ``admission`` — the byte-weighted, fair FIFO admission semaphore (the
  reference GpuSemaphore at query granularity): bounds concurrent
  queries and their summed memory weights, with a typed
  ``AdmissionFault`` on queue overflow or wait timeout.
- ``context`` — ``QueryContext``: scopes every piece of per-query
  robustness state to one query, and purges stale thread-ident
  adoptions at exit.
- ``scheduler`` — ``FairInterleaver``: weighted round robin over the
  admitted queries' batch pulls (off by default).
"""

from spark_rapids_tpu_torch.serving.admission import (  # noqa: F401
    AdmissionController, AdmissionTicket)
from spark_rapids_tpu_torch.serving.context import QueryContext  # noqa: F401
