"""Prepared statements: hoist and plan once, bind per run.

Counterpart of ``spark_rapids_tpu/api/prepared.py``.
``session.prepare(df)`` runs the literal-hoisting pass
(``plan/template.py``) and plans the template once, and returns a
:class:`PreparedStatement`.  Each ``handle.run(p0=..., p1=...)`` binds a
new parameter vector and executes the cached physical plan: no parsing,
planning or tagging on a repeat, while admission, the recovery ladder,
the watchdog and span tracing apply as to any query (a ladder rung that
re-plans, split or cpu, plans afresh).  The port's stages are eager, so
each slot emits its bound value at each batch and there is no trace to
share.

The handle's ParamSlots are shared state: ``run`` serializes executions
with a per-handle lock, so one handle may be called from many threads
(runs queue); concurrent throughput wants one handle per thread.

Requires ``spark.rapids.tpu.template.enabled`` (default off): with it
off ``prepare`` refuses rather than hand back a handle that re-plans
every run.
"""

from __future__ import annotations

import threading
from typing import List, Tuple

from spark_rapids_tpu_torch.api.dataframe import DataFrame


class PreparedStatement:
    """A hoisted plan template and its physical plan.  Made by
    :meth:`TpuSession.prepare`; ``refusals`` lists the (reason, expr)
    pairs the hoister left inline (a handle with refusals works, it just
    keys more of its plan by value)."""

    def __init__(self, session, df: DataFrame):
        from spark_rapids_tpu_torch.config import rapids_conf as rc
        from spark_rapids_tpu_torch.plan.template import hoist_literals
        if not session.conf.get(rc.TEMPLATE_ENABLED):
            raise RuntimeError(
                "session.prepare requires "
                f"{rc.TEMPLATE_ENABLED.key}=true (plan templates are "
                "off by default; ad-hoc execution is unaffected)")
        self.session = session
        self.dataframe = df
        self.info = hoist_literals(df.plan)
        # planned once here, so no run pays for planning; a physical
        # plan is reusable (execute() returns a fresh iterator)
        self.exec_plan = session.plan(self.info.plan)
        self.run_count = 0
        self._lock = threading.Lock()
        # the frame that runs: the original plan for event and explain
        # text, with the back-pointer _execute_batches reads to adopt
        # this handle's template and physical plan
        self._frame = DataFrame(session, df.plan)
        self._frame._prepared = self

    @property
    def param_count(self) -> int:
        return self.info.param_count

    @property
    def fingerprint(self) -> str:
        return self.info.fingerprint

    @property
    def refusals(self) -> List[Tuple[str, str]]:
        return list(self.info.refusals)

    def describe(self) -> str:
        """The slot table and the refusal list."""
        lines = [f"template {self.info.fingerprint[:16]} "
                 f"({self.param_count} parameter(s))"]
        for s in self.info.slots:
            lines.append(f"  $p{s.index}: {s.dtype.name} "
                         f"= {s.value!r}")
        for reason, expr in self.info.refusals:
            lines.append(f"  inline [{reason}]: {expr}")
        return "\n".join(lines)

    def _resolve(self, args, kwargs) -> Tuple:
        """Positional args (the full vector) or ``pN=...`` keywords
        (partial: slots not named keep their previous binding)."""
        n = self.info.param_count
        if args and kwargs:
            raise TypeError(
                "pass parameters positionally or by name, not both")
        if args:
            return tuple(args)
        vals = list(self.info.values())
        for k, v in kwargs.items():
            if not (len(k) > 1 and k[0] == "p" and k[1:].isdigit()):
                raise TypeError(
                    f"unknown parameter {k!r}; slots are named "
                    f"p0..p{n - 1}")
            i = int(k[1:])
            if i >= n:
                raise TypeError(
                    f"parameter p{i} out of range; template has "
                    f"{n} slot(s)")
            vals[i] = v
        return tuple(vals)

    def _run(self, action, args, params):
        values = self._resolve(args, params)
        with self._lock:
            self.info.bind(values)
            self.run_count += 1
            return action()

    def run_batches(self, *args, **params):
        """Bind and execute; the result's columnar batches."""
        return self._run(self._frame._execute_batches, args, params)

    def run(self, *args, **params) -> List[tuple]:
        """Bind and execute; rows, as ``df.collect()``."""
        return self._run(self._frame.collect, args, params)

    def run_pandas(self, *args, **params):
        return self._run(self._frame.to_pandas, args, params)
