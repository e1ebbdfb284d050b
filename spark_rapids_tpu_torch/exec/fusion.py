"""Whole-stage fusion: a Filter/Project chain as ONE stage.

Counterpart of ``spark_rapids_tpu/exec/fusion.py``.  A chain composes into
one :class:`FusedStageExec`: projections substitute through
(``substitute_bound``), predicates AND into one row mask, and rows compact
once at the stage boundary instead of once per filter.  The chain feeding
an aggregate folds into the aggregate itself (``plan/overrides.py``), its
predicates becoming the aggregate's row mask.
``spark.rapids.tpu.fusion.enabled=false`` runs one stage per operator;
results are identical either way.
"""

from __future__ import annotations

import threading
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.exec.base import (NUM_INPUT_BATCHES,
                                              NUM_INPUT_ROWS, Schema,
                                              TpuExec)
from spark_rapids_tpu_torch.memory.retry import with_retry
from spark_rapids_tpu_torch.ops.compiler import FilterStageFn, StageFn
from spark_rapids_tpu_torch.ops.expressions import (BoundReference,
                                                    Expression,
                                                    substitute_bound)


class FusionMetrics:
    """Process-wide fusion and hash-path counters."""

    FIELDS = ("fusedStages", "fusedOperators", "fusibleChains",
              # hash group-by: launches through the hash table, and
              # launches whose overflow flag sent the stage to the exact
              # sort path
              "hashKernelLaunches", "hashOverflowFallbacks")

    def __init__(self):
        self._lock = threading.Lock()
        self.counters: Dict[str, int] = {k: 0 for k in self.FIELDS}

    def bump(self, field: str, by: int = 1) -> None:
        with self._lock:
            self.counters[field] += int(by)

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self.counters)

    def reset(self) -> None:
        with self._lock:
            for k in self.counters:
                self.counters[k] = 0


fusion_metrics = FusionMetrics()


def compose_chain(exprs: Optional[List[Expression]],
                  conds: List[Expression], node,
                  schema: Schema) -> Tuple[List[Expression],
                                           List[Expression]]:
    """Fold one chain member into the running (exprs, conds) pair.

    After folding ``node``, ``exprs`` and every conjunct are expressed over
    ``node``'s input: a Project substitutes its expressions through them,
    a Filter prepends its predicate, so ``conds`` stays in BOTTOM-FIRST
    order.  Masked evaluation selects the same rows as per-operator
    compaction, because compaction keeps row order and expressions are
    pure."""
    from spark_rapids_tpu_torch.plan import logical as L
    if isinstance(node, L.Project):
        repl = list(node.exprs)
        exprs = repl if exprs is None else \
            [substitute_bound(e, repl) for e in exprs]
        conds = [substitute_bound(c, repl) for c in conds]
    else:  # Filter: namespace unchanged
        if exprs is None:
            exprs = [BoundReference(i, dt, name=n)
                     for i, (n, dt) in enumerate(schema)]
        conds = [node.condition] + conds
    return exprs, conds


class FusedStageExec(TpuExec):
    """One stage for a collapsed Filter/Project chain: ``exprs`` are its
    outputs and ``conds`` the member predicates (bottom-first), all over
    the child's schema."""

    def __init__(self, exprs: Sequence[Expression],
                 conds: Sequence[Expression], child: TpuExec,
                 members: Sequence[str]):
        super().__init__(child)
        self.exprs = list(exprs)
        self.conds = list(conds or [])
        self.members = list(members)
        in_dtypes = [dt for _, dt in child.schema]
        if self.conds:
            self._fn = FilterStageFn(self.conds, self.exprs, in_dtypes)
        else:
            self._fn = StageFn(self.exprs, in_dtypes)
        self._register_metric(NUM_INPUT_ROWS)
        self._register_metric(NUM_INPUT_BATCHES)

    @property
    def child(self) -> TpuExec:
        return self.children[0]

    @property
    def schema(self) -> Schema:
        return [(e.name, e.dtype) for e in self.exprs]

    def describe(self) -> str:
        return (f"FusedStageExec[{'+'.join(self.members)}; "
                f"{len(self.exprs)} cols"
                + (", filtered" if self.conds else "") + "]")

    def _tallied(self) -> Iterator[ColumnarBatch]:
        for batch in self.child.execute():
            self.metrics[NUM_INPUT_ROWS] += batch.row_count
            self.metrics[NUM_INPUT_BATCHES] += 1
            yield batch

    def do_execute(self) -> Iterator[ColumnarBatch]:
        """One stage call per batch, under ``with_retry`` (a device OOM
        spills the catalog, then splits the batch)."""
        names = [e.name for e in self.exprs]
        catalog = self.spill_catalog()
        if not self.conds:
            yield from with_retry(
                self._tallied(),
                lambda b: ColumnarBatch(dict(zip(names, self._fn(b))),
                                        b.row_count), catalog=catalog)
            return
        for cols, n in with_retry(self._tallied(), self._fn,
                                  catalog=catalog):
            if n:
                yield ColumnarBatch(dict(zip(names, cols)), n)
