"""Cost-based optimizer: send device regions back to the CPU when they
cannot pay for their host<->device transitions.

Counterpart of ``spark_rapids_tpu/plan/cbo.py`` (the reference's
``CostBasedOptimizer.scala``; off by default, on with
``spark.rapids.sql.optimizer.enabled``).  It works on device regions:
maximal connected subtrees of plan nodes that run on the device (judged
by each node's own reasons, so a region above a CPU child still counts)
and that the CPU fallback can run.
A region's cost is

    device = sum(rows_i * w_device(op_i)) + (rows_in + rows_out) * w_transition
    cpu    = sum(rows_i * w_cpu(op_i))

where rows_in come from CPU children and rows_out go to the collect or a
CPU parent, with rows estimated bottom-up (exact for in-memory relations,
fixed selectivities elsewhere).  Rows that pass to or from a device node
the fallback cannot run (a Window, a semi or anti join) are charged to the
cpu side instead: they cross only if the region reverts.  When
``device > cpu`` every node of the region is tagged "not worth the
transition cost (CBO ...)" and the planner's fallback does the rest.  Leaf relations stay as they are: they read from
the host or the card either way.

Weights are microseconds per row.  ``load_weights`` reads
``cbo_weights.json`` beside this module only when the file's provenance
names the platform it runs for (``cuda`` or ``cpu``); otherwise, and as
shipped (no file), it serves the built-in ratio table, in which every
device operator costs a sixth of its CPU twin, and ``weights_calibrated()``
is False.  ``spark.rapids.sql.optimizer.{tpu,cpu}OpCost.<Op>`` override
single entries.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Tuple

from spark_rapids_tpu_torch.plan import logical as L

# the built-in table (arbitrary units; only the ratios matter), scaled by
# _US_PER_UNIT into the us/row domain of transitionRowCost
_BUILTIN_CPU_W = {
    "Project": 1.0, "Filter": 1.0, "Aggregate": 4.0, "Join": 6.0,
    "Sort": 5.0, "Window": 8.0, "Limit": 0.1, "Union": 0.1,
    "default": 1.0,
}
_BUILTIN_TPU_W = {k: v / 6.0 for k, v in _BUILTIN_CPU_W.items()}
_US_PER_UNIT = 0.05

_WEIGHTS_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "cbo_weights.json")
_loaded: Dict[str, Tuple[Dict[str, float], Dict[str, float], bool]] = {}


def weights_calibrated(platform: str = "cuda") -> bool:
    """True when ``load_weights(platform)`` serves a calibration measured
    on that platform; False when it serves the built-in table."""
    return load_weights(platform)[2]


def load_weights(platform: str = "cuda"
                 ) -> Tuple[Dict[str, float], Dict[str, float], bool]:
    """(device weights, cpu weights, calibrated) in us/row for a session
    on ``platform`` (a torch device type).  A weights file measured on
    another platform is fiction here (a CPU's sort and join costs would
    revert every region on the card), so it is ignored."""
    got = _loaded.get(platform)
    if got is not None:
        return got
    try:
        with open(_WEIGHTS_PATH, encoding="utf-8") as f:
            blob = json.load(f)
        if blob.get("provenance", {}).get("platform") != platform:
            raise ValueError(f"{_WEIGHTS_PATH} was not measured on "
                             f"{platform!r}")
        data = blob["weights"]
        dev = {k: float(v["tpu"]) for k, v in data.items()}
        cpu = {k: float(v["cpu"]) for k, v in data.items()}
        # an unmeasured op takes the measured median ratio
        ratios = sorted(dev[k] / cpu[k] for k in dev if cpu[k] > 0)
        med = ratios[len(ratios) // 2] if ratios else 1.0
        for k, v in _BUILTIN_CPU_W.items():
            cpu.setdefault(k, v * _US_PER_UNIT)
            dev.setdefault(k, cpu[k] * med)
        got = (dev, cpu, True)
    except (OSError, KeyError, TypeError, ValueError):
        got = ({k: v * _US_PER_UNIT for k, v in _BUILTIN_TPU_W.items()},
               {k: v * _US_PER_UNIT for k, v in _BUILTIN_CPU_W.items()},
               False)
    _loaded[platform] = got
    return got


def _estimate_rows(node, child_rows: List[float]) -> float:
    if isinstance(node, L.InMemoryRelation):
        return float(sum(b.nrows for b in node.batches))
    if isinstance(node, L.FileRelation):
        return 1_000_000.0 * max(len(node.paths), 1)
    if isinstance(node, L.Range):
        step = node.step or 1
        return float(max((node.end - node.start) // step, 0))
    inp = child_rows[0] if child_rows else 0.0
    if isinstance(node, L.Filter):
        return inp * 0.5
    if isinstance(node, L.Aggregate):
        return max(inp * 0.1, 1.0)
    if isinstance(node, L.Join):
        right = child_rows[1] if len(child_rows) > 1 else 0.0
        return max(inp, right)
    if isinstance(node, L.Limit):
        return min(inp, float(node.n))
    if isinstance(node, L.Union):
        return float(sum(child_rows))
    return inp


_LEAVES = (L.InMemoryRelation, L.FileRelation, L.Range)


def _revertible(meta) -> bool:
    """A device node the CPU fallback can run.  A device node it cannot
    run (a Window, a semi or anti join) stays on the device and bounds
    the regions around it."""
    from spark_rapids_tpu_torch.exec.fallback import host_runnable
    return not meta.reasons and host_runnable(meta.wrapped)


class CostBasedOptimizer:
    """``optimize(meta)`` adds reasons to the tagged meta tree in place;
    ``explain`` lists the regions it reverted."""

    def __init__(self, conf, platform: str = "cuda"):
        from spark_rapids_tpu_torch.config import rapids_conf as rc
        self.transition_w = conf.get(rc.OPTIMIZER_TRANSITION_COST)
        dev_w, cpu_w, _ = load_weights(platform)
        self.tpu_w = dict(dev_w)
        self.cpu_w = dict(cpu_w)
        for name in set(self.tpu_w) | set(self.cpu_w):
            ov = conf.op_cost("tpu", name)
            if ov is not None:
                self.tpu_w[name] = ov
            ov = conf.op_cost("cpu", name)
            if ov is not None:
                self.cpu_w[name] = ov
        self.explain: List[str] = []
        self._rows: Dict[int, float] = {}

    def optimize(self, meta) -> None:
        self._rows = {}
        self._fill_rows(meta)
        self._visit_regions(meta, parent_on_device=False)

    def _fill_rows(self, meta) -> float:
        child_rows = [self._fill_rows(c) for c in meta.child_metas]
        rows = _estimate_rows(meta.wrapped, child_rows)
        self._rows[id(meta)] = rows
        return rows

    def _region_cost(self, meta) -> Tuple[float, float, List]:
        """(device cost, cpu cost, nodes) of the device region rooted at
        ``meta``, with its children's transitions: rows from a CPU child
        cross to the device if the region stays there, rows from a device
        node the fallback cannot run cross to the host if it reverts."""
        rows = self._rows[id(meta)]
        w = type(meta.wrapped).__name__
        dev = rows * self.tpu_w.get(w, self.tpu_w["default"])
        cpu = rows * self.cpu_w.get(w, self.cpu_w["default"])
        nodes = [meta]
        for c in meta.child_metas:
            if isinstance(c.wrapped, _LEAVES):
                continue
            if _revertible(c):
                d, p, ns = self._region_cost(c)
                dev += d
                cpu += p
                nodes.extend(ns)
            elif c.reasons:
                dev += self._rows[id(c)] * self.transition_w
            else:
                cpu += self._rows[id(c)] * self.transition_w
        return dev, cpu, nodes

    def _visit_regions(self, meta, parent_on_device: bool,
                       under_device: bool = False) -> None:
        if isinstance(meta.wrapped, _LEAVES):
            return
        if _revertible(meta) and not parent_on_device:
            dev, cpu, nodes = self._region_cost(meta)
            # the region's output crosses to the host (the collect, or a
            # CPU parent), or back to the device under a node that stays
            # there
            out = self._rows[id(meta)] * self.transition_w
            if under_device:
                cpu += out
            else:
                dev += out
            if dev > cpu:
                for n in nodes:
                    n.will_not_work(
                        "not worth the transition cost "
                        f"(CBO: device={dev:.0f} > cpu={cpu:.0f})")
                self.explain.append(
                    f"CBO reverted {type(meta.wrapped).__name__} region "
                    f"({len(nodes)} ops) to CPU")
                for c in meta.child_metas:
                    self._visit_regions(c, False)
                return
            for c in meta.child_metas:
                self._visit_regions(c, True)
            return
        # below a device node that the fallback cannot run, a region's
        # output stays on the device
        pinned = not meta.reasons and not _revertible(meta)
        for c in meta.child_metas:
            self._visit_regions(c, _revertible(meta) and parent_on_device,
                                pinned)
