"""The PyTorch port's cost-based optimizer (``plan/cbo.py``, off by
default) against the JAX package's, on the CPU.

The cases of ``tests/test_cbo.py``: off by default, a huge transition
cost reverts small plans (which still answer right on the CPU), cheap
transitions keep them on the device, the decisions land in ``last_cbo``,
and a device region above a CPU node is still costed.  The parity cases
set every ``spark.rapids.sql.optimizer.{tpu,cpu}OpCost.<Op>`` key in both
packages, so both price the same weights: then both revert the same
regions and tag the same nodes.  The port reads a weights file only when
its provenance names the session's device type, and ships none.
"""

import json
import re

import numpy as np
import pandas as pd
import pytest
import torch

from spark_rapids_tpu.api.session import TpuSession as JaxSession
from spark_rapids_tpu.models import tpch as jax_tpch
from spark_rapids_tpu_torch.api import functions as TF
from spark_rapids_tpu_torch.api.session import TpuSession
from spark_rapids_tpu_torch.config.rapids_conf import RapidsConf
from spark_rapids_tpu_torch.exec.fallback import CpuFallbackExec, host_runnable
from spark_rapids_tpu_torch.models import tpch
from spark_rapids_tpu_torch.plan import cbo


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _cpu(conf):
    return TpuSession(conf, device="cpu")


def test_cbo_off_by_default():
    s = _cpu({})
    q = s.create_dataframe({"x": [1, 2, 3]}).filter(TF.col("x") > 1)
    assert "CpuFallbackExec" not in s.plan(q.plan).tree_string()
    assert s.overrides.last_cbo == []


def test_cbo_reverts_tiny_plans():
    """With a huge transition weight, small plans are not worth the
    round trip and revert to the CPU, where they still answer right."""
    conf = {"spark.rapids.sql.optimizer.enabled": "true",
            "spark.rapids.sql.optimizer.transitionRowCost": "1e9"}
    s = _cpu(conf)
    q = s.create_dataframe({"x": [1, 2, 3]}).filter(
        TF.col("x") > 1).select((TF.col("x") * 2).alias("y"))
    assert "CpuFallbackExec" in s.plan(q.plan).tree_string()
    assert "not worth the transition cost" in s.overrides.last_explain
    assert q.to_pandas()["y"].tolist() == [4, 6]


def test_cbo_keeps_cheap_transitions():
    s = _cpu({"spark.rapids.sql.optimizer.enabled": "true",
              "spark.rapids.sql.optimizer.transitionRowCost": "0",
              "spark.rapids.sql.optimizer.tpuOpCost.Filter": "0.001",
              "spark.rapids.sql.optimizer.cpuOpCost.Filter": "1.0"})
    q = s.create_dataframe({"x": list(range(100))}).filter(
        TF.col("x") > 50)
    assert "CpuFallbackExec" not in s.plan(q.plan).tree_string()


def test_cbo_explain_records_decisions():
    s = _cpu({"spark.rapids.sql.optimizer.enabled": "true",
              "spark.rapids.sql.optimizer.transitionRowCost": "1e9"})
    df = s.create_dataframe({"x": [1]})
    s.plan(df.select((TF.col("x") + 1).alias("y")).plan)
    assert s.overrides.last_cbo == ["CBO reverted Project region (1 ops) "
                                    "to CPU"]


def test_cbo_evaluates_regions_above_fallback_nodes():
    """A device region above a CPU fallback child is still costed."""
    s = _cpu({"spark.rapids.sql.optimizer.enabled": "true",
              "spark.rapids.sql.optimizer.transitionRowCost": "1e9",
              "spark.rapids.sql.exec.Filter": "false"})
    q = s.create_dataframe({"x": [1, 2, 3]}).filter(
        TF.col("x") > 0).select((TF.col("x") * 2).alias("y"))
    tree = s.plan(q.plan).tree_string()
    assert "TpuProjectExec" not in tree  # reverted, not sandwiched
    assert s.overrides.last_cbo
    assert q.to_pandas()["y"].tolist() == [2, 4, 6]


def _all_device_costly(extra=()):
    """Weights under which every device region loses to the CPU."""
    conf = {"spark.rapids.sql.optimizer.enabled": "true",
            "spark.rapids.sql.optimizer.transitionRowCost": "0"}
    for op in ("Project", "Filter", "Aggregate", "Join", "Sort", "Window",
               "Limit", "Union", "default"):
        conf[f"spark.rapids.sql.optimizer.tpuOpCost.{op}"] = "1e6"
        conf[f"spark.rapids.sql.optimizer.cpuOpCost.{op}"] = "1e-3"
    conf.update(extra)
    return conf


@pytest.mark.parametrize("shape", ["window", "semi", "anti"])
def test_cbo_keeps_nodes_without_a_cpu_branch(shape):
    """A reverted region leaves out the nodes the CPU fallback cannot run
    (a Window, a semi or anti join): they stay on the device, the nodes
    around them revert, and the query still answers as without the
    optimizer."""
    rng = np.random.default_rng(23)
    data = {"g": [int(v) for v in rng.integers(0, 5, 40)],
            "x": [int(v) for v in rng.integers(0, 100, 40)]}
    other = {"k": [0, 2, 4, 7]}

    def build(s):
        df = s.create_dataframe(data)
        if shape == "window":
            w = TF.Window.partitionBy("g").orderBy("x")
            q = df.select("g", "x", TF.row_number().over(w).alias("rn"))
        else:
            q = df.join(s.create_dataframe(other),
                        TF.col("g") == TF.col("k"), how=shape)
        return q.filter(TF.col("x") > 10).select(
            "g", (TF.col("x") * 2).alias("y"), *(
                ["rn"] if shape == "window" else []))

    s = _cpu(_all_device_costly())
    q = build(s)
    tree = s.plan(q.plan).tree_string()
    kept = "TpuWindowExec" if shape == "window" else "TpuHashJoinExec"
    assert kept in tree, tree
    assert "CpuFallbackExec[Window]" not in tree
    assert "CpuFallbackExec[Join]" not in tree
    assert "CpuFallbackExec[Project]" in tree
    assert s.overrides.last_cbo
    by = ["g", "y"] + (["rn"] if shape == "window" else [])
    got = q.to_pandas().sort_values(by).reset_index(drop=True)
    plain = _cpu({})
    want = build(plain).to_pandas().sort_values(by).reset_index(drop=True)
    assert len(want) > 0
    pd.testing.assert_frame_equal(got, want)


def test_last_cbo_initialized():
    assert _cpu({}).overrides.last_cbo == []


def test_cbo_weights_calibrated_not_fiction(tmp_path, monkeypatch):
    """As shipped, the card (and the CPU) use the built-in ratio table; a
    weights file counts only for the platform its provenance names; conf
    keys override single entries."""
    assert not cbo.weights_calibrated("cuda")
    assert not cbo.weights_calibrated("cpu")
    dev_w, cpu_w, _ = cbo.load_weights("cuda")
    assert dev_w["Sort"] == pytest.approx(cpu_w["Sort"] / 6.0)
    path = tmp_path / "cbo_weights.json"
    path.write_text(json.dumps({
        "provenance": {"platform": "cpu"},
        "weights": {"Sort": {"tpu": 0.5, "cpu": 0.25},
                    "Aggregate": {"tpu": 0.1, "cpu": 0.4}}}))
    monkeypatch.setattr(cbo, "_WEIGHTS_PATH", str(path))
    monkeypatch.setattr(cbo, "_loaded", {})
    assert cbo.weights_calibrated("cpu")
    assert not cbo.weights_calibrated("cuda")
    assert cbo.load_weights("cpu")[0]["Sort"] == 0.5
    opt = cbo.CostBasedOptimizer(RapidsConf({
        "spark.rapids.sql.optimizer.tpuOpCost.Sort": "123.5",
        "spark.rapids.sql.optimizer.cpuOpCost.Join": "9.25"}), "cpu")
    assert opt.tpu_w["Sort"] == 123.5 and opt.cpu_w["Join"] == 9.25
    assert opt.tpu_w["Aggregate"] == 0.1  # untouched entries stay


# ------------------------------------------------------------- parity --

OPS = ("Project", "Filter", "Aggregate", "Join", "Sort", "Window", "Limit",
       "Union", "Generate", "default")


def _weights(transition):
    rng = np.random.default_rng(17)
    conf = {"spark.rapids.sql.optimizer.enabled": "true",
            "spark.rapids.sql.optimizer.transitionRowCost": str(transition)}
    for op in OPS:
        cpu_w = float(rng.uniform(0.01, 0.3))
        conf[f"spark.rapids.sql.optimizer.cpuOpCost.{op}"] = str(cpu_w)
        conf[f"spark.rapids.sql.optimizer.tpuOpCost.{op}"] = str(
            cpu_w * float(rng.uniform(0.05, 1.5)))
    return conf


def _execs(root):
    out, todo = [], [root]
    while todo:
        e = todo.pop()
        out.append(e)
        todo.extend(e.children)
    return out


def _holds_device_only_node(plan):
    todo = [plan]
    while todo:
        n = todo.pop()
        todo.extend(n.children)
        if not n.children:
            continue  # a leaf is never reverted
        if not host_runnable(n):
            return True
    return False


def _tagged(explain):
    return [m.group(1) for m in re.finditer(r"^\s*! (\w+) ", explain, re.M)]


@pytest.fixture(scope="module")
def tables():
    return tpch.gen_tables(sf=0.002)


@pytest.mark.parametrize("transition", [0.0, 0.05, 0.5, 5.0])
def test_cbo_parity_with_jax_over_tpch(transition, tables):
    """Under the same weights both optimizers revert the same regions of
    the TPC-H plans (the 19 without a scalar subquery, less those whose
    semi or anti joins the port keeps on the device) and tag the same
    nodes."""
    conf = _weights(transition)
    port = _cpu(conf)
    jax = JaxSession(conf)
    pt = tpch.load(port, tables)
    jt = jax_tpch.load(jax, tables)
    reverted = compared = 0
    try:
        for name in tpch.QUERIES:
            if name in ("q11", "q15", "q22"):
                # a scalar subquery would run under the optimizer while
                # the DataFrame is built
                continue
            pdf = tpch.QUERIES[name](pt)
            jdf = jax_tpch.QUERIES[name](jt)
            execs = _execs(port.plan(pdf.plan))
            jax.plan(jdf.plan)
            # the port reverts no node its CPU fallback cannot run
            assert all(host_runnable(e.node) for e in execs
                       if isinstance(e, CpuFallbackExec)), name
            reverted += len(port.overrides.last_cbo)
            if _holds_device_only_node(pdf.plan):
                # its semi or anti joins stay on the port's device and
                # bound its regions; the JAX optimizer reverts them with
                # the rest of their region (and its fallback then raises)
                continue
            compared += 1
            assert port.overrides.last_cbo == jax.overrides.last_cbo, name
            assert _tagged(port.overrides.last_explain) == \
                _tagged(jax.overrides.last_explain), name
    finally:
        jax.stop()
    assert compared >= 8
    if transition == 5.0:
        assert reverted > 0
