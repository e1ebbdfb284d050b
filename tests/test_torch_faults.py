"""The fault taxonomy of the PyTorch port (``robustness/faults.py``),
against the JAX package's, on the CPU.

``classify`` over a table of exceptions gives the port the same (kind,
severity) as the reference gives its counterpart; an XLA runtime error
maps to its CUDA counterpart, both FATAL.  A CUDA runtime error, a
kernel build or launch failure, a failed host-runtime build,
``NotImplementedError`` and an NCCL error are FATAL, and none of them
reaches the recovery ladder's ``cpu`` rung: the driver re-raises at
once, through a DataFrame too.  The envelope's modules import neither
``jax`` nor the JAX package.
"""

import ast
from concurrent.futures.process import BrokenProcessPool
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

from spark_rapids_tpu.memory import retry as JR
from spark_rapids_tpu.robustness import faults as JF
from spark_rapids_tpu_torch.api import functions as F
from spark_rapids_tpu_torch.api.dataframe import DataFrame
from spark_rapids_tpu_torch.api.session import TpuSession
from spark_rapids_tpu_torch.memory import retry as R
from spark_rapids_tpu_torch.memory.spill import SpillCorruptionError
from spark_rapids_tpu_torch.native import NativeBuildError
from spark_rapids_tpu_torch.robustness import faults as FT
from spark_rapids_tpu_torch.robustness.driver import (
    QueryRetryDriver, recovery_metrics)

ROOT = Path(__file__).resolve().parents[1]


class XlaRuntimeError(RuntimeError):
    """Stands for jaxlib's class, which the reference matches by name."""


def _pairs():
    """(label, port exception, reference exception)."""
    return [
        ("injected oom", R.InjectedOomError("x"), JR.InjectedOomError("x")),
        ("split floor", R.SplitAndRetryOOM("floor"),
         JR.SplitAndRetryOOM("floor")),
        ("host memory", MemoryError("host"), MemoryError("host")),
        ("user bug", ValueError("no"), ValueError("no")),
        ("timeout", FT.TimeoutFault("io.reader", 10, 20),
         JF.TimeoutFault("io.reader", 10, 20)),
        ("admission", FT.AdmissionFault("queue-full"),
         JF.AdmissionFault("queue-full")),
        ("budget", FT.BudgetExhaustedFault("syncs", 3, 2),
         JF.BudgetExhaustedFault("syncs", 3, 2)),
        ("corruption", SpillCorruptionError("HOST", "crc"),
         JF.CorruptionFault("HOST", "crc")),
        ("corruption fault", FT.CorruptionFault("DISK"),
         JF.CorruptionFault("DISK")),
        ("host sync", FT.HostSyncError("t/o"), JF.HostSyncError("t/o")),
        ("spill io", FT.SpillIOError("disk"), JF.SpillIOError("disk")),
        ("reader", FT.InjectedReaderFault("io.read"),
         JF.InjectedReaderFault("io.read")),
        ("shuffle", FT.InjectedShuffleFault("shuffle.exchange"),
         JF.InjectedShuffleFault("shuffle.exchange")),
        ("dist sync", FT.InjectedHostSyncFault("dist.host_sync"),
         JF.InjectedHostSyncFault("dist.host_sync")),
        ("spill inject", FT.InjectedSpillFault("spill.disk"),
         JF.InjectedSpillFault("spill.disk")),
        ("worker", FT.InjectedWorkerFault("udf.worker"),
         JF.InjectedWorkerFault("udf.worker")),
        ("broken pool", BrokenProcessPool("gone"), BrokenProcessPool("gone")),
    ]


@pytest.mark.parametrize("label,port,ref", _pairs(),
                         ids=[p[0] for p in _pairs()])
def test_classify_matches_reference(label, port, ref):
    got, want = FT.classify(port), JF.classify(ref)
    assert (got.kind, got.severity) == (want.kind, want.severity), label


def test_device_oom_is_retryable():
    f = FT.classify(torch.OutOfMemoryError("CUDA out of memory. Tried ..."))
    assert (f.kind, f.severity) == ("device_oom", FT.RETRYABLE)
    assert FT.classify(R.InjectedOomError("x")).retryable


def _accelerator_error(text):
    cls = getattr(torch, "AcceleratorError", None)
    if cls is None:
        return RuntimeError(text)
    try:
        return cls(text)
    except TypeError:
        return RuntimeError(text)


def _fatal_cases():
    """(label, port exception, expected kind): each FATAL."""
    nccl = torch.distributed.DistBackendError(
        "NCCL error in: ProcessGroupNCCL.cpp, unhandled cuda error")
    return [
        ("cuda runtime text", RuntimeError(
            "CUDA error: an illegal memory access was encountered"),
         "cuda_runtime"),
        ("accelerator error", _accelerator_error(
            "CUDA error: an illegal memory access was encountered"),
         "cuda_runtime"),
        ("nvcc build", RuntimeError("nvcc failed:\nerror: expected ';'"),
         "cuda_kernel"),
        ("nvcc missing", RuntimeError(
            "nvcc not found: the CUDA kernels of spark_rapids_tpu_torch "
            "need the CUDA toolkit"), "cuda_kernel"),
        ("launch", RuntimeError(
            "hash_insert: CUDA launch failed (cudaError 700)"),
         "cuda_kernel"),
        ("host runtime build", NativeBuildError("g++ failed"),
         "native_build"),
        ("unported", NotImplementedError("ntile"), "not_implemented"),
        ("nccl one rank", nccl, "nccl"),
    ]


@pytest.mark.parametrize("label,exc,kind", _fatal_cases(),
                         ids=[c[0] for c in _fatal_cases()])
def test_cuda_and_kernel_failures_are_fatal(label, exc, kind):
    f = FT.classify(exc)
    assert (f.kind, f.severity) == (kind, FT.FATAL), label


def test_xla_error_maps_to_cuda_counterpart():
    """The reference's XLA runtime error and the port's CUDA runtime error
    are the same class of failure, both FATAL."""
    ref = JF.classify(XlaRuntimeError("INTERNAL: device halted"))
    port = FT.classify(RuntimeError("CUDA error: unspecified launch "
                                    "failure"))
    assert (ref.kind, port.kind) == ("xla_runtime", "cuda_runtime")
    assert ref.severity == port.severity == FT.FATAL


@pytest.fixture(scope="module")
def session():
    s = TpuSession({"spark.rapids.sql.recovery.backoffMs": 0},
                   device="cpu")
    yield s
    s.stop()


@pytest.mark.parametrize("label,exc,kind", _fatal_cases(),
                         ids=[c[0] for c in _fatal_cases()])
def test_fatal_faults_never_reach_the_cpu_rung(session, label, exc, kind):
    session.recovery_log.clear()
    recovery_metrics.reset()
    rungs = []

    def attempt(mode):
        rungs.append(mode.rung)
        raise exc

    with pytest.raises(type(exc)):
        QueryRetryDriver(session).run(attempt)
    assert rungs == ["initial"], label
    assert session.recovery_log == [] and recovery_metrics.snapshot() == {}


def test_kernel_failure_through_a_dataframe(session, monkeypatch):
    """A kernel's failure inside a collect propagates untouched: no
    recovery action, and no CPU answer in its place."""
    df = session.create_dataframe(pd.DataFrame(
        {"k": np.arange(10) % 3, "v": np.arange(10.0)})).groupBy("k").agg(
        F.sum("v").alias("s"))
    want = df.to_pandas()
    calls = []

    def broken(self, exec_plan):
        calls.append(type(exec_plan).__name__)
        raise RuntimeError("CUDA error: an illegal memory access was "
                           "encountered")

    session.recovery_log.clear()
    monkeypatch.setattr(DataFrame, "_drive", broken)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        df.to_pandas()
    assert len(calls) == 1 and session.recovery_log == []
    monkeypatch.undo()
    pd.testing.assert_frame_equal(df.to_pandas(), want)


def test_retryable_fault_walks_the_ladder(session):
    """The ladder of a one-device session: retries, spill, split, cpu."""
    session.recovery_log.clear()
    rungs = []

    def attempt(mode):
        rungs.append(mode.rung)
        if not mode.cpu_only:
            raise FT.InjectedReaderFault("io.read")
        return "answer"

    assert QueryRetryDriver(session).run(attempt) == "answer"
    assert rungs == ["initial", "retry", "retry", "spill", "split", "cpu"]
    assert [r["action"] for r in session.recovery_log] == rungs[1:]


def test_card_session_ladder_has_no_cpu_rung(session, monkeypatch):
    """On a CUDA session the ladder stops at split: the retryable fault
    re-raises once it is spent, and no attempt runs on the CPU."""
    from spark_rapids_tpu_torch.robustness import driver as D
    monkeypatch.setattr(D, "on_card", lambda s: True)
    session.recovery_log.clear()
    rungs = []

    def attempt(mode):
        rungs.append(mode.rung)
        raise FT.InjectedReaderFault("io.read")

    with pytest.raises(FT.InjectedReaderFault):
        QueryRetryDriver(session).run(attempt)
    assert rungs == ["initial", "retry", "retry", "spill", "split"]
    assert [r["action"] for r in session.recovery_log] == rungs[1:]


def test_on_card_reads_the_session_device():
    from types import SimpleNamespace
    from spark_rapids_tpu_torch.robustness.driver import on_card
    assert on_card(SimpleNamespace(device=torch.device("cuda", 0)))
    assert not on_card(SimpleNamespace(device=torch.device("cpu")))
    assert not on_card(SimpleNamespace())


ENVELOPE_MODULES = (
    "version.py", "utils/trees.py", "utils/events.py",
    "utils/tracing.py", "utils/hostsync.py", "robustness/__init__.py",
    "robustness/faults.py", "robustness/inject.py",
    "robustness/watchdog.py", "robustness/driver.py", "serving/__init__.py",
    "serving/context.py", "serving/admission.py", "serving/scheduler.py",
    "tools/__init__.py", "tools/eventlog.py", "tools/traceview.py")


@pytest.mark.parametrize("rel", ENVELOPE_MODULES)
def test_envelope_modules_import_no_jax(rel):
    path = ROOT / "spark_rapids_tpu_torch" / rel
    tree = ast.parse(path.read_text())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    bad = [n for n in names if n.split(".")[0] in ("jax", "jaxlib")
           or n == "spark_rapids_tpu" or n.startswith("spark_rapids_tpu.")]
    assert not bad, f"{rel} imports {bad}"
