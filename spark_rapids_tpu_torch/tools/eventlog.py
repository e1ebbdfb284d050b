"""Event-log parsing (counterpart of ``spark_rapids_tpu/tools/eventlog.py``).

Reads the JSON-lines files the engine writes (utils/events.py), grouping
records into per-session ``AppInfo`` objects with per-query details —
the role ``ApplicationInfo``/``EventsProcessor`` play in the reference's
tools module (tools/src/main/.../profiling/ApplicationInfo.scala).
"""

from __future__ import annotations

import glob
import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass
class QueryInfo:
    query_id: int
    logical_plan: str = ""
    physical_plan: str = ""
    explain: str = ""
    status: str = ""
    duration_ms: float = 0.0
    start_ts: float = 0.0   # epoch seconds (QueryStart record ts)
    end_ts: float = 0.0
    metrics: Dict[str, Dict[str, int]] = field(default_factory=dict)
    spill: Dict[str, int] = field(default_factory=dict)
    retry: Dict[str, int] = field(default_factory=dict)
    # async pipeline stats (exec/pipeline.py PipelineStats.as_dict():
    # depth, batches, pipelineFillRatio, hostSyncCount, uploadOverlapMs,
    # consumerWaitMs, jitCacheHits/Misses); empty when the query ran
    # sequential
    pipeline: Dict[str, float] = field(default_factory=dict)
    # shuffle-wire summary of a distributed query (parallel/shuffle.py
    # ShuffleWireMetrics.summarize: exchanges, collectives, rowsMoved,
    # rowsUseful, bytesMoved, paddingRatio, slotOverflowRetries,
    # perColumnFallbacks); empty when the query never exchanged
    shuffle: Dict[str, float] = field(default_factory=dict)
    # query-level recovery ladder actions (robustness/driver.py
    # RecoveryAction events stamped with this query's id)
    recovery: List[Dict[str, str]] = field(default_factory=list)
    # watchdog trips/cancellations (robustness/watchdog.py
    # WatchdogTrip / WatchdogCancel events; "kind" is trip|cancel)
    watchdog: List[Dict[str, str]] = field(default_factory=list)
    # spill-integrity checksum failures (memory/spill.py
    # SpillCorruption events: tier, bufId, detail)
    corruption: List[Dict[str, str]] = field(default_factory=list)
    # stage-checkpoint lineage events (robustness/checkpoint.py
    # CheckpointWrite/Resume/Evict/Invalid; "kind" is
    # write|resume|evict|invalid)
    checkpoint: List[Dict[str, str]] = field(default_factory=list)
    # the lineage log's counters at a sharded QueryEnd (writes,
    # bytesWritten, resumes, stagesSkipped, evictions, invalid, live,
    # liveBytes, liveBytesRaw); empty without a log
    checkpoint_stats: Dict[str, int] = field(default_factory=dict)
    # continuous-ingest events (robustness/incremental.py
    # StateCommit/StateRollback/StateEvict/IncrementalResume/
    # StateWatermark; "kind" is commit|rollback|evict|resume|
    # watermark) — resumes land here (they fire inside a tick's query
    # envelope); commit/rollback/watermark usually land on the app
    # (they fire between the tick's executions)
    incremental: List[Dict[str, str]] = field(default_factory=list)
    # full post-mortem trail of a fatally-failed query (QueryFatal:
    # error, recovery actions, watchdog + checkpoint snapshots) —
    # present even when the ladder never succeeded
    fatal: Dict[str, object] = field(default_factory=dict)
    # serving-layer admission cost (QueryEnd admission dict:
    # waitMs, weightBytes); empty when admission control is off
    admission: Dict[str, float] = field(default_factory=dict)
    # per-query budget ladder events (serving BudgetExhausted:
    # budget, used, limit, action=spill|reject)
    budget: List[Dict[str, str]] = field(default_factory=list)
    # whole-stage fusion + persistent jit cache (QueryEnd fusion dict,
    # exec/fusion.py: fusedStages/fusedOperators/dispatchesSaved/
    # fusibleChains + persistentHits/Misses/Invalid/Stores deltas)
    fusion: Dict[str, float] = field(default_factory=dict)
    # dropped persistent jit-cache entries (JitCacheInvalid events:
    # reason, entry) — informative; the query recompiled fresh
    jitcache: List[Dict[str, str]] = field(default_factory=list)
    # span-tracing rollup (QueryEnd spans dict, utils/tracing.py:
    # wallMs, exclusiveMs, unattributedMs/Frac, overlapMs, phases,
    # points, operators, sites); empty when tracing was off
    spans: Dict[str, object] = field(default_factory=dict)
    # cross-query reuse (QueryEnd sharing dict, serving/reuse.py +
    # serving/scheduler.py: resultCacheHit, resultCache
    # miss/invalidated note, spliceResumes/stageWrites tallies,
    # interleave wait/timeslices; stores ride the ResultCacheStore
    # EVENT — they land after the envelope closed); ABSENT when every
    # reuse knob is off
    sharing: Dict[str, object] = field(default_factory=dict)
    # result-cache / shared-stage-store events attributed to this
    # query (kind is hit|store|invalid|evict|write|splice)
    sharing_events: List[Dict[str, str]] = field(default_factory=list)
    # self-tuning cost model (QueryEnd planner dict,
    # plan/costmodel.py: decisions ledger [knob, site, chosen,
    # alternatives, predicted, observed], replans, mispredicts,
    # invalidLoads); ABSENT when costModel.enabled is off
    planner: Dict[str, object] = field(default_factory=dict)
    # CostModelInvalid events (corrupt evidence load / ledger write
    # fault — the model degraded to built-in defaults)
    costmodel: List[Dict[str, str]] = field(default_factory=list)
    # gray-failure counters (QueryEnd fleet dict,
    # robustness/grayfailure.py: hedgesFired/hedgesWon/
    # duplicatesSuppressed/suspects/quarantines/rejoins deltas +
    # suspectHosts list); ABSENT when grayFailure.enabled is off
    fleet_health: Dict[str, object] = field(default_factory=dict)

    @property
    def succeeded(self) -> bool:
        return self.status == "success"

    def op_names(self) -> List[str]:
        return [line.strip() for line in self.physical_plan.splitlines()]

    def fallback_ops(self) -> List[str]:
        return [op for op in self.op_names()
                if op.startswith("CpuFallbackExec")]

    def op_time_ns(self) -> Dict[str, int]:
        """Per-exec-node opTime; keys are metric-tree paths."""
        return {k: v.get("opTime", 0) for k, v in self.metrics.items()}


@dataclass
class AppInfo:
    session_id: str
    path: str
    conf: Dict[str, str] = field(default_factory=dict)
    queries: List[QueryInfo] = field(default_factory=list)
    start_ts: float = 0.0   # SessionStart record ts
    # recovery actions not attributable to a query (no qid yet when
    # the attempt died before its QueryStart)
    recovery: List[Dict[str, str]] = field(default_factory=list)
    # un-attributed watchdog / corruption / checkpoint / fatal events
    # (same reason)
    watchdog: List[Dict[str, str]] = field(default_factory=list)
    corruption: List[Dict[str, str]] = field(default_factory=list)
    checkpoint: List[Dict[str, str]] = field(default_factory=list)
    incremental: List[Dict[str, str]] = field(default_factory=list)
    fatal: List[Dict[str, object]] = field(default_factory=list)
    # serving-layer admission stream (Admission grants are emitted
    # before the query draws its id, so they live at session level)
    # and typed rejections (AdmissionReject: reason, waitMs)
    admission: List[Dict[str, float]] = field(default_factory=list)
    rejections: List[Dict[str, str]] = field(default_factory=list)
    # un-attributed BudgetExhausted events
    budget: List[Dict[str, str]] = field(default_factory=list)
    # un-attributed JitCacheInvalid events (a load outside any query
    # envelope)
    jitcache: List[Dict[str, str]] = field(default_factory=list)
    # un-attributed cross-query reuse events (a result-cache store
    # lands after its query's envelope closed, invalidations fire
    # during another query's lookup)
    sharing_events: List[Dict[str, str]] = field(default_factory=list)
    # un-attributed CostModelInvalid events (a load at session
    # construction runs before any query envelope)
    costmodel: List[Dict[str, str]] = field(default_factory=list)
    # fleet membership / fencing stream (HostJoin, HostLoss,
    # MeshShrink, FleetCacheFence) — host lifecycle is session-level
    # by nature, so these always live on the app
    fleet: List[Dict[str, object]] = field(default_factory=list)

    def max_concurrent(self) -> int:
        """Peak number of simultaneously-open query envelopes — the
        per-session concurrency timeline's headline number, computed
        from QueryStart/QueryEnd timestamps."""
        edges = []
        for q in self.queries:
            if q.start_ts and q.end_ts:
                edges.append((q.start_ts, 1))
                edges.append((q.end_ts, -1))
        peak = cur = 0
        for _, d in sorted(edges):
            cur += d
            peak = max(peak, cur)
        return peak

    @property
    def total_duration_ms(self) -> float:
        return sum(q.duration_ms for q in self.queries)

    @property
    def end_ts(self) -> float:
        return max((q.end_ts for q in self.queries if q.end_ts),
                   default=self.start_ts)


def parse_event_log(path: str) -> AppInfo:
    app = AppInfo(session_id=os.path.basename(path), path=path)
    open_queries: Dict[int, QueryInfo] = {}
    all_queries: Dict[int, QueryInfo] = {}  # incl. completed, last wins
    with open(path, encoding="utf-8") as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue  # torn write at the tail of a live log
            ev = rec.get("event")
            if ev == "SessionStart":
                app.conf = rec.get("conf", {})
                app.session_id = rec.get("sessionId", app.session_id)
                app.start_ts = rec.get("ts", 0.0)
            elif ev == "QueryStart":
                q = QueryInfo(rec["queryId"],
                              logical_plan=rec.get("logicalPlan", ""),
                              physical_plan=rec.get("physicalPlan", ""),
                              explain=rec.get("explain", ""),
                              start_ts=rec.get("ts", 0.0))
                open_queries[q.query_id] = q
                all_queries[q.query_id] = q
            elif ev == "RecoveryAction":
                # emitted AFTER the failed attempt's QueryEnd, so match
                # completed queries too; un-attributed actions go on the
                # app
                info = {k: rec[k] for k in ("action", "fault",
                                            "severity", "error", "rung")
                        if k in rec}
                q = all_queries.get(rec.get("queryId"))
                (q.recovery if q is not None
                 else app.recovery).append(info)
            elif ev in ("WatchdogTrip", "WatchdogCancel"):
                info = {k: rec[k] for k in
                        ("point", "deadlineMs", "elapsedMs",
                         "overrunMs") if k in rec}
                info["kind"] = "trip" if ev == "WatchdogTrip" \
                    else "cancel"
                q = all_queries.get(rec.get("queryId"))
                (q.watchdog if q is not None
                 else app.watchdog).append(info)
            elif ev == "SpillCorruption":
                info = {k: rec[k] for k in ("tier", "bufId", "detail")
                        if k in rec}
                q = all_queries.get(rec.get("queryId"))
                (q.corruption if q is not None
                 else app.corruption).append(info)
            elif ev in ("CheckpointWrite", "CheckpointResume",
                        "CheckpointEvict", "CheckpointInvalid"):
                info = {k: rec[k] for k in
                        ("stageId", "bytes", "stages", "stagesSaved",
                         "tier", "reason") if k in rec}
                info["kind"] = ev[len("Checkpoint"):].lower()
                q = all_queries.get(rec.get("queryId"))
                (q.checkpoint if q is not None
                 else app.checkpoint).append(info)
            elif ev in ("StateCommit", "StateRollback", "StateEvict",
                        "IncrementalResume", "StateWatermark",
                        "SinkCommit", "FleetRound"):
                info = {k: rec[k] for k in
                        ("epoch", "stateBytes", "entries", "mode",
                         "deltaFiles", "reusedState", "reason",
                         "bytes", "stageId", "stagesSaved",
                         "watermark", "evictedBuckets", "evictedRows",
                         "evictedBytes", "stateRows", "store",
                         "crc", "rows", "replayed", "round",
                         "subscribers", "sourcePulls", "splices",
                         "failures")
                        if k in rec}
                info["kind"] = {"StateCommit": "commit",
                                "StateRollback": "rollback",
                                "StateEvict": "evict",
                                "IncrementalResume": "resume",
                                "StateWatermark": "watermark",
                                "SinkCommit": "sink",
                                "FleetRound": "round"}[ev]
                q = all_queries.get(rec.get("queryId"))
                (q.incremental if q is not None
                 else app.incremental).append(info)
            elif ev == "Admission":
                app.admission.append(
                    {k: rec[k] for k in ("waitMs", "weightBytes",
                                         "active", "queued")
                     if k in rec})
            elif ev == "AdmissionReject":
                app.rejections.append(
                    {k: rec[k] for k in ("reason", "waitMs", "queued")
                     if k in rec})
            elif ev == "BudgetExhausted":
                info = {k: rec[k] for k in ("budget", "used", "limit",
                                            "action") if k in rec}
                q = all_queries.get(rec.get("queryId"))
                (q.budget if q is not None else app.budget).append(info)
            elif ev in ("ResultCacheHit", "ResultCacheStore",
                        "ResultCacheInvalid", "ResultCacheEvict",
                        "TemplateCacheHit", "TemplateCacheStore",
                        "SharedStageWrite", "SharedStageSplice",
                        "SharedStageEvict", "SharedStageInvalid"):
                info = {k: rec[k] for k in
                        ("key", "bytes", "batches", "rows", "reason",
                         "stageId", "stages", "stagesSaved", "tier",
                         "owner", "crossProcess") if k in rec}
                info["kind"] = {
                    "ResultCacheHit": "hit",
                    "ResultCacheStore": "store",
                    "ResultCacheInvalid": "invalid",
                    "ResultCacheEvict": "evict",
                    "TemplateCacheHit": "hit",
                    "TemplateCacheStore": "store",
                    "SharedStageWrite": "write",
                    "SharedStageSplice": "splice",
                    "SharedStageEvict": "evict",
                    "SharedStageInvalid": "invalid"}[ev]
                info["store"] = (
                    "template" if ev.startswith("Template") else
                    "result" if ev.startswith("Result") else "stage")
                q = all_queries.get(rec.get("queryId"))
                (q.sharing_events if q is not None
                 else app.sharing_events).append(info)
            elif ev in ("HostJoin", "HostLoss", "MeshShrink",
                        "FleetCacheFence", "HostSuspect",
                        "HostRecovered", "HostQuarantine", "HostRejoin",
                        "HedgeFired", "HedgeWon"):
                info = {k: rec[k] for k in
                        ("host", "pid", "hosts", "silentMs", "missed",
                         "fromHosts", "toHosts", "fromDevices",
                         "toDevices", "lostHosts", "reason", "action",
                         "key", "writerEpoch", "fenceEpoch", "ts",
                         "score", "factor", "point", "deadlineMs")
                        if k in rec}
                info["kind"] = {"HostJoin": "join",
                                "HostLoss": "loss",
                                "MeshShrink": "shrink",
                                "FleetCacheFence": "fence",
                                "HostSuspect": "suspect",
                                "HostRecovered": "recovered",
                                "HostQuarantine": "quarantine",
                                "HostRejoin": "rejoin",
                                "HedgeFired": "hedge_fired",
                                "HedgeWon": "hedge_won"}[ev]
                app.fleet.append(info)
            elif ev == "CostModelInvalid":
                info = {k: rec[k] for k in ("reason",) if k in rec}
                q = all_queries.get(rec.get("queryId"))
                (q.costmodel if q is not None
                 else app.costmodel).append(info)
            elif ev == "JitCacheInvalid":
                info = {k: rec[k] for k in ("reason", "entry")
                        if k in rec}
                q = all_queries.get(rec.get("queryId"))
                (q.jitcache if q is not None
                 else app.jitcache).append(info)
            elif ev == "QueryFatal":
                info = {k: rec[k] for k in
                        ("error", "recovery", "watchdog", "checkpoint")
                        if k in rec}
                q = all_queries.get(rec.get("queryId"))
                if q is not None:
                    q.fatal = info
                else:
                    app.fatal.append(info)
            elif ev == "QueryEnd":
                q = open_queries.pop(rec["queryId"],
                                     QueryInfo(rec["queryId"]))
                q.status = rec.get("status", "")
                q.duration_ms = rec.get("durationMs", 0.0)
                q.end_ts = rec.get("ts", 0.0)
                # distributed envelopes open before execution (so
                # mid-flight events attribute) and restate the final
                # explain at the end, once it is known
                q.explain = rec.get("explain") or q.explain
                q.metrics = rec.get("metrics", {})
                q.spill = rec.get("spill", {})
                q.retry = rec.get("retry", {})
                q.pipeline = rec.get("pipeline", {})
                q.shuffle = rec.get("shuffle", {})
                q.fusion = rec.get("fusion", {})
                q.spans = rec.get("spans", {}) or {}
                q.sharing = rec.get("sharing", {}) or {}
                q.checkpoint_stats = rec.get("checkpoint", {}) or {}
                q.planner = rec.get("planner", {}) or {}
                q.fleet_health = rec.get("fleet", {}) or {}
                q.admission = rec.get("admission", {}) or q.admission
                app.queries.append(q)
    # queries that started but never ended (crash) count as failed
    for q in open_queries.values():
        q.status = "incomplete"
        app.queries.append(q)
    return app


def load_logs(log_dir_or_file: str) -> List[AppInfo]:
    if os.path.isdir(log_dir_or_file):
        paths = sorted(glob.glob(os.path.join(log_dir_or_file,
                                              "tpu-events-*.jsonl")))
    elif os.path.isfile(log_dir_or_file):
        paths = [log_dir_or_file]
    else:
        return []
    return [parse_event_log(p) for p in paths]


def filter_apps(apps: List[AppInfo],
                match: Optional[str] = None,
                started_after: Optional[float] = None,
                newest: Optional[int] = None) -> List[AppInfo]:
    """The AppFilterImpl role: narrow a log directory's sessions by id
    regex, start time, and recency before analysis (reference
    tools/.../AppFilterImpl.scala)."""
    import re
    out = list(apps)
    if match:
        rx = re.compile(match)
        out = [a for a in out if rx.search(a.session_id) or
               rx.search(os.path.basename(a.path))]
    if started_after is not None:
        out = [a for a in out if a.start_ts >= started_after]
    if newest is not None and newest >= 0:
        out.sort(key=lambda a: -a.start_ts)
        out = out[:newest]
        out.sort(key=lambda a: a.start_ts)
    return out
