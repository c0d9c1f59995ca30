"""Typed benchmark results (paper §4.2.5 — the PerfDB record schema).

``JobResult`` is the frozen, typed view of one benchmark outcome.  It
serializes to exactly the PerfDB JSONL record layout the repo has always
written (``to_record``) and parses back losslessly (``from_record``), so
the storage schema and every existing analysis/leaderboard consumer are
unchanged — only the in-process representation is now structured.

A copy of ``repro.core.results``, importing only ``repro_torch``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Optional

from repro_torch.core.spec import (AnyJobSpec, BenchmarkJobSpec, CalibrationSpec,
                             PlanSpec)


@dataclasses.dataclass(frozen=True)
class StageBreakdown:
    """Mean per-request latency of each pipeline stage (paper Fig. 14).

    ``batch_wait`` is the policy-attributable slice of ``queue`` (waiting
    while capacity was free but the batch had not fired), so it is *not*
    added again by ``total()``.  ``kv_transfer`` is the disaggregated
    prefill→decode KV handoff (0 for colocated serving and for records
    written before the stage existed).
    """
    preprocess: float = 0.0
    transmit: float = 0.0
    queue: float = 0.0
    inference: float = 0.0
    postprocess: float = 0.0
    batch_wait: float = 0.0
    kv_transfer: float = 0.0

    def total(self) -> float:
        return (self.preprocess + self.transmit + self.queue
                + self.kv_transfer + self.inference + self.postprocess)

    def to_dict(self) -> Dict[str, float]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Mapping[str, float]) -> "StageBreakdown":
        return cls(**dict(d))


@dataclasses.dataclass(frozen=True)
class ScheduleInfo:
    """Where/when the two-tier scheduler placed the job (paper §4.3.2)."""
    worker: int
    start_s: float
    finish_s: float
    jct_s: float

    def to_dict(self) -> Dict[str, float]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Mapping[str, float]) -> "ScheduleInfo":
        return cls(**dict(d))


@dataclasses.dataclass(frozen=True)
class JobResult:
    """One executed benchmark job: spec + metrics + provenance.

    ``metrics`` holds the mode-dependent measurement dict (the record's
    ``result`` field: throughput/percentiles/cost for simulated serving,
    roofline numbers for generated models); treat it as read-only.
    """
    spec: AnyJobSpec
    metrics: Dict[str, Any]
    stages: Optional[StageBreakdown] = None
    cold_start_s: Optional[float] = None
    generated: Optional[Dict[str, Any]] = None
    cluster: Optional[Dict[str, Any]] = None   # replica-tier provenance
    memory: Optional[Dict[str, Any]] = None    # KV-cache accounting (peak/
                                               # mean occupancy, prefix hit
                                               # rate, preemption count)
    timeseries: Optional[Dict[str, Any]] = None  # repro_torch.obs Timeseries
                                               # dict (ObsSpec runs only);
                                               # the HTML report plots it
    schedule: Optional[ScheduleInfo] = None
    benchmark_wall_s: float = 0.0
    ts: Optional[float] = None
    # side-channel records the session also persists to PerfDB (e.g. the
    # per-grid-point kind="calibration" measurements behind a fitted
    # profile); not part of this result's own record
    extra_records: Optional[List[Dict[str, Any]]] = None

    # ---- convenience accessors -------------------------------------------
    @property
    def job_id(self) -> str:
        return self.spec.job_id

    @property
    def mode(self) -> str:
        return str(self.metrics.get("mode", "unknown"))

    def metric(self, key: str, default: float = float("nan")) -> float:
        return self.metrics.get(key, default)

    def with_schedule(self, schedule: ScheduleInfo) -> "JobResult":
        return dataclasses.replace(self, schedule=schedule)

    # ---- PerfDB JSONL schema ---------------------------------------------
    def to_record(self) -> Dict[str, Any]:
        """The flat PerfDB record.

        Benchmark jobs keep the unchanged legacy schema; calibration and
        plan jobs add a top-level ``kind`` plus their own provenance
        columns (``extra_records`` are *not* folded in — the session
        persists those as sibling rows).
        """
        spec = self.spec
        if isinstance(spec, CalibrationSpec):
            rec = {
                "job_id": spec.job_id,
                "user": spec.user,
                "kind": spec.kind,
                "arch": spec.model.label,
                "hardware": spec.hardware,
                "chips": spec.chips,
                "spec": spec.to_dict(),
            }
        elif isinstance(spec, PlanSpec):
            rec = {
                "job_id": spec.job_id,
                "user": spec.user,
                "kind": spec.kind,
                "profile": spec.profile,
                "spec": spec.to_dict(),
            }
        else:
            rec = {
                "job_id": spec.job_id,
                "user": spec.user,
                "arch": spec.model.name,
                "hardware": spec.hardware,
                "chips": spec.chips,
                "policy": spec.software.policy,
                "network": spec.network,
                "spec": spec.to_dict(),
            }
            if spec.scenario:
                # top-level so PerfDB queries can filter by scenario
                # without walking into the spec
                rec["scenario"] = spec.scenario
        if self.generated is not None:
            rec["generated"] = dict(self.generated)
        rec["result"] = dict(self.metrics)
        if self.stages is not None:
            rec["stages"] = self.stages.to_dict()
        if self.cold_start_s is not None:
            rec["cold_start_s"] = self.cold_start_s
        if self.cluster is not None:
            rec["cluster"] = dict(self.cluster)
        if self.memory is not None:
            rec["memory"] = dict(self.memory)
        if self.timeseries is not None:
            rec["timeseries"] = dict(self.timeseries)
        rec["benchmark_wall_s"] = self.benchmark_wall_s
        if self.schedule is not None:
            rec["sched"] = self.schedule.to_dict()
        if self.ts is not None:
            rec["ts"] = self.ts
        return rec

    @classmethod
    def from_record(cls, rec: Mapping[str, Any]) -> "JobResult":
        spec_cls = {"calibration": CalibrationSpec,
                    "plan": PlanSpec}.get(rec.get("kind", "benchmark"),
                                          BenchmarkJobSpec)
        return cls(
            spec=spec_cls.from_dict(rec["spec"]),
            metrics=dict(rec.get("result", {})),
            stages=(StageBreakdown.from_dict(rec["stages"])
                    if "stages" in rec else None),
            cold_start_s=rec.get("cold_start_s"),
            generated=(dict(rec["generated"])
                       if rec.get("generated") is not None else None),
            cluster=(dict(rec["cluster"])
                     if rec.get("cluster") is not None else None),
            memory=(dict(rec["memory"])
                    if rec.get("memory") is not None else None),
            timeseries=(dict(rec["timeseries"])
                        if rec.get("timeseries") is not None else None),
            schedule=(ScheduleInfo.from_dict(rec["sched"])
                      if "sched" in rec else None),
            benchmark_wall_s=rec.get("benchmark_wall_s", 0.0),
            ts=rec.get("ts"),
        )
