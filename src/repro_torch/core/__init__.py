"""repro_torch.core — the benchmark-job system, ported from ``repro.core``:
specs, the two-tier scheduler, the session with its followers and
executors, PerfDB, typed results and the generated models."""
from repro_torch.core.leader import Leader
from repro_torch.core.perfdb import PerfDB
from repro_torch.core.results import JobResult, ScheduleInfo, StageBreakdown
from repro_torch.core.scheduler import ClusterScheduler, evaluate_schedulers
from repro_torch.core.session import (BenchmarkSession,
                                      ConcurrentFollowerExecutor, Executor,
                                      Follower, InlineExecutor, JobHandle,
                                      execute_job, resolve_policy, run_stages)
from repro_torch.core.spec import (BenchmarkJobSpec, CalibrationSpec,
                                   ClusterSpec, DisaggSpec, MemorySpec,
                                   ModelRef, PlanSpec, SoftwareSpec, SweepSpec,
                                   load_jobs, spec_from_dict)

__all__ = [
    "BenchmarkSession", "ConcurrentFollowerExecutor", "Executor", "Follower",
    "InlineExecutor", "JobHandle", "execute_job", "resolve_policy",
    "run_stages", "JobResult", "ScheduleInfo", "StageBreakdown", "Leader",
    "PerfDB", "ClusterScheduler", "evaluate_schedulers", "BenchmarkJobSpec",
    "CalibrationSpec", "ClusterSpec", "DisaggSpec", "MemorySpec", "ModelRef",
    "PlanSpec", "SoftwareSpec", "SweepSpec", "load_jobs", "spec_from_dict",
]
