"""BenchmarkSession — the declarative job-submission surface (paper §4.1).

The paper's promise is that a developer hands the system "a configuration
file consisting of a few lines of code" and the leader/follower machinery
does the rest.  This module is that front end:

  * jobs are submitted as ``BenchmarkJobSpec`` objects, plain dicts, or
    JSON/TOML config files (single job, job list, or sweep);
  * ``submit`` returns a ``JobHandle`` future resolved when the job runs;
  * execution is pluggable behind the ``Executor`` protocol —
    ``InlineExecutor`` runs the two-tier schedule sequentially in-process,
    ``ConcurrentFollowerExecutor`` fans out one thread per follower with
    real per-worker queues and ``Follower.busy_until`` bookkeeping;
  * every outcome is a typed ``JobResult`` that serializes to the
    unchanged PerfDB JSONL schema.

The four benchmark stages per job are unchanged:
  1 Generate — resolve the model (registered arch or canonical generated
               model) + workload trace,
  2 Serve    — run the serving pipeline (simulator clocked by the roofline
               latency oracle, or real execution of generated models on the
               device: the card unless the session is given
               ``device="cpu"``),
  3 Collect  — per-stage latencies, utilization, energy/cost,
  4 Analyze  — aggregate into PerfDB; recommender/leaderboard read it.

Ported from ``repro.core.session``.  Generated models are the port's
``nn.Module``s, timed with ``MeasuredLatency`` (which waits for the card);
everything else is the reference's orchestration.  ``ConcurrentFollowerExecutor``
runs its followers' jobs in threads: measured jobs on concurrent followers
share one card and disturb each other's timings, so run measured jobs with
the ``InlineExecutor`` (the default).
"""
from __future__ import annotations

import dataclasses
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import (Any, Callable, Dict, List, Mapping, Optional, Sequence,
                    Union)

import torch

from repro_torch import hw as hw_lib
from repro_torch import ieee_fp32, resolve_device
from repro_torch.configs import get_config
from repro_torch.core import generator as gen_lib
from repro_torch.core.perfdb import PerfDB
from repro_torch.core.results import JobResult, ScheduleInfo, StageBreakdown
from repro_torch.core.scheduler import ClusterScheduler, Job, ScheduledJob
from repro_torch.core.spec import (AnyJobSpec, BenchmarkJobSpec, CalibrationSpec,
                             PlanSpec, SoftwareSpec, SweepSpec, load_jobs,
                             spec_from_dict)
from repro_torch.serving.batching import BatchPolicy, make_policy
from repro_torch.serving.cluster import simulate_cluster
from repro_torch.serving.latency_model import (FittedLatencyModel, LatencyModel,
                                         MeasuredLatency, NETWORKS)

JobLike = Union[AnyJobSpec, Mapping[str, Any], str, Path]


def resolve_policy(sw: SoftwareSpec) -> BatchPolicy:
    """Software tier → batching policy (paper's TFS vs TrIS comparison,
    plus the Orca/vLLM-style continuous batcher)."""
    if sw.policy in ("none", "nobatch"):
        return make_policy("none")
    if sw.policy in ("tfs", "window"):
        return make_policy("tfs", max_batch=sw.max_batch,
                           timeout_s=sw.timeout_s)
    if sw.policy in ("continuous", "orca", "vllm"):
        return make_policy("continuous", max_batch=sw.max_batch,
                           max_prefill=sw.max_prefill)
    return make_policy("tris", preferred=tuple(sw.preferred))


def run_stages(spec: AnyJobSpec, device=None) -> JobResult:
    """Stages 1–3 for one job; pure w.r.t. session state (thread-safe).

    ``device`` is where measured work runs — generated models and
    calibration sweeps: the card unless ``device="cpu"``; jobs on the
    simulator touch no device.  Calibration and plan submissions dispatch
    to their own stage runners in :mod:`repro_torch.calibrate` (lazy imports
    keep the core importable without pulling the calibration stack in)."""
    if isinstance(spec, CalibrationSpec):
        from repro_torch.calibrate.microbench import run_calibration_job
        return run_calibration_job(spec, device=device)
    if isinstance(spec, PlanSpec):
        from repro_torch.calibrate.planner import run_plan_job
        return run_plan_job(spec)

    t0 = time.time()
    hwm = hw_lib.HARDWARE[spec.hardware]

    if spec.model.kind == "generated":
        gspec = gen_lib.GeneratedSpec(
            family=spec.model.family, layers=spec.model.layers,
            width=spec.model.width, batch=spec.model.batch_hint)
        dev = resolve_device(device)
        model, inputs = gen_lib.build(gspec, dev)
        # an fp32 model: its products stay IEEE fp32, whatever the
        # caller's TF32 settings
        with torch.inference_mode(), ieee_fp32():
            measured = MeasuredLatency(model).measure(*inputs)
        flops = gspec.batch * gen_lib.flops_estimate(gspec)
        bytes_moved = gen_lib.param_bytes(model) + sum(
            float(x.numel() * x.element_size()) for x in inputs)
        return JobResult(
            spec=spec,
            generated=dataclasses.asdict(gspec),
            metrics={
                "latency_s": measured,
                "throughput_rps": gspec.batch / measured,
                "flops": flops,
                "bytes": bytes_moved,
                "intensity": flops / max(bytes_moved, 1.0),
                "attained_flops": flops / measured,
                "mode": f"measured-{dev.type}",
            },
            benchmark_wall_s=time.time() - t0)

    if spec.profile:
        # calibrated oracle: the fitted profile replaces the analytic
        # roofline model (its hardware/chips define the cost context)
        lat = FittedLatencyModel.from_profile(spec.profile)
    else:
        cfg = get_config(spec.model.name)
        lat = LatencyModel(cfg, hw=hwm, chips=spec.chips,
                           int8=spec.software.int8)
    if spec.software.speed_mode:
        # serving speed mode (int8 / speculative): scale the oracle's
        # roofline terms and effective decode step
        from repro_torch.serving.latency_model import apply_speed_mode
        lat = apply_speed_mode(lat, spec.software.speed_mode)
    policy = resolve_policy(spec.software)
    sim_t0 = time.perf_counter()
    res = simulate_cluster(spec.workload, policy, lat, cluster=spec.cluster,
                           network=NETWORKS[spec.network])
    sim_wall = time.perf_counter() - sim_t0
    metrics = dict(res.summary(),
                   mode="fitted-profile" if spec.profile
                   else "roofline-model")
    if spec.software.speed_mode:
        metrics["speed_mode"] = spec.software.speed_mode
    # simulator provenance on every simulator-backed record: reports can
    # plot the event-loop perf trajectory straight from PerfDB
    metrics["events"] = res.events
    metrics["requests_served"] = res.requests_served or len(res.traces)
    metrics["sim_events_per_sec"] = (res.events / sim_wall
                                     if sim_wall > 0 else 0.0)
    if spec.slo_latency_s is not None:
        metrics["slo_attainment"] = res.slo_attainment(spec.slo_latency_s)
    if spec.slo_ttft_s is not None or spec.slo_tpot_s is not None:
        # joint phase attainment/goodput over every SLO the job declares
        metrics["phase_slo_attainment"] = res.phase_slo_attainment(
            ttft_slo_s=spec.slo_ttft_s, tpot_slo_s=spec.slo_tpot_s,
            e2e_slo_s=spec.slo_latency_s)
        metrics["goodput_rps"] = res.goodput(
            spec.slo_ttft_s, spec.slo_tpot_s, spec.slo_latency_s)
    if spec.workload.tenants:
        # multi-tenant run: per-tenant goodput/attainment against each
        # tenant's own SLOs + fairness/isolation aggregates
        from repro_torch.scenarios.tenants import tenant_report
        metrics["tenants"] = tenant_report(res, spec.workload.tenants)
    cluster_info = {
        "replicas": res.replicas,
        "router": res.router,
        "autoscale": spec.cluster.autoscale,
        "replica_seconds": res.billed_replica_seconds(),
        "per_replica_busy_s": list(res.per_replica_busy_s or []),
    }
    if res.pools is not None:
        cluster_info["pools"] = dict(res.pools)
    if res.fleet is not None:
        # heterogeneous-fleet provenance: per-pool hardware/pricing bill
        # plus the spot/cross-region counters, preserved in the PerfDB
        cluster_info["fleet"] = dict(res.fleet)
    return JobResult(
        spec=spec,
        metrics=metrics,
        stages=StageBreakdown.from_dict(res.stage_means()),
        cold_start_s=lat.cold_start(),
        cluster=cluster_info,
        memory=res.memory,
        timeseries=(res.timeseries.to_dict()
                    if res.timeseries is not None else None),
        benchmark_wall_s=time.time() - t0)


def execute_job(spec: BenchmarkJobSpec, device=None) -> Dict[str, Any]:
    """Legacy entry point: stages 1–3, returned as the PerfDB record."""
    return run_stages(spec, device=device).to_record()


@dataclasses.dataclass
class Follower:
    """A follower worker (paper Fig. 5): executes its queue in order.

    ``busy_until`` tracks the worker's horizon on the schedule clock — it
    advances monotonically to each job's scheduled finish as the job
    completes, so mid-run reads reflect actual progress.
    """
    worker_id: int
    busy_until: float = 0.0
    executed: int = 0


class JobHandle:
    """Future for one submitted job; resolved when its executor runs it."""

    def __init__(self, spec: AnyJobSpec):
        self.spec = spec
        self._done = threading.Event()
        self._result: Optional[JobResult] = None
        self._exc: Optional[BaseException] = None

    @property
    def job_id(self) -> str:
        return self.spec.job_id

    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout: Optional[float] = None) -> JobResult:
        if not self._done.wait(timeout):
            raise TimeoutError(f"job {self.job_id!r} not finished "
                               "(did you call BenchmarkSession.run()?)")
        if self._exc is not None:
            raise self._exc
        assert self._result is not None
        return self._result

    def _resolve(self, result: JobResult) -> None:
        self._result = result
        self._done.set()

    def _fail(self, exc: BaseException) -> None:
        self._exc = exc
        self._done.set()


@dataclasses.dataclass
class PlacedJob:
    """A submission bound to its slot in the two-tier schedule, and the
    device its measured stages run on."""
    handle: JobHandle
    sched: ScheduledJob
    device: Any = None

    @property
    def spec(self) -> AnyJobSpec:
        return self.handle.spec

    def schedule_info(self) -> ScheduleInfo:
        return ScheduleInfo(worker=self.sched.worker,
                            start_s=self.sched.start_s,
                            finish_s=self.sched.finish_s,
                            jct_s=self.sched.jct)


class Executor:
    """Execution strategy for a scheduled batch of benchmark jobs.

    Implementations must honor the two-tier schedule: tier-1 placement
    (``PlacedJob.sched.worker``) is fixed, and each worker runs its own
    jobs in scheduled start order.
    """
    name = "base"

    def execute(self, placed: Sequence[PlacedJob],
                followers: Sequence[Follower],
                on_result: Callable[[JobResult], None]) -> List[JobResult]:
        raise NotImplementedError


def _run_placed(pj: PlacedJob, follower: Follower,
                on_result: Callable[[JobResult], None]) -> JobResult:
    try:
        result = run_stages(pj.spec, pj.device).with_schedule(
            pj.schedule_info())
    except BaseException as exc:
        pj.handle._fail(exc)
        raise
    follower.busy_until = max(follower.busy_until, pj.sched.finish_s)
    follower.executed += 1
    on_result(result)
    pj.handle._resolve(result)
    return result


class InlineExecutor(Executor):
    """Sequential in-process execution in global scheduled-start order
    (the behavior of the old ``Leader.run_all``)."""
    name = "inline"

    def execute(self, placed, followers, on_result):
        results = []
        for pj in sorted(placed, key=lambda p: p.sched.start_s):
            results.append(_run_placed(pj, followers[pj.sched.worker],
                                       on_result))
        return results


class ConcurrentFollowerExecutor(Executor):
    """One thread per follower, each draining its own queue in scheduled
    order — the schedule's per-worker timelines actually run concurrently.
    Measured jobs on concurrent followers share the one card, so their
    timings disturb each other."""
    name = "concurrent"

    def execute(self, placed, followers, on_result):
        queues: Dict[int, List[PlacedJob]] = {f.worker_id: []
                                              for f in followers}
        for pj in placed:
            queues[pj.sched.worker].append(pj)
        for q in queues.values():
            q.sort(key=lambda p: p.sched.start_s)

        results: List[JobResult] = []
        lock = threading.Lock()

        def locked_on_result(res: JobResult) -> None:
            with lock:
                on_result(res)
                results.append(res)

        def drain(follower: Follower) -> None:
            for pj in queues[follower.worker_id]:
                _run_placed(pj, follower, locked_on_result)

        active = [f for f in followers if queues[f.worker_id]]
        if not active:
            return []
        with ThreadPoolExecutor(max_workers=len(active)) as pool:
            futures = [pool.submit(drain, f) for f in active]
            for fut in futures:
                fut.result()
        return results


class BenchmarkSession:
    """Facade: declarative submission → two-tier schedule → executor → PerfDB.

    >>> session = BenchmarkSession(n_workers=4)
    >>> session.submit({"job_id": "j0", "model": {"name": "gemma2-2b"}})
    >>> session.submit_file("configs/jobs/quickstart.json")   # sweep
    >>> results = session.run()                               # [JobResult]

    ``device`` is where measured stages run (the card unless
    ``device="cpu"``; resolved by each measured job, so a session of
    simulated jobs needs no card).
    """

    def __init__(self, n_workers: int = 4, db: Optional[PerfDB] = None,
                 lb: str = "qa", order: str = "sjf",
                 executor: Optional[Executor] = None, device=None):
        self.device = device
        self.db = db if db is not None else PerfDB()
        self.followers = [Follower(i) for i in range(n_workers)]
        self.scheduler = ClusterScheduler(n_workers, lb=lb, order=order)
        self.executor = executor if executor is not None else InlineExecutor()
        self._pending: List[JobHandle] = []
        self._pending_ids: set = set()
        self._results: List[JobResult] = []

    # ---- submission -------------------------------------------------------
    def _coerce(self, job: JobLike) -> AnyJobSpec:
        if isinstance(job, (BenchmarkJobSpec, CalibrationSpec, PlanSpec)):
            return job
        if isinstance(job, Mapping):
            # dicts dispatch on their optional "kind" field
            # (benchmark | calibration | plan)
            return spec_from_dict(dict(job))
        raise TypeError(f"cannot submit {type(job).__name__}; expected "
                        "BenchmarkJobSpec/CalibrationSpec/PlanSpec, dict, "
                        "or a config-file path")

    def submit(self, job: JobLike) -> JobHandle:
        """Queue one job (spec, dict, or single-job config file)."""
        if isinstance(job, (str, Path)):
            specs = load_jobs(job)
            if len(specs) != 1:
                raise ValueError(
                    f"{job} expands to {len(specs)} jobs; use submit_file")
            job = specs[0]
        spec = self._coerce(job)
        if spec.job_id in self._pending_ids:
            raise ValueError(f"duplicate pending job_id {spec.job_id!r}")
        handle = JobHandle(spec)
        self._pending.append(handle)
        self._pending_ids.add(spec.job_id)
        return handle

    def submit_sweep(self, sweep: Union[SweepSpec, Mapping[str, Any]]
                     ) -> List[JobHandle]:
        """Queue a cross-product sweep (SweepSpec or its dict form)."""
        if isinstance(sweep, Mapping):
            sweep = SweepSpec.from_dict(dict(sweep))
        return [self.submit(spec) for spec in sweep.expand()]

    def submit_file(self, path: Union[str, Path]) -> List[JobHandle]:
        """Queue every job a JSON/TOML config expands to (job/list/sweep)."""
        return [self.submit(spec) for spec in load_jobs(path)]

    # ---- execution --------------------------------------------------------
    def run(self) -> List[JobResult]:
        """Schedule all pending jobs and execute them; returns their results
        in the executor's completion order."""
        pending, self._pending = self._pending, []
        self._pending_ids.clear()
        if not pending:
            return []
        jobs = [Job(job_id=h.spec.job_id, submit_s=float(i),
                    processing_s=h.spec.est_processing_s)
                for i, h in enumerate(pending)]
        by_id = {h.spec.job_id: h for h in pending}
        placed = [PlacedJob(handle=by_id[sj.job.job_id], sched=sj,
                            device=self.device)
                  for sj in self.scheduler.run(jobs)]
        try:
            return self.executor.execute(placed, self.followers, self._record)
        finally:
            # a job that raised aborts its worker's queue; make sure every
            # unexecuted handle fails loudly instead of blocking result()
            for h in pending:
                if not h.done():
                    h._fail(RuntimeError(
                        f"job {h.job_id!r} was not executed "
                        "(another job aborted the run)"))

    def _record(self, result: JobResult) -> None:
        # side-channel rows first (e.g. per-grid-point calibration
        # records), then the job's own record — both write-through
        for rec in result.extra_records or ():
            self.db.append(dict(rec))
        self.db.append(result.to_record())
        self._results.append(result)

    def results(self) -> List[JobResult]:
        """All results produced by this session so far."""
        return list(self._results)

    def report(self, path: str, *, title: str = "Benchmark run report"
               ) -> str:
        """Render the session's results as a standalone HTML report
        (see :mod:`repro_torch.obs.report`); returns the path written."""
        from repro_torch.obs.report import write_report
        return write_report([r.to_record() for r in self._results], path,
                            title=title)

    @property
    def pending(self) -> int:
        return len(self._pending)

    # ---- context manager: run whatever is still queued on clean exit ------
    def __enter__(self) -> "BenchmarkSession":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is None and self._pending:
            self.run()
