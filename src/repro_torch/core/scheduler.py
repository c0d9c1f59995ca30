"""Two-tier benchmark-job scheduler (paper §4.3.2, Algorithm 1).

Tier 1: the leader's load balancer places a job on a follower worker —
  RR  (round-robin, the baseline) or
  QA  (queue-aware: the worker with the shortest total queued time).
Tier 2: each worker orders its queue —
  FCFS (arrival order) or SJF (ascending processing time).

The paper's claim: QA-LB + SJF reduces average job-completion time 1.43×
(≈30%) vs RR + FCFS.  ``evaluate_schedulers`` reproduces that experiment
(EXPERIMENTS.md §Paper-claims).

A copy of ``repro.core.scheduler``, importing only ``repro_torch``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np

RR = "rr"
QA = "qa"
FCFS = "fcfs"
SJF = "sjf"


@dataclasses.dataclass
class Job:
    job_id: str
    submit_s: float
    processing_s: float


@dataclasses.dataclass
class ScheduledJob:
    job: Job
    worker: int
    start_s: float
    finish_s: float

    @property
    def jct(self) -> float:
        """Job completion time = waiting + processing (paper's t_j)."""
        return self.finish_s - self.job.submit_s


class ClusterScheduler:
    """Simulates placement + per-worker execution for a job trace."""

    def __init__(self, n_workers: int, lb: str = QA, order: str = SJF):
        assert lb in (RR, QA) and order in (FCFS, SJF)
        self.n_workers = n_workers
        self.lb = lb
        self.order = order

    def run(self, jobs: Sequence[Job]) -> List[ScheduledJob]:
        jobs = sorted(jobs, key=lambda j: j.submit_s)
        free_at = [0.0] * self.n_workers        # worker busy horizon
        queued: List[List[Job]] = [[] for _ in range(self.n_workers)]
        rr_next = 0
        placements: Dict[str, int] = {}

        # Tier 1 — placement at submission time.
        for job in jobs:
            if self.lb == RR:
                w = rr_next
                rr_next = (rr_next + 1) % self.n_workers
            else:  # queue-aware: shortest total outstanding work
                loads = [max(free_at[i], job.submit_s)
                         + sum(j.processing_s for j in queued[i])
                         for i in range(self.n_workers)]
                w = int(np.argmin(loads))
            queued[w].append(job)
            placements[job.job_id] = w

        # Tier 2 — per-worker ordering + sequential execution.
        out: List[ScheduledJob] = []
        for w in range(self.n_workers):
            q = list(queued[w])
            if self.order == SJF:
                # re-order within the scheduling interval (paper: processing
                # times known before execution)
                q.sort(key=lambda j: (j.submit_s, j.processing_s))
                # SJF applies among jobs that are waiting together: simulate
                # by repeatedly picking the shortest *available* job.
                t = 0.0
                remaining = sorted(q, key=lambda j: j.submit_s)
                done: List[ScheduledJob] = []
                while remaining:
                    avail = [j for j in remaining if j.submit_s <= t]
                    if not avail:
                        t = min(j.submit_s for j in remaining)
                        continue
                    nxt = min(avail, key=lambda j: j.processing_s)
                    remaining.remove(nxt)
                    start = max(t, nxt.submit_s)
                    finish = start + nxt.processing_s
                    done.append(ScheduledJob(nxt, w, start, finish))
                    t = finish
                out.extend(done)
            else:  # FCFS
                t = 0.0
                for j in q:
                    start = max(t, j.submit_s)
                    finish = start + j.processing_s
                    out.append(ScheduledJob(j, w, start, finish))
                    t = finish
        return out


def average_jct(schedule: List[ScheduledJob]) -> float:
    return float(np.mean([s.jct for s in schedule])) if schedule else 0.0


def make_job_trace(n_jobs: int = 200, n_heavy_frac: float = 0.2,
                   arrival_rate: float = 2.0, seed: int = 0) -> List[Job]:
    """Benchmark-job trace: mostly short smoke jobs + a heavy AutoML tail
    (the paper's motivation: AutoML-style tasks hog workers)."""
    rng = np.random.default_rng(seed)
    t = 0.0
    jobs = []
    for i in range(n_jobs):
        t += rng.exponential(1.0 / arrival_rate)
        if rng.random() < n_heavy_frac:
            proc = rng.uniform(20.0, 60.0)       # AutoML-ish sweeps
        else:
            proc = rng.uniform(0.5, 5.0)         # single-config checks
        jobs.append(Job(job_id=f"j{i}", submit_s=t, processing_s=proc))
    return jobs


def evaluate_schedulers(n_workers: int = 4, n_jobs: int = 200,
                        seed: int = 0) -> Dict[str, float]:
    """Reproduce the paper's Fig. 15: RR+FCFS vs QA+FCFS (LB) vs QA+SJF."""
    jobs = make_job_trace(n_jobs=n_jobs, seed=seed)
    out = {}
    for name, (lb, order) in {
        "rr_fcfs": (RR, FCFS),
        "qa_fcfs": (QA, FCFS),
        "rr_sjf": (RR, SJF),
        "qa_sjf": (QA, SJF),
    }.items():
        sched = ClusterScheduler(n_workers, lb=lb, order=order)
        out[name] = average_jct(sched.run(jobs))
    out["speedup_qa_sjf_vs_rr_fcfs"] = out["rr_fcfs"] / out["qa_sjf"]
    return out
