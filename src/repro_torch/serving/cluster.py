"""Multi-replica cluster simulation: routers, reactive autoscaling, and
the shared discrete-event loop over ``ReplicaEngine`` timelines.

This is the capacity-planning layer the paper's benchmark questions need
at scale: N model replicas behind a pluggable router (round-robin,
least-loaded/JSQ, session-affinity, cost-weighted, fastest-TTFT) with an
optional reactive autoscaler that adds replicas under backlog and
retires idle ones.  A cluster is either a flat pool of identical
replicas (``ClusterSpec.replicas``), a prefill/decode split
(``disaggregation``), or a heterogeneous fleet of typed ``PoolSpec``s —
each pool with its own hardware, latency oracle, memory budget, pricing
class (reserved vs. spot, with a seeded reclamation process) and
optional region.  The event loop owns arrivals, routing, closed-loop
reissue, spot kills, inter-region forwarding and the shared clock.

A copy of ``repro.serving.cluster``, importing only ``repro_torch``.
"""
from __future__ import annotations

import dataclasses
import heapq
import math
from typing import Dict, List, Optional, Tuple

from repro_torch import hw as hw_lib
from repro_torch.obs.recorder import MetricsRecorder
from repro_torch.obs.spec import ObsSpec
from repro_torch.serving.batching import (BatchPolicy, ContinuousBatcher,
                                    QueuedRequest)
from repro_torch.serving.latency_model import (FittedLatencyModel, LatencyModel,
                                         NetworkModel, NETWORKS,
                                         inter_region_network,
                                         oracle_for_hardware)
from repro_torch.serving.memory import (KVBudgetError, KVCacheManager, MemorySpec,
                                  ResolvedMemory, oracle_kv_bytes_per_token,
                                  resolve_memory,
                                  validate_budget_for_requests)
from repro_torch.serving.simulator import (EPS, PRE_PROCESS_S, ReplicaEngine,
                                     RequestTrace, SimResult,
                                     clamped_output_tokens)
from repro_torch.serving.workload import CLOSED, TRACE, Request, WorkloadSpec, \
    generate


@dataclasses.dataclass(frozen=True)
class DisaggSpec:
    """Disaggregated prefill/decode serving (DistServe/Splitwise-style).

    Requests land on a *prefill pool* that runs chunked prefill only and
    emits the first token; the KV cache then migrates to a *decode pool*
    over ``kv_network`` (bytes = ``kv_bytes_per_token × prompt_tokens``)
    and the request joins a decode engine's continuous batch with its KV
    already resident.  Each pool has its own replica count, router, and
    batching knobs, so prefill bursts can no longer stall decode
    iterations (TPOT) and long prompts stop queueing behind decode
    (TTFT).
    """
    prefill_replicas: int = 1
    decode_replicas: int = 1
    prefill_router: str = "least-loaded"
    decode_router: str = "least-loaded"
    prefill_chunk_tokens: int = 512  # chunked-prefill granularity
                                     # (0 → whole-prompt prefill)
    prefill_max_batch: int = 4       # concurrent prefills per engine
    decode_max_batch: int = 0        # decode slots; 0 → the job policy's
                                     # max_batch
    kv_network: str = "infiniband"   # NetworkModel clocking the handoff
    kv_bytes_per_token: float = 0.0  # 0 → derive from the memory spec /
                                     # model config (0 if underivable:
                                     # the handoff costs one RTT)

    def __post_init__(self):
        if self.prefill_replicas < 1 or self.decode_replicas < 1:
            raise ValueError("DisaggSpec needs at least one replica in "
                             "each pool")
        if self.prefill_max_batch < 1:
            raise ValueError("DisaggSpec.prefill_max_batch must be >= 1")
        if self.prefill_chunk_tokens < 0:
            raise ValueError("DisaggSpec.prefill_chunk_tokens must be "
                             ">= 0 (0 = whole-prompt prefill)")
        if self.kv_network not in NETWORKS:
            raise ValueError(f"unknown kv_network {self.kv_network!r} "
                             f"(known: {sorted(NETWORKS)})")

    @property
    def total_replicas(self) -> int:
        return self.prefill_replicas + self.decode_replicas

    @classmethod
    def from_dict(cls, d) -> "DisaggSpec":
        return cls(**dict(d))


@dataclasses.dataclass(frozen=True)
class PoolSpec:
    """One homogeneous slice of a heterogeneous fleet.

    A fleet is a list of pools; each pool contributes ``replicas``
    engines that share one hardware target, latency oracle, memory
    budget and billing class.  The flat ``ClusterSpec(replicas=N)``
    cluster is the degenerate one-pool case (and keeps its own code
    path, byte-identical to the pre-fleet simulator).

    Fields:

    - ``name``: label for routing/observability ("" → ``pool{index}``).
    - ``hardware``: ``hw.HARDWARE`` catalog key; "" inherits the job's
      base oracle hardware.  The pool's oracle is the same analytic
      roofline model re-targeted at this chip (``oracle_for_hardware``),
      unless ``profile`` supplies calibrated coefficients.
    - ``replicas``: initial engine count (>= 1).
    - ``chips``: chips per replica (0 → the base oracle's count).
    - ``pricing``: ``"reserved"`` (on-demand rates) or ``"spot"``
      (discounted rates + eligibility for the reclamation process).
    - ``region``: placement label; requests routed across regions pay
      the ``inter_region_network`` RTT, and session affinity prefers a
      session's home region ("" → co-located with the front door).
    - ``preempt_mtbf_s``: mean seconds between spot reclamations per
      replica slot (exponential inter-kill times, seeded by
      ``ClusterSpec.preempt_seed``).  0 disables kills.  Only the
      pool's *initial* replica slots are tracked; each kill immediately
      provisions a cold replacement into the same slot.
    - ``min_replicas`` / ``max_replicas``: per-pool autoscaler bounds
      (0 → pinned at ``replicas``; any pool with ``min != max`` turns
      on the per-pool reactive controller).
    - ``memory``: pool-specific ``MemorySpec`` overriding
      ``ClusterSpec.memory`` (each pool's budget is resolved against
      its *own* oracle/HBM).
    - ``profile``: ``CalibrationProfile`` (dict/path/key) for a fitted
      per-pool latency oracle instead of the analytic roofline.
    """
    name: str = ""
    hardware: str = ""
    replicas: int = 1
    chips: int = 0
    pricing: str = "reserved"
    region: str = ""
    preempt_mtbf_s: float = 0.0
    min_replicas: int = 0
    max_replicas: int = 0
    memory: Optional[MemorySpec] = None
    profile: Optional[dict] = None

    def __post_init__(self):
        if self.replicas < 1:
            raise ValueError("PoolSpec.replicas must be >= 1")
        if self.chips < 0:
            raise ValueError("PoolSpec.chips must be >= 0 (0 inherits "
                             "the base oracle's chip count)")
        if self.pricing not in hw_lib.PRICING_CLASSES:
            raise ValueError(f"unknown pricing class {self.pricing!r} "
                             f"(expected one of {hw_lib.PRICING_CLASSES})")
        if self.hardware and self.hardware not in hw_lib.HARDWARE:
            raise ValueError(f"unknown hardware {self.hardware!r} "
                             f"(known: {sorted(hw_lib.HARDWARE)})")
        if self.preempt_mtbf_s < 0:
            raise ValueError("PoolSpec.preempt_mtbf_s must be >= 0")
        if self.preempt_mtbf_s > 0 and self.pricing != "spot":
            raise ValueError("preempt_mtbf_s models spot reclamation; "
                             "set pricing='spot' (reserved capacity is "
                             "never reclaimed)")
        if self.min_replicas < 0 or self.max_replicas < 0:
            raise ValueError("PoolSpec autoscale bounds must be >= 0 "
                             "(0 pins the pool at its replica count)")
        lo, hi = self.bounds()
        if not lo <= self.replicas <= hi:
            raise ValueError(
                f"PoolSpec.replicas={self.replicas} outside autoscale "
                f"bounds [{lo}, {hi}]")
        if isinstance(self.memory, dict):
            object.__setattr__(self, "memory",
                               MemorySpec.from_dict(self.memory))

    def bounds(self) -> Tuple[int, int]:
        """Effective (min, max) replica bounds (0 → pinned)."""
        return (self.min_replicas or self.replicas,
                self.max_replicas or self.replicas)

    @classmethod
    def from_dict(cls, d) -> "PoolSpec":
        return cls(**dict(d))


@dataclasses.dataclass(frozen=True)
class ClusterSpec:
    """Replica-tier configuration (plumbed through BenchmarkJobSpec)."""
    replicas: int = 1
    router: str = "round-robin"     # round-robin | least-loaded | affinity
    autoscale: bool = False
    min_replicas: int = 1
    max_replicas: int = 8
    scale_interval_s: float = 0.5   # reactive-controller evaluation period
    scale_up_load: float = 4.0      # mean in-flight/replica to add one
    scale_down_load: float = 0.5    # mean in-flight/replica to retire one
    spawn_delay_s: float = 0.5      # cold-start before a new replica serves
    memory: Optional[MemorySpec] = None   # per-replica KV-cache accounting
                                    # (None → memory unmodeled, legacy)
    disaggregation: Optional[DisaggSpec] = None   # split prefill/decode
                                    # pools (None → colocated, legacy)
    obs: Optional[ObsSpec] = None   # observability layer (time-series +
                                    # timeline); None → fast path, zero
                                    # recording overhead
    pools: Optional[Tuple[PoolSpec, ...]] = None  # heterogeneous fleet
                                    # (None → flat identical replicas;
                                    # when set, ``replicas`` is ignored)
    preempt_seed: int = 0           # seeds the spot-reclamation schedule

    def __post_init__(self):
        if self.replicas < 1 or self.min_replicas < 1:
            raise ValueError("ClusterSpec needs replicas >= 1 and "
                             "min_replicas >= 1 (the cluster cannot scale "
                             "up from zero: backlog is only observed on "
                             "live replicas)")
        if self.max_replicas < self.min_replicas:
            raise ValueError("ClusterSpec.max_replicas must be >= "
                             "min_replicas")
        if isinstance(self.memory, dict):
            object.__setattr__(self, "memory",
                               MemorySpec.from_dict(self.memory))
        if isinstance(self.disaggregation, dict):
            object.__setattr__(self, "disaggregation",
                               DisaggSpec.from_dict(self.disaggregation))
        if isinstance(self.obs, dict):
            object.__setattr__(self, "obs", ObsSpec.from_dict(self.obs))
        if self.disaggregation is not None and self.autoscale:
            raise ValueError("disaggregated pools are fixed-size: "
                             "autoscale=True is not supported with "
                             "ClusterSpec.disaggregation")
        if self.pools is not None:
            coerced = tuple(
                PoolSpec.from_dict(p) if isinstance(p, dict) else p
                for p in self.pools)
            if not coerced:
                raise ValueError("ClusterSpec.pools must name at least "
                                 "one pool when set (None means a flat "
                                 "cluster)")
            object.__setattr__(self, "pools", coerced)
            if self.disaggregation is not None:
                raise ValueError("pools and disaggregation are mutually "
                                 "exclusive cluster layouts")
            if self.autoscale:
                raise ValueError("fleet pools carry their own min/max_"
                                 "replicas bounds; leave ClusterSpec."
                                 "autoscale off")

    @classmethod
    def from_dict(cls, d) -> "ClusterSpec":
        return cls(**dict(d))


# ---- routers ---------------------------------------------------------------
class Router:
    """Picks a live replica index for each arriving request."""
    name = "base"

    def route(self, request: Request, engines: List[ReplicaEngine],
              now: float) -> int:
        raise NotImplementedError


class RoundRobinRouter(Router):
    """Rotation over stable ``replica_id``s, skip-based.

    Each arrival goes to the lowest live ``replica_id`` greater than the
    previously chosen one (wrapping to the lowest).  The old
    implementation applied a global counter mod the *filtered* ready
    list, so an autoscaler add/retire — or a replica merely finishing
    its cold start — shifted every subsequent assignment and skewed the
    distribution (the same churn bug the affinity router had).  Skipping
    over missing ids keeps the rotation anchored to replica identity:
    membership changes only affect the replicas that actually changed.
    """
    name = "round-robin"

    def __init__(self):
        self._last_id = -1

    def route(self, request, engines, now):
        nxt = wrap = None
        for i, e in enumerate(engines):
            rid = e.replica_id
            if rid > self._last_id and (
                    nxt is None or rid < engines[nxt].replica_id):
                nxt = i
            if wrap is None or rid < engines[wrap].replica_id:
                wrap = i
        idx = nxt if nxt is not None else wrap
        self._last_id = engines[idx].replica_id
        return idx


class LeastLoadedRouter(Router):
    """Join-the-shortest-queue over in-flight work (queued + running)."""
    name = "least-loaded"

    def route(self, request, engines, now):
        # explicit scan (first minimum wins, same tie-break as the old
        # min-with-key) — this runs once per arrival over every live
        # replica, so the continuous-engine load signal (queued +
        # running, exactly ``ReplicaEngine.load``) is inlined rather
        # than paying a method call per engine
        best = 0
        e = engines[0]
        best_load = len(e.queue) + len(e.active) if e.continuous \
            else e.load(now)
        for i in range(1, len(engines)):
            e = engines[i]
            load = len(e.queue) + len(e.active) if e.continuous \
                else e.load(now)
            if load < best_load:
                best, best_load = i, load
        return best


class CostWeightedRouter(Router):
    """Marginal-cost routing for heterogeneous fleets.

    Picks the replica minimizing ``cost_rate × (load + 1)`` — the
    $/hour the next request's marginal share of the replica would cost
    — so work packs onto cheap pools until their backlog makes an
    expensive replica's idle capacity worth paying for.  Ties (and the
    flat-cluster case where every ``cost_rate`` is equal or zero) fall
    back to least-loaded, then lowest ``replica_id``.
    """
    name = "cost-weighted"

    def route(self, request, engines, now):
        best = 0
        e = engines[0]
        best_key = (e.cost_rate * (e.load(now) + 1), e.load(now),
                    e.replica_id)
        for i in range(1, len(engines)):
            e = engines[i]
            load = e.load(now)
            key = (e.cost_rate * (load + 1), load, e.replica_id)
            if key < best_key:
                best, best_key = i, key
        return best


class FastestTTFTRouter(Router):
    """Latency-aware routing for heterogeneous fleets.

    Picks the replica minimizing ``ttft_hint × (load + 1)`` — the
    pool's nominal first-token latency scaled by the queue the request
    would join — so fast hardware absorbs traffic until its backlog
    erases its speed advantage.  Ties (including flat clusters, where
    every hint is equal or zero) fall back to least-loaded, then lowest
    ``replica_id``.
    """
    name = "fastest-ttft"

    def route(self, request, engines, now):
        best = 0
        e = engines[0]
        best_key = (e.ttft_hint * (e.load(now) + 1), e.load(now),
                    e.replica_id)
        for i in range(1, len(engines)):
            e = engines[i]
            load = e.load(now)
            key = (e.ttft_hint * (load + 1), load, e.replica_id)
            if key < best_key:
                best, best_key = i, key
        return best


_MASK64 = (1 << 64) - 1


def _rendezvous_weight(session_id: int, replica_id: int) -> int:
    """Deterministic splitmix64-style mix of (session, replica) — the
    highest-random-weight (rendezvous) hash.  Seed-independent, so runs
    are reproducible across processes."""
    x = (session_id * 0x9E3779B97F4A7C15
         + replica_id * 0xBF58476D1CE4E5B9 + 0x94D049BB133111EB) & _MASK64
    x ^= x >> 30
    x = (x * 0xBF58476D1CE4E5B9) & _MASK64
    x ^= x >> 27
    x = (x * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def _kill_gap(seed: int, slot: int, draw: int, mtbf_s: float) -> float:
    """Exponential spot-reclamation gap, deterministic in
    (seed, slot, draw) — inverse-CDF over a splitmix64 uniform."""
    x = _rendezvous_weight(seed * 1000003 + slot + 1, draw)
    u = (x + 0.5) / float(_MASK64 + 1)      # uniform in (0, 1)
    return -mtbf_s * math.log(u)


class SessionAffinityRouter(Router):
    """Sticky sessions bound to stable ``replica_id``s.

    A session stays on its assigned replica for as long as that replica
    is live; only sessions whose replica was retired are remapped
    (rendezvous hashing over the currently-live set picks the new home).
    The old implementation hashed ``session_id % len(engines)`` over the
    *filtered* ready list, so every autoscaler add/retire — or a replica
    merely cold-starting — remapped every session, destroying stickiness
    and the prefix-cache hit rate.

    Multi-region fleets add one preference: a remapped session stays in
    its recorded home *region* when any replica there is available, so
    a spot kill inside the region doesn't send the session (and its
    prefix-cache locality) across a WAN hop.  Region-less clusters see
    identical behavior (every region label is "").
    """
    name = "affinity"

    def __init__(self):
        self._home: Dict[int, int] = {}     # session_id → replica_id
        self._region: Dict[int, str] = {}   # session_id → home region

    def route(self, request, engines, now):
        sid = request.session_id
        home = self._home.get(sid)
        if home is not None:
            for i, e in enumerate(engines):
                if e.replica_id == home:
                    return i
        cands = range(len(engines))
        region = self._region.get(sid)
        if region:
            # getattr: routers are duck-typed over engine stand-ins
            local = [i for i in cands
                     if getattr(engines[i], "region", "") == region]
            if local:
                cands = local
        idx = max(cands,
                  key=lambda i: _rendezvous_weight(sid,
                                                   engines[i].replica_id))
        self._home[sid] = engines[idx].replica_id
        home_region = getattr(engines[idx], "region", "")
        if home_region:
            self._region[sid] = home_region
        return idx


def make_router(name: str) -> Router:
    if name in ("round-robin", "rr"):
        return RoundRobinRouter()
    if name in ("least-loaded", "jsq", "least_loaded"):
        return LeastLoadedRouter()
    if name in ("affinity", "session", "session-affinity"):
        return SessionAffinityRouter()
    if name in ("cost-weighted", "cost_weighted", "cost"):
        return CostWeightedRouter()
    if name in ("fastest-ttft", "fastest_ttft", "ttft"):
        return FastestTTFTRouter()
    raise ValueError(f"unknown router {name!r}")


# ---- reactive autoscaler ---------------------------------------------------
class Autoscaler:
    """Threshold controller: scale up when mean *queued* (waiting, not
    yet served) requests per replica exceed ``scale_up_load`` — in-flight
    decode slots are healthy capacity use, not backlog — and retire an
    idle replica when mean in-flight work drops below
    ``scale_down_load``.  New replicas pay ``spawn_delay_s`` cold start."""

    def __init__(self, spec: ClusterSpec, policy: BatchPolicy,
                 latency: LatencyModel, make_engine=None):
        self.spec = spec
        self.policy = policy
        self.latency = latency
        # factory so spawned replicas get their own KV-cache manager
        self.make_engine = make_engine or (
            lambda i, spawn_s=0.0, created_s=0.0: ReplicaEngine(
                i, policy, latency, spawn_s=spawn_s, created_s=created_s))

    def step(self, engines: List[ReplicaEngine], now: float) -> None:
        live = [e for e in engines if not e.retired]
        n = len(live)
        queued = sum(len(e.queue) for e in live) / max(n, 1)
        inflight = sum(e.load(now) for e in live) / max(n, 1)
        if queued > self.spec.scale_up_load and n < self.spec.max_replicas:
            engines.append(self.make_engine(
                len(engines), now + self.spec.spawn_delay_s, now))
        elif inflight < self.spec.scale_down_load \
                and n > self.spec.min_replicas:
            for e in reversed(live):
                if e.idle(now):
                    e.retired = True
                    e.retired_s = now   # billing: the replica-second
                    # integral stops here, not at the end of the run
                    break


# ---- per-pool reactive autoscaler ------------------------------------------
class FleetAutoscaler:
    """Per-pool threshold controller for heterogeneous fleets.

    Each pool scales independently between its own ``PoolSpec`` bounds
    using the cluster-wide thresholds — so a spot overflow pool grows
    under backlog while the reserved baseline stays pinned.  Shares the
    flat :class:`Autoscaler`'s signals: mean *queued* per replica to
    add, mean in-flight per replica to retire an idle one.
    """

    def __init__(self, spec: ClusterSpec, pools, bounds, make_engine,
                 pool_of: List[int]):
        self.spec = spec
        self.pools = pools
        self.bounds = bounds            # [(lo, hi)] aligned with pools
        self.make_engine = make_engine  # (pool_idx, rid, spawn_s, created_s)
        self.pool_of = pool_of          # replica_id → pool index (shared
        # with the event loop; appends here keep it aligned with engines)

    def step(self, engines: List[ReplicaEngine], now: float) -> None:
        live: List[List[ReplicaEngine]] = [[] for _ in self.pools]
        for e in engines:
            if not e.retired:
                live[self.pool_of[e.replica_id]].append(e)
        for pi, (lo, hi) in enumerate(self.bounds):
            members = live[pi]
            n = len(members)
            queued = sum(len(e.queue) for e in members) / max(n, 1)
            inflight = sum(e.load(now) for e in members) / max(n, 1)
            if queued > self.spec.scale_up_load and n < hi:
                rid = len(engines)
                engines.append(self.make_engine(
                    pi, rid, now + self.spec.spawn_delay_s, now))
                self.pool_of.append(pi)
            elif inflight < self.spec.scale_down_load and n > lo:
                for e in reversed(members):
                    if e.idle(now):
                        e.retired = True
                        e.retired_s = now
                        break


# ---- memory grounding ------------------------------------------------------
def _resolve_cluster_memory(cluster: ClusterSpec, policy: BatchPolicy,
                            latency, requests: List[Request]
                            ) -> Optional[ResolvedMemory]:
    """Ground the cluster's MemorySpec and validate that the per-replica
    block budget can hold the largest single request — below that there
    is no victim to preempt and the sequence could never run."""
    if cluster.memory is None:
        return None
    resolved = resolve_memory(cluster.memory, latency)
    validate_budget_for_requests(cluster.memory, resolved, requests,
                                 isinstance(policy, ContinuousBatcher))
    return resolved


# ---- cluster event loop ----------------------------------------------------
def simulate_cluster(workload: WorkloadSpec, policy: BatchPolicy,
                     latency: LatencyModel, *,
                     cluster: ClusterSpec = ClusterSpec(),
                     network: NetworkModel = NETWORKS["lan"],
                     trace_sample: float = 1.0) -> SimResult:
    """Drive a cluster of replicas over a workload; returns a SimResult
    whose utilization accounts for the peak replica count and whose
    energy/cost bill the integrated live replica-seconds.

    ``duration_s`` is ``max(workload window, last completion)`` — a sparse
    open-loop workload no longer reports inflated throughput, and overload
    (completions past the window) stretches the denominator instead of
    shrinking it.  Trace replay has no declared window, so its duration is
    the makespan.

    With ``cluster.disaggregation`` set, arrivals land on the prefill
    pool, completions there (= first token) trigger a KV handoff over the
    disaggregation's ``kv_network``, and the decode pool finishes the
    generation with the migrated KV already resident.

    With ``cluster.pools`` set, the fleet is heterogeneous: each
    ``PoolSpec`` contributes replicas on its own hardware/oracle/memory
    budget, billed at its pricing class.  Spot pools are subject to a
    seeded reclamation process (kills requeue in-flight work through
    the recompute machinery and provision a cold replacement); requests
    routed to a pool outside the front door's region (the first pool's)
    pay the ``inter_region_network`` transfer before enqueueing, and
    ``SimResult.fleet`` carries the per-pool bill plus
    ``spot_preemptions`` / ``cross_region_fraction``.

    ``trace_sample`` < 1 keeps full per-request trace recording (stage
    accounting, per-iteration batch sizes) for only that deterministic
    fraction of requests and drops the rest from ``SimResult.traces``.
    Counting aggregates — throughput, duration, utilization, cost, the
    memory/pool dicts and ``requests_served`` — remain exact over *all*
    requests; percentile metrics are computed over the sample.  Use it
    for aggregate-only sweeps at production scale.
    """
    disagg = cluster.disaggregation
    if disagg is not None and not isinstance(policy, ContinuousBatcher):
        raise ValueError(
            "disaggregated serving needs the continuous batcher "
            f"(got {policy.name!r}): request-level policies have no "
            "decode loop to migrate into")
    fleet = cluster.pools
    pool_names: List[str] = []
    if fleet is not None:
        if any(p.preempt_mtbf_s > 0 for p in fleet) \
                and not isinstance(policy, ContinuousBatcher):
            raise ValueError(
                "spot preemption requeues in-flight decode work through "
                "the continuous engine's recompute machinery (got "
                f"{policy.name!r}); use a continuous policy or set "
                "preempt_mtbf_s=0")
        pool_names = [p.name or f"pool{i}" for i, p in enumerate(fleet)]
        if len(set(pool_names)) != len(pool_names):
            raise ValueError(f"duplicate pool names in fleet: "
                             f"{pool_names}")
    if not 0.0 < trace_sample <= 1.0:
        raise ValueError(f"trace_sample must be in (0, 1], got "
                         f"{trace_sample}")
    sampling = trace_sample < 1.0
    # deterministic per-request coin flip (splitmix64 of req_id): the
    # same requests are sampled across runs and processes
    sample_cut = int(trace_sample * float(_MASK64 + 1))
    requests = generate(workload)
    closed_loop = workload.kind == CLOSED
    traces: Dict[int, RequestTrace] = {}
    arrivals: List[Tuple[float, int, Request]] = []   # (server_arrival, id, r)

    def admit(r: Request) -> None:
        tr = RequestTrace(request=r, t_preprocess=PRE_PROCESS_S,
                          t_transmit=network.transmit(r.payload_bytes))
        if sampling:
            tr.detail = _rendezvous_weight(r.req_id, 0x7ACE) < sample_cut
        traces[r.req_id] = tr
        heapq.heappush(arrivals,
                       (r.arrival_s + tr.t_preprocess + tr.t_transmit,
                        r.req_id, r))

    for r in requests:
        admit(r)
    next_id = len(requests)

    pool_oracles: List = []
    pool_mem: List[Tuple[Optional[MemorySpec], Optional[ResolvedMemory]]] \
        = []
    if fleet is not None:
        resolved = None
        continuous = isinstance(policy, ContinuousBatcher)
        lens = []
        for p in fleet:
            if p.profile is not None:
                oracle_p = FittedLatencyModel.from_profile(p.profile)
            else:
                oracle_p = oracle_for_hardware(latency, p.hardware,
                                               p.chips)
            pool_oracles.append(oracle_p)
            mspec = p.memory if p.memory is not None else cluster.memory
            res_p = None
            if mspec is not None:
                # each pool's budget grounds against its *own* oracle
                # (HBM, KV bytes/token), and every pool must hold the
                # workload's worst request — any request can route there
                res_p = resolve_memory(mspec, oracle_p)
                validate_budget_for_requests(mspec, res_p, requests,
                                             continuous)
                lens.append(res_p.max_model_len)
            else:
                ml = getattr(getattr(oracle_p, "cfg", None),
                             "max_seq_len", 0)
                if ml:
                    lens.append(ml)
            pool_mem.append((mspec, res_p))
        # spot requeue can move a sequence between pools mid-flight, so
        # decode is clamped by the tightest pool's context limit
        max_len = min(lens) if lens else 0
    else:
        resolved = _resolve_cluster_memory(cluster, policy, latency,
                                           requests)
        # decode is bounded by the model's context limit even when
        # memory is unmodeled — otherwise output_tokens_max=None
        # workloads run their 32k-token sentinel far past max_seq_len
        max_len = resolved.max_model_len if resolved is not None \
            else getattr(getattr(latency, "cfg", None), "max_seq_len", 0)
    if max_len:
        over = next((r for r in requests if r.prompt_tokens >= max_len),
                    None)
        if over is not None:
            # clamped_output_tokens would otherwise floor the budget at 1
            # and decode a token past the context limit
            raise ValueError(
                f"request {over.req_id}: prompt of {over.prompt_tokens} "
                f"tokens is at/over the model context limit "
                f"(max_model_len={max_len}) — no output token fits; "
                "shrink the workload's prompts or raise the context "
                "limit")

    def _kv():
        return KVCacheManager(cluster.memory, resolved) \
            if resolved is not None else None

    # observability (opt-in): counters/gauges + engine activity spans.
    # rec is None on the default path — every hook below is behind a
    # single None-check, keeping the fast path's event rate intact.
    rec: Optional[MetricsRecorder] = None
    if cluster.obs is not None and cluster.obs.enabled:
        window0 = 0.0 if workload.kind == TRACE else workload.duration_s
        rec = MetricsRecorder(cluster.obs,
                              cluster.obs.resolve_interval(window0))
    rec_ticks = rec if rec is not None and cluster.obs.timeseries else None
    # local mirror of rec_ticks.next_tick so the event loop pays one
    # float compare per pass, not an attribute walk (inf when sampling
    # is off)
    obs_next_tick = (rec_ticks.next_tick if rec_ticks is not None
                     else float("inf"))

    def make_engine(i: int, spawn_s: float = 0.0,
                    created_s: float = 0.0) -> ReplicaEngine:
        if rec is not None:
            rec.register_engine(i, "serve")
        return ReplicaEngine(i, policy, latency, spawn_s=spawn_s,
                             kv=_kv(), max_model_len=max_len,
                             created_s=created_s, obs=rec)

    pool_of: List[int] = []         # replica_id → pool index
    pool_rates: List[float] = []    # $/chip-hour at the pool's pricing
    pool_chips: List[int] = []
    if fleet is not None:
        for pi, p in enumerate(fleet):
            oracle_p = pool_oracles[pi]
            pool_rates.append(hw_lib.cloud_rate_usd_per_hour(
                oracle_p.hw.name, pricing=p.pricing))
            pool_chips.append(getattr(oracle_p, "chips", 1) or 1)

    def make_fleet_engine(pi: int, rid: int, spawn_s: float = 0.0,
                          created_s: float = 0.0) -> ReplicaEngine:
        p = fleet[pi]
        oracle_p = pool_oracles[pi]
        mspec, res_p = pool_mem[pi]
        if rec is not None:
            rec.register_engine(rid, pool_names[pi])
        e = ReplicaEngine(
            rid, policy, oracle_p, spawn_s=spawn_s,
            kv=KVCacheManager(mspec, res_p) if res_p is not None
            else None,
            max_model_len=max_len, created_s=created_s, obs=rec)
        e.pool_name = pool_names[pi]
        e.region = p.region
        e.cost_rate = pool_rates[pi] * pool_chips[pi]
        # nominal single-stream first-token time on this hardware — the
        # fastest-ttft router's capability signal (memoized per oracle)
        e.ttft_hint = oracle_p.prefill_latency(1, 256) \
            + oracle_p.decode_latency(1, 257)
        return e

    migrations: List[Tuple[float, int, Request]] = []  # (kv_ready, id, r)
    prefill_engines: List[ReplicaEngine] = []
    decode_engines: List[ReplicaEngine] = []
    decode_router = kv_net = None
    kv_bpt = 0.0
    if disagg is not None:
        prefill_policy = ContinuousBatcher(
            max_batch=disagg.prefill_max_batch,
            max_prefill=disagg.prefill_max_batch)
        decode_policy = policy if disagg.decode_max_batch <= 0 else \
            dataclasses.replace(policy, max_batch=disagg.decode_max_batch)
        prefill_engines = [
            ReplicaEngine(i, prefill_policy, latency, kv=_kv(),
                          max_model_len=max_len, role="prefill",
                          chunk_tokens=disagg.prefill_chunk_tokens,
                          obs=rec)
            for i in range(disagg.prefill_replicas)]
        decode_engines = [
            ReplicaEngine(disagg.prefill_replicas + i, decode_policy,
                          latency, kv=_kv(), max_model_len=max_len,
                          role="decode", obs=rec)
            for i in range(disagg.decode_replicas)]
        if rec is not None:
            for e in prefill_engines:
                rec.register_engine(e.replica_id, "prefill")
            for e in decode_engines:
                rec.register_engine(e.replica_id, "decode")
        engines = prefill_engines + decode_engines
        router = make_router(disagg.prefill_router)
        decode_router = make_router(disagg.decode_router)
        kv_net = NETWORKS[disagg.kv_network]
        kv_bpt = disagg.kv_bytes_per_token
        if kv_bpt <= 0 and resolved is not None:
            kv_bpt = resolved.kv_bytes_per_token
        if kv_bpt <= 0:
            kv_bpt = oracle_kv_bytes_per_token(latency)
    elif fleet is not None:
        engines = []
        for pi, p in enumerate(fleet):
            for _ in range(p.replicas):
                engines.append(make_fleet_engine(pi, len(engines)))
                pool_of.append(pi)
        router = make_router(cluster.router)
    else:
        engines = [make_engine(i) for i in range(max(cluster.replicas, 1))]
        router = make_router(cluster.router)
    if fleet is not None:
        fbounds = [p.bounds() for p in fleet]
        scaler = FleetAutoscaler(cluster, fleet, fbounds,
                                 make_fleet_engine, pool_of) \
            if any(lo != hi for lo, hi in fbounds) else None
    else:
        scaler = Autoscaler(cluster, policy, latency, make_engine) \
            if cluster.autoscale else None
    next_scale = cluster.scale_interval_s
    peak = len(engines)

    # spot reclamation: one slot per initial spot replica, exponential
    # inter-kill gaps from a counter-keyed splitmix stream — the same
    # preempt_seed reproduces the same kill schedule in any process
    kills: List[Tuple[float, int]] = []
    slot_engine: List[int] = []     # slot → current replica_id
    slot_pool: List[int] = []
    slot_draws: List[int] = []
    n_kills = 0
    # inter-region forwarding: a WAN-routed request reaches its target
    # engine only after the transfer (seq breaks heap ties)
    forwards: List[Tuple[float, int, int, QueuedRequest]] = []
    fwd_seq = 0
    cross_arrivals = routed_arrivals = 0
    home_region = fleet[0].region if fleet is not None else ""
    if fleet is not None:
        for rid, pi in enumerate(pool_of):
            p = fleet[pi]
            if p.pricing == "spot" and p.preempt_mtbf_s > 0:
                slot = len(slot_engine)
                slot_engine.append(rid)
                slot_pool.append(pi)
                slot_draws.append(1)
                heapq.heappush(kills, (_kill_gap(
                    cluster.preempt_seed, slot, 0, p.preempt_mtbf_s),
                    slot))

    # ---- indexed event scheduler -----------------------------------------
    # Per-engine next-event times live in a lazy-deletion heap instead of
    # being rescanned across all replicas on every pass: entries are
    # (t, engine_idx, version) and an entry is live iff its version
    # matches the engine's current one (``evers``) — every reschedule
    # bumps the version, staling out old entries in O(1).  Only engines
    # whose entry is due at ``now`` act; an engine's next-event time can
    # only change when its own state changes (an enqueue or its own act),
    # so everything else is provably a no-op and is skipped.  Engine list
    # position == replica_id (the autoscaler appends with len(engines)),
    # which lets routed targets be rescheduled by id.
    eheap: List[Tuple[float, int, int]] = []
    evers: List[int] = [0] * len(engines)

    def schedule(i: int, t_now: float) -> None:
        evers[i] += 1
        t = engines[i].next_action_s(t_now)
        if t is not None:
            heapq.heappush(eheap, (t, i, evers[i]))

    route_pool = prefill_engines if disagg is not None else engines

    def live_engines() -> List[ReplicaEngine]:
        return [e for e in route_pool if not e.retired]

    for i in range(len(engines)):
        schedule(i, 0.0)
    # the live routing set only changes on autoscaler steps — maintain it
    # across passes instead of refiltering per arrival
    live = live_engines()
    events = 0
    now = 0.0
    inf = float("inf")
    while True:
        while eheap and eheap[0][2] != evers[eheap[0][1]]:
            heapq.heappop(eheap)            # stale (rescheduled) entries
        t_next = arrivals[0][0] if arrivals else inf
        if migrations and migrations[0][0] < t_next:
            t_next = migrations[0][0]
        if forwards and forwards[0][0] < t_next:
            t_next = forwards[0][0]
        if eheap and eheap[0][0] < t_next:
            t_next = eheap[0][0]
        if t_next == inf:
            break
        if scaler is not None and next_scale < t_next:
            t_next = next_scale     # only re-evaluate while work remains
        if kills and kills[0][0] < t_next:
            t_next = kills[0][0]    # reclamations fire only while work
            # remains — an idle fleet past the last completion has
            # nothing observable to lose
        if obs_next_tick < t_next - EPS:
            # state is constant between events: every tick in the open
            # interval (now, t_next) samples it exactly
            rec_ticks.sample_ticks(t_next, engines)
            obs_next_tick = rec_ticks.next_tick
        if t_next > now:
            now = t_next

        # spot reclamations run before arrivals so this pass's routing
        # already sees the post-kill fleet
        if kills and kills[0][0] <= now + EPS:
            touched_k = set()
            while kills and kills[0][0] <= now + EPS:
                _, slot = heapq.heappop(kills)
                pi = slot_pool[slot]
                p = fleet[pi]
                victim = engines[slot_engine[slot]]
                if not victim.retired:
                    events += 1
                    n_kills += 1
                    work = victim.spot_kill(now, traces)
                    evers[victim.replica_id] += 1   # stale its entries
                    # a cold replacement takes over the slot
                    rid2 = len(engines)
                    engines.append(make_fleet_engine(
                        pi, rid2, now + cluster.spawn_delay_s, now))
                    pool_of.append(pi)
                    evers.append(0)
                    slot_engine[slot] = rid2
                    touched_k.add(rid2)
                    live = live_engines()
                    warm = [e for e in live
                            if e.spawn_s <= now + EPS] or live
                    for q in work:
                        e2 = warm[router.route(q.request, warm, now)]
                        xnet = inter_region_network(victim.region,
                                                    e2.region)
                        if xnet is not None:
                            xfer = xnet.transmit(q.request.payload_bytes)
                            traces[q.request.req_id].t_transmit += xfer
                            q.enqueue_s = max(q.enqueue_s, now + xfer)
                            fwd_seq += 1
                            heapq.heappush(forwards,
                                           (now + xfer, fwd_seq,
                                            e2.replica_id, q))
                        else:
                            e2.enqueue(q)
                            touched_k.add(e2.replica_id)
                # the slot's next reclamation clocks from when its
                # replacement comes up, whether or not this kill landed
                k = slot_draws[slot]
                slot_draws[slot] += 1
                heapq.heappush(kills, (
                    now + cluster.spawn_delay_s + _kill_gap(
                        cluster.preempt_seed, slot, k,
                        p.preempt_mtbf_s),
                    slot))
            for i in touched_k:
                schedule(i, now)

        if arrivals and arrivals[0][0] <= now + EPS:
            # prefer replicas already past cold start; a still-spawning
            # replica only takes traffic if no warm replica exists
            # (retired/spawn states are fixed within a pass, so the ready
            # set is computed once per drain)
            ready = [e for e in live if e.spawn_s <= now + EPS] or live
            touched = set()
            while arrivals and arrivals[0][0] <= now + EPS:
                t_arr, _, r = heapq.heappop(arrivals)
                events += 1
                if rec is not None:
                    rec.count_arrival(r.tenant)
                e = ready[router.route(r, ready, now)]
                if fleet is not None:
                    routed_arrivals += 1
                    xnet = inter_region_network(home_region, e.region)
                    if xnet is not None:
                        # WAN hop: the request reaches its target pool
                        # after the inter-region transfer
                        cross_arrivals += 1
                        xfer = xnet.transmit(r.payload_bytes)
                        traces[r.req_id].t_transmit += xfer
                        fwd_seq += 1
                        heapq.heappush(
                            forwards,
                            (t_arr + xfer, fwd_seq, e.replica_id,
                             QueuedRequest(request=r,
                                           enqueue_s=t_arr + xfer)))
                        continue
                e.enqueue(QueuedRequest(request=r, enqueue_s=t_arr))
                touched.add(e.replica_id)
            for i in touched:
                schedule(i, now)

        # cross-region deliveries whose transfer finished join their
        # target; a target reclaimed mid-flight gets rerouted locally
        while forwards and forwards[0][0] <= now + EPS:
            _, _, rid, q = heapq.heappop(forwards)
            events += 1
            e = engines[rid]
            if e.retired:
                cands = [x for x in live
                         if x.spawn_s <= now + EPS] or live
                e = cands[router.route(q.request, cands, now)]
            e.enqueue(q)
            schedule(e.replica_id, now)

        # KV handoffs whose transfer finished join the decode pool with
        # their cache already resident (first token was already emitted)
        while migrations and migrations[0][0] <= now + EPS:
            t_ready, _, r = heapq.heappop(migrations)
            events += 1
            out = clamped_output_tokens(r, max_len)
            e = decode_engines[decode_router.route(r, decode_engines, now)]
            e.enqueue(QueuedRequest(request=r, enqueue_s=t_ready,
                                    remaining=out - 1, migrated=True))
            schedule(e.replica_id, now)

        if scaler is not None and now + EPS >= next_scale:
            n_before = len(engines)
            scaler.step(engines, now)
            peak = max(peak, sum(1 for e in engines if not e.retired))
            while next_scale <= now + EPS:
                next_scale += cluster.scale_interval_s
            for i in range(n_before, len(engines)):
                evers.append(0)
                schedule(i, now)    # spawned replica enters the heap
            live = live_engines()   # membership changed (add/retire)

        due = []
        while eheap and eheap[0][0] <= now + EPS:
            t, i, ver = heapq.heappop(eheap)
            if ver == evers[i]:
                due.append(i)
        due.sort()                  # act in replica order (determinism)
        for i in due:
            e = engines[i]
            events += 1
            for done_s, r in e.act(now, traces):
                if e.role == "prefill" \
                        and clamped_output_tokens(r, max_len) > 1:
                    # first token out — clock the KV handoff and hand the
                    # request to the decode pool (single-token requests
                    # are complete after prefill and never migrate)
                    tr = traces[r.req_id]
                    transfer = kv_net.transmit(kv_bpt * r.prompt_tokens)
                    tr.t_kv_transfer = transfer
                    tr.done_s = 0.0     # decode owns final completion
                    heapq.heappush(migrations,
                                   (done_s + transfer, r.req_id, r))
                    continue
                if rec is not None:
                    rec.count_completion(r.tenant)
                if closed_loop and done_s < workload.duration_s:
                    # the client observes the response and issues its next
                    # request, keeping its loop at concurrency 1
                    admit(dataclasses.replace(r, req_id=next_id,
                                              arrival_s=done_s))
                    next_id += 1
            schedule(i, now)

    done = [t for t in traces.values() if t.done_s > 0]
    served = len(done)
    last_done = max((t.done_s for t in done), default=0.0)
    if sampling:
        done = [t for t in done if t.detail]
    window = 0.0 if workload.kind == TRACE else workload.duration_s
    duration = max(window, last_done)
    # live replica-seconds (spawn→retire spans): what energy/cost bill —
    # an autoscaled cluster no longer pays its peak count for the full run
    replica_seconds = sum(
        max((e.retired_s if e.retired_s is not None else duration)
            - e.created_s, 0.0)
        for e in engines)
    pools = None
    if disagg is not None:
        transfers = [t.t_kv_transfer for t in done if t.t_kv_transfer > 0]
        pools = {
            "prefill_replicas": disagg.prefill_replicas,
            "decode_replicas": disagg.decode_replicas,
            "prefill_busy_s": sum(e.busy_s for e in prefill_engines),
            "decode_busy_s": sum(e.busy_s for e in decode_engines),
            "kv_network": disagg.kv_network,
            "kv_bytes_per_token": kv_bpt,
            "migrated_requests": len(transfers),
            "mean_kv_transfer_s": (sum(transfers) / len(transfers)
                                   if transfers else 0.0),
        }
    fleet_info = None
    if fleet is not None:
        pools_out = []
        for pi, p in enumerate(fleet):
            members = [e for e in engines if pool_of[e.replica_id] == pi]
            rs = sum(
                max((e.retired_s if e.retired_s is not None else duration)
                    - e.created_s, 0.0)
                for e in members)
            hw_name = pool_oracles[pi].hw.name
            d = {
                "name": pool_names[pi],
                "hardware": hw_name,
                "region": p.region,
                "pricing": p.pricing,
                "chips": pool_chips[pi],
                "replicas": len(members),
                "replica_seconds": rs,
                "busy_s": sum(e.busy_s for e in members),
                # integrated replica-seconds billed at the pool's class
                # (spot capacity pays spot rates — that's the bargain
                # the reclamation process prices in)
                "cost_usd": hw_lib.cloud_cost_usd(
                    hw_name, rs, pricing=p.pricing) * pool_chips[pi],
            }
            if pool_mem[pi][1] is not None:
                stats = [e.kv.stats(duration) for e in members]
                d["kv_preemptions"] = sum(s["preemptions"]
                                          for s in stats)
                d["peak_occupancy"] = max(s["peak_occupancy"]
                                          for s in stats)
            pools_out.append(d)
        fleet_info = {
            "pools": pools_out,
            "spot_preemptions": n_kills,
            "spot_killed_requests": sum(
                1 for t in traces.values() if t.spot_evictions > 0),
            "cross_region_fraction": cross_arrivals / routed_arrivals
            if routed_arrivals else 0.0,
            "routed_requests": routed_arrivals,
        }
    memory = None
    if resolved is not None:
        per = [e.kv.stats(duration) for e in engines]
        hits = sum(p["prefix_hit_tokens"] for p in per)
        served_tokens = sum(e.kv.hit_tokens + e.kv.miss_tokens
                            for e in engines)
        memory = {
            "block_tokens": cluster.memory.block_tokens,
            "total_blocks_per_replica": resolved.total_blocks,
            "budget_bytes_per_replica": resolved.budget_bytes,
            "kv_bytes_per_token": resolved.kv_bytes_per_token,
            "max_model_len": resolved.max_model_len,
            "peak_blocks": max(p["peak_blocks"] for p in per),
            "peak_occupancy": max(p["peak_occupancy"] for p in per),
            "mean_occupancy": (sum(p["mean_occupancy"] for p in per)
                               / len(per)),
            "prefix_hit_tokens": hits,
            "prefix_hit_rate": hits / served_tokens if served_tokens
            else 0.0,
            "preemptions": sum(p["preemptions"] for p in per),
            "evictions": sum(p["evictions"] for p in per),
            "per_replica": per,
        }
    timeseries = engine_spans = None
    if rec is not None:
        if rec_ticks is not None:
            rec.finish(duration, engines)
            timeseries = rec.build()
        if cluster.obs.timeline:
            engine_spans = rec.spans
    return SimResult(
        traces=done,
        busy_s=sum(e.busy_s for e in engines),
        duration_s=duration,
        hw=latency.hw,
        chips=latency.chips,
        replicas=peak,
        router="disaggregated" if disagg is not None else cluster.router,
        per_replica_busy_s=[e.busy_s for e in engines],
        memory=memory,
        replica_seconds=replica_seconds,
        pools=pools,
        fleet=fleet_info,
        requests_served=served,
        events=events,
        timeseries=timeseries,
        engine_spans=engine_spans)
