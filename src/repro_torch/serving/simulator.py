"""Discrete-event simulator of the full inference pipeline (paper Fig. 4):

  client → pre-process → transmission → route → queue/batch → inference → post.

The unit of execution is a ``ReplicaEngine`` — one server timeline that
interprets either a request-level batching policy (NoBatching / Window /
Preferred: whole batches occupy the server) or a ``ContinuousBatcher``
(Orca/vLLM-style: decode slots free per iteration, waiting requests join
the running batch at iteration boundaries, clocked by the LatencyModel's
prefill/decode split).  ``simulate`` runs one replica; a ``Cluster`` of
replicas behind a router/autoscaler lives in ``repro_torch.serving.cluster``
and drives the same engines from a shared indexed event loop.

A copy of ``repro.serving.simulator``, importing only ``repro_torch``.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch import hw as hw_lib
from repro_torch.serving.batching import (BatchPolicy, ContinuousBatcher,
                                    QueuedRequest)
from repro_torch.serving.latency_model import (LatencyModel, NetworkModel,
                                         NETWORKS)
from repro_torch.serving.memory import KVCacheManager
from repro_torch.serving.workload import Request, WorkloadSpec

PRE_PROCESS_S = 0.0015     # resize + tensorize, per request
POST_PROCESS_S = 0.0004    # label lookup / detokenize, per request
EPS = 1e-12


@dataclasses.dataclass(slots=True)
class RequestTrace:
    request: Request
    t_preprocess: float = 0.0
    t_transmit: float = 0.0
    t_queue: float = 0.0       # enqueue → service start (total wait)
    t_batch_wait: float = 0.0  # the policy-attributable slice of t_queue:
                               # time waited while capacity (slots *and*
                               # KV memory) was free but the batch had not
                               # fired / the iteration boundary had not
                               # been reached.  Waits caused by a full KV
                               # cache are memory pressure, not policy,
                               # and are excluded
    t_inference: float = 0.0
    t_postprocess: float = 0.0
    t_kv_transfer: float = 0.0      # disaggregated serving: prefill→decode
                                    # KV-cache handoff over the interconnect
    batch_size: int = 1
    replica: int = 0
    done_s: float = 0.0
    first_token_s: float = 0.0      # absolute sim time of the first token
                                    # (end of prefill); 0 = none emitted
    tokens_out: int = 0             # tokens actually generated (post-clamp)
    preemptions: int = 0            # KV-pressure evict/recompute cycles
    spot_evictions: int = 0         # times a spot reclamation killed this
                                    # request's replica mid-decode (subset
                                    # of preemptions; recompute on rejoin)
    cached_prompt_tokens: int = 0   # prompt tokens served from prefix cache
    detail: bool = True             # False → unsampled (trace_sample < 1):
                                    # engines skip per-iteration stage
                                    # bookkeeping and the trace is dropped
                                    # from the result's per-request view

    @property
    def e2e(self) -> float:
        # t_batch_wait is a sub-component of t_queue, not an extra stage
        return (self.t_preprocess + self.t_transmit + self.t_queue
                + self.t_kv_transfer + self.t_inference + self.t_postprocess)

    # ---- phase latencies (the TTFT/TPOT language of LLM SLOs) ------------
    @property
    def t_first_token(self) -> float:
        """TTFT: request arrival → first generated token (0 if none)."""
        if self.first_token_s <= 0.0:
            return 0.0
        return self.first_token_s - self.request.arrival_s

    @property
    def tpot(self) -> float:
        """Mean time per output token after the first (0 when ≤ 1 token).
        Preemption stalls and KV-transfer gaps between tokens count — the
        client experiences them as inter-token latency."""
        if self.tokens_out <= 1 or self.first_token_s <= 0.0:
            return 0.0
        last = self.done_s - self.t_postprocess
        return max(last - self.first_token_s, 0.0) / (self.tokens_out - 1)


@dataclasses.dataclass
class SimResult:
    traces: List[RequestTrace]
    busy_s: float
    duration_s: float
    hw: hw_lib.HardwareModel
    chips: int
    replicas: int = 1                   # peak live replica count
    router: str = "single"
    per_replica_busy_s: Optional[List[float]] = None
    memory: Optional[Dict[str, object]] = None   # KV-cache accounting
                                        # (None when memory is unmodeled)
    replica_seconds: float = 0.0        # ∫ live replicas dt over the run
                                        # (0 → bill replicas × duration)
    pools: Optional[Dict[str, object]] = None    # disaggregated prefill/
                                        # decode pool provenance (None when
                                        # colocated)
    fleet: Optional[Dict[str, object]] = None    # heterogeneous-pool
                                        # provenance (ClusterSpec.pools):
                                        # per-pool hardware/pricing/region
                                        # splits, spot preemptions, cross-
                                        # region routing (None for flat
                                        # identical-replica clusters)
    requests_served: int = 0            # completions including unsampled
                                        # traces (0 → len(traces): full
                                        # recording, the default)
    events: int = 0                     # event-loop work units processed
                                        # (engine acts + arrival/migration
                                        # pops) — bench_simulator.py's
                                        # sim-events/sec numerator
    timeseries: Optional[object] = None  # repro_torch.obs Timeseries (only when
                                        # the run carried an ObsSpec with
                                        # timeseries=True)
    engine_spans: Optional[List] = None  # repro_torch.obs EngineSpan activity
                                        # (ObsSpec.timeline runs; feeds
                                        # the Chrome-trace export)
    # percentile/mean metrics re-materialized these arrays on every call
    # (summary() alone did so ~10×); memoize per result.  init=False so
    # dataclasses.replace()-based slicing (tenant_result) starts cold.
    _cache: Dict[str, np.ndarray] = dataclasses.field(
        default_factory=dict, init=False, repr=False, compare=False)

    # ---- aggregate metrics (the paper's metric collector) ----------------
    def _served(self) -> int:
        return self.requests_served or len(self.traces)

    def _sample_scale(self) -> float:
        """Served-to-recorded ratio: scales counts derived from the
        sampled traces back to the full population (1.0 when every
        trace was recorded)."""
        if self.requests_served and self.traces \
                and self.requests_served != len(self.traces):
            return self.requests_served / len(self.traces)
        return 1.0

    def latencies(self) -> np.ndarray:
        a = self._cache.get("latencies")
        if a is None:
            a = np.array([t.e2e for t in self.traces])
            self._cache["latencies"] = a
        return a

    def percentile(self, p: float) -> float:
        lat = self.latencies()
        return float(np.percentile(lat, p)) if len(lat) else 0.0

    def throughput(self) -> float:
        return self._served() / self.duration_s if self.duration_s else 0.0

    def utilization(self) -> float:
        denom = self.duration_s * max(self.replicas, 1)
        return self.busy_s / denom if denom else 0.0

    def slo_attainment(self, slo_latency_s: float) -> float:
        """Fraction of served requests whose e2e latency met the SLO."""
        from repro_torch.core.analysis import slo_attainment
        return slo_attainment(self.latencies(), slo_latency_s)

    # ---- phase metrics (TTFT / TPOT / goodput) ---------------------------
    def ttfts(self) -> np.ndarray:
        """Time-to-first-token of every request that emitted one."""
        a = self._cache.get("ttfts")
        if a is None:
            a = np.array([t.t_first_token for t in self.traces
                          if t.first_token_s > 0.0])
            self._cache["ttfts"] = a
        return a

    def tpots(self) -> np.ndarray:
        """Per-token decode time of every request with ≥ 2 tokens
        (single-token requests have no defined inter-token latency)."""
        a = self._cache.get("tpots")
        if a is None:
            a = np.array([t.tpot for t in self.traces if t.tokens_out > 1])
            self._cache["tpots"] = a
        return a

    def ttft(self, p: float = 50.0) -> float:
        """TTFT percentile (median by default)."""
        v = self.ttfts()
        return float(np.percentile(v, p)) if len(v) else 0.0

    def tpot(self, p: float = 50.0) -> float:
        """TPOT percentile (median by default)."""
        v = self.tpots()
        return float(np.percentile(v, p)) if len(v) else 0.0

    def _meets_phase_slos(self, t: RequestTrace,
                          ttft_slo_s: Optional[float],
                          tpot_slo_s: Optional[float],
                          e2e_slo_s: Optional[float]) -> bool:
        if ttft_slo_s is not None and t.t_first_token > ttft_slo_s:
            return False
        # single-token requests trivially meet any TPOT SLO (no decode)
        if tpot_slo_s is not None and t.tokens_out > 1 \
                and t.tpot > tpot_slo_s:
            return False
        if e2e_slo_s is not None and t.e2e > e2e_slo_s:
            return False
        return True

    def goodput(self, ttft_slo_s: Optional[float] = None,
                tpot_slo_s: Optional[float] = None,
                e2e_slo_s: Optional[float] = None) -> float:
        """Requests/s meeting *every* provided SLO (TTFT and TPOT and,
        optionally, e2e) — the rate real LLM deployments are judged by.
        Under trace sampling the recorded traces' attainment rate is
        extrapolated to the full served count."""
        if not self.duration_s:
            return 0.0
        n = sum(self._meets_phase_slos(t, ttft_slo_s, tpot_slo_s, e2e_slo_s)
                for t in self.traces)
        return n * self._sample_scale() / self.duration_s

    def phase_slo_attainment(self, ttft_slo_s: Optional[float] = None,
                             tpot_slo_s: Optional[float] = None,
                             e2e_slo_s: Optional[float] = None) -> float:
        """Fraction of served requests meeting every provided SLO."""
        if not self.traces:
            return 0.0
        n = sum(self._meets_phase_slos(t, ttft_slo_s, tpot_slo_s, e2e_slo_s)
                for t in self.traces)
        return n / len(self.traces)

    def preemption_goodput_loss(self, ttft_slo_s: Optional[float] = None,
                                tpot_slo_s: Optional[float] = None,
                                e2e_slo_s: Optional[float] = None) -> float:
        """Goodput (req/s) lost to spot preemption under the given SLOs.

        Counterfactuals are unobservable, so the loss is estimated as the
        *excess* SLO-miss rate among preemption-affected requests (those
        whose replica was spot-killed mid-decode at least once) over the
        unaffected baseline, scaled by the affected arrival rate.  0.0
        when no request was spot-killed — including every reserved-only
        or flat cluster.
        """
        if not self.duration_s or not self.traces:
            return 0.0
        affected = [t for t in self.traces if t.spot_evictions > 0]
        if not affected:
            return 0.0
        clean = [t for t in self.traces if t.spot_evictions == 0]

        def miss_rate(ts):
            if not ts:
                return 0.0
            n = sum(not self._meets_phase_slos(t, ttft_slo_s, tpot_slo_s,
                                               e2e_slo_s) for t in ts)
            return n / len(ts)

        excess = max(miss_rate(affected) - miss_rate(clean), 0.0)
        return excess * len(affected) * self._sample_scale() \
            / self.duration_s

    def cdf(self, points: int = 50):
        lat = np.sort(self.latencies())
        if not len(lat):
            return [], []
        qs = np.linspace(0, 1, points)
        return list(np.quantile(lat, qs)), list(qs)

    # ---- per-tenant slicing (multi-tenant workloads) ---------------------
    def tenants(self) -> List[str]:
        """Tenant names present in the served traces (multi-tenant
        workloads tag every request; [] for single-tenant runs)."""
        return sorted({t.request.tenant for t in self.traces
                       if t.request.tenant})

    def tenant_result(self, name: str) -> "SimResult":
        """This result restricted to one tenant's requests.

        Latency/TTFT/TPOT/goodput metrics of the slice are exact;
        cluster-wide provenance (busy_s, memory, pools) stays aggregate,
        and cost/energy still bill the whole cluster — tenants share the
        fleet, so per-tenant dollars need an attribution policy, not a
        slice.  Use :func:`repro_torch.scenarios.tenants.tenant_report` for
        the fairness/isolation view across all tenants.
        """
        sub = [t for t in self.traces if t.request.tenant == name]
        # the slice serves exactly its recorded traces (sampling scale
        # does not survive slicing: per-tenant served counts are unknown)
        return dataclasses.replace(self, traces=sub, requests_served=0)

    def billed_replica_seconds(self) -> float:
        """Replica-seconds energy/cost are billed over: the integrated
        live-replica span when the event loop measured it, else the static
        ``replicas × duration`` (identical for fixed-size clusters).  An
        autoscaled cluster is no longer charged its *peak* replica count
        for the whole run."""
        if self.replica_seconds > 0.0:
            return self.replica_seconds
        return self.duration_s * max(self.replicas, 1)

    def energy_joules(self) -> float:
        if self.fleet is not None:
            # heterogeneous pools: each pool's chips draw their own TDP
            # over that pool's live span at that pool's utilization
            total = 0.0
            for p in self.fleet["pools"]:
                rs = p["replica_seconds"]
                util = min(p["busy_s"] / rs, 1.0) if rs else 0.0
                total += hw_lib.energy_joules(
                    hw_lib.HARDWARE[p["hardware"]], rs, util) * p["chips"]
            return total
        rs = self.billed_replica_seconds()
        util = min(self.busy_s / rs, 1.0) if rs else 0.0
        return hw_lib.energy_joules(self.hw, rs, util) * self.chips

    def co2_kg(self) -> float:
        return hw_lib.co2_kg(self.energy_joules())

    def cost_usd(self) -> float:
        if self.fleet is not None:
            # per-pool bill: each pool's integrated replica-seconds at
            # its own hardware's rate and pricing class (spot pools are
            # billed spot rates only up to each replica's kill time)
            return sum(p["cost_usd"] for p in self.fleet["pools"])
        return hw_lib.cloud_cost_usd(self.hw.name,
                                     self.billed_replica_seconds()) \
            * self.chips

    def cost_per_1k_requests(self) -> float:
        n = self._served()
        return self.cost_usd() / n * 1000 if n else 0.0

    def stage_means(self) -> Dict[str, float]:
        if not self.traces:
            return {}
        return {
            "preprocess": float(np.mean([t.t_preprocess for t in self.traces])),
            "transmit": float(np.mean([t.t_transmit for t in self.traces])),
            "queue": float(np.mean([t.t_queue for t in self.traces])),
            "batch_wait": float(np.mean([t.t_batch_wait
                                         for t in self.traces])),
            "kv_transfer": float(np.mean([t.t_kv_transfer
                                          for t in self.traces])),
            "inference": float(np.mean([t.t_inference for t in self.traces])),
            "postprocess": float(np.mean([t.t_postprocess
                                          for t in self.traces])),
        }

    def summary(self) -> Dict[str, float]:
        s = {
            "requests": self._served(),
            "throughput_rps": self.throughput(),
            "p50_s": self.percentile(50),
            "p95_s": self.percentile(95),
            "p99_s": self.percentile(99),
            "mean_s": float(np.mean(self.latencies())) if self.traces else 0.0,
            "ttft_p50_s": self.ttft(50),
            "ttft_p99_s": self.ttft(99),
            "tpot_p50_s": self.tpot(50),
            "tpot_p99_s": self.tpot(99),
            "utilization": self.utilization(),
            "replicas": self.replicas,
            "replica_seconds": self.billed_replica_seconds(),
            "energy_j": self.energy_joules(),
            "co2_kg": self.co2_kg(),
            "cost_usd": self.cost_usd(),
            "cost_per_1k_req": self.cost_per_1k_requests(),
        }
        if self.pools is not None:
            s["prefill_replicas"] = self.pools["prefill_replicas"]
            s["decode_replicas"] = self.pools["decode_replicas"]
            s["mean_kv_transfer_s"] = self.pools["mean_kv_transfer_s"]
        if self.fleet is not None:
            s["spot_preemptions"] = self.fleet["spot_preemptions"]
            s["spot_killed_requests"] = self.fleet["spot_killed_requests"]
            s["cross_region_fraction"] = self.fleet["cross_region_fraction"]
        if self.memory is not None:
            s["prefix_hit_rate"] = self.memory["prefix_hit_rate"]
            s["preemptions"] = self.memory["preemptions"]
            s["kv_peak_occupancy"] = self.memory["peak_occupancy"]
            s["kv_mean_occupancy"] = self.memory["mean_occupancy"]
        return s


@dataclasses.dataclass(slots=True)
class _ActiveRequest:
    """A request occupying a decode slot of a continuous engine."""
    qreq: QueuedRequest
    remaining: int          # tokens still to produce (prefill yields one)
    context: int            # KV length so far
    join_s: float
    prefill_left: int = 0   # prompt tokens still to chunk-prefill (0 when
                            # the prompt was prefilled whole at join)
    chunk: int = 0          # tokens being prefilled this iteration
    trace: Optional[RequestTrace] = None    # resolved once at join so the
                            # per-token hot loop never hits the trace dict


def clamped_output_tokens(request: Request, max_model_len: int) -> int:
    """Decode tokens owed, bounded by the model's context limit so
    slot/KV accounting is always finite (``output_tokens_max=None``
    workloads carry an unbounded-generation sentinel).  Prompts at or
    over ``max_model_len`` are rejected at simulation entry
    (``simulate_cluster``), so the ≥1 floor never masks a context
    overrun — it only guards zero-output workloads."""
    out = request.output_tokens
    if max_model_len:
        out = min(out, max_model_len - request.prompt_tokens)
    return max(out, 1)


class ReplicaEngine:
    """One server timeline, steppable from an external event loop.

    The loop calls ``next_action_s`` to learn when this replica next wants
    the clock, advances global time, then calls ``act(now, traces)`` which
    performs every action due at ``now`` and returns ``(done_s, request)``
    completions (``done_s`` may lie in the future — inference started at
    ``now`` finishes later; completions only feed closed-loop reissue).
    ``next_action_s`` only changes when the engine's own state changes
    (an enqueue or its own act), which is what lets the cluster loop index
    engines in a lazy-deletion heap instead of rescanning all of them.
    """

    def __init__(self, replica_id: int, policy: BatchPolicy,
                 latency: LatencyModel, spawn_s: float = 0.0,
                 kv: Optional[KVCacheManager] = None,
                 max_model_len: int = 0, role: str = "both",
                 chunk_tokens: int = 0, created_s: float = 0.0,
                 obs=None):
        self.replica_id = replica_id
        self.obs = obs      # MetricsRecorder hooks (None → zero overhead)
        # span hook bound only when the timeline actually records, so the
        # per-iteration site pays one attribute check otherwise
        self.obs_span = (obs.engine_span if obs is not None
                         and getattr(obs, "record_spans", False) else None)
        self.policy = policy
        self.latency = latency
        self.continuous = isinstance(policy, ContinuousBatcher)
        self.spawn_s = spawn_s
        self.kv = kv                        # None → memory unmodeled
        self.max_model_len = max_model_len  # 0 → unbounded decode
        # disaggregated serving: a "prefill" engine runs chunked prefill
        # only and completes each request at its first token (the cluster
        # loop migrates it to the decode pool); "decode"/"both" engines
        # run the full continuous loop
        self.role = role
        self.chunk_tokens = chunk_tokens    # 0 → whole-prompt prefill
        self.created_s = created_s          # provisioning time (billing)
        self.retired_s: Optional[float] = None
        # fleet routing metadata — defaults describe the flat cluster;
        # simulate_cluster overwrites these for heterogeneous pools
        self.pool_name = "serve"
        self.region = ""
        self.cost_rate = 0.0    # $/replica-hour (rate × chips), router hint
        self.ttft_hint = 0.0    # nominal first-token latency, router hint
        # continuous admission pops head / preempts back to head: deque.
        # Request-level policies slice the queue (queue[:n]), so they
        # keep a list.
        self.queue = deque() if self.continuous else []
        self.server_free_at = spawn_s
        self.busy_s = 0.0
        self.served = 0
        self.retired = False
        # continuous-engine state
        self.active: List[_ActiveRequest] = []
        self.iter_end: Optional[float] = None
        self._slot_free_s = spawn_s     # last time capacity opened (a
        # decode slot freed, or KV blocks freed after blocking admission)
        self._kv_blocked_ver: Optional[int] = None  # KV version observed
        # when admission last failed allocation (None = not blocked)
        # memoized policy decision; every queue/clock mutation the engine
        # can see changes (now, len(queue), server_free_at)
        self._decision_key = None
        self._decision = None
        # bind the dispatch once — act() is called for every engine event
        self.act = self._act_continuous if self.continuous \
            else self._act_batched

    # ---- routing signals --------------------------------------------------
    def load(self, now: float) -> int:
        """In-flight work (queued + running) — the least-loaded signal."""
        n = len(self.queue) + len(self.active)
        if not self.continuous and self.server_free_at > now + EPS:
            n += 1          # a batch currently occupies the server
        return n

    def idle(self, now: float) -> bool:
        return (not self.queue and not self.active and self.iter_end is None
                and self.server_free_at <= now + EPS)

    # ---- event-loop interface --------------------------------------------
    def enqueue(self, qreq: QueuedRequest) -> None:
        self.queue.append(qreq)

    def next_action_s(self, now: float) -> Optional[float]:
        """Earliest time this replica can change state (None = nothing)."""
        if self.continuous:
            if self.iter_end is not None:
                return self.iter_end
            if self.queue or self.active:
                return max(now, self.spawn_s)
            return None
        if not self.queue:
            return None
        decision = self._decide(now)
        if decision is not None:
            return max(now, decision[1])
        fire = self.policy.earliest_fire(self.queue)
        if fire is not None:
            return max(fire, self.server_free_at)
        return None

    def _decide(self, now: float):
        key = (now, len(self.queue), self.server_free_at)
        if key != self._decision_key:
            self._decision = self.policy.next_batch(self.queue, now,
                                                    self.server_free_at)
            self._decision_key = key
        return self._decision

    def act(self, now: float,
            traces: Dict[int, RequestTrace]) -> List[Tuple[float, Request]]:
        if self.continuous:
            return self._act_continuous(now, traces)
        return self._act_batched(now, traces)

    # ---- request-level policies ------------------------------------------
    def _batch_fitting_memory(self, batch):
        """Longest batch prefix whose whole-batch KV working set fits the
        replica budget (request-level policies hold every sequence's full
        context for the batch's duration)."""
        kept, blocks = [], 0
        for q in batch:
            b = self.kv.blocks_for(q.request.prompt_tokens
                                   + q.request.output_tokens)
            if kept and blocks + b > self.kv.total_blocks:
                break
            kept.append(q)
            blocks += b
        return kept, blocks

    def _act_batched(self, now, traces):
        completions: List[Tuple[float, Request]] = []
        while self.queue:
            decision = self._decide(now)
            if decision is None:
                break
            batch, fire_t = decision
            if fire_t > now + EPS:
                break
            kv_blocks = 0
            if self.kv is not None:
                batch, kv_blocks = self._batch_fitting_memory(batch)
            ids = {q.request.req_id for q in batch}
            self.queue = [q for q in self.queue
                          if q.request.req_id not in ids]
            bsz = len(batch)
            prompt = max(q.request.prompt_tokens for q in batch)
            out_toks = max(q.request.output_tokens for q in batch)
            infer_s = self.latency.request_latency(bsz, prompt, out_toks)
            prev_free = self.server_free_at
            start = max(now, prev_free)
            self.server_free_at = start + infer_s
            self.busy_s += infer_s
            self.served += bsz
            if self.obs_span is not None:
                self.obs_span(self.replica_id, start,
                              self.server_free_at, "batch", bsz)
            if self.kv is not None:
                self.kv.charge_span(kv_blocks, start, self.server_free_at)
            # the batch emits its first tokens once the (padded) prefill
            # completes; decode steps follow until the batch's max length
            first_token = start + self.latency.prefill_latency(bsz, prompt)
            for q in batch:
                tr = traces[q.request.req_id]
                tr.replica = self.replica_id
                if tr.detail:
                    tr.t_queue = start - q.enqueue_s
                    tr.t_batch_wait = max(
                        0.0, start - max(q.enqueue_s, prev_free))
                    tr.t_inference = infer_s
                    tr.t_postprocess = POST_PROCESS_S
                    tr.batch_size = bsz
                tr.first_token_s = min(first_token, self.server_free_at)
                tr.tokens_out = clamped_output_tokens(q.request,
                                                      self.max_model_len)
                tr.done_s = self.server_free_at + POST_PROCESS_S
                completions.append((tr.done_s, q.request))
        return completions

    # ---- continuous (token-level) engine ---------------------------------
    def _clamped_output(self, request: Request) -> int:
        return clamped_output_tokens(request, self.max_model_len)

    def _preempt(self, victim: _ActiveRequest, now: float, traces) -> None:
        """Evict a running request under KV pressure (recompute policy):
        free its blocks and requeue it carrying its progress — on rejoin
        it re-prefills prompt + generated-so-far at latency-model cost."""
        q = victim.qreq
        self.kv.free(q.request.req_id, now, preempted=True)
        if self.obs is not None:
            self.obs.count_preemption()
        q.remaining = victim.remaining
        q.recompute_tokens = victim.context
        q.preemptions += 1
        tr = victim.trace
        tr.preemptions += 1
        # close this service segment so stage accounting stays truthful:
        # time served so far is inference, the wait from here to the
        # rejoin accrues to t_queue (segments accumulate via +=)
        if tr.detail:
            tr.t_inference += now - victim.join_s
        q.enqueue_s = now
        self.queue.appendleft(q)

    def spot_kill(self, now: float, traces) -> List[QueuedRequest]:
        """Spot reclamation: the provider takes the replica back *now*.

        Every in-flight sequence loses its KV and rejoins the fleet via
        the cluster router carrying its progress (recompute on rejoin,
        same machinery as memory-pressure preemption); queued requests
        are handed back untouched.  Returns the work to re-route.  The
        engine is retired and bills only up to ``now`` — the partially
        run iteration never completes, so its unspent tail is refunded
        from ``busy_s``.
        """
        victims: List[QueuedRequest] = []
        if self.iter_end is not None and self.iter_end > now:
            self.busy_s -= self.iter_end - now
        self.iter_end = None
        for a in self.active:
            q = a.qreq
            if self.kv is not None:
                self.kv.free(q.request.req_id, now, preempted=True)
            if self.obs is not None:
                self.obs.count_preemption()
            q.remaining = a.remaining
            q.recompute_tokens = a.context
            q.preemptions += 1
            tr = a.trace
            tr.preemptions += 1
            tr.spot_evictions += 1
            if tr.detail:
                tr.t_inference += now - a.join_s
            q.enqueue_s = now
            victims.append(q)
        self.active = []
        # queued work was never started: keep its original enqueue_s so
        # queue-time accounting spans the whole wait
        victims.extend(self.queue)
        self.queue.clear()
        self.server_free_at = now
        self.retired = True
        self.retired_s = now
        return victims

    def _grow_or_preempt(self, still: List[_ActiveRequest], now: float,
                         traces) -> List[_ActiveRequest]:
        """Extend every surviving sequence's KV by its new token; when a
        block allocation fails, preempt victims (youngest-join or
        largest-context first) until the extension fits."""
        survivors: List[_ActiveRequest] = []
        pending = sorted(still, key=lambda a: (a.join_s,
                                               a.qreq.request.req_id))
        while pending:
            a = pending.pop(0)              # oldest first: highest priority
            while not self.kv.extend(a.qreq.request.req_id, a.context, now):
                candidates = pending + survivors
                if not candidates:
                    raise RuntimeError(
                        "KV budget cannot hold a single sequence — "
                        "simulate_cluster validates against this; was the "
                        "manager constructed directly with too few blocks?")
                if self.kv.spec.preemption == "largest":
                    victim = max(candidates,
                                 key=lambda v: (v.context,
                                                v.qreq.request.req_id))
                else:                       # youngest join first
                    victim = max(candidates,
                                 key=lambda v: (v.join_s,
                                                v.qreq.request.req_id))
                self._preempt(victim, now, traces)
                (pending if victim in pending else survivors).remove(victim)
            survivors.append(a)
        return survivors

    def _act_continuous(self, now, traces):
        completions: List[Tuple[float, Request]] = []
        cap = self.policy.max_batch
        if self.iter_end is not None and self.iter_end <= now + EPS:
            end = self.iter_end
            self.iter_end = None
            was_full = len(self.active) >= cap
            still: List[_ActiveRequest] = []
            for a in self.active:
                if a.chunk > 0:
                    # chunked prefill advanced; no token until the final
                    # chunk's iteration (which falls through below)
                    a.prefill_left -= a.chunk
                    a.chunk = 0
                    if a.prefill_left > 0:
                        still.append(a)
                        continue
                a.remaining -= 1
                a.context += 1
                tr = a.trace
                if tr.detail:
                    tr.tokens_out += 1
                    if tr.first_token_s <= 0.0:
                        tr.first_token_s = end
                if a.remaining <= 0:
                    if tr.detail:
                        tr.t_inference += end - a.join_s
                    if self.role == "prefill" and clamped_output_tokens(
                            a.qreq.request, self.max_model_len) > 1:
                        # hand-off point (the cluster loop migrates this
                        # request): the decode pool owns the final done/
                        # postprocess accounting.  Single-token requests
                        # finish here and pay postprocess like everyone
                        tr.done_s = end
                    else:
                        tr.t_postprocess = POST_PROCESS_S
                        tr.done_s = end + POST_PROCESS_S
                    completions.append((tr.done_s, a.qreq.request))
                    self.served += 1
                    if self.kv is not None:
                        self.kv.free(a.qreq.request.req_id, now)
                else:
                    still.append(a)
            if self.kv is not None and still:
                still = self._grow_or_preempt(still, now, traces)
            if was_full and len(still) < cap:
                self._slot_free_s = end
            if self._kv_blocked_ver is not None \
                    and self.kv.version != self._kv_blocked_ver:
                # admission was blocked on a failed KV allocation and
                # blocks have since been freed: capacity (re)opened *now*,
                # so the wait up to this point was memory pressure, not
                # batching policy — advance the marker before admission
                # below computes t_batch_wait
                self._slot_free_s = max(self._slot_free_s, end)
                self._kv_blocked_ver = None
            self.active = still
        if self.iter_end is None and (self.queue or self.active):
            start = max(now, self.spawn_s)
            joined: List[_ActiveRequest] = []
            decode_joins: List[_ActiveRequest] = []
            prefill_lens: List[int] = []
            # max_prefill caps prefill admissions per boundary; migrated
            # (KV-resident) joins need no prefill compute, so they only
            # count against the decode-slot cap
            while (self.queue and len(self.active) + len(joined) < cap
                   and len(joined) - len(decode_joins)
                   < self.policy.max_prefill):
                q = self.queue[0]
                # a preempted request re-prefills its full saved context
                context0 = q.recompute_tokens or q.request.prompt_tokens
                if self.role == "prefill":
                    remaining = 1   # prefill emits exactly the first token
                elif q.remaining is not None:
                    remaining = q.remaining
                else:
                    remaining = self._clamped_output(q.request)
                cached = 0
                if self.kv is not None:
                    # migrated KV arrives as private blocks — keep it out
                    # of the prefix cache (its prefix was already shared
                    # on the prefill pool)
                    got = self.kv.allocate(
                        q.request.req_id, context0, now,
                        session_id=None if q.migrated
                        else q.request.session_id,
                        prefix_tokens=0 if q.migrated
                        else q.request.prefix_tokens)
                    if got is None:
                        # no KV headroom: stays queued.  Remember the
                        # cache's version so the next free() is seen as
                        # the moment capacity reopened (t_batch_wait must
                        # not charge this wait to the batching policy)
                        self._kv_blocked_ver = self.kv.version
                        break
                    cached = got
                self.queue.popleft()
                tr = traces[q.request.req_id]
                tr.replica = self.replica_id
                if tr.detail:
                    # += so a preempted request's rejoin adds its re-queue
                    # segment instead of overwriting the first one
                    tr.t_queue += start - q.enqueue_s
                    tr.t_batch_wait += max(
                        0.0, start - max(q.enqueue_s, self._slot_free_s))
                    tr.cached_prompt_tokens = max(tr.cached_prompt_tokens,
                                                  cached)
                a = _ActiveRequest(qreq=q, remaining=remaining,
                                   context=context0, join_s=start,
                                   trace=tr)
                if q.migrated and not q.recompute_tokens:
                    # KV already resident (transferred): no prefill
                    # compute; it takes a decode step this very iteration
                    decode_joins.append(a)
                else:
                    # prefix-cache hits skip those tokens' prefill compute
                    need = max(context0 - cached, 1)
                    if self.chunk_tokens and need > self.chunk_tokens:
                        a.prefill_left = need
                        a.chunk = min(self.chunk_tokens, need)
                        prefill_lens.append(a.chunk)
                    else:
                        prefill_lens.append(need)
                joined.append(a)
            # in-flight chunked prefills schedule their next chunk
            # (prefill_left can only be nonzero on chunking engines)
            if self.chunk_tokens:
                for a in self.active:
                    if a.prefill_left > 0:
                        a.chunk = min(self.chunk_tokens, a.prefill_left)
                        prefill_lens.append(a.chunk)
            if joined or self.active:
                if self.chunk_tokens:
                    decoders = [a for a in self.active
                                if a.prefill_left <= 0] + decode_joins
                else:
                    decoders = self.active + decode_joins
                n_decode = len(decoders)
                max_ctx = 0
                for a in decoders:
                    if a.context > max_ctx:
                        max_ctx = a.context
                n_prefill = len(prefill_lens)
                max_prompt = max(prefill_lens, default=0)
                t_iter = self.latency.iteration_latency(
                    n_prefill, max_prompt, n_decode, max_ctx)
                self.active.extend(joined)
                bsz = len(self.active)
                for a in self.active:
                    tr = a.trace
                    if tr.detail and bsz > tr.batch_size:
                        tr.batch_size = bsz
                self.iter_end = start + t_iter
                self.server_free_at = self.iter_end
                self.busy_s += t_iter
                if self.obs_span is not None:
                    self.obs_span(self.replica_id, start, self.iter_end,
                                  "iteration", bsz, n_prefill)
        return completions


def simulate(workload: WorkloadSpec, policy: BatchPolicy,
             latency: LatencyModel, *, network: NetworkModel = NETWORKS["lan"],
             server_side_processing: bool = True,
             memory=None, trace_sample: float = 1.0,
             obs=None) -> SimResult:
    """Run the single-replica pipeline simulation.

    This is the one-server special case of
    :func:`repro_torch.serving.cluster.simulate_cluster`; closed-loop workloads
    (``kind="closed"``) reissue each client's next request on completion
    until ``duration_s``.  ``memory`` (a ``MemorySpec`` or its dict form)
    enables KV-cache accounting on the single replica.  ``trace_sample``
    < 1 records full per-request traces for only that fraction of
    requests (aggregates like throughput stay exact; see
    ``simulate_cluster``).  ``obs`` (an ``ObsSpec``) opts into the
    observability layer — time-series + timeline on the single replica.
    """
    from repro_torch.serving.cluster import ClusterSpec, simulate_cluster
    return simulate_cluster(workload, policy, latency,
                            cluster=ClusterSpec(replicas=1, memory=memory,
                                                obs=obs),
                            network=network, trace_sample=trace_sample)
