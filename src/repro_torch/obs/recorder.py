"""MetricsRecorder — fixed-tick time-series capture for the cluster loop.

The recorder rides the indexed event loop: between any two events the
cluster's state is constant, so sampling every gauge at the tick times
that fall inside that interval is *exact*, not approximate.  The event
loop calls :meth:`sample_ticks` once per pass (before it processes the
events due at the new clock value), and :meth:`finish` once at the end
to flush the remaining ticks and take a final sample at ``duration``.

Gauges (per replica, summable per pool / cluster):
  queue_depth      — requests waiting in the replica's queue
  batch_occupancy  — decode slots in use (continuous engines) or 1/0
                     busy flag (request-level engines)
  kv_occupancy     — resident KV blocks / total blocks (memory-modeled
                     runs only)
  prefix_hit_rate  — cumulative prefix-cache hit-token fraction

Cluster gauges: ``live_replicas`` (non-retired engines — the series
whose step integral reconciles with ``SimResult.replica_seconds``).

Counters (cumulative, snapshotted at each tick; also split per tenant):
  arrivals, completions, preemptions.

Everything lands in a :class:`Timeseries`, a plain JSON-serializable
container attached to ``SimResult.timeseries`` and persisted through
PerfDB records, with slicing helpers (``total`` / ``replica`` /
``pool`` / ``rate``).

This module deliberately imports nothing from ``repro_torch.serving`` — the
engines it samples are duck-typed (``queue``/``active``/``kv``/
``retired``/``replica_id``), which keeps the dependency arrow pointing
serving → obs only.

A copy of ``repro.obs.recorder``, importing only ``repro_torch``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

EPS = 1e-12

GAUGE_NAMES = ("queue_depth", "batch_occupancy", "kv_occupancy",
               "prefix_hit_rate")
COUNTER_NAMES = ("arrivals", "completions", "preemptions")


@dataclasses.dataclass(slots=True)
class EngineSpan:
    """One engine service span (a continuous-batching iteration or a
    request-level batch occupation), recorded by the ``ReplicaEngine``
    begin/end hooks for the Chrome-trace timeline."""
    replica: int
    pool: str               # "serve" (flat), "prefill"/"decode"
                            # (disagg), or the PoolSpec name (fleet)
    start_s: float
    end_s: float
    kind: str               # iteration | batch
    batch: int              # decode slots in use / batch size
    n_prefill: int = 0      # prefills admitted this iteration


@dataclasses.dataclass
class Timeseries:
    """The recorded run trajectory (JSON-serializable, PerfDB-persisted).

    ``gauges[name][replica_id_str]`` and all counter lists are aligned
    with ``times`` (one value per tick; replicas spawned mid-run are
    zero-padded back to t=0).  Counters are cumulative; use ``rate`` for
    per-second derivatives.
    """
    interval_s: float
    times: List[float]
    live_replicas: List[int]
    gauges: Dict[str, Dict[str, List[float]]]
    counters: Dict[str, List[int]]
    tenant_counters: Dict[str, Dict[str, List[int]]]
    replica_pool: Dict[str, str]

    # ---- slicing ----------------------------------------------------------
    def replicas(self) -> List[str]:
        ids = set()
        for series in self.gauges.values():
            ids.update(series)
        return sorted(ids, key=int)

    def pools(self) -> List[str]:
        return sorted(set(self.replica_pool.values()))

    def replica(self, gauge: str, replica_id) -> List[float]:
        return list(self.gauges.get(gauge, {}).get(str(replica_id), []))

    def total(self, gauge: str, *, pool: Optional[str] = None,
              mean: bool = False) -> List[float]:
        """Sum (or mean) of a gauge across replicas, optionally only the
        replicas of one pool — ``"prefill"``/``"decode"`` for a
        disaggregated cluster, ``"serve"`` for a flat one, or any
        named ``PoolSpec`` of a heterogeneous fleet."""
        series = self.gauges.get(gauge, {})
        cols = [v for rid, v in series.items()
                if pool is None or self.replica_pool.get(rid) == pool]
        if not cols:
            return [0.0] * len(self.times)
        out = [float(sum(vals)) for vals in zip(*cols)]
        if mean:
            out = [v / len(cols) for v in out]
        return out

    def counter(self, name: str, *, tenant: Optional[str] = None
                ) -> List[int]:
        if tenant is not None:
            return list(self.tenant_counters.get(name, {}).get(tenant, []))
        return list(self.counters.get(name, []))

    def counter_total(self, name: str, *, tenant: Optional[str] = None
                      ) -> int:
        c = self.counter(name, tenant=tenant)
        return int(c[-1]) if c else 0

    def tenants(self) -> List[str]:
        names = set()
        for per in self.tenant_counters.values():
            names.update(per)
        return sorted(names)

    def rate(self, name: str, *, tenant: Optional[str] = None
             ) -> List[float]:
        """Per-second rate of a cumulative counter (length == times;
        the first point covers [0, times[0]])."""
        c = self.counter(name, tenant=tenant)
        out: List[float] = []
        prev_t = prev_v = 0.0
        for t, v in zip(self.times, c):
            dt = t - prev_t
            out.append((v - prev_v) / dt if dt > EPS else 0.0)
            prev_t, prev_v = t, v
        return out

    def live_replica_integral(self) -> float:
        """∫ live_replicas dt under the step-function reading (each
        sample holds until the next tick) — reconciles with
        ``SimResult.replica_seconds`` to within one tick per scaling
        event."""
        total = 0.0
        for i in range(len(self.times) - 1):
            total += self.live_replicas[i] * (self.times[i + 1]
                                              - self.times[i])
        return total

    # ---- (de)serialization ------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Timeseries":
        return cls(interval_s=float(d["interval_s"]),
                   times=list(d["times"]),
                   live_replicas=list(d["live_replicas"]),
                   gauges={g: {r: list(v) for r, v in series.items()}
                           for g, series in d.get("gauges", {}).items()},
                   counters={k: list(v)
                             for k, v in d.get("counters", {}).items()},
                   tenant_counters={k: {t: list(v) for t, v in per.items()}
                                    for k, per in
                                    d.get("tenant_counters", {}).items()},
                   replica_pool=dict(d.get("replica_pool", {})))


class MetricsRecorder:
    """Counters + tick-sampled gauges for one ``simulate_cluster`` run.

    Hot-path cost with the recorder attached is one attribute increment
    per arrival/completion/preemption, one float comparison per event-
    loop pass, and one O(replicas) scan per *tick* (not per event) —
    the ``sim_obs_overhead_frac`` bench gate holds it under 5%.
    """

    def __init__(self, spec, interval_s: float):
        self.spec = spec
        self.interval_s = interval_s
        self.next_tick = 0.0
        self.record_spans = bool(spec.timeline)
        self.spans: List[EngineSpan] = []
        self.replica_pool: Dict[str, str] = {}
        # counters (ints bumped by the loop/engine hooks)
        self.arrivals = 0
        self.completions = 0
        self.preemptions = 0
        self._tenant_counts: Dict[str, Dict[str, int]] = {}
        # tick-aligned storage
        self._times: List[float] = []
        self._live: List[int] = []
        self._gauges: Dict[str, Dict[str, List[float]]] = {
            g: {} for g in GAUGE_NAMES}
        self._counters: Dict[str, List[int]] = {c: []
                                                for c in COUNTER_NAMES}
        self._tenant_samples: Dict[str, Dict[str, List[int]]] = {
            c: {} for c in ("arrivals", "completions")}
        # per-replica column refs, resolved once per replica instead of
        # per gauge per tick — tick sampling is the recorder's only
        # O(replicas) hot path, and it must stay inside the ≤5%
        # sim_obs_overhead_frac bench gate
        self._cols: Dict[int, tuple] = {}

    # ---- registration / counter hooks (called by the event loop) ----------
    def register_engine(self, replica_id: int, pool: str) -> None:
        self.replica_pool[str(replica_id)] = pool

    def count_arrival(self, tenant: str = "") -> None:
        self.arrivals += 1
        if tenant:
            self._tenant_counts.setdefault(
                tenant, {"arrivals": 0, "completions": 0})["arrivals"] += 1

    def count_completion(self, tenant: str = "") -> None:
        self.completions += 1
        if tenant:
            self._tenant_counts.setdefault(
                tenant,
                {"arrivals": 0, "completions": 0})["completions"] += 1

    def count_preemption(self) -> None:
        self.preemptions += 1

    def engine_span(self, replica: int, start_s: float, end_s: float,
                    kind: str, batch: int, n_prefill: int = 0) -> None:
        """Engine begin/end hook (no-op unless the timeline is on)."""
        if self.record_spans:
            self.spans.append(EngineSpan(
                replica=replica,
                pool=self.replica_pool.get(str(replica), "serve"),
                start_s=start_s, end_s=end_s, kind=kind, batch=batch,
                n_prefill=n_prefill))

    # ---- tick sampling ----------------------------------------------------
    def _append(self, store: Dict[str, List], key: str, value,
                fill=0) -> None:
        col = store.get(key)
        if col is None:
            col = store[key] = []
        n = len(self._times)
        if len(col) < n - 1:        # spawned/seen mid-run: pad back to t=0
            col.extend([fill] * (n - 1 - len(col)))
        col.append(value)

    def _new_cols(self, e, n: int) -> tuple:
        """Column lists for a replica first seen at tick index ``n``
        (zero-padded back to t=0)."""
        rid = str(e.replica_id)
        g = self._gauges
        q_col = g["queue_depth"][rid] = [0.0] * n
        occ_col = g["batch_occupancy"][rid] = [0.0] * n
        kv_col = hit_col = None
        if e.kv is not None:
            kv_col = g["kv_occupancy"][rid] = [0.0] * n
            hit_col = g["prefix_hit_rate"][rid] = [0.0] * n
        cols = (q_col, occ_col, kv_col, hit_col)
        self._cols[e.replica_id] = cols
        return cols

    def _sample(self, t: float, engines) -> None:
        n = len(self._times)
        self._times.append(t)
        live = 0
        get_cols = self._cols.get
        for e in engines:
            if not e.retired:
                live += 1
            cols = get_cols(e.replica_id)
            if cols is None:
                cols = self._new_cols(e, n)
            q_col, occ_col, kv_col, hit_col = cols
            q_col.append(float(len(e.queue)))
            if e.continuous:
                occ_col.append(float(len(e.active)))
            else:
                occ_col.append(1.0 if e.server_free_at > t + EPS else 0.0)
            if kv_col is not None:
                kv = e.kv
                kv_col.append(kv.resident_blocks / kv.total_blocks)
                served = kv.hit_tokens + kv.miss_tokens
                hit_col.append(kv.hit_tokens / served if served else 0.0)
        self._live.append(live)
        self._counters["arrivals"].append(self.arrivals)
        self._counters["completions"].append(self.completions)
        self._counters["preemptions"].append(self.preemptions)
        for tenant, counts in self._tenant_counts.items():
            for cname in ("arrivals", "completions"):
                self._append(self._tenant_samples[cname], tenant,
                             counts[cname])

    def sample_ticks(self, t_limit: float, engines) -> None:
        """Sample every tick strictly before ``t_limit`` (the event
        loop's next clock value): state is constant on the open interval
        since the last processed event, so those samples are exact."""
        while self.next_tick < t_limit - EPS:
            self._sample(self.next_tick, engines)
            self.next_tick += self.interval_s

    def finish(self, duration_s: float, engines) -> None:
        """Flush remaining ticks and close with a sample at exactly
        ``duration_s`` (so drained queues are visibly drained and the
        live-replica step integral covers the whole run)."""
        self.sample_ticks(duration_s, engines)
        if not self._times or self._times[-1] < duration_s - EPS:
            self._sample(duration_s, engines)

    # ---- result -----------------------------------------------------------
    def build(self) -> Timeseries:
        n = len(self._times)

        def pad(store):
            for col in store.values():
                if len(col) < n:
                    col.extend([0] * (n - len(col)))
            return store

        gauges = {g: pad(series) for g, series in self._gauges.items()
                  if series}
        return Timeseries(
            interval_s=self.interval_s,
            times=self._times,
            live_replicas=self._live,
            gauges=gauges,
            counters=self._counters,
            tenant_counters={c: pad(per) for c, per in
                             self._tenant_samples.items() if per},
            replica_pool=dict(self.replica_pool))
