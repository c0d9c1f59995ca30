"""Multi-tenant traffic: split one aggregate workload across named
tenants, each with its own scenario, rate share, and SLOs.  A copy of
``repro.scenarios.tenants``.

A ``WorkloadSpec`` with ``tenants=[TenantSpec(...), ...]`` generates one
merged arrival stream: each tenant's slice is its own workload (the
parent spec, specialized by the tenant's scenario profile and
overrides) at ``rate = parent rate × normalized share`` (or the
tenant's absolute ``rate``), with disjoint session-id ranges so
affinity routing and the prefix cache never alias across tenants.
Every request carries ``tenant`` through the simulator, so results
slice per tenant and answer the isolation questions production teams
ask: does the small tenant's goodput survive the big tenant's burst?

``tenant_report`` computes the per-tenant view of a ``SimResult`` —
goodput against each tenant's *own* SLOs, attainment, tail latencies —
plus the cross-tenant fairness/isolation metrics: Jain's fairness index
over share-normalized goodput, and the worst tenant by attainment.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence

from repro_torch.scenarios.profiles import get_profile

# session-id stride between tenants: far larger than any plausible
# session_count, so per-tenant session ids never collide
_SESSION_STRIDE = 1_000_003
# seed stride between tenants: distinct, deterministic per-tenant rngs
_SEED_STRIDE = 7919


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One tenant's slice of the aggregate traffic.

    ``share`` is a relative weight (normalized over all tenants);
    ``rate`` overrides the share split with an absolute requests/s.
    ``scenario`` names a registered profile providing the tenant's
    token/session shape and default SLOs; ``workload`` holds per-tenant
    ``WorkloadSpec`` field overrides (e.g. a different ``kind`` so one
    tenant bursts while the rest stay steady).  SLO fields set here win
    over the scenario's defaults.
    """
    name: str
    share: float = 1.0
    rate: Optional[float] = None
    scenario: Optional[str] = None
    workload: Dict[str, Any] = dataclasses.field(default_factory=dict)
    slo_ttft_s: Optional[float] = None
    slo_tpot_s: Optional[float] = None
    slo_latency_s: Optional[float] = None

    def __post_init__(self):
        if not self.name:
            raise ValueError("TenantSpec needs a non-empty name")
        if self.rate is None and self.share <= 0:
            raise ValueError(f"tenant {self.name!r} needs share > 0 "
                             "or an absolute rate")
        if self.scenario is not None:
            get_profile(self.scenario)      # fail fast on unknown names

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "TenantSpec":
        return cls(**dict(d))

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def coerce_tenants(tenants) -> tuple:
    """dicts/TenantSpecs → tuple of TenantSpec, names unique."""
    out = tuple(t if isinstance(t, TenantSpec) else TenantSpec.from_dict(t)
                for t in tenants)
    names = [t.name for t in out]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate tenant names: {names}")
    return out


def resolve_tenant_slos(tenant: TenantSpec) -> Dict[str, Optional[float]]:
    """The SLOs this tenant is judged by: its own fields, falling back
    to its scenario profile's defaults."""
    slos = {"slo_ttft_s": tenant.slo_ttft_s,
            "slo_tpot_s": tenant.slo_tpot_s,
            "slo_latency_s": tenant.slo_latency_s}
    if tenant.scenario is not None:
        for k, v in get_profile(tenant.scenario).slos().items():
            if slos[k] is None:
                slos[k] = v
    return slos


def normalized_shares(tenants: Sequence[TenantSpec]) -> Dict[str, float]:
    total = sum(t.share for t in tenants)
    return {t.name: t.share / total for t in tenants}


def tenant_workload(parent, tenant: TenantSpec, index: int,
                    rate: float):
    """The tenant's own WorkloadSpec: parent minus the tenant list,
    specialized by the tenant's scenario profile and field overrides."""
    base = dataclasses.replace(
        parent, tenants=None, rate=rate,
        seed=parent.seed + _SEED_STRIDE * (index + 1))
    if tenant.scenario is not None:
        base = get_profile(tenant.scenario).apply_to_workload(base)
    if tenant.workload:
        base = dataclasses.replace(base, **dict(tenant.workload))
    return base


def generate_multi_tenant(spec) -> List:
    """Merged request stream for a ``WorkloadSpec`` carrying tenants.

    Called from ``repro_torch.serving.workload.generate`` (the single entry
    point every simulator path uses).  Requests are tagged with their
    tenant name, session ids are offset per tenant, and the merged
    stream is re-numbered in arrival order.
    """
    from repro_torch.serving.workload import CLOSED, TRACE, generate
    tenants = coerce_tenants(spec.tenants)
    if spec.kind in (CLOSED, TRACE):
        raise ValueError(
            f"multi-tenant workloads cannot use kind={spec.kind!r}: "
            "closed-loop reissue and trace replay own their own arrival "
            "streams (record tenants in the trace instead)")
    shares = normalized_shares(tenants)
    merged = []
    for i, tenant in enumerate(tenants):
        rate = tenant.rate if tenant.rate is not None \
            else spec.rate * shares[tenant.name]
        sub = tenant_workload(spec, tenant, i, rate)
        offset = _SESSION_STRIDE * i
        for r in generate(sub):
            merged.append(dataclasses.replace(
                r, tenant=tenant.name, session_id=r.session_id + offset))
    merged.sort(key=lambda r: (r.arrival_s, r.tenant))
    return [dataclasses.replace(r, req_id=i) for i, r in enumerate(merged)]


# ---- per-tenant metrics over a SimResult -----------------------------------
def tenant_report(result, tenants) -> Dict[str, Any]:
    """Per-tenant slices + fairness/isolation metrics for one run.

    Each tenant is judged by its *own* resolved SLOs (goodput and
    attainment); the fairness index is Jain's index over
    share-normalized goodput (1.0 = every tenant gets goodput exactly
    proportional to its share; → 1/n as one tenant starves the rest).
    """
    from repro_torch.core.analysis import jain_index
    tenants = coerce_tenants(tenants)
    shares = normalized_shares(tenants)
    per: Dict[str, Dict[str, float]] = {}
    normalized: List[float] = []
    for t in tenants:
        sub = result.tenant_result(t.name)
        slos = resolve_tenant_slos(t)
        has_slo = any(v is not None for v in slos.values())
        goodput = sub.goodput(slos["slo_ttft_s"], slos["slo_tpot_s"],
                              slos["slo_latency_s"])
        att = sub.phase_slo_attainment(
            slos["slo_ttft_s"], slos["slo_tpot_s"], slos["slo_latency_s"]) \
            if has_slo and sub.traces else (1.0 if sub.traces else 0.0)
        per[t.name] = {
            "requests": len(sub.traces),
            "share": shares[t.name],
            "throughput_rps": sub.throughput(),
            "goodput_rps": goodput,
            "slo_attainment": att,
            "p50_s": sub.percentile(50),
            "p99_s": sub.percentile(99),
            "ttft_p99_s": sub.ttft(99),
            "tpot_p99_s": sub.tpot(99),
            "slos": slos,
        }
        normalized.append(goodput / max(shares[t.name], 1e-12))
    worst = min(per, key=lambda n: per[n]["slo_attainment"])
    return {
        "per_tenant": per,
        "fairness_index": jain_index(normalized),
        "worst_tenant": worst,
        "worst_tenant_attainment": per[worst]["slo_attainment"],
        "worst_tenant_p99_s": max(p["p99_s"] for p in per.values()),
        "min_goodput_rps": min(p["goodput_rps"] for p in per.values()),
    }


def tenant_table(report: Dict[str, Any]) -> str:
    """Render a ``tenant_report`` as an aligned table."""
    cols = (f"{'tenant':>14}{'share':>8}{'reqs':>7}{'thr rps':>9}"
            f"{'goodput':>9}{'slo':>6}{'p99 ms':>8}{'ttft99':>8}")
    lines = [f"multi-tenant report  (fairness={report['fairness_index']:.3f}"
             f", worst={report['worst_tenant']})", cols]
    for name, p in report["per_tenant"].items():
        lines.append(
            f"{name:>14}{p['share']:>8.2f}{p['requests']:>7}"
            f"{p['throughput_rps']:>9.1f}{p['goodput_rps']:>9.1f}"
            f"{p['slo_attainment']:>6.2f}{p['p99_s'] * 1e3:>8.1f}"
            f"{p['ttft_p99_s'] * 1e3:>8.1f}")
    return "\n".join(lines)
