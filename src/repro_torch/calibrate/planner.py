"""SLO-aware capacity planner (the plan step of measure → model → plan),
a copy of ``repro.calibrate.planner`` that reads the port's profiles (the
h100 one that the calibration job fits on the card among them).

Loads a calibration profile, clocks the multi-replica cluster simulator
with its fitted latency oracle, and searches a replicas × batching-policy
× router grid for the cheapest configuration whose SLO attainment meets
the target.  Cost comes from the same ``repro_torch.hw`` cloud-rate/energy
model the benchmark results use, so planned and benchmarked dollars are
directly comparable.  That model has no price for ``h100``: on an h100
profile the cost objectives tie every candidate that meets the SLO, so such
a plan names another ``SimResult.summary()`` key (``p99_s``) as objective.
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Any, Dict, List, Optional, Sequence

from repro_torch.calibrate.profile import CalibrationProfile, load_profile
from repro_torch.core.results import JobResult
from repro_torch.core.spec import PlanSpec
from repro_torch.serving.cluster import (ClusterSpec, DisaggSpec, PoolSpec,
                                         simulate_cluster)
from repro_torch.serving.latency_model import (NETWORKS, SpeedMode,
                                               apply_speed_mode,
                                               resolve_speed_mode)
from repro_torch.serving.memory import (GiB, KVBudgetError, MemorySpec,
                                        resolve_memory, scaled_memory_spec)
from repro_torch.serving.workload import WorkloadSpec


@dataclasses.dataclass(frozen=True)
class PlanCandidate:
    """One configuration of the planning grid.

    ``infeasible_reason`` is set when the memory check rejected the
    candidate before simulation (its KV working set cannot fit the
    per-replica HBM budget, however good its latency would be).
    ``split`` is ``(prefill_replicas, decode_replicas)`` for a
    disaggregated candidate, None for colocated; ``replicas`` is always
    the total chip-normalizing replica count.  ``speed_mode`` names the
    serving mode the candidate was simulated under ("fp16" when the
    plan searched none).  ``fleet`` is the heterogeneous composition the
    candidate simulated — a tuple of ``PoolSpec`` dicts (JSON-able, and
    accepted back by ``ClusterSpec(pools=...)``) — or None for a flat
    identical-replica cluster.
    """
    replicas: int
    policy: str
    router: str
    metrics: Dict[str, float]       # SimResult.summary() + slo_attainment
    meets_slo: bool
    objective: float                # the minimized metric's value
    max_batch: int = 0              # 0 in legacy single-max_batch plans
    split: Optional[Sequence[int]] = None
    speed_mode: str = "fp16"
    infeasible_reason: Optional[str] = None
    fleet: Optional[Sequence[Dict[str, Any]]] = None

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class PlanResult:
    """The full grid, sorted feasible-first then by objective."""
    profile_key: str
    slo_latency_s: Optional[float]
    slo_target: float
    objective: str
    candidates: List[PlanCandidate]
    ttft_slo_s: Optional[float] = None
    tpot_slo_s: Optional[float] = None

    @property
    def best(self) -> Optional[PlanCandidate]:
        feasible = [c for c in self.candidates if c.meets_slo]
        return min(feasible, key=lambda c: c.objective) if feasible else None

    def to_dict(self) -> Dict[str, Any]:
        best = self.best
        return {
            "profile_key": self.profile_key,
            "slo_latency_s": self.slo_latency_s,
            "slo_target": self.slo_target,
            "objective": self.objective,
            "best": best.to_dict() if best else None,
            "candidates": [c.to_dict() for c in self.candidates],
        }


def _policy(name: str, max_batch: int, max_prefill: int):
    from repro_torch.core.session import resolve_policy
    from repro_torch.core.spec import SoftwareSpec
    return resolve_policy(SoftwareSpec(policy=name, max_batch=max_batch,
                                       max_prefill=max_prefill))


def _memory_working_set_reason(memory: MemorySpec, oracle,
                               workload: WorkloadSpec,
                               max_batch: int) -> Optional[str]:
    """Static admission check: can ``max_batch`` concurrent sequences at
    their full context length ever fit the per-replica KV budget?  The
    estimate is conservative (every slot at max length) — that is the
    regime a capacity plan must survive."""
    resolved = resolve_memory(memory, oracle)
    # mixed-prompt workloads size the check at the longest prompt they
    # can draw — the conservative regime the plan must survive
    prompt = max(workload.prompt_tokens, workload.prompt_tokens_max)
    out_max = workload.output_tokens_max
    if out_max is None:
        # unbounded generation: the engine clamps each sequence at
        # max_model_len, so that is the per-slot working set
        tokens = max(resolved.max_model_len, prompt + 1)
    else:
        tokens = prompt + max(workload.output_tokens, out_max, 1)
        tokens = min(tokens, max(resolved.max_model_len, prompt + 1))
    bt = memory.block_tokens
    blocks = -(-tokens // bt) * max_batch
    if blocks <= resolved.total_blocks:
        return None
    ws_gib = blocks * bt * resolved.kv_bytes_per_token / GiB
    return (f"KV working set {ws_gib:.2f} GiB "
            f"(max_batch={max_batch} × {tokens} tok × "
            f"{resolved.kv_bytes_per_token:.0f} B/tok) exceeds the "
            f"per-replica KV budget of "
            f"{resolved.budget_bytes / GiB:.2f} GiB "
            f"({resolved.total_blocks} × {bt}-token blocks)")


_CONTINUOUS_NAMES = ("continuous", "orca", "vllm")


def plan_capacity(profile, workload: WorkloadSpec, *,
                  slo_latency_s: Optional[float] = None,
                  slo_target: float = 0.99,
                  ttft_slo_s: Optional[float] = None,
                  tpot_slo_s: Optional[float] = None,
                  tenants: Sequence[Any] = (),
                  replicas: Sequence[int] = (1, 2, 4),
                  policies: Sequence[str] = ("tfs", "continuous"),
                  routers: Sequence[str] = ("least-loaded",),
                  max_batch: int = 16,
                  max_batches: Sequence[int] = (),
                  max_prefill: int = 8,
                  prefill_decode_splits: Sequence[Sequence[int]] = (),
                  kv_network: str = "infiniband",
                  network: str = "lan",
                  objective: str = "cost_per_1k_req",
                  speed_modes: Sequence[Any] = (),
                  memory: Optional[MemorySpec] = None,
                  fleets: Sequence[Any] = ()) -> PlanResult:
    """Search the configuration grid for the cheapest SLO-meeting setup.

    ``profile`` may be a :class:`CalibrationProfile`, its dict/JSON-path/
    ``model@hardware`` form, or any ready ``LatencyOracle`` (so a plan
    can also be run against the analytic roofline model directly).

    SLOs: ``slo_latency_s`` constrains e2e latency; ``ttft_slo_s`` /
    ``tpot_slo_s`` constrain the phases real LLM deployments are judged
    by.  Attainment is joint — a request counts only when it meets
    *every* provided SLO — and at least one SLO must be given.

    ``tenants`` plans for a traffic mix instead of one stream: the
    workload is split across the given ``TenantSpec``s (shares, per-
    tenant scenarios/overrides) and a candidate is feasible only when
    its *worst* tenant meets that tenant's own resolved SLOs at the
    target, so the plan is the cheapest config under which every tenant
    survives.  Candidate metrics gain the per-tenant slices plus
    ``fairness_index``/``min_goodput_rps``; the top-level SLO arguments
    become optional (each tenant must resolve at least one SLO).

    ``prefill_decode_splits`` adds disaggregated candidates to the grid:
    each ``(prefill, decode)`` pair is simulated as split pools (total
    replicas = prefill + decode, KV handoff over ``kv_network``) under
    every continuous-batching policy/router/slot combination, so the
    planner can recommend colocated vs disaggregated per workload.

    With ``memory`` set the plan is memory-*and*-latency-aware: every
    candidate whose KV working set cannot fit the per-replica HBM budget
    is rejected up front (``infeasible_reason`` says why), and surviving
    candidates are simulated under that budget, so preemption/thrashing
    shows up in their latency numbers.  ``max_batches`` widens the grid
    over decode-slot counts (default: just ``max_batch``).

    ``speed_modes`` multiplies the grid by serving speed modes (names,
    :class:`SpeedMode` instances, or parameter dicts): each candidate is
    simulated under the mode-scaled oracle *and* the mode-scaled memory
    budget (int8 KV entries are half-size, so the same HBM admits bigger
    batches), letting the planner recommend a quantized or speculative
    config when it wins on the objective.  Names resolve through the
    profile's calibrated ``speed_modes`` section first, then the
    built-in presets.

    ``fleets`` adds heterogeneous compositions to the grid: each entry
    is a sequence of ``PoolSpec``s (or their dicts) — e.g. 2×v5e
    reserved + a spot t4 overflow pool vs. 3×v5e reserved — simulated
    under every router/policy/slot combination, so the planner can
    answer the paper's headline question (which *mix* of devices serves
    this traffic cheapest) under the same ``cost_per_goodput``
    objective.  Fleets with spot preemption pair only with continuous
    policies (kills requeue through the decode loop); per-pool memory
    grounding happens inside the simulation, so infeasible fleet
    budgets surface as ``KVBudgetError`` rejections.
    """
    tenant_specs = ()
    if tenants:
        from repro_torch.scenarios.tenants import (coerce_tenants,
                                                   resolve_tenant_slos,
                                                   tenant_workload)
        tenant_specs = coerce_tenants(tenants)
        for t in tenant_specs:
            if all(v is None for v in resolve_tenant_slos(t).values()):
                raise ValueError(
                    f"tenant {t.name!r} resolves no SLO: give it "
                    "slo_latency_s/slo_ttft_s/slo_tpot_s or a scenario "
                    "whose profile carries defaults")
        workload = dataclasses.replace(workload, tenants=tenant_specs)
    elif slo_latency_s is None and ttft_slo_s is None and tpot_slo_s is None:
        raise ValueError("plan_capacity needs at least one SLO: "
                         "slo_latency_s, ttft_slo_s, or tpot_slo_s")
    if isinstance(profile, dict):
        profile = CalibrationProfile.from_dict(profile)
    elif isinstance(profile, str):
        profile = load_profile(profile)
    mode_overrides = None
    if isinstance(profile, CalibrationProfile):
        oracle, key = profile.to_latency_model(), profile.key
        mode_overrides = profile.speed_modes
    else:
        oracle, key = profile, getattr(profile, "name", "oracle")
    if isinstance(memory, dict):
        memory = MemorySpec.from_dict(memory)
    mbs = tuple(max_batches) or (max_batch,)
    phase_slos = ttft_slo_s is not None or tpot_slo_s is not None

    # the speed-mode axis: calibrated profile parameters win over the
    # built-in presets; duplicates (by name) collapse to the first
    modes: List[SpeedMode] = []
    for m in (speed_modes or ("fp16",)):
        sm = resolve_speed_mode(m, mode_overrides)
        if all(sm.name != seen.name for seen in modes):
            modes.append(sm)

    # grid rows: (total_replicas, policy, router, max_batch, split, fleet)
    grid: List[tuple] = [
        (int(n), pol, router, int(mb), None, None)
        for n, pol, router, mb in itertools.product(replicas, policies,
                                                    routers, mbs)]
    # disaggregation needs a decode loop to migrate into, so split
    # candidates only pair with continuous policies (falling back to
    # plain "continuous" when the grid has none)
    disagg_pols = [p for p in policies if p in _CONTINUOUS_NAMES] \
        or ["continuous"]
    for split in prefill_decode_splits:
        pre, dec = int(split[0]), int(split[1])
        for pol, router, mb in itertools.product(disagg_pols, routers,
                                                 mbs):
            grid.append((pre + dec, pol, router, int(mb), (pre, dec),
                         None))
    # heterogeneous compositions: one row per fleet × policy × router ×
    # slots (spot-preempting fleets need the continuous decode loop)
    for f in fleets:
        pools = tuple(PoolSpec.from_dict(p) if isinstance(p, dict) else p
                      for p in f)
        n = sum(p.replicas for p in pools)
        fleet_pols = disagg_pols \
            if any(p.preempt_mtbf_s > 0 for p in pools) else policies
        for pol, router, mb in itertools.product(fleet_pols, routers,
                                                 mbs):
            grid.append((n, pol, router, int(mb), None, pools))

    # the static memory check sizes at the longest-context slice of the
    # traffic; for a tenant mix that is each tenant's own specialized
    # workload, not the parent shell
    sizing_workloads = [workload]
    if tenant_specs:
        sizing_workloads = [tenant_workload(workload, t, i, workload.rate)
                            for i, t in enumerate(tenant_specs)]

    candidates: List[PlanCandidate] = []
    for mode in modes:
        # mode-scaled serving physics: the oracle's latencies, KV
        # footprint, and resident weights all shift together, and an
        # explicit memory budget re-grounds at the smaller KV entry size
        oracle_m = apply_speed_mode(oracle, mode)
        memory_m = scaled_memory_spec(memory, mode)
        for n, pol, router, mb, split, fleet in grid:
            fleet_dicts = tuple(dataclasses.asdict(p) for p in fleet) \
                if fleet is not None else None
            reason = None
            # fleet budgets ground per pool against each pool's own
            # oracle inside the simulation, so the flat working-set
            # estimate doesn't apply — KVBudgetError covers them below
            if memory_m is not None and fleet is None:
                reason = next(
                    (r for r in (_memory_working_set_reason(memory_m,
                                                            oracle_m,
                                                            wl, mb)
                                 for wl in sizing_workloads)
                     if r is not None), None)
            if reason is not None:
                candidates.append(PlanCandidate(
                    replicas=n, policy=pol, router=router, metrics={},
                    meets_slo=False, objective=float("inf"),
                    max_batch=mb, split=split, speed_mode=mode.name,
                    infeasible_reason=reason))
                continue
            if fleet is not None:
                cluster = ClusterSpec(pools=fleet, router=router,
                                      memory=memory_m)
            elif split is None:
                cluster = ClusterSpec(replicas=n, router=router,
                                      memory=memory_m)
            else:
                cluster = ClusterSpec(
                    replicas=n, router=router, memory=memory_m,
                    disaggregation=DisaggSpec(
                        prefill_replicas=split[0],
                        decode_replicas=split[1],
                        prefill_router=router, decode_router=router,
                        prefill_max_batch=max_prefill,
                        kv_network=kv_network))
            try:
                res = simulate_cluster(
                    workload, _policy(pol, mb, max_prefill), oracle_m,
                    cluster=cluster, network=NETWORKS[network])
            except KVBudgetError as exc:
                # budget validation caught something the static estimate
                # missed (e.g. per-request lengths from a replayed
                # trace): reject the candidate, not the whole grid
                candidates.append(PlanCandidate(
                    replicas=n, policy=pol, router=router, metrics={},
                    meets_slo=False, objective=float("inf"),
                    max_batch=mb, split=split, speed_mode=mode.name,
                    infeasible_reason=str(exc), fleet=fleet_dicts))
                continue
            if tenant_specs:
                # a tenant mix is judged by its weakest member: every
                # tenant must hit its *own* resolved SLOs at the target
                from repro_torch.scenarios.tenants import tenant_report
                report = tenant_report(res, tenant_specs)
                att = report["worst_tenant_attainment"]
                metrics = dict(res.summary(), slo_attainment=att,
                               fairness_index=report["fairness_index"],
                               worst_tenant=report["worst_tenant"],
                               min_goodput_rps=report["min_goodput_rps"],
                               tenants=report["per_tenant"])
            else:
                if phase_slos:
                    att = res.phase_slo_attainment(
                        ttft_slo_s=ttft_slo_s, tpot_slo_s=tpot_slo_s,
                        e2e_slo_s=slo_latency_s)
                else:
                    att = res.slo_attainment(slo_latency_s)
                metrics = dict(res.summary(), slo_attainment=att)
                metrics["goodput_rps"] = res.goodput(
                    ttft_slo_s, tpot_slo_s, slo_latency_s)
            # $/goodput-req: the speed-mode tiebreaker — a mode only wins
            # by serving more SLO-meeting traffic per dollar, not by raw
            # throughput
            gp = metrics.get("goodput_rps",
                             metrics.get("min_goodput_rps", 0.0))
            metrics["cost_per_goodput"] = \
                metrics.get("cost_usd", 0.0) / (gp * res.duration_s) \
                if gp > 0 and res.duration_s else float("inf")
            if objective not in metrics:
                raise ValueError(
                    f"unknown plan objective {objective!r} "
                    f"(available: {sorted(metrics)})")
            candidates.append(PlanCandidate(
                replicas=n, policy=pol, router=router, metrics=metrics,
                meets_slo=att >= slo_target,
                objective=float(metrics[objective]), max_batch=mb,
                split=split, speed_mode=mode.name, fleet=fleet_dicts))
    candidates.sort(key=lambda c: (not c.meets_slo, c.objective))
    return PlanResult(profile_key=key, slo_latency_s=slo_latency_s,
                      slo_target=slo_target, objective=objective,
                      candidates=candidates,
                      ttft_slo_s=ttft_slo_s, tpot_slo_s=tpot_slo_s)


def simulate_candidate(profile, workload: WorkloadSpec,
                       candidate: PlanCandidate, *,
                       tenants: Sequence[Any] = (),
                       max_prefill: int = 8,
                       kv_network: str = "infiniband",
                       network: str = "lan",
                       memory: Optional[MemorySpec] = None):
    """Re-simulate one plan candidate and return the raw ``SimResult``.

    This is the verification half of plan → verify: rebuild exactly the
    cluster a :class:`PlanCandidate` describes — including its
    ``speed_mode`` — and run the workload through it, so a caller can
    independently confirm the planner's claimed attainment (e.g.
    per-tenant SLOs of the cheapest feasible config) rather than trust
    the grid numbers.
    """
    if isinstance(profile, dict):
        profile = CalibrationProfile.from_dict(profile)
    elif isinstance(profile, str):
        profile = load_profile(profile)
    mode_overrides = None
    if isinstance(profile, CalibrationProfile):
        oracle = profile.to_latency_model()
        mode_overrides = profile.speed_modes
    else:
        oracle = profile
    if isinstance(memory, dict):
        memory = MemorySpec.from_dict(memory)
    mode = resolve_speed_mode(candidate.speed_mode, mode_overrides)
    oracle = apply_speed_mode(oracle, mode)
    memory = scaled_memory_spec(memory, mode)
    if tenants:
        from repro_torch.scenarios.tenants import coerce_tenants
        workload = dataclasses.replace(workload,
                                       tenants=coerce_tenants(tenants))
    if getattr(candidate, "fleet", None):
        cluster = ClusterSpec(pools=candidate.fleet,
                              router=candidate.router, memory=memory)
    elif candidate.split is None:
        cluster = ClusterSpec(replicas=candidate.replicas,
                              router=candidate.router, memory=memory)
    else:
        pre, dec = candidate.split
        cluster = ClusterSpec(
            replicas=candidate.replicas, router=candidate.router,
            memory=memory,
            disaggregation=DisaggSpec(
                prefill_replicas=pre, decode_replicas=dec,
                prefill_router=candidate.router,
                decode_router=candidate.router,
                prefill_max_batch=max_prefill, kv_network=kv_network))
    mb = candidate.max_batch or 16
    return simulate_cluster(workload,
                            _policy(candidate.policy, mb, max_prefill),
                            oracle, cluster=cluster,
                            network=NETWORKS[network])


def plan_from_spec(spec: PlanSpec) -> PlanResult:
    profile = load_profile(spec.profile, spec.profile_dir)
    return plan_capacity(
        profile, spec.workload, slo_latency_s=spec.slo_latency_s,
        slo_target=spec.slo_target,
        ttft_slo_s=spec.ttft_slo_s, tpot_slo_s=spec.tpot_slo_s,
        tenants=spec.tenants,
        replicas=spec.replicas,
        policies=spec.policies, routers=spec.routers,
        max_batch=spec.max_batch, max_batches=spec.max_batches,
        max_prefill=spec.max_prefill,
        prefill_decode_splits=spec.prefill_decode_splits,
        kv_network=spec.kv_network,
        network=spec.network, objective=spec.objective,
        speed_modes=spec.speed_modes,
        memory=spec.memory, fleets=spec.fleets)


def run_plan_job(spec: PlanSpec) -> JobResult:
    """BenchmarkSession stage runner for a plan submission."""
    t0 = time.time()
    plan = plan_from_spec(spec)
    best = plan.best
    metrics: Dict[str, Any] = {
        "mode": "plan",
        "profile_key": plan.profile_key,
        "slo_latency_s": spec.slo_latency_s,
        "ttft_slo_s": spec.ttft_slo_s,
        "tpot_slo_s": spec.tpot_slo_s,
        "slo_target": spec.slo_target,
        "objective": spec.objective,
        "candidates": len(plan.candidates),
        "feasible": sum(c.meets_slo for c in plan.candidates),
        "rejected_memory": sum(c.infeasible_reason is not None
                               for c in plan.candidates),
        "best": best.to_dict() if best else None,
        "plan": plan.to_dict(),
    }
    return JobResult(spec=spec, metrics=metrics,
                     benchmark_wall_s=time.time() - t0)
