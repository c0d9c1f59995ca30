"""Scenario library: named production traffic profiles, realistic
arrival processes, multi-tenant workloads, and a synthetic trace scaler.
A copy of ``repro.scenarios`` that imports only ``repro_torch``: the same
catalog, and the same numpy draws, so a spec gives the reference's stream.

The workload layer (``repro_torch.serving.workload``) exposes raw primitives
— Poisson/burst/ramp arrival generators, trace replay, session and
prompt-mix knobs.  This package gives them a *vocabulary*:

  * :mod:`repro_torch.scenarios.profiles` — a registry of named production
    scenarios (``chat``, ``code-generation``, ``summarization``,
    ``classification``, ``rag-long-context``) binding prompt/output
    token distributions, session/prefix structure, and default SLOs,
    resolvable from one config line (``"scenario": "chat"``);
  * :mod:`repro_torch.scenarios.arrivals` — diurnal (sinusoid-modulated
    Poisson), flash-crowd (baseline + exponential spike decay), and
    scale-to-saturation sweep arrival processes, surfaced as
    ``WorkloadSpec`` kinds;
  * :mod:`repro_torch.scenarios.tenants` — multi-tenant traffic splits with
    per-tenant scenarios, rate shares, and SLOs, plus fairness/
    isolation metrics over the simulator's per-tenant slices;
  * :mod:`repro_torch.scenarios.synth` — scales a small seed JSONL trace to
    millions-of-users volume while preserving interarrival burstiness,
    session-length distribution, and prefix-sharing structure.
"""
from repro_torch.scenarios.profiles import (ScenarioProfile, catalog_table,
                                            get_profile, list_profiles,
                                            register_profile)
from repro_torch.scenarios.tenants import (TenantSpec, generate_multi_tenant,
                                           resolve_tenant_slos, tenant_report)
from repro_torch.scenarios.synth import (load_trace_rows, scale_trace,
                                         trace_stats, write_trace_rows)

__all__ = [
    "ScenarioProfile", "catalog_table", "get_profile", "list_profiles",
    "register_profile",
    "TenantSpec", "generate_multi_tenant", "resolve_tenant_slos",
    "tenant_report",
    "load_trace_rows", "scale_trace", "trace_stats", "write_trace_rows",
]
