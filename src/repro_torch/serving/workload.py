"""Workload generator (paper §4.2.2), a copy of ``repro.serving.workload``.

Produces request arrival traces for the serving benchmarks: Poisson (the
paper's primary mode), uniform, closed-loop, spike/burst patterns, stepped
``ramp`` rate sweeps (for saturation-knee finding), and ``trace`` replay
from recorded JSONL files (schema documented in ``configs/traces/``).
The scenario library (``repro_torch.scenarios``) adds diurnal, flash-crowd,
and geometric ``sweep`` arrival processes plus multi-tenant splits
(``WorkloadSpec.tenants``), all dispatched through :func:`generate`.
Deterministic given a seed: the same spec gives the same request stream as
the reference.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

POISSON = "poisson"
UNIFORM = "uniform"
BURST = "burst"
CLOSED = "closed"
RAMP = "ramp"
TRACE = "trace"
# scenario-library arrival processes (generated by repro_torch.scenarios.arrivals)
DIURNAL = "diurnal"          # sinusoid-modulated Poisson (day/night cycle)
FLASH = "flash-crowd"        # baseline + exponential spike/decay
SWEEP = "sweep"              # geometric scale-to-saturation rate ladder

KINDS = (POISSON, UNIFORM, BURST, CLOSED, RAMP, TRACE, DIURNAL, FLASH,
         SWEEP)
# kinds whose arrival stream is driven by ``rate``
RATE_KINDS = (POISSON, UNIFORM, BURST, DIURNAL, FLASH)

# ``output_tokens_max=None`` ⇒ generate-until-stopped.  Requests carry this
# sentinel; the continuous engine bounds each decode by the model's
# ``max_seq_len`` (minus the prompt) so slot/KV accounting stays finite.
UNBOUNDED_OUTPUT_TOKENS = 1 << 15

# JSONL trace-replay columns; only ``arrival_s`` is required per line, the
# rest default to the WorkloadSpec values (see configs/traces/README.md).
TRACE_FIELDS = ("arrival_s", "prompt_tokens", "output_tokens",
                "payload_bytes", "session_id", "prefix_tokens", "tenant")


@dataclasses.dataclass(frozen=True)
class Request:
    req_id: int
    arrival_s: float
    prompt_tokens: int
    output_tokens: int
    payload_bytes: int
    session_id: int = 0             # client/session for affinity routing
    prefix_tokens: int = 0          # leading prompt tokens shared by every
                                    # request of this session (system prompt
                                    # / chat history — prefix-cache reusable)
    tenant: str = ""                # multi-tenant workloads: which tenant
                                    # issued this request ("" = untagged);
                                    # SimResult slices metrics by it


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    kind: str = POISSON
    rate: float = 30.0                  # requests/s (poisson & uniform)
    duration_s: float = 60.0
    prompt_tokens: int = 128
    prompt_tokens_max: int = 0          # > prompt_tokens ⇒ per-request
                                        # uniform sample in [min, max] —
                                        # mixed short/long-prefill loads
                                        # (disaggregation's home turf)
    prefix_tokens: int = 0              # leading prompt tokens identical
                                        # within a session (shared-prefix
                                        # chat; enables prefix-cache reuse)
    output_tokens: int = 1              # classification-style: 1 step
    output_tokens_max: Optional[int] = 0    # > output_tokens ⇒ per-request
                                        # uniform sample in [min, max];
                                        # None ⇒ unbounded generation — the
                                        # serving engine bounds it by the
                                        # model's max_seq_len when memory
                                        # accounting is on
    payload_bytes: int = 150 * 1024     # ~one image
    burst_factor: float = 10.0          # rate multiplier inside a burst
    burst_fraction: float = 0.1         # fraction of time bursting
    concurrency: int = 8                # closed-loop clients
    session_count: int = 4              # distinct sessions (affinity routing)
    ramp_min_rate: float = 10.0         # ramp/sweep: first step's rate
    ramp_max_rate: float = 200.0        # ramp/sweep: last step's rate
    ramp_steps: int = 5                 # ramp/sweep: equal-length steps
                                        # (ramp is linear, sweep geometric)
    diurnal_period_s: float = 20.0      # diurnal: one day/night cycle,
                                        # compressed to simulation scale
    diurnal_amplitude: float = 0.8      # diurnal: peak deviation as a
                                        # fraction of ``rate`` (0..1)
    flash_start_s: float = -1.0         # flash-crowd: spike onset
                                        # (< 0 → duration_s / 3)
    flash_decay_s: float = -1.0         # flash-crowd: exponential decay
                                        # time constant (≤ 0 → duration/10);
                                        # spike magnitude is burst_factor
    trace_path: Optional[str] = None    # trace: JSONL file to replay
    tenants: Optional[Tuple] = None     # multi-tenant traffic split: a
                                        # tuple of TenantSpec (or dicts) —
                                        # see repro.scenarios.tenants
    seed: int = 0

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown workload kind {self.kind!r} "
                             f"(known: {list(KINDS)})")
        if self.kind != TRACE and self.duration_s <= 0:
            raise ValueError(f"WorkloadSpec.duration_s must be > 0 "
                             f"(got {self.duration_s})")
        if self.kind in RATE_KINDS and self.rate <= 0:
            raise ValueError(f"WorkloadSpec.rate must be > 0 for "
                             f"kind={self.kind!r} (got {self.rate})")
        if not 0.0 <= self.burst_fraction <= 1.0:
            raise ValueError(f"WorkloadSpec.burst_fraction must be in "
                             f"[0, 1] (got {self.burst_fraction})")
        if self.ramp_steps < 1:
            raise ValueError(f"WorkloadSpec.ramp_steps must be >= 1 "
                             f"(got {self.ramp_steps})")
        if self.kind in (RAMP, SWEEP) and self.ramp_min_rate <= 0:
            raise ValueError(f"WorkloadSpec.ramp_min_rate must be > 0 for "
                             f"kind={self.kind!r} (got {self.ramp_min_rate})")
        if not 0.0 <= self.diurnal_amplitude <= 1.0:
            raise ValueError(f"WorkloadSpec.diurnal_amplitude must be in "
                             f"[0, 1] (got {self.diurnal_amplitude})")
        if self.kind == DIURNAL and self.diurnal_period_s <= 0:
            raise ValueError("WorkloadSpec.diurnal_period_s must be > 0 "
                             f"(got {self.diurnal_period_s})")
        if self.tenants is not None:
            if len(self.tenants) == 0:
                object.__setattr__(self, "tenants", None)
            else:
                from repro_torch.scenarios.tenants import coerce_tenants
                object.__setattr__(self, "tenants",
                                   coerce_tenants(self.tenants))


def ramp_step_rates(spec: WorkloadSpec) -> List[float]:
    """The per-step arrival rates of a ``ramp`` workload (low → high)."""
    denom = max(spec.ramp_steps - 1, 1)
    return [spec.ramp_min_rate
            + (spec.ramp_max_rate - spec.ramp_min_rate) * k / denom
            for k in range(spec.ramp_steps)]


def _load_trace(spec: WorkloadSpec) -> List[Request]:
    if not spec.trace_path:
        raise ValueError("kind='trace' needs WorkloadSpec.trace_path")
    rows = []
    for line in Path(spec.trace_path).read_text().splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        rows.append(json.loads(line))
    rows.sort(key=lambda d: float(d["arrival_s"]))
    return [
        Request(req_id=i, arrival_s=float(d["arrival_s"]),
                prompt_tokens=int(d.get("prompt_tokens", spec.prompt_tokens)),
                output_tokens=int(d.get("output_tokens", spec.output_tokens)),
                payload_bytes=int(d.get("payload_bytes", spec.payload_bytes)),
                session_id=int(d.get("session_id", 0)),
                prefix_tokens=int(d.get("prefix_tokens",
                                        spec.prefix_tokens)),
                tenant=str(d.get("tenant", "")))
        for i, d in enumerate(rows)
    ]


def generate(spec: WorkloadSpec) -> List[Request]:
    if spec.tenants:
        # multi-tenant split: one merged, tenant-tagged stream (lazy
        # import — the scenario library sits above the serving layer)
        from repro_torch.scenarios.tenants import generate_multi_tenant
        return generate_multi_tenant(spec)
    if spec.kind == TRACE:
        return _load_trace(spec)
    rng = np.random.default_rng(spec.seed)
    times: List[float] = []
    if spec.kind == POISSON:
        t = 0.0
        while t < spec.duration_s:
            t += rng.exponential(1.0 / spec.rate)
            if t < spec.duration_s:
                times.append(t)
    elif spec.kind == UNIFORM:
        n = int(spec.rate * spec.duration_s)
        times = list(np.linspace(0, spec.duration_s, n, endpoint=False))
    elif spec.kind == BURST:
        t = 0.0
        period = spec.duration_s / 10.0
        while t < spec.duration_s:
            in_burst = (t % period) < spec.burst_fraction * period
            rate = spec.rate * (spec.burst_factor if in_burst else 1.0)
            t += rng.exponential(1.0 / rate)
            if t < spec.duration_s:
                times.append(t)
    elif spec.kind == RAMP:
        step_len = spec.duration_s / spec.ramp_steps
        for k, rate in enumerate(ramp_step_rates(spec)):
            t, end = k * step_len, (k + 1) * step_len
            while True:
                t += rng.exponential(1.0 / max(rate, 1e-9))
                if t >= end:
                    break
                times.append(t)
    elif spec.kind == CLOSED:
        # one seed request per client at t=0; the simulator reissues each
        # client's next request on completion until duration_s
        times = [0.0] * spec.concurrency
    elif spec.kind in (DIURNAL, FLASH, SWEEP):
        # scenario-library arrival processes (thinned non-homogeneous
        # Poisson / geometric saturation ladder)
        from repro_torch.scenarios import arrivals
        times = {DIURNAL: arrivals.diurnal_times,
                 FLASH: arrivals.flash_crowd_times,
                 SWEEP: arrivals.sweep_times}[spec.kind](spec, rng)
    else:
        raise ValueError(spec.kind)

    n = len(times)
    if spec.kind == CLOSED:
        # each closed-loop client is its own session (sticky routing keeps
        # a client's loop on one replica)
        sessions = np.arange(n)
    elif spec.session_count > 1:
        sessions = rng.integers(0, spec.session_count, size=n)
    else:
        sessions = np.zeros(n, dtype=int)
    if spec.output_tokens_max is None:
        # unbounded generation: the engine clamps by the model's max
        # sequence length (see UNBOUNDED_OUTPUT_TOKENS)
        outs = np.full(n, UNBOUNDED_OUTPUT_TOKENS, dtype=int)
    elif spec.output_tokens_max > spec.output_tokens:
        outs = rng.integers(spec.output_tokens, spec.output_tokens_max + 1,
                            size=n)
    else:
        outs = np.full(n, spec.output_tokens, dtype=int)
    # mixed prompt lengths only sample the rng when enabled, so legacy
    # workloads keep byte-identical request streams for a given seed
    if spec.prompt_tokens_max > spec.prompt_tokens:
        prompts = rng.integers(spec.prompt_tokens,
                               spec.prompt_tokens_max + 1, size=n)
    else:
        prompts = np.full(n, spec.prompt_tokens, dtype=int)
    prefix0 = max(spec.prefix_tokens, 0)
    return [
        Request(req_id=i, arrival_s=float(t),
                prompt_tokens=int(prompts[i]),
                output_tokens=int(outs[i]),
                payload_bytes=spec.payload_bytes,
                session_id=int(sessions[i]),
                prefix_tokens=min(prefix0, int(prompts[i])))
        for i, t in enumerate(times)
    ]
