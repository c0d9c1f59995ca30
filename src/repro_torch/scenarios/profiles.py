"""Named production traffic profiles (the scenario registry), a copy of
``repro.scenarios.profiles`` with the same catalog.

A :class:`ScenarioProfile` binds the knobs that distinguish production
use cases — prompt/output token distributions, session/prefix
structure, payload size, and the SLOs each use case is judged by — so a
benchmark job names the scenario instead of re-deriving the numbers:

    {"job_id": "j0", "scenario": "chat", "workload": {"rate": 100}}

``BenchmarkJobSpec`` resolves the name at construction: profile values
fill every workload field the config left at its default, and the
profile's SLOs become the job's SLOs unless the config sets its own.
Explicit config values always win — the profile is a vocabulary of
defaults, not an override.

Token distributions map onto the uniform ``[min, max]`` samplers the
workload layer already has (``prompt_tokens``/``prompt_tokens_max``,
``output_tokens``/``output_tokens_max``); session structure maps onto
``session_count``/``prefix_tokens`` (shared system prompt + history —
the prefix cache's food).  The catalog numbers follow the shapes
production benchmarks report (inference-perf's use-case presets,
inference-benchmarker's chat/code/fixed profiles): chat is mid-prompt /
mid-decode with heavy prefix sharing, code generation is long-prompt /
long-decode, summarization is very-long-prompt / short-decode,
classification is single-token decode, RAG stuffs retrieved context
into the prompt with a shared corpus preamble.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from repro_torch.serving.workload import WorkloadSpec

# workload fields a profile provides defaults for
_WORKLOAD_FIELDS = ("prompt_tokens", "prompt_tokens_max", "output_tokens",
                    "output_tokens_max", "prefix_tokens", "session_count",
                    "payload_bytes")
_DEFAULTS = WorkloadSpec()


@dataclasses.dataclass(frozen=True)
class ScenarioProfile:
    """One named production scenario.

    ``prompt_tokens``/``prompt_tokens_max`` and ``output_tokens``/
    ``output_tokens_max`` are uniform-distribution bounds (``max`` of 0
    means fixed length); ``prefix_tokens`` is the per-session shared
    prompt prefix; the ``slo_*`` fields are the defaults a job inherits
    when it names this scenario without declaring its own SLOs.
    """
    name: str
    description: str
    prompt_tokens: int
    prompt_tokens_max: int = 0
    output_tokens: int = 1
    output_tokens_max: int = 0
    prefix_tokens: int = 0
    session_count: int = 4
    payload_bytes: int = 4 * 1024
    slo_ttft_s: Optional[float] = None
    slo_tpot_s: Optional[float] = None
    slo_e2e_s: Optional[float] = None

    def workload_overrides(self) -> Dict[str, int]:
        """The profile's values for the workload fields it governs."""
        return {f: getattr(self, f) for f in _WORKLOAD_FIELDS}

    def apply_to_workload(self, wl: WorkloadSpec) -> WorkloadSpec:
        """Fill profile values into every governed field the spec left
        at its dataclass default (explicit config values win).
        Idempotent: re-applying to an already-resolved spec is a
        no-op."""
        over = {f: v for f, v in self.workload_overrides().items()
                if getattr(wl, f) == getattr(_DEFAULTS, f)}
        return dataclasses.replace(wl, **over) if over else wl

    def slos(self) -> Dict[str, Optional[float]]:
        return {"slo_ttft_s": self.slo_ttft_s, "slo_tpot_s": self.slo_tpot_s,
                "slo_latency_s": self.slo_e2e_s}


_REGISTRY: Dict[str, ScenarioProfile] = {}


def register_profile(profile: ScenarioProfile,
                     overwrite: bool = False) -> ScenarioProfile:
    """Add a profile to the registry (site-local scenarios welcome)."""
    if profile.name in _REGISTRY and not overwrite:
        raise ValueError(f"scenario {profile.name!r} is already registered "
                         "(pass overwrite=True to replace it)")
    _REGISTRY[profile.name] = profile
    return profile


def get_profile(name: str) -> ScenarioProfile:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown scenario {name!r} "
                         f"(registered: {sorted(_REGISTRY)})") from None


def list_profiles() -> List[str]:
    return sorted(_REGISTRY)


def catalog_table() -> str:
    """Human-readable catalog (README / example output)."""
    cols = (f"{'scenario':>18}{'prompt tok':>12}{'output tok':>12}"
            f"{'prefix':>8}{'sessions':>10}{'ttft':>7}{'tpot':>7}"
            f"{'e2e':>6}")
    lines = ["scenario catalog (token ranges are uniform [min, max])", cols]
    for name in list_profiles():
        p = _REGISTRY[name]
        rng = (lambda lo, hi: f"{lo}-{hi}" if hi > lo else f"{lo}")
        fmt = (lambda v, scale=1.0:
               f"{v * scale:g}" if v is not None else "-")
        lines.append(
            f"{name:>18}{rng(p.prompt_tokens, p.prompt_tokens_max):>12}"
            f"{rng(p.output_tokens, p.output_tokens_max):>12}"
            f"{p.prefix_tokens:>8}{p.session_count:>10}"
            f"{fmt(p.slo_ttft_s):>7}{fmt(p.slo_tpot_s):>7}"
            f"{fmt(p.slo_e2e_s):>6}")
    return "\n".join(lines)


# ---- the built-in catalog --------------------------------------------------
register_profile(ScenarioProfile(
    name="chat",
    description="Interactive chat assistant: mid-length prompts carrying "
                "the running conversation, heavy per-session prefix "
                "sharing (system prompt + history), streaming decode "
                "judged by TTFT/TPOT.",
    prompt_tokens=256, prompt_tokens_max=1024,
    output_tokens=64, output_tokens_max=512,
    prefix_tokens=192, session_count=32, payload_bytes=4 * 1024,
    slo_ttft_s=0.5, slo_tpot_s=0.05))

register_profile(ScenarioProfile(
    name="code-generation",
    description="IDE / agent code completion: long prompts (file context "
                "+ instructions), long generations, a shared repo-level "
                "preamble per session; tolerant TTFT, tight TPOT.",
    prompt_tokens=512, prompt_tokens_max=4096,
    output_tokens=128, output_tokens_max=1024,
    prefix_tokens=256, session_count=16, payload_bytes=16 * 1024,
    slo_ttft_s=1.0, slo_tpot_s=0.04))

register_profile(ScenarioProfile(
    name="summarization",
    description="Document summarization: very long prompts, short "
                "outputs, no cross-request prefix reuse; prefill-bound, "
                "judged mostly by TTFT/e2e.",
    prompt_tokens=2048, prompt_tokens_max=6144,
    output_tokens=64, output_tokens_max=256,
    prefix_tokens=0, session_count=8, payload_bytes=64 * 1024,
    slo_ttft_s=2.0, slo_tpot_s=0.06, slo_e2e_s=20.0))

register_profile(ScenarioProfile(
    name="classification",
    description="Single-token classification / moderation: short fixed "
                "prompts, one decode step, judged by end-to-end latency "
                "(the paper's image-classification regime).",
    prompt_tokens=64, prompt_tokens_max=256,
    output_tokens=1, output_tokens_max=0,
    prefix_tokens=0, session_count=4, payload_bytes=2 * 1024,
    slo_e2e_s=0.2))

register_profile(ScenarioProfile(
    name="rag-long-context",
    description="Retrieval-augmented generation: retrieved chunks stuff "
                "the prompt toward the context limit, a large shared "
                "corpus preamble per session feeds the prefix cache, "
                "short grounded answers.",
    prompt_tokens=3072, prompt_tokens_max=7168,
    output_tokens=64, output_tokens_max=256,
    prefix_tokens=2048, session_count=16, payload_bytes=32 * 1024,
    slo_ttft_s=2.5, slo_tpot_s=0.06))
