"""Latency oracles and the measuring clock, ported from
``repro.serving.latency_model`` — only what the kernel-calibration backend
needs: the serving speed modes, the shared ``LatencyOracle`` composition,
the calibrated ``FittedLatencyModel`` and ``MeasuredLatency``.  The
analytic roofline ``LatencyModel`` needs the port's parameter accounting
and is not here yet.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch import hw as hw_lib

COLD_START_CONST_S = 2.0       # runtime + compile cache init


# --- speed modes ------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class SpeedMode:
    """A serving *speed mode*: a named bundle of roofline scale factors
    plus an optional speculative-decoding model.

    Quantization is expressed as byte/FLOP scale factors applied to the
    roofline terms of an oracle (``weight_bytes_scale`` and
    ``kv_bytes_scale`` shrink the memory terms and the KV footprint;
    ``compute_scale`` models quant/dequant overhead on the compute term).
    Speculative decoding is a draft/verify cycle: a draft model proposes
    ``draft_len`` tokens at ``draft_cost_frac`` of a target decode step
    each, the target verifies them in one step, and on average
    ``expected_tokens_per_cycle()`` tokens are emitted per cycle — so the
    effective per-token decode latency is the base latency times
    ``decode_cost_factor()``.

    Attributes (all scales dimensionless):
        name: mode identifier ("fp16", "int8", "speculative", ...).
        weight_bytes_scale: resident-weight bytes multiplier (int8 = 0.5
            of bf16).
        kv_bytes_scale: per-token KV-cache bytes multiplier.
        compute_scale: FLOP-term multiplier (> 1 models quantize /
            dequantize overhead).
        draft_len: speculative draft tokens per cycle (k); 0 disables
            speculation.
        acceptance_rate: probability a ∈ [0, 1] each draft token is
            accepted (position-independent, the standard geometric model).
        draft_cost_frac: cost of one draft-model step as a fraction of a
            target decode step.
    """
    name: str = "fp16"
    weight_bytes_scale: float = 1.0
    kv_bytes_scale: float = 1.0
    compute_scale: float = 1.0
    draft_len: int = 0
    acceptance_rate: float = 0.0
    draft_cost_frac: float = 1.0

    def __post_init__(self):
        if not (0.0 < self.weight_bytes_scale
                and 0.0 < self.kv_bytes_scale
                and 0.0 < self.compute_scale):
            raise ValueError(f"speed mode {self.name!r}: scale factors "
                             "must be positive")
        if self.draft_len < 0:
            raise ValueError(f"speed mode {self.name!r}: draft_len must "
                             "be >= 0")
        if not 0.0 <= self.acceptance_rate <= 1.0:
            raise ValueError(f"speed mode {self.name!r}: acceptance_rate "
                             "must be in [0, 1]")
        if self.draft_cost_frac < 0.0:
            raise ValueError(f"speed mode {self.name!r}: draft_cost_frac "
                             "must be >= 0")

    @property
    def is_identity(self) -> bool:
        """True when the mode changes nothing (vanilla fp16 serving)."""
        return (self.weight_bytes_scale == 1.0
                and self.kv_bytes_scale == 1.0
                and self.compute_scale == 1.0
                and self.draft_len == 0)

    def expected_tokens_per_cycle(self) -> float:
        """E[tokens emitted per draft/verify cycle] = (1-a^(k+1))/(1-a):
        the accepted prefix plus the verifier's one corrected/bonus token."""
        k, a = self.draft_len, self.acceptance_rate
        if k <= 0:
            return 1.0
        if a >= 1.0:
            return float(k + 1)
        return (1.0 - a ** (k + 1)) / (1.0 - a)

    def decode_cost_factor(self) -> float:
        """Multiplier on base decode latency per *emitted* token: a cycle
        costs ``1 + draft_len·draft_cost_frac`` target steps and emits
        ``expected_tokens_per_cycle()`` tokens."""
        if self.draft_len <= 0:
            return 1.0
        cycle_cost = 1.0 + self.draft_len * self.draft_cost_frac
        return cycle_cost / self.expected_tokens_per_cycle()

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "SpeedMode":
        return cls(**d)


#: Named presets resolved by string, the reference's: ``int8`` halves
#: weight + KV bytes with a small dequant compute penalty; ``speculative``
#: uses a 4-token draft at 30% of target step cost with ~0.7 acceptance.
SPEED_MODES: Dict[str, SpeedMode] = {
    "fp16": SpeedMode("fp16"),
    "int8": SpeedMode("int8", weight_bytes_scale=0.5, kv_bytes_scale=0.5,
                      compute_scale=1.05),
    "speculative": SpeedMode("speculative", draft_len=4,
                             acceptance_rate=0.7, draft_cost_frac=0.3),
}


def resolve_speed_mode(mode, overrides: Optional[dict] = None) -> SpeedMode:
    """Coerce ``mode`` (SpeedMode | name | dict | None) to a SpeedMode.

    ``overrides`` maps mode names to parameter dicts (e.g. calibrated
    values from a profile's ``speed_modes`` section) consulted before
    the built-in :data:`SPEED_MODES` presets.
    """
    if mode is None:
        return SPEED_MODES["fp16"]
    if isinstance(mode, SpeedMode):
        return mode
    if isinstance(mode, dict):
        return SpeedMode.from_dict(mode)
    if isinstance(mode, str):
        if overrides and mode in overrides:
            ov = dict(overrides[mode])
            ov.setdefault("name", mode)
            return SpeedMode.from_dict(ov)
        if mode in SPEED_MODES:
            return SPEED_MODES[mode]
        raise KeyError(f"unknown speed mode {mode!r} "
                       f"(known: {sorted(SPEED_MODES)})")
    raise TypeError(f"cannot resolve speed mode from {type(mode).__name__}")


class LatencyOracle:
    """Shared per-request composition over a prefill/decode split.

    Concrete oracles supply ``prefill_latency(batch, prompt)`` and
    ``decode_latency(batch, context)``; everything composed on top of those
    is defined once here, memoized per oracle (latencies are pure functions
    of their arguments; the cap bounds memory when every shape differs).
    """
    hw: hw_lib.HardwareModel
    chips: int

    _CACHE_CAP = 1 << 20

    def prefill_latency(self, batch: int, prompt: int) -> float:
        raise NotImplementedError

    def decode_latency(self, batch: int, context: int) -> float:
        raise NotImplementedError

    def iteration_latency(self, n_prefill: int, prompt: int,
                          n_decode: int, max_context: int) -> float:
        """One continuous-batching engine iteration (Orca-style): prefill
        the requests joining this boundary, then one decode step for the
        whole running batch."""
        cache = getattr(self, "_iter_cache", None)
        if cache is None:
            cache = self._iter_cache = {}
        key = (n_prefill, prompt, n_decode, max_context)
        t = cache.get(key)
        if t is None:
            t = 0.0
            if n_prefill > 0:
                t += self.prefill_latency(n_prefill, prompt)
            if n_decode > 0:
                t += self.decode_latency(n_decode, max(max_context, 1))
            if len(cache) < self._CACHE_CAP:
                cache[key] = t
        return t

    def request_latency(self, batch: int, prompt: int, out_tokens: int) -> float:
        cache = getattr(self, "_req_cache", None)
        if cache is None:
            cache = self._req_cache = {}
        key = (batch, prompt, out_tokens)
        t = cache.get(key)
        if t is None:
            t = self.prefill_latency(batch, prompt)
            for i in range(out_tokens - 1):
                t += self.decode_latency(batch, prompt + i)
            if len(cache) < self._CACHE_CAP:
                cache[key] = t
        return t


@dataclasses.dataclass
class FittedLatencyModel(LatencyOracle):
    """Parametric latency oracle backed by calibrated coefficients:

        prefill(b, s) = p0 + p1·(b·s) + p2·(b·s²)
        decode(b, c)  = d0 + α·b + β·(b·c)

    ``p1`` is the prefill FLOPs term, ``p2`` the quadratic-attention term;
    ``α`` the per-sequence decode-step cost and ``β`` the per-cached-token
    (KV read) cost.  Latencies are clamped to a small positive floor so a
    degenerate fit can never stall a simulator.
    """
    prefill_coef: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    decode_coef: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    hw: hw_lib.HardwareModel = hw_lib.GPU_H100
    chips: int = 1
    cold_start_s: float = COLD_START_CONST_S
    name: str = "fitted"

    _FLOOR_S = 1e-9

    def prefill_latency(self, batch: int, prompt: int) -> float:
        p0, p1, p2 = self.prefill_coef
        toks = batch * prompt
        return max(p0 + p1 * toks + p2 * toks * prompt, self._FLOOR_S)

    def decode_latency(self, batch: int, context: int) -> float:
        d0, alpha, beta = self.decode_coef
        return max(d0 + alpha * batch + beta * batch * context,
                   self._FLOOR_S)

    def cold_start(self) -> float:
        return self.cold_start_s

    def with_speed_mode(self, mode: SpeedMode) -> "FittedLatencyModel":
        """Re-derive the fitted coefficients under ``mode``, by each
        coefficient's roofline meaning: decode ``d0`` (weight read) ×
        ``weight_bytes_scale``, ``α`` × ``compute_scale``, ``β`` (KV read) ×
        ``kv_bytes_scale``, the whole decode step × ``decode_cost_factor()``;
        prefill is compute-bound, so only its token terms scale."""
        p0, p1, p2 = self.prefill_coef
        d0, alpha, beta = self.decode_coef
        cs, f = mode.compute_scale, mode.decode_cost_factor()
        return dataclasses.replace(
            self,
            prefill_coef=(p0, p1 * cs, p2 * cs),
            decode_coef=(d0 * mode.weight_bytes_scale * f,
                         alpha * cs * f,
                         beta * mode.kv_bytes_scale * f),
            name=f"{self.name}+{mode.name}")

    @classmethod
    def from_profile(cls, profile) -> "FittedLatencyModel":
        """Build the oracle from a ``CalibrationProfile``, its dict form,
        a profile JSON path, or a ``model@hardware`` key resolved in the
        default profile directory."""
        from repro_torch.calibrate.profile import CalibrationProfile, load_profile
        if isinstance(profile, dict):
            profile = CalibrationProfile.from_dict(profile)
        elif not isinstance(profile, CalibrationProfile):
            profile = load_profile(profile)
        if profile.hardware not in hw_lib.HARDWARE:
            raise ValueError(
                f"profile {profile.key!r} names unknown hardware "
                f"{profile.hardware!r} (known: {sorted(hw_lib.HARDWARE)}) — "
                "costs/energy would be computed for the wrong machine")
        return cls(prefill_coef=tuple(profile.prefill.coef),
                   decode_coef=tuple(profile.decode.coef),
                   hw=hw_lib.HARDWARE[profile.hardware], chips=profile.chips,
                   cold_start_s=profile.cold_start_s,
                   name=profile.key)


def _wait(out) -> None:
    """Wait for the card where ``out`` (a tensor, or a tuple or list whose
    first item is one) lives on it; a CPU result is already computed."""
    while isinstance(out, (tuple, list)) and out:
        out = out[0]
    if isinstance(out, torch.Tensor) and out.is_cuda:
        torch.cuda.synchronize(out.device)


@dataclasses.dataclass
class MeasuredLatency:
    """Wall-clock a real callable, waiting for the card after each call.

    ``reducer="mean"`` (default) averages one timed loop; ``reducer="min"``
    times each iteration and takes the fastest — the noise-robust estimator
    the calibration microbenchmarks use (scheduler jitter only ever adds
    time).
    """
    fn: Callable
    warmup: int = 2
    iters: int = 5
    reducer: str = "mean"

    def measure(self, *args) -> float:
        for _ in range(self.warmup):
            _wait(self.fn(*args))
        if self.reducer == "min":
            best = math.inf
            for _ in range(self.iters):
                t0 = time.perf_counter()
                _wait(self.fn(*args))
                best = min(best, time.perf_counter() - t0)
            return best
        t0 = time.perf_counter()
        for _ in range(self.iters):
            _wait(self.fn(*args))
        return (time.perf_counter() - t0) / self.iters
