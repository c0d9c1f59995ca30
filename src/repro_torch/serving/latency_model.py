"""Latency oracles and the measuring clock, ported from
``repro.serving.latency_model``: the analytic roofline ``LatencyModel``
(on the port's parameter accounting, ``repro_torch.models.registry``), the
serving speed modes, the shared ``LatencyOracle`` composition, the
calibrated ``FittedLatencyModel``, ``MeasuredLatency`` (which waits for the
card), and the network models of the pipeline tier and of multi-region
serving.  Everything but ``MeasuredLatency`` is the reference's arithmetic,
unchanged.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch import hw as hw_lib
from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import (build_model, count_params,
                                         model_flops_per_token, param_shapes)

LAUNCH_OVERHEAD_S = 50e-6      # dispatch + DMA warmup per device step
COLD_START_DISK_BW = 2e9       # bytes/s from checkpoint storage
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


def apply_speed_mode(oracle: "LatencyOracle", mode) -> "LatencyOracle":
    """Return an oracle serving under ``mode`` (identity modes pass the
    oracle through untouched).

    Oracles that know their roofline decomposition
    (:class:`LatencyModel`, :class:`FittedLatencyModel`) implement
    ``with_speed_mode`` and get exact per-term scaling; anything else is
    wrapped in a conservative :class:`SpeedModeOracle`.
    """
    mode = resolve_speed_mode(mode)
    if mode.is_identity:
        return oracle
    with_mode = getattr(oracle, "with_speed_mode", None)
    if with_mode is not None:
        return with_mode(mode)
    return SpeedModeOracle(oracle, mode)


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
class LatencyModel(LatencyOracle):
    """Analytic roofline oracle for ``cfg`` served on ``chips`` × ``hw``.

    Attributes:
        cfg: architecture being served.
        hw: hardware model (peak FLOPs, HBM bandwidth, $/hr).
        chips: chips per replica (weights + KV sharded across them).
        serve_bytes_per_param: resident bytes per weight (2.0 = bf16).
        int8: legacy shim — sets ``serve_bytes_per_param`` to 1.0
            (weight-only quantization; superseded by ``speed_mode``).
        speed_mode: optional :class:`SpeedMode` scaling the roofline
            terms (weights/KV/compute) and the effective decode step.
    """
    cfg: ModelConfig
    hw: hw_lib.HardwareModel = hw_lib.TPU_V5E
    chips: int = 1
    serve_bytes_per_param: float = 2.0     # bf16 weights
    int8: bool = False
    speed_mode: Optional[SpeedMode] = None

    def __post_init__(self):
        self.flops_per_token = model_flops_per_token(self.cfg) / 3.0  # fwd
        # count every param (incl. all experts) for weight traffic; the
        # shapes come from a model on the meta device, which allocates
        # nothing
        self.n_params = count_params(param_shapes(build_model(self.cfg, "meta")))
        if self.int8:
            self.serve_bytes_per_param = 1.0
        mode = self.speed_mode
        self._compute_scale = mode.compute_scale if mode else 1.0
        self._kv_scale = mode.kv_bytes_scale if mode else 1.0
        self._weight_scale = mode.weight_bytes_scale if mode else 1.0
        self._decode_factor = mode.decode_cost_factor() if mode else 1.0
        # per-model constants the simulator's hot path would otherwise
        # re-derive on every engine iteration (layer_kinds() builds a
        # fresh tuple per call); values and accumulation order are
        # unchanged, so latencies stay bit-identical
        kinds = self.cfg.layer_kinds()
        self._attn_kinds = tuple(k for k in kinds
                                 if k in ("attn_global", "attn_local"))
        self._n_attn = sum(k.startswith("attn") for k in kinds)
        self._weight_bytes = (self.n_params * self.serve_bytes_per_param
                              * self._weight_scale)

    def with_speed_mode(self, mode: SpeedMode) -> "LatencyModel":
        """This model re-derived under ``mode`` (fresh latency caches)."""
        return dataclasses.replace(self, speed_mode=mode)

    # ---- analytic per-phase latencies -----------------------------------
    def _kv_bytes_per_token(self) -> float:
        # decode_latency calls this once per engine iteration — memoize
        # the (deterministic) model-config derivation instead of paying a
        # module import + recompute on the simulator's hot path
        v = getattr(self, "_kv_bpt", None)
        if v is None:
            from repro_torch.analysis.memory_model import kv_bytes_per_token
            v = self._kv_bpt = kv_bytes_per_token(self.cfg) * self._kv_scale
        return v

    # ---- memory-subsystem hooks (repro_torch.serving.memory) -------------
    def kv_bytes_per_token(self) -> float:
        """Public alias for the per-token KV footprint (memory accounting)."""
        return self._kv_bytes_per_token()

    def weight_bytes(self) -> float:
        """Resident serving weights on one replica (all chips pooled)."""
        return self._weight_bytes

    def prefill_latency(self, batch: int, prompt: int) -> float:
        cfg = self.cfg
        flops = batch * prompt * self.flops_per_token
        # quadratic attention term (windowed layers capped at the window)
        for kind in self._attn_kinds:
            if kind == "attn_global":
                span = prompt
            else:                       # attn_local
                span = min(cfg.local_window or prompt, prompt)
            flops += 4 * batch * prompt * span * cfg.num_heads * cfg.head_dim / 2
        act_bytes = 8 * batch * prompt * cfg.d_model * 2.0 * cfg.num_layers
        compute_s = flops * self._compute_scale \
            / (self.chips * self.hw.peak_flops)
        memory_s = (self._weight_bytes / self.chips + act_bytes / self.chips) \
            / self.hw.hbm_bw
        return max(compute_s, memory_s) + LAUNCH_OVERHEAD_S

    def decode_latency(self, batch: int, context: int) -> float:
        cfg = self.cfg
        flops = batch * self.flops_per_token
        flops += 4 * batch * min(context, 1 << 30) * cfg.num_heads \
            * cfg.head_dim * self._n_attn
        kv_bytes = batch * context * self._kv_bytes_per_token()
        compute_s = flops * self._compute_scale \
            / (self.chips * self.hw.peak_flops)
        memory_s = (self._weight_bytes + kv_bytes) \
            / (self.chips * self.hw.hbm_bw)
        return (max(compute_s, memory_s) + LAUNCH_OVERHEAD_S) \
            * self._decode_factor

    def cold_start(self) -> float:
        return COLD_START_CONST_S + self._weight_bytes \
            / (self.chips * COLD_START_DISK_BW)

    def to_profile(self, *, batches=(1, 2, 4, 8, 16),
                   seqs=(32, 64, 128, 256), contexts=None,
                   holdout_fraction: float = 0.0):
        """Fit this oracle's analytic grid into a calibration profile
        (``repro_torch.calibrate`` round-trip — see ``CalibrationProfile``)."""
        from repro_torch.calibrate.fit import fit_records
        from repro_torch.calibrate.microbench import oracle_records
        records = oracle_records(self, batches=batches, seqs=seqs,
                                 contexts=contexts)
        return fit_records(
            records, model=self.cfg.name, hardware=self.hw.name,
            chips=self.chips, source="oracle",
            holdout_fraction=holdout_fraction,
            cold_start_s=self.cold_start())


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


class SpeedModeOracle(LatencyOracle):
    """Generic :class:`SpeedMode` wrapper for oracles without a native
    ``with_speed_mode``.

    Without a roofline decomposition the byte scales cannot be applied
    per-term, so the wrapper is conservative: prefill scales by
    ``compute_scale`` only, decode by ``max(compute_scale,
    kv_bytes_scale)`` times the speculative ``decode_cost_factor()``.
    KV/weight memory hooks are forwarded scaled when the base oracle
    exposes them.
    """

    def __init__(self, base: LatencyOracle, mode: SpeedMode):
        self.base = base
        self.mode = mode
        # duck-typed bases (tests, ad-hoc oracles) may not carry hardware
        # identity; fall back to the oracle defaults so cost accounting
        # still runs
        self.hw = getattr(base, "hw", None) or hw_lib.HARDWARE["tpu-v5e"]
        self.chips = getattr(base, "chips", 1)
        self._decode_scale = (max(mode.compute_scale, mode.kv_bytes_scale)
                              * mode.decode_cost_factor())

    def prefill_latency(self, batch: int, prompt: int) -> float:
        return self.base.prefill_latency(batch, prompt) \
            * self.mode.compute_scale

    def decode_latency(self, batch: int, context: int) -> float:
        return self.base.decode_latency(batch, context) * self._decode_scale

    # memory hooks exist only when the base oracle has them, so the
    # duck-typed probes in repro_torch.serving.memory behave as if they were
    # looking at the base directly
    def __getattr__(self, name):
        if name in ("base", "mode"):       # guard pre-__init__ recursion
            raise AttributeError(name)
        if name == "kv_bytes_per_token":
            base_fn = self.base.kv_bytes_per_token
            return lambda: base_fn() * self.mode.kv_bytes_scale
        if name == "weight_bytes":
            base_fn = self.base.weight_bytes
            return lambda: base_fn() * self.mode.weight_bytes_scale
        if name == "cold_start":
            return self.base.cold_start
        raise AttributeError(name)


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


# --- network models for the pipeline tier (paper Fig. 14) ------------------
@dataclasses.dataclass(frozen=True)
class NetworkModel:
    name: str
    bandwidth_bps: float
    rtt_s: float
    jitter_s: float = 0.0

    def transmit(self, payload_bytes: int) -> float:
        return self.rtt_s + payload_bytes * 8 / self.bandwidth_bps


NETWORKS: Dict[str, NetworkModel] = {
    "lan": NetworkModel("lan", 10e9, 0.0002),
    "wifi": NetworkModel("wifi", 100e6, 0.004),
    "4g": NetworkModel("4g", 20e6, 0.045),
    # datacenter interconnects for the disaggregated prefill→decode
    # KV-cache handoff (bytes = kv_bytes_per_token × prompt_tokens)
    "infiniband": NetworkModel("infiniband", 400e9, 5e-6),
    "nvlink": NetworkModel("nvlink", 7.2e12, 2e-6),
}


# --- multi-region serving (heterogeneous pools with a region tag) -----------
#: WAN links between serving regions, keyed by unordered region pair.
#: ``simulate_cluster`` charges the link's transmit time to a request
#: whenever the router sends it to a pool outside the cluster's
#: front-door region (the first pool's region).  RTTs follow typical
#: public inter-region latency matrices; per-flow bandwidth is the
#: practical WAN share, not the trunk capacity.
INTER_REGION_NETWORKS: Dict[tuple, NetworkModel] = {
    ("us-central", "us-east"): NetworkModel("us-central<->us-east",
                                            25e9, 0.032),
    ("us-central", "eu-west"): NetworkModel("us-central<->eu-west",
                                            10e9, 0.105),
    ("us-east", "eu-west"): NetworkModel("us-east<->eu-west", 12e9, 0.078),
    ("us-central", "asia-east"): NetworkModel("us-central<->asia-east",
                                              8e9, 0.140),
    ("us-east", "asia-east"): NetworkModel("us-east<->asia-east",
                                           8e9, 0.170),
    ("eu-west", "asia-east"): NetworkModel("eu-west<->asia-east",
                                           6e9, 0.210),
}

#: Fallback link for region pairs not in the table (same order of
#: magnitude as a cross-continent hop).
DEFAULT_INTER_REGION = NetworkModel("inter-region", 10e9, 0.080)


def inter_region_network(a: str, b: str) -> Optional[NetworkModel]:
    """The WAN link between regions ``a`` and ``b``, or None when the
    hop stays inside one region (same name, or either side unset —
    region-less pools are co-located with the front door)."""
    if not a or not b or a == b:
        return None
    return (INTER_REGION_NETWORKS.get((a, b))
            or INTER_REGION_NETWORKS.get((b, a))
            or DEFAULT_INTER_REGION)


def oracle_for_hardware(base: LatencyOracle, hardware: str = "",
                        chips: int = 0) -> LatencyOracle:
    """Re-target a latency oracle at another hardware catalog entry.

    The per-pool plumbing of heterogeneous clusters: a pool that names
    its own ``hardware``/``chips`` gets the *same analytic model* served
    on that chip (fresh roofline terms and latency caches via
    ``dataclasses.replace``).  When the pool matches the base oracle the
    base is returned as-is, sharing its memoized latency caches.

    Fitted oracles embed one machine's measured coefficients, so they
    cannot be re-targeted analytically — pools backed by a
    :class:`FittedLatencyModel` must supply their own per-hardware
    profile (``PoolSpec.profile``) instead.
    """
    base_hw = getattr(base, "hw", None)
    base_chips = getattr(base, "chips", 1)
    hw_name = hardware or (base_hw.name if base_hw is not None else "")
    n_chips = chips or base_chips
    if base_hw is not None and hw_name == base_hw.name \
            and n_chips == base_chips:
        return base
    if hw_name not in hw_lib.HARDWARE:
        raise ValueError(f"unknown hardware {hw_name!r} "
                         f"(known: {sorted(hw_lib.HARDWARE)})")
    if not isinstance(base, LatencyModel):
        raise ValueError(
            f"cannot re-target a {type(base).__name__} oracle at "
            f"{hw_name!r}: fitted/measured oracles embed one machine's "
            "coefficients — give the pool its own calibrated profile "
            "for that hardware")
    return dataclasses.replace(base, hw=hw_lib.HARDWARE[hw_name],
                               chips=n_chips)
