"""Model configuration, a copy of ``repro.models.config`` with torch dtypes.

A config is pure data; ``repro_torch.models.registry`` interprets it.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

# Block kinds a layer can be (hybrids mix them).
ATTN_GLOBAL = "attn_global"
ATTN_LOCAL = "attn_local"
RGLRU = "rglru"
RWKV6 = "rwkv6"


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense | moe | hybrid | ssm | encdec | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                 # 0 → d_model // num_heads
    max_seq_len: int = 8192           # context limit (prompt + generation);
                                      # bounds serving KV-cache accounting

    # --- MoE ---------------------------------------------------------------
    num_experts: int = 0              # 0 → dense FFN
    experts_per_token: int = 0
    moe_capacity_factor: float = 1.25

    # --- attention variants --------------------------------------------------
    local_window: int = 0             # >0 → sliding-window size for local layers
    layer_pattern: Tuple[str, ...] = ()   # repeating block pattern; () → all global
    attn_logit_softcap: float = 0.0   # gemma2-style soft capping (0 = off)
    final_logit_softcap: float = 0.0
    rope_theta: float = 10_000.0

    # --- recurrent families ---------------------------------------------------
    rglru_d_rnn: int = 0              # RG-LRU recurrence width (0 → d_model)
    rwkv_head_dim: int = 64

    # --- encoder-decoder ------------------------------------------------------
    encoder_layers: int = 0           # >0 → enc-dec; num_layers = decoder layers

    # --- multimodal stub frontends -------------------------------------------
    frontend: str = "none"            # none | audio_frames | vision_patches
    num_frontend_tokens: int = 0      # patch/frame tokens supplied by input_specs

    # --- cost-accounting mode -------------------------------------------------
    # XLA's cost_analysis counts a while-loop body ONCE, so the dry-run
    # measures FLOPs/bytes on depth-reduced model variants with all scans
    # unrolled and extrapolates (see launch/dryrun.py).  This flag switches
    # every internal lax.scan to a Python loop; never set it for execution.
    cost_unroll: bool = False

    # --- numerics -------------------------------------------------------------
    dtype: str = "bfloat16"           # activation/compute dtype
    param_dtype: str = "float32"      # master parameter dtype (training)
    serve_param_dtype: str = "bfloat16"
    norm_eps: float = 1e-6

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // max(self.num_heads, 1))
        if self.family == "hybrid" and self.rglru_d_rnn == 0:
            object.__setattr__(self, "rglru_d_rnn", self.d_model)
        if not self.layer_pattern:
            object.__setattr__(self, "layer_pattern", (ATTN_GLOBAL,))

    # ---- derived properties --------------------------------------------------
    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def activation_dtype(self):
        return getattr(torch, self.dtype)

    def block_kind(self, layer_idx: int) -> str:
        return self.layer_pattern[layer_idx % len(self.layer_pattern)]

    def layer_kinds(self) -> Tuple[str, ...]:
        return tuple(self.block_kind(i) for i in range(self.num_layers))

    @property
    def sub_quadratic(self) -> bool:
        """True iff no layer does *global* full attention (long_500k eligible)."""
        return ATTN_GLOBAL not in set(self.layer_kinds())

    @property
    def q_per_kv(self) -> int:
        return max(self.num_heads // max(self.num_kv_heads, 1), 1)

    # ---- analytic parameter / FLOP accounting (for MODEL_FLOPS = 6·N·D) ----
    def param_count(self, active_only: bool = False) -> int:
        """Total (or routed-active) parameter count, analytic."""
        d, h, k, hd, ff = (self.d_model, self.num_heads, self.num_kv_heads,
                           self.head_dim, self.d_ff)
        embed = self.vocab_size * d
        n = embed  # tied output head assumed untied → add once more below
        n += embed  # lm head
        kinds = self.layer_kinds()
        for kind in kinds:
            if kind in (ATTN_GLOBAL, ATTN_LOCAL):
                n += d * h * hd + 2 * d * k * hd + h * hd * d   # q, k+v, o
            elif kind == RGLRU:
                r = self.rglru_d_rnn
                n += 2 * d * r + r * d + 3 * r                  # in x/y, out, gates
            elif kind == RWKV6:
                n += 4 * d * d + 6 * d                          # r,k,v,o + mix/decay
            # FFN (every layer has one in all assigned archs)
            if self.is_moe:
                e = self.experts_per_token if active_only else self.num_experts
                n += e * 3 * d * ff + d * self.num_experts      # experts + router
            else:
                n += 3 * d * ff                                 # gated MLP
        if self.is_encdec:
            # encoder self-attn + mlp per encoder layer, decoder cross-attn
            enc = self.encoder_layers * (4 * d * h * hd + 3 * d * ff)
            cross = self.num_layers * (d * h * hd + 2 * d * k * hd + h * hd * d)
            n += enc + cross
        return int(n)

    def model_flops_per_token(self, active_only: bool = True) -> float:
        """6·N (dense) or 6·N_active (MoE) per trained token."""
        return 6.0 * self.param_count(active_only=active_only)


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """A tiny same-family config for CPU smoke tests."""
    base = dict(
        num_layers=min(cfg.num_layers, 2 * len(cfg.layer_pattern)),
        d_model=64,
        num_heads=4,
        num_kv_heads=min(cfg.num_kv_heads, 2),
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        num_experts=min(cfg.num_experts, 4) if cfg.is_moe else 0,
        experts_per_token=min(cfg.experts_per_token, 2) if cfg.is_moe else 0,
        local_window=min(cfg.local_window, 16) if cfg.local_window else 0,
        rglru_d_rnn=64 if cfg.family == "hybrid" else 0,
        rwkv_head_dim=16,
        encoder_layers=min(cfg.encoder_layers, 2) if cfg.is_encdec else 0,
        num_frontend_tokens=min(cfg.num_frontend_tokens, 8),
        dtype="float32",
        param_dtype="float32",
        serve_param_dtype="float32",
    )
    base.update(overrides)
    return dataclasses.replace(cfg, name=cfg.name + "-smoke", **base)
