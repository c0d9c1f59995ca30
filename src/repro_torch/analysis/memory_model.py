"""Analytic per-device HBM-traffic model (TPU-fused counterpart to the
CPU-XLA "bytes accessed" figure).

CPU XLA materialises f32 attention-logit and CE-logit intermediates that
the TPU path (Pallas flash kernels, fused chunked CE) never writes to HBM,
so the measured bytes overstate the memory term by 5–20×.  This model
counts the traffic a well-fused TPU program actually pays:

  train   ≈ 8·P  (params fwd+bwd reads, grad write, Adam m/v r/w, param write)
          + L·C_act·A      per-layer residual/QKVO streams incl. remat reread
          + CE logits chunk traffic (bf16, fwd+bwd)
  prefill ≈ P + L·C_pre·A + cache write
  decode  ≈ P + cache read+write + batch·d streams

A = B_dev·S·d_model·act_bytes.  C_act = 24 (fwd ~8 streams, bwd ~12,
remat reread ~4), C_pre = 8.  The constants are documented estimates, not
fits; both the measured-HLO and model terms are reported side by side in
EXPERIMENTS.md §Roofline.

A copy of ``repro.analysis.memory_model``, importing only ``repro_torch``.
"""
from __future__ import annotations

from typing import Dict

from repro_torch import hw as hw_lib
from repro_torch.configs.shapes import DECODE, PREFILL, TRAIN, ShapeSpec
from repro_torch.models.config import ModelConfig

C_ACT_TRAIN = 24.0
C_ACT_PREFILL = 8.0


def estimate_bytes(kind: str, cfg: ModelConfig, shape: ShapeSpec,
                   mem_info: Dict[str, float]) -> float:
    """Per-device HBM bytes for one step under TPU-grade fusion."""
    P = mem_info["params_bytes"]
    O = mem_info.get("opt_bytes", 0.0)
    C = mem_info.get("cache_bytes", 0.0)
    b_dev = mem_info["batch_dev"]
    act_bytes = 2.0 if "float32" not in cfg.dtype else 4.0
    A = b_dev * shape.seq_len * cfg.d_model * act_bytes
    L = cfg.num_layers + cfg.encoder_layers
    v_shard = mem_info.get("vocab_shard_bytes_per_token", 0.0)

    if kind == TRAIN:
        # params fwd + bwd + grads + m/v read/write + write-back (O≈2P f32)
        weight_traffic = 4.0 * P + 2.0 * O
        act_traffic = L * C_ACT_TRAIN * A
        ce_traffic = 4.0 * b_dev * shape.seq_len * v_shard
        return weight_traffic + act_traffic + ce_traffic
    if kind == PREFILL:
        return P + L * C_ACT_PREFILL * A + 2.0 * C
    if kind == DECODE:
        return P + C + 8.0 * b_dev * cfg.d_model * act_bytes * max(L, 1)
    raise ValueError(kind)


# ---- serving KV-cache capacity (the memory subsystem's budget source) ------
def kv_bytes_per_token(cfg: ModelConfig,
                       bytes_per_elem: float = 2.0) -> float:
    """KV-cache bytes one cached token costs across all attention layers.

    Attention-free blocks (RG-LRU, RWKV6) keep constant-size state, so
    only ``attn_*`` layers contribute; K and V are each
    ``num_kv_heads × head_dim`` elements per layer.
    """
    n_attn = sum(k.startswith("attn") for k in cfg.layer_kinds())
    return n_attn * 2.0 * cfg.num_kv_heads * cfg.head_dim * bytes_per_elem


def serving_hbm_headroom(hw: hw_lib.HardwareModel, chips: int,
                         weight_bytes: float,
                         util_fraction: float = 0.9) -> float:
    """HBM bytes left for KV cache on one replica after resident weights.

    ``util_fraction`` reserves slack for activations, collectives and
    allocator fragmentation, mirroring vLLM's ``gpu_memory_utilization``.
    """
    usable = hw.hbm_bytes * max(chips, 1) * util_fraction
    return max(usable - weight_bytes, 0.0)
