"""Core model building blocks as plain functions on tensors, ported from
``repro.models.layers``.

Parameters are nested dicts of tensors in the reference's layouts (``wq``
(D, H, hd), ``wo`` (H, hd, D), ...), so converted JAX weights drop in as they
are.  ``attend`` stays plain: it is the model-level reference the kernels are
held to.  Attention inside the model goes through ``repro_torch.kernels.ops``.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.dist.sharding import constrain_attn_q, merge_dims, split_last
from repro_torch.kernels import ops
from repro_torch.kernels.ref import _softcap

Params = Dict[str, Any]

# Leaves that stay fp32 even under bf16 compute (log-space decays etc.), as
# in the reference.
F32_LEAVES = frozenset({"lam", "decay_w0", "bonus_u"})


def cast_layer_params(params: Params, dtype) -> Params:
    """A layer's weights in the compute dtype, cast at the point of use;
    ``F32_LEAVES`` and non-float leaves keep theirs."""
    return {name: (cast_layer_params(leaf, dtype) if isinstance(leaf, dict)
                   else leaf if name in F32_LEAVES or not leaf.is_floating_point()
                   else leaf.to(dtype))
            for name, leaf in params.items()}


# --------------------------------------------------------------------------
# initializers (same distributions as the reference; not the same numbers)
# --------------------------------------------------------------------------
def dense_init(gen: torch.Generator, shape, in_dim: int, dtype,
               device) -> torch.Tensor:
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (w / math.sqrt(in_dim)).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int, dtype,
               device) -> torch.Tensor:
    w = torch.randn((vocab, d), generator=gen, dtype=torch.float32, device=device)
    return (w * 0.02).to(dtype)


# --------------------------------------------------------------------------
# RMSNorm, RoPE (the softcap is the kernels' plain one, ``ref._softcap``)
# --------------------------------------------------------------------------
def rmsnorm_axes() -> Params:
    """Logical sharding axes of ``rmsnorm``'s parameters
    (``repro_torch.dist.sharding``), as the reference's."""
    return {"scale": ("embed",)}


def rmsnorm(params: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (1.0 + params["scale"].float())).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    angles = positions[..., None].float() * freqs          # (..., S, half)
    cos = torch.cos(angles)[..., None, :]                  # (..., S, 1, half)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# attention (GQA + optional local window + optional logit softcap)
# --------------------------------------------------------------------------
def attend(q, k, v, q_pos, k_pos, *, causal: bool, window: int = 0,
           softcap: float = 0.0,
           k_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Grouped-query attention core, plain.

    q: (B, S, H, hd); k/v: (B, T, K, hd); q_pos: (B, S); k_pos: (B, T);
    k_valid: optional (B, T) bool mask of live cache slots; window 0 =
    global.  Returns (B, S, H, hd).
    """
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    qg = q.reshape(B, S, K, H // K, hd)
    logits = torch.einsum("bskgd,btkd->bkgst", qg.float(), k.float()) \
        * (1.0 / math.sqrt(hd))
    logits = _softcap(logits, softcap)
    mask = torch.ones((B, S, T), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos[:, None, :] <= q_pos[:, :, None]
    if window > 0:
        mask &= k_pos[:, None, :] > (q_pos[:, :, None] - window)
    if k_valid is not None:
        mask &= k_valid[:, None, :]
    logits = torch.where(mask[:, None, None], logits, -1e30)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v.float())
    return out.reshape(B, S, H, hd).to(q.dtype)


def attention_axes() -> Params:
    return {
        "wq": ("embed", "heads", "head_dim"),
        "wk": ("embed", "kv_heads", "head_dim"),
        "wv": ("embed", "kv_heads", "head_dim"),
        "wo": ("heads", "head_dim", "embed"),
    }


def project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (B, S, D) @ w: (D, H, hd) → (B, S, H, hd)."""
    D, H, hd = w.shape
    return split_last(x @ merge_dims(w, 1), (H, hd))


def project_out(out: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """out: (B, S, H, hd) @ wo: (H, hd, D) → (B, S, D)."""
    return merge_dims(out, out.dim() - 2) @ merge_dims(wo, 0)


def attention_apply(params: Params, x: torch.Tensor, positions: torch.Tensor,
                    *, rope_theta: float, causal: bool = True,
                    window: int = 0, softcap: float = 0.0,
                    lengths: Optional[torch.Tensor] = None,
                    return_kv: bool = False):
    """Self-attention over a prompt: projections, RoPE, flash attention,
    output projection.  ``positions`` are 0..S-1 per row (prompts start at
    position 0, which the kernel's causal mask assumes); ``lengths`` (B,)
    masks keys of right-padded prompts.  With ``return_kv`` also returns the
    roped k and v, (B, S, K, hd) each."""
    q = constrain_attn_q(rope(project(x, params["wq"]), positions, rope_theta))
    k = rope(project(x, params["wk"]), positions, rope_theta)
    v = project(x, params["wv"])
    out = ops.flash_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        causal=causal, window=window, softcap=softcap,
        lengths=lengths).transpose(1, 2)
    y = project_out(out, params["wo"])
    if return_kv:
        return y, (k, v)
    return y


def cross_attention_kv(params: Params, enc_out: torch.Tensor):
    """Cross-attention k and v from the encoder output (no RoPE), (B, T, K,
    hd) each."""
    return project(enc_out, params["wk"]), project(enc_out, params["wv"])


def cross_attention_apply(params: Params, x: torch.Tensor, kv) -> torch.Tensor:
    """Cross-attention: queries from x (B, S, D) against precomputed ``kv``
    ((B, T, K, hd) each): no RoPE, not causal, every encoder key valid.  A
    sequence goes through flash attention (Sq = S, Skv = T); one decode
    token (S = 1) through decode attention over all T slots (no slot
    positions: the query may see every t < T)."""
    k, v = kv
    B, S = x.shape[:2]
    q = constrain_attn_q(project(x, params["wq"]))
    if S == 1:
        full = torch.full((B,), k.shape[1], dtype=torch.int32, device=x.device)
        out = ops.decode_attention(q[:, 0], k.transpose(1, 2), v.transpose(1, 2),
                                   full)[:, None]
    else:
        out = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                  causal=False).transpose(1, 2)
    return project_out(out, params["wo"])


# --------------------------------------------------------------------------
# gated MLP (SwiGLU)
# --------------------------------------------------------------------------
def mlp_axes() -> Params:
    return {"wi": ("embed", "ffn"), "wg": ("embed", "ffn"), "wo": ("ffn", "embed")}


def mlp_apply(params: Params, x: torch.Tensor) -> torch.Tensor:
    h = x @ params["wi"]
    g = x @ params["wg"]
    return (F.silu(g) * h) @ params["wo"]
