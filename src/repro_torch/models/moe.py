"""Capacity-based top-k Mixture-of-Experts FFN (GShard/Switch-style),
ported from ``repro.models.moe``.

Dispatch is scatter-based (no (S, E, C) one-hot blowup): every token's k
assignments get a position-in-expert via a cumulative sum, tokens beyond
an expert's capacity are dropped (weight renormalised), and activations
are scattered into an (E, C, d) buffer that the expert matmuls consume.

This is the reference's single-device path, ``_moe_core``, which it takes
whenever no mesh is active.  Its ``shard_map`` modes (gspmd, local,
ep_local) come with distribution (ROADMAP M12).  Semantics kept exactly:

- capacity C = max(ceil(S·k/E·factor), k) per batch row over the *padded*
  sequence length S;
- assignments ordered token-major, then by descending gate; top-k from a
  stable descending sort, so ties go to the lower expert index as in
  ``lax.top_k``;
- positions from a cumulative sum over that order; padding sits at the end
  of each row, so it never takes a valid token's slot;
- the scatter *adds* into a zero buffer: dropped assignments point at slot
  0 with zeroed rows;
- the gate weights are cast to the activation dtype and the k outputs are
  summed in it.

Everything here is plain PyTorch; the reference computes it outside any
Pallas kernel.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F


def moe_shapes(d: int, d_ff: int, num_experts: int) -> Dict[str, Tuple[int, ...]]:
    """One block's parameter shapes, in the reference's layout."""
    E = num_experts
    return {"router": (d, E), "wi": (E, d, d_ff), "wg": (E, d, d_ff),
            "wo": (E, d_ff, d)}


def moe_init(gen: torch.Generator, d: int, d_ff: int, num_experts: int, dtype,
             device, lead: Tuple[int, ...] = ()) -> Dict[str, torch.Tensor]:
    """Random block parameters with the reference's distributions (not its
    numbers): N(0, 1/d) for the router, wi and wg, N(0, 1/d_ff) for wo; each
    with leading axes ``lead`` (a stack of layers)."""
    out = {}
    for name, shape in moe_shapes(d, d_ff, num_experts).items():
        scale = 1.0 / math.sqrt(d_ff if name == "wo" else d)
        w = torch.randn(lead + shape, generator=gen, dtype=torch.float32, device=device)
        out[name] = w.mul_(scale).to(dtype)
    return out


def _capacity(tokens: int, num_experts: int, k: int, factor: float) -> int:
    cap = int(math.ceil(tokens * k / num_experts * factor))
    return max(cap, k)


def _route(params, x: torch.Tensor, E: int, k: int):
    """→ (gates (B, S, E) fp32, top-k weights (B, S, k) renormalised, top-k
    expert indices (B, S, k) int64), the router in fp32."""
    gates = torch.softmax(x.float() @ params["router"].float(), dim=-1)
    topk_w, topk_idx = torch.sort(gates, dim=-1, descending=True, stable=True)
    topk_w, topk_idx = topk_w[..., :k], topk_idx[..., :k]
    topk_w = topk_w / topk_w.sum(-1, keepdim=True).clamp(min=1e-9)
    return gates, topk_w, topk_idx


def _dispatch_indices(topk_idx: torch.Tensor, E: int, C: int):
    """→ (one-hot (B, S·k, E) int32, position in expert (0 where dropped),
    keep (B, S·k) bool)."""
    B, S, k = topk_idx.shape
    flat = topk_idx.reshape(B, S * k)
    onehot = F.one_hot(flat, E).to(torch.int32)
    pos = torch.cumsum(onehot, dim=1, dtype=torch.int32) - 1
    pos = torch.gather(pos, -1, flat[..., None])[..., 0]
    keep = pos < C
    return onehot, torch.where(keep, pos, 0), keep


def _scatter_local(xk: torch.Tensor, eidx: torch.Tensor, pos: torch.Tensor, *,
                   E: int, C: int) -> torch.Tensor:
    """xk (B, N, d) added into a zero (B, E, C, d) buffer at (b, eidx, pos)."""
    B = xk.shape[0]
    b = torch.arange(B, device=xk.device)[:, None].expand(eidx.shape)
    buf = xk.new_zeros((B, E, C, xk.shape[-1]))
    return buf.index_put_((b, eidx, pos.long()), xk, accumulate=True)


def _gather_local(buf: torch.Tensor, eidx: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    B = buf.shape[0]
    b = torch.arange(B, device=buf.device)[:, None].expand(eidx.shape)
    return buf[b, eidx, pos.long()]


def _expert_ffn(params, buf: torch.Tensor) -> torch.Tensor:
    """The experts' SwiGLU over every expert's buffer: (B, E, C, d)."""
    h = torch.einsum("becd,edf->becf", buf, params["wi"])
    g = torch.einsum("becd,edf->becf", buf, params["wg"])
    h = F.silu(g) * h
    return torch.einsum("becf,efd->becd", h, params["wo"])


def _moe_core(params, x: torch.Tensor, *, E: int, k: int,
              capacity_factor: float) -> torch.Tensor:
    """Full MoE block on a (B, S, d) batch."""
    B, S, d = x.shape
    C = _capacity(S, E, k, capacity_factor)
    _, topk_w, topk_idx = _route(params, x, E, k)
    _, pos, keep = _dispatch_indices(topk_idx, E, C)
    eidx = topk_idx.reshape(B, S * k)
    # jnp.repeat(x, k, axis=1): each token k times in a row, as an expand
    xk = x[:, :, None].expand(B, S, k, d).reshape(B, S * k, d)
    xk = torch.where(keep[..., None], xk, 0)
    buf = _scatter_local(xk, eidx, pos, E=E, C=C)
    out_buf = _expert_ffn(params, buf)
    yk = _gather_local(out_buf, eidx, pos)
    w = (topk_w.reshape(B, S * k) * keep).to(x.dtype)
    return (yk * w[..., None]).reshape(B, S, k, d).sum(dim=2)


def _aux_loss(params, x: torch.Tensor, E: int, k: int) -> torch.Tensor:
    """The load-balancing loss E·Σ_e mean gate_e · share of assignments_e."""
    gates, _, topk_idx = _route(params, x, E, k)
    B, S, _ = topk_idx.shape
    onehot = F.one_hot(topk_idx.reshape(B, S * k), E).float()
    me = gates.mean(dim=(0, 1))
    ce = (onehot.sum(dim=1) / (S * k)).mean(dim=0)
    return E * (me * ce).sum()


def moe_apply(params: Dict, x: torch.Tensor, *, num_experts: int, k: int,
              capacity_factor: float = 1.25, return_aux: bool = False):
    """x: (B, S, d) → (B, S, d), plus the load-balancing aux loss with
    ``return_aux``."""
    y = _moe_core(params, x, E=num_experts, k=k, capacity_factor=capacity_factor)
    if not return_aux:
        return y
    return y, _aux_loss(params, x, num_experts, k)
