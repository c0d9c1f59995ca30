"""Capacity-based top-k Mixture-of-Experts FFN (GShard/Switch-style),
ported from ``repro.models.moe``.

Dispatch is scatter-based (no (S, E, C) one-hot blowup): every token's k
assignments get a position-in-expert via a cumulative sum, tokens beyond
an expert's capacity are dropped (weight renormalised), and activations
are scattered into an (E, C, d) buffer that the expert matmuls consume.

With no mesh active (``repro_torch.dist.sharding``) the block is
``_moe_core`` on the whole batch.  Under a mesh the rules choose one of the
reference's three modes (``_mesh_mode``), with ``local_map`` where the
reference has ``shard_map``:

  gspmd (default)   routing, dispatch and the scatter, and the gather and
                    combine, local per batch shard; the expert products on
                    DTensors, so the ffn-TP / expert-EP rules apply (dbrx).
  local             (rules with no "ffn" and no "expert" axes) the whole
                    block local per (batch[, seq via "moe_seq"]) shard with
                    the expert weights replicated; with "moe_seq" the
                    capacity is enforced per sequence shard.
  ep_local          ("moe_ep_local") each model rank owns E/m experts, routes
                    its (replicated) tokens to them locally, and the outputs
                    are summed with one all-reduce of (B, S, d) over "model".

A batch the batch axes do not divide runs the whole block on every rank.
At "model" 1 every mode computes ``_moe_core``'s function.  Semantics kept
exactly:

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

import functools
import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.dist import sharding as shd


def moe_shapes(d: int, d_ff: int, num_experts: int) -> Dict[str, Tuple[int, ...]]:
    """One block's parameter shapes, in the reference's layout."""
    E = num_experts
    return {"router": (d, E), "wi": (E, d, d_ff), "wg": (E, d, d_ff),
            "wo": (E, d_ff, d)}


def moe_axes() -> Dict:
    """Logical sharding axes of one block's parameters, as the reference's."""
    return {
        "router": ("embed", "expert"),
        "wi": ("expert", "embed", "ffn"),
        "wg": ("expert", "embed", "ffn"),
        "wo": ("expert", "ffn", "embed"),
    }


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
    """The experts' SwiGLU over every expert's buffer: (B, E, C, d).  The
    reference's einsums as the batched matmuls ``torch.einsum`` makes of
    them, written out in the (E, B·C) layout throughout (DTensor's view
    rules refuse the einsum's layouts with the batch sharded)."""
    B, E, C, d = buf.shape
    x = buf.transpose(0, 1).reshape(E, B * C, d)
    h = F.silu(torch.bmm(x, params["wg"])) * torch.bmm(x, params["wi"])
    return torch.bmm(h, params["wo"]).reshape(E, B, C, d).transpose(0, 1)


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


# --------------------------------------------------------------------------
# distribution modes
# --------------------------------------------------------------------------
def _mesh_mode(B: int, Sk: int, E: int):
    """Resolve (mesh, batch_axes, mode, seq_axis) from the active rules, as
    the reference does; None without a mesh or with a batch the batch axes
    do not divide."""
    ctx = shd._ACT_CTX[0]
    return None if ctx is None else _mode_on(*ctx, B, Sk, E)


def mode_name(mesh, rules, B: int, Sk: int, E: int) -> str:
    """The mode a block of E experts runs in on (B, Sk) tokens under
    ``rules`` on ``mesh``: "gspmd", "local", "ep_local", or "whole" (the
    block on every rank)."""
    mode = _mode_on(mesh, rules, B, Sk, E)
    return "whole" if mode is None else mode[2]


def _mode_on(mesh, rules, B: int, Sk: int, E: int):
    sizes = shd.mesh_sizes(mesh)
    b_axes = tuple(a for a in ("pod", "data") if a in sizes)
    n_b = math.prod(sizes[a] for a in b_axes) if b_axes else 1
    if not b_axes or B % n_b:
        return None
    if (rules.get("moe_ep_local") and "model" in sizes
            and E % sizes["model"] == 0):
        mode = "ep_local"
    elif not rules.get("ffn") and not rules.get("expert"):
        mode = "local"
    else:
        mode = "gspmd"
    seq_ok = (rules.get("moe_seq") and "model" in sizes
              and Sk % sizes["model"] == 0)
    return mesh, b_axes, mode, ("model" if mode == "local" and seq_ok else None)


def _layout(mesh, dims: Dict[str, int]) -> Tuple:
    """Placements: Shard(dims[axis]) on the mesh axes named in ``dims``,
    Replicate on the others."""
    return tuple(Shard(dims[a]) if a in dims else Replicate() for a in shd.mesh_sizes(mesh))


def _expert_offset(mesh, E_l: int) -> int:
    """The first expert this rank owns under ep_local."""
    return mesh.get_local_rank("model") * E_l


def _moe_ep_local(params, x, *, E: int, k: int, capacity_factor: float, mesh, b_axes):
    """Expert-parallel local dispatch: every model rank owns E/m experts,
    routes its (replicated) tokens to its own experts locally, and the
    outputs are summed with ONE all-reduce of (B, S, d) over "model"."""
    E_l = E // shd.mesh_sizes(mesh)["model"]

    def block(router, wi, wg, wo, x_l):
        B_l, S, d = x_l.shape
        C = _capacity(S, E, k, capacity_factor)
        _, topk_w, topk_idx = _route({"router": router}, x_l, E, k)
        _, pos, keep = _dispatch_indices(topk_idx, E, C)
        eidx = topk_idx.reshape(B_l, S * k)
        first = _expert_offset(mesh, E_l)
        mine = keep & (eidx >= first) & (eidx < first + E_l)
        xk = x_l[:, :, None].expand(B_l, S, k, d).reshape(B_l, S * k, d)
        xk = torch.where(mine[..., None], xk, 0)
        e_loc = torch.where(mine, eidx - first, 0)
        p_loc = torch.where(mine, pos, 0)
        buf = _scatter_local(xk, e_loc, p_loc, E=E_l, C=C)
        out_buf = _expert_ffn({"wi": wi, "wg": wg, "wo": wo}, buf)
        yk = _gather_local(out_buf, e_loc, p_loc)
        w = (topk_w.reshape(B_l, S * k) * mine).to(x_l.dtype)
        return (yk * w[..., None]).reshape(B_l, S, k, d).sum(dim=2)

    xs = _layout(mesh, {a: 0 for a in b_axes})
    ws = _layout(mesh, {"model": 0})
    part = tuple(Partial() if n == "model" else p
                 for n, p in zip(shd.mesh_sizes(mesh), xs))
    y = shd.local_call(block, mesh, (params["router"], params["wi"], params["wg"],
                                     params["wo"], x),
                       (_layout(mesh, {}), ws, ws, ws, xs), part)
    return y.redistribute(mesh, xs)                        # the one all-reduce


def _moe_gspmd(params, x, *, E: int, k: int, capacity_factor: float, mesh, b_axes):
    """Dispatch local per batch shard, expert products on DTensors."""
    B, S, d = x.shape
    C = _capacity(S, E, k, capacity_factor)

    def dispatch(router, x_l):
        B_l = x_l.shape[0]
        _, topk_w, topk_idx = _route({"router": router}, x_l, E, k)
        _, pos, keep = _dispatch_indices(topk_idx, E, C)
        eidx = topk_idx.reshape(B_l, S * k)
        xk = x_l[:, :, None].expand(B_l, S, k, d).reshape(B_l, S * k, d)
        xk = torch.where(keep[..., None], xk, 0)
        w = (topk_w.reshape(B_l, S * k) * keep).to(x_l.dtype)
        return _scatter_local(xk, eidx, pos, E=E, C=C), eidx, pos, w

    def combine(out_buf, eidx, pos, w):
        B_l = out_buf.shape[0]
        yk = _gather_local(out_buf, eidx, pos)
        return (yk * w[..., None]).reshape(B_l, S, k, d).sum(dim=2)

    bs = _layout(mesh, {a: 0 for a in b_axes})
    buf, eidx, pos, w = shd.local_call(dispatch, mesh, (params["router"], x),
                                       (_layout(mesh, {}), bs), (bs, bs, bs, bs))
    out_buf = _expert_ffn(params, buf)
    return shd.local_call(combine, mesh, (out_buf, eidx, pos, w), (bs,) * 4, bs)


def _moe_whole(params, x, core, axes: Dict[str, int]):
    """``core`` on local blocks of x cut along ``axes`` (mesh axis →
    dim), the weights replicated."""
    mesh = x.device_mesh
    names = sorted(params)
    xs = _layout(mesh, axes)
    rep = _layout(mesh, {})
    return shd.local_call(lambda *a: core(dict(zip(names, a[:-1])), a[-1]), mesh,
                          tuple(params[n] for n in names) + (x,),
                          (rep,) * len(names) + (xs,), xs)


def _aux_sharded(params, x, E: int, k: int, b_axes):
    """``_aux_loss`` with the two batch means taken per batch shard and
    averaged over the shards: each shard's means divided by the number of
    shards, then summed (a Partial sum, whose gradient reaches each shard
    whole; a Partial("avg") output would get the same gradient, n times its
    share)."""
    mesh = x.device_mesh
    n = math.prod(shd.mesh_sizes(mesh)[a] for a in b_axes)

    def means(router, x_l):
        gates, _, topk_idx = _route({"router": router}, x_l, E, k)
        B_l, S, _ = topk_idx.shape
        onehot = F.one_hot(topk_idx.reshape(B_l, S * k), E).float()
        me, ce = gates.mean(dim=(0, 1)), (onehot.sum(dim=1) / (S * k)).mean(dim=0)
        return (me, ce) if n == 1 else (me / n, ce / n)   # 1 × 1: _aux_loss's ops

    bs = _layout(mesh, {a: 0 for a in b_axes})
    part = tuple(Partial() if isinstance(p, Shard) else p for p in bs)
    me, ce = shd.local_call(means, mesh, (params["router"], x),
                            (_layout(mesh, {}), bs), (part, part))
    return E * (me * ce).sum()


def moe_apply(params: Dict, x: torch.Tensor, *, num_experts: int, k: int,
              capacity_factor: float = 1.25, return_aux: bool = False):
    """x: (B, S, d) → (B, S, d), plus the load-balancing aux loss with
    ``return_aux``."""
    B, S, d = x.shape
    E = num_experts
    core = functools.partial(_moe_core, E=E, k=k, capacity_factor=capacity_factor)
    mode = _mesh_mode(B, S, E) if isinstance(x, DTensor) else None
    if mode is None:
        y = core(params, x) if not isinstance(x, DTensor) else _moe_whole(params, x, core, {})
    else:
        mesh, b_axes, kind, seq_ax = mode
        if kind == "ep_local":
            y = _moe_ep_local(params, x, E=E, k=k, capacity_factor=capacity_factor,
                              mesh=mesh, b_axes=b_axes)
        elif kind == "local":
            axes = {a: 0 for a in b_axes}
            if seq_ax:
                axes[seq_ax] = 1
            y = _moe_whole(params, x, core, axes)
            if seq_ax:       # the sequence gathered again, as the block's input came
                y = y.redistribute(mesh, _layout(mesh, {a: 0 for a in b_axes}))
        else:
            y = _moe_gspmd(params, x, E=E, k=k, capacity_factor=capacity_factor,
                           mesh=mesh, b_axes=b_axes)
    if not return_aux:
        return y
    if mode is None and isinstance(x, DTensor):
        aux = _moe_whole(params, x, lambda p, x_l: _aux_loss(p, x_l, E, k), {})
    elif mode is not None:
        aux = _aux_sharded(params, x, E, k, mode[1])
    else:
        aux = _aux_loss(params, x, E, k)
    return y, aux
