"""Dispatch over the port's kernels, mirroring ``repro.kernels.ops``.

A tensor on the card goes to the hand-written CUDA kernel, which launches or
raises; a tensor on the CPU goes to the kernel's plain PyTorch version.
There is no fallback from one to the other.  A meta tensor (the cost pass,
``launch/costing.py``) goes to the kernel's shape-only custom op in
``kernels/meta.py``, which allocates the kernel's outputs, computes
nothing and is counted by the kernel's formula in ``kernels/costs.py``; under autograd its backward is the backward kernel's
op (K1′, K3′, K4′).  The int8 matmul has no meta op: no model step calls it.

Gradients: on the CPU autograd differentiates the plain versions.  On the
card flash attention, the RG-LRU scan and the WKV recurrence run through
``FlashAttention``, ``RGLRUScan`` and ``WKV6``, whose backwards are kernels
too; decode attention and the int8 matmul have no backward kernel, so they
raise when a gradient is wanted through them rather than cut it off
silently.

Under a device mesh (``repro_torch.dist``): when an input is a DTensor,
each entry point runs on the local shards through ``local_map``, the
counterpart of the reference's ``shard_map``, and the local call takes the
route above by its device (the kernel on the card, the plain version on the
CPU, the shape-only op on meta).  Batch and heads stay sharded as they come;
every other dimension (the sequence, K2's cache slots, the head dimension)
is gathered first, because a kernel is a function of the whole of it.
Query heads sharded over m ranks where the kv heads K do not divide by m
(dbrx-132b's 8, recurrentgemma-9b's 1 at m = 16) leave k and v replicated,
and each rank's call takes only the kv heads its query heads use; their
gradient is then summed over those ranks (``local_call``'s partial sums).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.dist.sharding import as_dtensor, coordinate, local_call
from repro_torch.kernels import decode_attention as _dec
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import int8_matmul as _i8
from repro_torch.kernels import meta as _meta
from repro_torch.kernels import ref
from repro_torch.kernels import rglru_scan as _rg
from repro_torch.kernels import wkv6 as _wkv


def _wants_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def _no_backward(name: str, *tensors) -> None:
    """Raise if a gradient is wanted through kernel ``name`` on the card."""
    if tensors[0].is_cuda and _wants_grad(*tensors):
        raise NotImplementedError(
            f"{name} has no backward kernel on the card: its inputs require a "
            "gradient; run this on the CPU, or without grad")


# ---- DTensor inputs: the local shards through local_map ---------------------
def _sharded(*tensors) -> bool:
    return any(isinstance(t, DTensor) for t in tensors)


def _mesh_of(*tensors):
    return next(t.device_mesh for t in tensors if isinstance(t, DTensor))


def _keep(t, dims, like=None) -> Tuple:
    """The placements a kernel takes ``t`` in: Shard(d) kept for d in
    ``dims``; on any other mesh dim the batch (dim 0) as ``like`` (the
    cache, for one query token) has it, else, for a partial sum or another
    dim sharded, a shard of the batch where the batch divides, else
    replicated."""
    mesh = t.device_mesh
    out = [p if isinstance(p, Shard) and p.dim in dims else None for p in t.placements]
    for i, p in enumerate(out):
        if p is None and like is not None:
            out[i] = Shard(0) if like.placements[i] == Shard(0) else Replicate()
        elif p is None:
            cut = math.prod(mesh.size(j) for j, q in enumerate(out) if q == Shard(0))
            out[i] = Shard(0) if t.shape[0] % (cut * mesh.size(i)) == 0 else Replicate()
    return tuple(out)


def _follow(lead, mapping) -> Tuple:
    """Placements of an operand whose dim ``mapping[d]`` follows dim d of
    the lead operand's placements ``lead``."""
    return tuple(Shard(mapping[p.dim]) if isinstance(p, Shard) and p.dim in mapping
                 else Replicate() for p in lead)


def _kv_heads(mesh, q_pl, H: int, K: int):
    """→ (kv placements' head entries, the local kv-head slice or None).

    Query heads sharded over m ranks (dim 1 of q): with K % m == 0 the kv
    heads shard with them; else k and v stay replicated over those ranks and
    rank r's query heads [r·H/m, (r+1)·H/m) read kv heads from
    r·(H/m) // G on (G = H/K), one when G is a multiple of H/m, H/m / G
    when H/m is a multiple of G."""
    dims = [i for i, p in enumerate(q_pl) if p == Shard(1)]
    m = math.prod(mesh.size(i) for i in dims)
    if K % m == 0:
        return True, None
    G, H_l = H // K, H // m
    if G % H_l and H_l % G:
        raise NotImplementedError(
            f"attention with {H} query heads on {m} ranks and {K} kv heads: a rank's "
            "query heads straddle kv groups unevenly")
    r = coordinate(mesh, dims)
    return False, (r * H_l // G, max(H_l // G, 1))


def _attention_placements(mesh, q, k):
    """q's and k/v's placements, the lengths', and the kv slice."""
    q_pl = _keep(q, (0, 1), k if isinstance(k, DTensor) else None)
    K = k.shape[1]
    shard_kv, sl = _kv_heads(mesh, q_pl, q.shape[1], K)
    kv_pl = tuple(Shard(0) if p == Shard(0) else
                  Shard(1) if p == Shard(1) and shard_kv else Replicate() for p in q_pl)
    return q_pl, kv_pl, _follow(q_pl, {0: 0}), sl


def _slice_kv(sl, k, v):
    if sl is None:
        return k, v
    start, n = sl
    return k[:, start:start + n], v[:, start:start + n]


def _flash_sharded(q, k, v, causal, window, softcap, lengths):
    mesh = _mesh_of(q, k, v)
    q = as_dtensor(q, mesh)
    q_pl, kv_pl, b_pl, sl = _attention_placements(mesh, q, k)

    def fn(q, k, v, lengths):
        k, v = _slice_kv(sl, k, v)
        return flash_attention(q, k, v, causal=causal, window=window, softcap=softcap,
                               lengths=lengths)

    return local_call(fn, mesh, (q, k, v, lengths), (q_pl, kv_pl, kv_pl, b_pl), q_pl)


def _decode_sharded(q, k, v, lengths, softcap, window, q_pos, slot_pos):
    mesh = _mesh_of(q, k, v)
    q = as_dtensor(q, mesh)
    q_pl, kv_pl, b_pl, sl = _attention_placements(mesh, q, k)

    def fn(q, k, v, lengths, q_pos, slot_pos):
        k, v = _slice_kv(sl, k, v)
        return decode_attention(q, k, v, lengths, softcap=softcap, window=window,
                                q_pos=q_pos, slot_pos=slot_pos)

    return local_call(fn, mesh, (q, k, v, lengths, q_pos, slot_pos),
                      (q_pl, kv_pl, kv_pl, b_pl, b_pl, b_pl), q_pl)


def _rglru_sharded(a, b, s0):
    mesh = _mesh_of(a, b, s0)
    a = as_dtensor(a, mesh)
    seq_pl = _keep(a, (0, 2))
    s_pl = _follow(seq_pl, {0: 0, 2: 1})
    return local_call(rglru_scan, mesh, (a, b, s0), (seq_pl, seq_pl, s_pl), (seq_pl, s_pl))


def _wkv6_sharded(r, k, v, logw, u, state0):
    mesh = _mesh_of(r, k, v, logw, u, state0)
    r = as_dtensor(r, mesh)
    seq_pl = _keep(r, (0, 2))
    u_pl = _follow(seq_pl, {2: 0})
    st_pl = _follow(seq_pl, {0: 0, 2: 1})
    return local_call(wkv6, mesh, (r, k, v, logw, u, state0),
                      (seq_pl,) * 4 + (u_pl, st_pl), (seq_pl, st_pl))


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    softcap: float = 0.0,
                    lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q: (B, H, Sq, d); k/v: (B, K, Skv, d) → (B, H, Sq, d)."""
    if _sharded(q, k, v, lengths):
        return _flash_sharded(q, k, v, causal, window, softcap, lengths)
    if q.is_meta:
        if _wants_grad(q, k, v):   # the state K1′ takes, kept for the backward
            return _meta.flash_attention_train(q, k, v, causal, window, softcap, lengths)[0]
        return _meta.flash_attention(q, k, v, causal, window, softcap, lengths)
    if not q.is_cuda:
        return _fa.plain(q, k, v, causal=causal, window=window, softcap=softcap,
                         lengths=lengths)
    if _wants_grad(q, k, v):
        return _fa.FlashAttention.apply(q, k, v, causal, window, softcap, lengths)
    return _fa.flash_attention(q, k, v, causal=causal, window=window, softcap=softcap,
                               lengths=lengths)


def decode_attention(q, k, v, lengths, *, softcap: float = 0.0,
                     window: int = 0, q_pos: Optional[torch.Tensor] = None,
                     slot_pos: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q: (B, H, d); k/v: (B, K, T, d); lengths: (B,) → (B, H, d)."""
    if _sharded(q, k, v, lengths, q_pos, slot_pos):
        return _decode_sharded(q, k, v, lengths, softcap, window, q_pos, slot_pos)
    _no_backward("decode_attention", q, k, v)
    if q.is_meta:
        return _meta.decode_attention(q, k, v, lengths, softcap, window, q_pos, slot_pos)
    fn = _dec.decode_attention if q.is_cuda else _dec.plain
    return fn(q, k, v, lengths, softcap=softcap, window=window, q_pos=q_pos,
              slot_pos=slot_pos)


def rglru_scan(a, b, s0) -> Tuple[torch.Tensor, torch.Tensor]:
    """s_t = a_t s_{t-1} + b_t.  a/b: (B, S, R) fp32 or bf16; s0: (B, R)
    fp32 → (seq (B, S, R) in a's dtype, last (B, R) fp32)."""
    if _sharded(a, b, s0):
        return _rglru_sharded(a, b, s0)
    if a.is_meta:
        return _meta.rglru_scan(a, b, s0)
    if not a.is_cuda:
        return _rg.plain(a, b, s0)
    if _wants_grad(a, b, s0):
        return _rg.RGLRUScan.apply(a, b, s0)
    return _rg.rglru_scan(a, b, s0)


def wkv6(r, k, v, logw, u, state0) -> Tuple[torch.Tensor, torch.Tensor]:
    """RWKV6 WKV.  r/k/v: (B, S, H, N); logw: (B, S, H, N) fp32; u: (H, N)
    fp32; state0: (B, H, N, N) fp32 → (out (B, S, H, N) in r's dtype, final
    state (B, H, N, N) fp32)."""
    if _sharded(r, k, v, logw, u, state0):
        return _wkv6_sharded(r, k, v, logw, u, state0)
    if r.is_meta:
        return _meta.wkv6(r, k, v, logw, u, state0)
    if not r.is_cuda:
        return _wkv.plain(r, k, v, logw, u, state0)
    if _wants_grad(r, k, v, logw, u, state0):
        return _wkv.WKV6.apply(r, k, v, logw, u, state0)
    return _wkv.wkv6(r, k, v, logw, u, state0)


def int8_matmul(x_q, w_q, sx, sw) -> torch.Tensor:
    """x_q: (M, K) int8; w_q: (K, N) int8; sx: (M,); sw: (N,) fp32 →
    (M, N) fp32, the int32 product scaled by sx[:, None] and sw[None, :]."""
    _no_backward("int8_matmul", x_q, w_q, sx, sw)
    fn = _i8.int8_matmul if x_q.is_cuda else _i8.plain
    return fn(x_q, w_q, sx, sw)


def quantize_rowwise(x) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row int8 quantization → (q, scales)."""
    return ref.quantize_rowwise(x)
