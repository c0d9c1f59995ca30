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
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

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


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    softcap: float = 0.0,
                    lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q: (B, H, Sq, d); k/v: (B, K, Skv, d) → (B, H, Sq, d)."""
    if q.is_meta:
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
    _no_backward("decode_attention", q, k, v)
    if q.is_meta:
        return _meta.decode_attention(q, k, v, lengths, softcap, window, q_pos, slot_pos)
    fn = _dec.decode_attention if q.is_cuda else _dec.plain
    return fn(q, k, v, lengths, softcap=softcap, window=window, q_pos=q_pos,
              slot_pos=slot_pos)


def rglru_scan(a, b, s0) -> Tuple[torch.Tensor, torch.Tensor]:
    """s_t = a_t s_{t-1} + b_t.  a/b: (B, S, R) fp32 or bf16; s0: (B, R)
    fp32 → (seq (B, S, R) in a's dtype, last (B, R) fp32)."""
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
