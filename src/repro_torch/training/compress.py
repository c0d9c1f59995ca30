"""Gradient compression, ported from ``repro.training.compress``: int8
symmetric quantization with a per-leaf scale and an error-feedback buffer
(residual accumulation), the standard trick for pushing gradient all-reduce
bytes down ~4×.  ``torch.round`` rounds half to even, as ``jnp.round``
does.  :func:`compressed_psum` is the int8 wire-format reduce over a
``torch.distributed`` group, the reference's ``psum``/``pmax`` inside
``shard_map``: on one card it runs over a group of one (``nccl``), across
ranks it is held to the reference on ``gloo`` CPU groups.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from repro_torch.training.tree import tree_map


def quantize(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    amax = g.abs().max()
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax)).float()
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_grads_with_feedback(grads: Any, error: Optional[Any]) -> Tuple[Any, Any]:
    """Quantize → dequantize each leaf, carrying the residual into the next
    step (error feedback keeps the compression unbiased over time) →
    (dequantized grads, new error)."""
    if error is None:
        error = tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                               device=g.device), grads)

    def one(g, e):
        g = g.float() + e
        deq = dequantize(*quantize(g))
        return deq, g - deq

    out = tree_map(one, grads, error)
    return tree_map(lambda t: t[0], out), tree_map(lambda t: t[1], out)


def compressed_psum(g: torch.Tensor, group=None) -> torch.Tensor:
    """int8-on-the-wire gradient all-reduce over ``group`` (default: the
    world): quantize locally, all-reduce the int8 payload widened to int32
    (a sum of ≤ world int8 values fits), all-reduce the scale by MAX, then
    dequantize with the max scale."""
    import torch.distributed as dist
    q, scale = quantize(g)
    total = q.to(torch.int32)
    dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
    max_scale = scale.clone()
    dist.all_reduce(max_scale, op=dist.ReduceOp.MAX, group=group)
    return total.to(torch.float32) * max_scale
