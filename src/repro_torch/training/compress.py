"""Gradient compression, ported from ``repro.training.compress``: int8
symmetric quantization with a per-leaf scale and an error-feedback buffer
(residual accumulation), the standard trick for pushing gradient all-reduce
bytes down ~4×.  ``torch.round`` rounds half to even, as ``jnp.round``
does.  The reference's ``compressed_psum`` (the int8 wire-format reduce
inside ``shard_map``) needs a process group and waits for the port's
distribution layer (ROADMAP M12).
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
