"""The kernels on meta tensors: shape-only implementations for the cost pass.

Each kernel of ``kernels/ops.py`` has a custom op here, ``repro_torch::<name>``,
implemented for the meta device only (its fake kernel; on a real device it
raises).  It allocates the outputs the card's wrapper allocates and
computes nothing; ``SCRATCH`` gives the bytes of the scratch the wrapper
holds beside them during the call, so a tracker of live bytes sees the
card's peak.  The backward kernels K1′, K3′
and K4′ are custom ops too, tied to their forwards by ``register_autograd``,
so a meta train step differentiates through them.  K1 under a gradient is
``flash_attention_train``, which also returns the state K1′ takes (the
fp32 output and each row's lse), saved for the backward as the card's
``FlashAttention`` saves it.

Each op carries its formula from ``kernels/costs.py``: ``FlopCounterMode``
reads the operations through ``register_flop_formula``, and ``COSTS`` gives
the cost pass the whole :class:`~repro_torch.kernels.costs.Cost` of a call.
The plain versions never run here: they walk the recurrences one step at a
time in Python and build attention's full logits, which would cost minutes
and count neither the card's work nor its memory.
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, Optional, Tuple

import torch
from torch import Tensor
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import costs
from repro_torch.kernels import decode_attention as _dec
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import rglru_scan as _rg
from repro_torch.kernels import wkv6 as _wkv


def _op(name: str):
    """Make the decorated function the shape-only implementation of the
    custom op ``repro_torch::<name>``: its fake kernel, which the meta
    device runs.  On a real device the op raises."""
    def make(shapes: Callable):
        @functools.wraps(shapes)
        def on_device(*args, **kwargs):
            raise NotImplementedError(
                f"repro_torch::{name} takes meta tensors only: kernels/ops.py sends "
                "real tensors to the kernel or its plain version")
        op = torch.library.custom_op(f"repro_torch::{name}", on_device, mutates_args=(),
                                     device_types="cpu")
        op.register_fake(shapes)
        return op
    return make


# ---- K1 / K1′ ----------------------------------------------------------------
@_op("flash_attention")
def flash_attention(q: Tensor, k: Tensor, v: Tensor, causal: bool, window: int,
                    softcap: float, lengths: Optional[Tensor]) -> Tensor:
    return torch.empty_like(q)


def _flash_state(q: Tensor) -> Tuple[Tensor, Tensor]:
    """The forward's state for K1′ (``flash_attention(..., return_stats=True)``):
    bf16 the fp32 output and each row's lse; fp32, whose backward takes
    none, empty."""
    B, H, Sq, d = q.shape
    if q.dtype == torch.float32:
        return (torch.empty(0, dtype=torch.float32, device=q.device),) * 2
    return (torch.empty((B, H, Sq, d), dtype=torch.float32, device=q.device),
            torch.empty((B, H, _fa.stats_pitch(Sq)), dtype=torch.float32, device=q.device))


@_op("flash_attention_train")
def flash_attention_train(q: Tensor, k: Tensor, v: Tensor, causal: bool, window: int,
                          softcap: float, lengths: Optional[Tensor]
                          ) -> Tuple[Tensor, Tensor, Tensor]:
    """K1 when a gradient is wanted: the output and the state it keeps."""
    return (torch.empty_like(q), *_flash_state(q))


@_op("flash_attention_bwd")
def flash_attention_bwd(q: Tensor, k: Tensor, v: Tensor, dout: Tensor, out32: Tensor,
                        lse: Tensor, causal: bool, window: int, softcap: float,
                        lengths: Optional[Tensor]) -> Tuple[Tensor, Tensor, Tensor]:
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


def _flash_bwd_scratch(q, *rest) -> int:
    B, H, Sq, _ = q.shape
    return 4 * 2 * B * H * _fa.stats_pitch(Sq)                        # D and an lse


def _flash_cost(fn: Callable) -> Callable:
    def cost(q, k, v, *rest):
        causal, window, softcap = rest[-4:-1]
        B, H, Sq, d = q.shape
        return fn(B, H, k.shape[1], Sq, k.shape[2], d, q.element_size(), causal=causal,
                  window=window, softcap=softcap)
    return cost


def _flash_train_cost(q, *rest) -> costs.Cost:
    """K1's formula, and the state written beside its output."""
    c = _flash_cost(costs.flash_attention)(q, *rest)
    return c._replace(bytes=c.bytes + sum(t.nbytes for t in _flash_state(q)))


def _flash_setup(ctx, inputs, output):
    q, k, v, causal, window, softcap, lengths = inputs
    _, out32, lse = output
    ctx.save_for_backward(q, k, v, lengths, out32, lse)
    ctx.mark_non_differentiable(out32, lse)
    ctx.set_materialize_grads(False)   # no zeros made for the state's gradients
    ctx.opts = (causal, window, softcap)


def _flash_backward(ctx, dout, d_out32, d_lse):
    q, k, v, lengths, out32, lse = ctx.saved_tensors
    return (*flash_attention_bwd(q, k, v, dout, out32, lse, *ctx.opts, lengths),
            None, None, None, None)


flash_attention_train.register_autograd(_flash_backward, setup_context=_flash_setup)


# ---- K2 ----------------------------------------------------------------------
@_op("decode_attention")
def decode_attention(q: Tensor, k: Tensor, v: Tensor, lengths: Tensor, softcap: float,
                     window: int, q_pos: Optional[Tensor], slot_pos: Optional[Tensor]
                     ) -> Tensor:
    return torch.empty(q.shape, dtype=q.dtype, device=q.device)


def _decode_scratch(q, k, *rest) -> int:
    B, H, d = q.shape
    K, T = k.shape[1], k.shape[2]
    nsplit, _ = _dec.plan_splits(B, K, T, d, q.element_size())
    return 4 * B * K * nsplit * (H // K) * (d + 2) if nsplit > 1 else 0   # the splits' partials


def _decode_cost(q, k, v, lengths, softcap, window, *rest):
    B, H, d = q.shape
    return costs.decode_attention(B, H, k.shape[1], k.shape[2], d, q.element_size(),
                                  window=window, softcap=softcap)


# ---- K3 / K3′ ----------------------------------------------------------------
@_op("rglru_scan")
def rglru_scan(a: Tensor, b: Tensor, s0: Tensor) -> Tuple[Tensor, Tensor]:
    return torch.empty_like(a), torch.empty_like(s0)


@_op("rglru_scan_bwd")
def rglru_scan_bwd(a: Tensor, b: Tensor, s0: Tensor, g: Tensor, g_last: Tensor
                   ) -> Tuple[Tensor, Tensor, Tensor]:
    return torch.empty_like(a), torch.empty_like(b), torch.empty_like(s0)


def _rglru_bwd_scratch(a, *rest) -> int:
    B, S, R = a.shape
    p = _rg.plan_bwd(B, S, R, a.element_size())
    every = _rg.BWD_CHUNK if p.variant == "register" else p.steps
    return 4 * B * -(-S // every) * R                                   # the stored states


def _by_first_operand(fn: Callable) -> Callable:
    """A recurrence's cost from its first operand, (B, S, R) or (B, S, H, N)."""
    def cost(x, *rest):
        return fn(*x.shape, x.element_size())
    return cost


def _save_inputs(ctx, inputs, output):
    ctx.save_for_backward(*inputs)


def _rglru_backward(ctx, g, g_last):
    a, b, s0 = ctx.saved_tensors
    return rglru_scan_bwd(a, b, s0, g, torch.zeros_like(s0) if g_last is None else g_last)


rglru_scan.register_autograd(_rglru_backward, setup_context=_save_inputs)


# ---- K4 / K4′ ----------------------------------------------------------------
@_op("wkv6")
def wkv6(r: Tensor, k: Tensor, v: Tensor, logw: Tensor, u: Tensor, state0: Tensor
         ) -> Tuple[Tensor, Tensor]:
    return torch.empty_like(r), torch.empty_like(state0)


def _wkv_scratch(r, *rest) -> int:
    B, S, H, N = r.shape
    P, _, _ = _wkv.forward_plan(B, H, S, N, r.dtype)
    n = _wkv.kernel_head_size(N)
    return 4 * B * H * (P - 1) * (n * n + n)                           # the segments' states, decays


@_op("wkv6_bwd")
def wkv6_bwd(r: Tensor, k: Tensor, v: Tensor, logw: Tensor, u: Tensor, state0: Tensor,
             dout: Tensor, dstate: Tensor
             ) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor, Tensor]:
    return (torch.empty_like(r), torch.empty_like(k), torch.empty_like(v),
            torch.empty_like(logw), torch.empty_like(u), torch.empty_like(state0))


def _wkv_bwd_scratch(r, *rest) -> int:
    B, S, H, N = r.shape
    P, _, chunk = _wkv.backward_plan(B, H, S, N, r.dtype)
    n = _wkv.kernel_head_size(N)
    if chunk == _wkv.CHUNK:   # the wgmma kernel: every chunk's state; each head's du part
        return 4 * B * H * (-(-S // chunk) * n * n + n)
    # every chunk's state; the segments' states, gradients, decays and du parts
    return 4 * B * H * ((-(-S // chunk) + 2 * (P - 1)) * n * n + 2 * P * n)


def _wkv_backward(ctx, dout, dstate):
    saved = ctx.saved_tensors
    return wkv6_bwd(*saved, dout, torch.zeros_like(saved[5]) if dstate is None else dstate)


wkv6.register_autograd(_wkv_backward, setup_context=_save_inputs)


# ---- the formulas ------------------------------------------------------------
# op → cost(*the op's arguments) → costs.Cost
COSTS: Dict[object, Callable] = {
    torch.ops.repro_torch.flash_attention: _flash_cost(costs.flash_attention),
    torch.ops.repro_torch.flash_attention_train: _flash_train_cost,
    torch.ops.repro_torch.flash_attention_bwd: _flash_cost(costs.flash_attention_bwd),
    torch.ops.repro_torch.decode_attention: _decode_cost,
    torch.ops.repro_torch.rglru_scan: _by_first_operand(costs.rglru_scan),
    torch.ops.repro_torch.rglru_scan_bwd: _by_first_operand(costs.rglru_scan_bwd),
    torch.ops.repro_torch.wkv6: _by_first_operand(costs.wkv6),
    torch.ops.repro_torch.wkv6_bwd: _by_first_operand(costs.wkv6_bwd),
}


# op → scratch(*the op's arguments) → bytes the wrapper holds during the call
SCRATCH: Dict[object, Callable] = {
    torch.ops.repro_torch.flash_attention_bwd: _flash_bwd_scratch,
    torch.ops.repro_torch.decode_attention: _decode_scratch,
    torch.ops.repro_torch.rglru_scan_bwd: _rglru_bwd_scratch,
    torch.ops.repro_torch.wkv6: _wkv_scratch,
    torch.ops.repro_torch.wkv6_bwd: _wkv_bwd_scratch,
}


def _flops(cost: Callable) -> Callable:
    def formula(*args, out_val=None, **kwargs):
        return int(cost(*args, **kwargs).flops)
    return formula


for _packet, _cost in COSTS.items():
    register_flop_formula(_packet, get_raw=True)(_flops(_cost))
