"""RWKV6 WKV recurrence: the CUDA kernel's wrapper and its plain version.

The kernel (``csrc/wkv6.cu``) replaces the Pallas TPU kernel
``repro.kernels.wkv6.wkv6``; its source says what bounds it on the H100 and
how its design answers that.  In bf16 at N = 64 it runs on wgmma in chunks
of ``CHUNK`` = 64 steps, each (batch, head) cut into segments of whole
chunks by ``plan_segments``; in fp32 and at N = 32 it runs the tf32
kernel (``mma.sync``) in chunks of ``BWD_CHUNK`` = 32, cut by ``plan_bwd_segments``
(``forward_plan`` says which).  Up to three launches a call; ``launches``
counts one per call.

The backward kernels (``csrc/wkv6_bwd.cu``) compute the gradient of the same
function and replace no TPU kernel (the reference differentiates its chunked
WKV with XLA).  In bf16 at N = 64 with B·H ≥ ``BWD_WGMMA_HEADS`` the wgmma kernel
takes one segment a (batch, head) in chunks of ``CHUNK``; every other call
runs the tf32 kernel in chunks of ``BWD_CHUNK`` cut by ``plan_bwd_segments``
(``backward_plan`` says which, before the launch).  ``launches_bwd`` counts
one per call (up to four launches).  :class:`WKV6` ties the two together for
autograd; :func:`plain_grad` is the backward's plain version.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import wkv6_backward_reference, wkv6_reference

HEAD_SIZES = (32, 64)   # the kernels' head sizes; a smaller head runs padded (pad_heads)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
CHUNK = 64             # steps of a chunk of the bf16 N = 64 kernel (wgmma)
SMS = _build.H100_SMS  # its blocks take an SM each: plan_segments fills one wave of them
BWD_CHUNK = 32         # steps of a chunk of the tf32 kernel and of the backward
TARGET_BLOCKS = 2048   # blocks plan_bwd_segments aims at (~8 waves)
# B·H from which the backward's bf16 N = 64 calls take the wgmma kernel: at
# S 2048 on the H100 it is slower than the tf32 kernel at 64 heads and faster
# at 96, 128 and 132 (parity_probe.py --kernel recurrent_bwd, its cut rows)
BWD_WGMMA_HEADS = 96

launches = 0
launches_bwd = 0

# The plain PyTorch version of the kernel: the CPU path, and the card-side
# check of the kernel.
plain = wkv6_reference


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library("wkv6")
    fn = lib.wkv6_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    return lib


def _cut(chunks: int, P: int) -> Tuple[int, int]:
    """(P, Lc): ``chunks`` in at most P segments of Lc whole chunks (the
    last may hold fewer); no chunks gives (1, 0)."""
    if chunks == 0:
        return 1, 0
    Lc = -(-chunks // min(chunks, P))
    return -(-chunks // Lc), Lc


def plan_segments(B: int, H: int, S: int) -> Tuple[int, int]:
    """(P, Lc) of the bf16 N = 64 kernel: each (batch, head) in P segments
    of Lc chunks of ``CHUNK`` steps.  A block takes an SM, and a segment
    past the first costs a second pass over its k, v and logw, so there are
    as many segments as keep B·H·P within one wave of ``SMS`` blocks: one
    once B·H fills the card.  S = 0 gives (1, 0)."""
    return _cut(-(-S // CHUNK), max(1, SMS // max(1, B * H)))


def plan_bwd_segments(B: int, H: int, S: int) -> Tuple[int, int]:
    """(P, Lc) of the backward kernel and of the tf32 forward (fp32,
    N = 32): each (batch, head) in P segments of Lc chunks of ``BWD_CHUNK``
    steps, so that B·H·P comes near ``TARGET_BLOCKS``.  S = 0 gives
    (1, 0)."""
    return _cut(-(-S // BWD_CHUNK), -(-TARGET_BLOCKS // max(1, B * H)))


def forward_plan(B: int, H: int, S: int, N: int, dtype: torch.dtype) -> Tuple[int, int, int]:
    """(P, Lc, chunk) of the forward kernel that a call with heads of N
    (padded to ``kernel_head_size``) and r in ``dtype`` launches."""
    if dtype == torch.bfloat16 and kernel_head_size(N) == 64:
        return (*plan_segments(B, H, S), CHUNK)
    return (*plan_bwd_segments(B, H, S), BWD_CHUNK)


def backward_plan(B: int, H: int, S: int, N: int, dtype: torch.dtype) -> Tuple[int, int, int]:
    """(P, Lc, chunk) of the backward kernel that a call with heads of N
    (padded to ``kernel_head_size``) and r in ``dtype`` launches: the wgmma
    kernel, one segment of every chunk of ``CHUNK`` steps (a block a (batch,
    head)), in bf16 at N = 64 with B·H ≥ ``BWD_WGMMA_HEADS``; else the tf32
    kernel in ``plan_bwd_segments``' segments of chunks of ``BWD_CHUNK``."""
    if (dtype == torch.bfloat16 and kernel_head_size(N) == 64
            and B * H >= BWD_WGMMA_HEADS):
        return (*_cut(-(-S // CHUNK), 1), CHUNK)
    return (*plan_bwd_segments(B, H, S), BWD_CHUNK)


def kernel_head_size(N: int) -> int:
    """The head size the kernels run a head of N at: the least of
    ``HEAD_SIZES`` that holds it."""
    for size in HEAD_SIZES:
        if 1 <= N <= size:
            return size
    raise ValueError(f"wkv6: head size {N} is not in 1..{HEAD_SIZES[-1]}")


def pad_heads(size: int, r, k, v, logw, u, state0, dout=None, dstate=None):
    """The operands with their head dimension zero-padded to ``size``: r,
    k, v, logw, u and ``dout`` along N, the states ``state0`` and
    ``dstate`` to size × size (None stays None).  With r, k, v and logw
    zero there (e^0 = 1 keeps a zero state zero), the first N channels of
    every output and every gradient are those of the unpadded call."""
    def row(t):
        return None if t is None else torch.nn.functional.pad(t, (0, size - t.shape[-1]))

    def square(t):
        return None if t is None else torch.nn.functional.pad(
            t, (0, size - t.shape[-1], 0, size - t.shape[-2]))
    return (row(r), row(k), row(v), row(logw), row(u), square(state0), row(dout),
            square(dstate))


def _check_call(name: str, r, k, v, logw, u, state0) -> None:
    if r.dim() != 4 or not 1 <= r.shape[-1] <= HEAD_SIZES[-1]:
        raise ValueError(f"{name}: head size {tuple(r.shape)[-1:]} is not in "
                         f"1..{HEAD_SIZES[-1]}")
    B, S, H, N = r.shape
    if (k.shape != r.shape or v.shape != r.shape or logw.shape != r.shape
            or u.shape != (H, N) or state0.shape != (B, H, N, N)):
        raise ValueError(f"{name}: bad shapes r{tuple(r.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)} logw{tuple(logw.shape)} "
                         f"u{tuple(u.shape)} state0{tuple(state0.shape)}")
    if r.dtype not in DTYPES:
        raise ValueError(f"{name}: dtype {r.dtype} not supported")
    for arg, t, dtype in (("r", r, r.dtype), ("k", k, r.dtype), ("v", v, r.dtype),
                          ("logw", logw, torch.float32), ("u", u, torch.float32),
                          ("state0", state0, torch.float32)):
        if not t.is_cuda or t.dtype != dtype or t.device != r.device:
            raise ValueError(f"{name}: {arg} must be a {dtype} tensor on the card "
                             f"of r, got {t.device} {t.dtype}")


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, logw: torch.Tensor,
         u: torch.Tensor, state0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel.  r/k/v: (B, S, H, N) float32 or bfloat16, one
    dtype, N in ``HEAD_SIZES`` (any other N ≤ 64 runs padded to the next,
    ``pad_heads``); logw: (B, S, H, N), u: (H, N) and state0:
    (B, H, N, N), all float32; every tensor on the card of r; any B ≤ 65535,
    S and H.  → (out (B, S, H, N) in r's dtype, final state (B, H, N, N)
    float32)."""
    global launches
    _check_call("wkv6", r, k, v, logw, u, state0)
    B, S, H, N = r.shape
    if N not in HEAD_SIZES:
        out, state = wkv6(*pad_heads(kernel_head_size(N), r, k, v, logw, u, state0)[:6])
        return out[..., :N].contiguous(), state[..., :N, :N].contiguous()
    # the kernels load 16 bytes at a time (TMA's rows at N = 64 in bf16): a
    # view that starts off that alignment is copied
    r, k, v, logw, state0 = (t if t.is_contiguous() and t.data_ptr() % 16 == 0
                             else t.clone(memory_format=torch.contiguous_format)
                             for t in (r, k, v, logw, state0))
    u = u.contiguous()
    P, Lc, _ = forward_plan(B, H, S, N, r.dtype)
    out = torch.empty_like(r)
    state = torch.empty_like(state0)
    # each segment's own contribution, then its incoming state; its decay
    seg_state = torch.empty((B, H, P - 1, N, N), dtype=torch.float32, device=r.device)
    seg_decay = torch.empty((B, H, P - 1, N), dtype=torch.float32, device=r.device)
    err = _lib().wkv6_fwd(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(), u.data_ptr(),
        state0.data_ptr(), out.data_ptr(), state.data_ptr(), seg_state.data_ptr(),
        seg_decay.data_ptr(), B, S, H, N, DTYPES[r.dtype], P, Lc,
        torch.cuda.current_stream(r.device).cuda_stream)
    _build.check(err, "wkv6")
    launches += 1
    return out, state


@functools.cache
def _lib_bwd() -> ctypes.CDLL:
    lib = _build.library("wkv6_bwd")
    fn = lib.wkv6_bwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 19 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn = lib.wkv6_bwd_wgmma
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    return lib


def wkv6_bwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, logw: torch.Tensor,
             u: torch.Tensor, state0: torch.Tensor, dout: torch.Tensor,
             dstate: Optional[torch.Tensor] = None):
    """Launch the backward kernel: the gradients (dr, dk, dv, dlogw, du,
    dstate0) of :func:`wkv6` given ``dout`` (B, S, H, N) in r's dtype, the
    gradient of its output, and ``dstate`` (B, H, N, N) fp32, that of its
    final state (None: zero).  Operands as for the forward; dr, dk and dv
    come back in r's dtype, the others in fp32.  The states at the chunks'
    starts are recomputed from state0 into scratch of B·H·ceil(S/chunk)·N²
    fp32, in ``backward_plan``'s segments and chunks."""
    global launches_bwd
    _check_call("wkv6_bwd", r, k, v, logw, u, state0)
    B, S, H, N = r.shape
    if dstate is None:
        dstate = torch.zeros_like(state0)
    if N not in HEAD_SIZES:
        grads = wkv6_bwd(*pad_heads(kernel_head_size(N), r, k, v, logw, u, state0, dout, dstate))
        return (*(g[..., :N].contiguous() for g in grads[:5]),
                grads[5][..., :N, :N].contiguous())
    if dout.shape != r.shape or dout.dtype != r.dtype or dout.device != r.device \
            or dstate.shape != state0.shape or dstate.dtype != torch.float32 \
            or dstate.device != r.device:
        raise ValueError(f"wkv6_bwd: dout {tuple(dout.shape)} {dout.dtype} and dstate "
                         f"{tuple(dstate.shape)} {dstate.dtype} do not match r and state0")
    # the kernels copy 16 bytes at a time: a view that starts off that
    # alignment is copied
    args = tuple(t if t.is_contiguous() and t.data_ptr() % 16 == 0
                 else t.clone(memory_format=torch.contiguous_format)
                 for t in (r, k, v, logw, u, state0, dout, dstate))
    P, Lc, chunk = backward_plan(B, H, S, N, r.dtype)
    grads = (_bwd_wgmma(*args) if chunk == CHUNK else _bwd_tf32(*args, P=P, Lc=Lc))
    launches_bwd += 1
    return grads


def _bwd_outputs(r, k, v, logw, u, state0):
    return (torch.empty_like(r), torch.empty_like(k), torch.empty_like(v),
            torch.empty_like(logw), torch.empty_like(u), torch.empty_like(state0))


def _bwd_wgmma(r, k, v, logw, u, state0, dout, dstate):
    """The wgmma kernel (``wkv6_bwd_wgmma``): one block a (batch, head),
    chunks of ``CHUNK``; scratch of every chunk's entering state and each
    (batch, head)'s part of du."""
    B, S, H, N = r.shape
    grads = _bwd_outputs(r, k, v, logw, u, state0)
    states = torch.empty((B, H, -(-S // CHUNK), N, N), dtype=torch.float32, device=r.device)
    du_part = torch.empty((B, H, N), dtype=torch.float32, device=r.device)
    err = _lib_bwd().wkv6_bwd_wgmma(
        *(t.data_ptr() for t in (r, k, v, logw, u, state0, dout, dstate, *grads, states,
                                 du_part)),
        B, S, H, torch.cuda.current_stream(r.device).cuda_stream)
    _build.check(err, "wkv6_bwd")
    return grads


def _bwd_tf32(r, k, v, logw, u, state0, dout, dstate, *, P: int, Lc: int):
    """The tf32 kernel (C entry ``wkv6_bwd``) in P
    segments of Lc chunks of ``BWD_CHUNK`` steps: scratch of every chunk's
    state, each segment's state and gradient contributions, decay and part
    of du."""
    B, S, H, N = r.shape
    grads = _bwd_outputs(r, k, v, logw, u, state0)

    def scratch(*shape):
        return torch.empty((B, H) + shape, dtype=torch.float32, device=r.device)
    # every chunk's state; each segment's state and gradient contributions,
    # then those entering and leaving it; its decay; its part of du
    states = scratch(-(-S // BWD_CHUNK), N, N)
    seg_state, seg_grad = scratch(P - 1, N, N), scratch(P - 1, N, N)
    seg_decay, du_part = scratch(P, N), scratch(P, N)
    err = _lib_bwd().wkv6_bwd(
        *(t.data_ptr() for t in (r, k, v, logw, u, state0, dout, dstate, *grads, states,
                                 seg_state, seg_grad, seg_decay, du_part)),
        B, S, H, N, DTYPES[r.dtype], P, Lc, torch.cuda.current_stream(r.device).cuda_stream)
    _build.check(err, "wkv6_bwd")
    return grads


def plain_grad(r, k, v, logw, u, state0, dout, dstate=None, *,
               acc: torch.dtype = torch.float32):
    """The backward's plain version: :func:`wkv6_backward_reference` on
    every operand cast to ``acc`` (float64 where the kernel is checked) →
    (dr, dk, dv, dlogw, du, dstate0) in ``acc``."""
    return wkv6_backward_reference(*(None if t is None else t.to(acc)
                                     for t in (r, k, v, logw, u, state0, dout, dstate)),
                                   chunk=BWD_CHUNK)


class WKV6(torch.autograd.Function):
    """The forward kernel, differentiated by the backward kernel: what
    ``ops.wkv6`` runs on the card when a gradient is wanted."""

    @staticmethod
    def forward(ctx, r, k, v, logw, u, state0):
        ctx.save_for_backward(r, k, v, logw, u, state0)
        return wkv6(r, k, v, logw, u, state0)

    @staticmethod
    def backward(ctx, dout, dstate):
        grads = wkv6_bwd(*ctx.saved_tensors, dout, dstate)
        return tuple(x if want else None for x, want in zip(grads, ctx.needs_input_grad))
