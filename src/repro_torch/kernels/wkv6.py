"""RWKV6 WKV recurrence: the CUDA kernel's wrapper and its plain version.

The kernel (``csrc/wkv6.cu``) replaces the Pallas TPU kernel
``repro.kernels.wkv6.wkv6``; its source says what bounds it on the H100 and
how its design answers that.  It cuts each (batch, head) into segments of
whole 32-step chunks (``plan_segments``) and runs up to three launches a
call; ``launches`` counts one per call.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import wkv6_reference

HEAD_SIZES = (32, 64)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
CHUNK = 32             # steps of a chunk, the kernel's T
TARGET_BLOCKS = 2048   # blocks of the output pass the planner aims at (~8 waves)

launches = 0

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


def plan_segments(B: int, H: int, S: int) -> Tuple[int, int]:
    """(P, Lc): each (batch, head) in P segments of Lc chunks of ``CHUNK``
    steps (the last segment may hold fewer), so that B·H·P comes near
    ``TARGET_BLOCKS``.  S = 0 gives (1, 0)."""
    chunks = -(-S // CHUNK)
    if chunks == 0:
        return 1, 0
    P = min(chunks, max(1, -(-TARGET_BLOCKS // max(1, B * H))))
    Lc = -(-chunks // P)
    return -(-chunks // Lc), Lc


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, logw: torch.Tensor,
         u: torch.Tensor, state0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel.  r/k/v: (B, S, H, N) float32 or bfloat16, one
    dtype, N in ``HEAD_SIZES``; logw: (B, S, H, N), u: (H, N) and state0:
    (B, H, N, N), all float32; every tensor on the card of r; any B ≤ 65535,
    S and H.  → (out (B, S, H, N) in r's dtype, final state (B, H, N, N)
    float32)."""
    global launches
    if r.dim() != 4 or r.shape[-1] not in HEAD_SIZES:
        raise ValueError(f"wkv6: head size {tuple(r.shape)[-1:]} is not one of "
                         f"{HEAD_SIZES}")
    B, S, H, N = r.shape
    if (k.shape != r.shape or v.shape != r.shape or logw.shape != r.shape
            or u.shape != (H, N) or state0.shape != (B, H, N, N)):
        raise ValueError(f"wkv6: bad shapes r{tuple(r.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)} logw{tuple(logw.shape)} "
                         f"u{tuple(u.shape)} state0{tuple(state0.shape)}")
    if r.dtype not in DTYPES:
        raise ValueError(f"wkv6: dtype {r.dtype} not supported")
    for name, t, dtype in (("r", r, r.dtype), ("k", k, r.dtype), ("v", v, r.dtype),
                           ("logw", logw, torch.float32), ("u", u, torch.float32),
                           ("state0", state0, torch.float32)):
        if not t.is_cuda or t.dtype != dtype or t.device != r.device:
            raise ValueError(f"wkv6: {name} must be a {dtype} tensor on the card "
                             f"of r, got {t.device} {t.dtype}")
    # the kernel loads 16 bytes at a time: a view that starts off that
    # alignment is copied
    r, k, v, logw, state0 = (t if t.is_contiguous() and t.data_ptr() % 16 == 0
                             else t.clone(memory_format=torch.contiguous_format)
                             for t in (r, k, v, logw, state0))
    u = u.contiguous()
    P, Lc = plan_segments(B, H, S)
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
