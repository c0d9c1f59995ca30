"""RWKV6 WKV recurrence: the CUDA kernel's wrapper and its plain version.

The kernel (``csrc/wkv6.cu``) replaces the Pallas TPU kernel
``repro.kernels.wkv6.wkv6``; its source says what bounds it on the H100 and
how its design answers that.  ``launches`` counts the kernel's launches.
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

launches = 0

# The plain PyTorch version of the kernel: the CPU path, and the card-side
# check of the kernel.
plain = wkv6_reference


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library("wkv6")
    fn = lib.wkv6_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    return lib


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
    r, k, v, logw, u, state0 = (t.contiguous() for t in (r, k, v, logw, u, state0))
    out = torch.empty_like(r)
    state = torch.empty_like(state0)
    err = _lib().wkv6_fwd(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(), u.data_ptr(),
        state0.data_ptr(), out.data_ptr(), state.data_ptr(), B, S, H, N, DTYPES[r.dtype],
        torch.cuda.current_stream(r.device).cuda_stream)
    _build.check(err, "wkv6")
    launches += 1
    return out, state
