"""Int8 × int8 → fp32 quantized matmul: the CUDA kernel's wrapper and its
plain version.

The kernel (``csrc/int8_matmul.cu``) replaces the Pallas TPU kernel
``repro.kernels.int8_matmul.int8_matmul``; its source says what bounds it on
the H100 and how its design answers that.  ``launches`` counts the kernel's
launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import int8_matmul_exact

# 128² · K must fit the kernel's int32 sums for any int8 operands
MAX_K = (2 ** 31 - 1) // 128 ** 2

launches = 0

# The plain PyTorch version of the kernel: the CPU path, and the card-side
# check of the kernel (bitwise: both sum exactly and round as the kernel does).
plain = int8_matmul_exact


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library("int8_matmul")
    fn = lib.int8_matmul_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    return lib


def int8_matmul(x_q: torch.Tensor, w_q: torch.Tensor, sx: torch.Tensor,
                sw: torch.Tensor) -> torch.Tensor:
    """Launch the kernel.  x_q: (M, K) and w_q: (K, N) int8, sx: (M,) and
    sw: (N,) float32, all on one card; any M and N, K a multiple of 4 up
    to ``MAX_K`` → (M, N) float32."""
    global launches
    if x_q.dim() != 2 or w_q.dim() != 2 or w_q.shape[0] != x_q.shape[1]:
        raise ValueError(f"int8_matmul: bad shapes x_q{tuple(x_q.shape)} "
                         f"w_q{tuple(w_q.shape)}")
    M, K = x_q.shape
    N = w_q.shape[1]
    if sx.shape != (M,) or sw.shape != (N,):
        raise ValueError(f"int8_matmul: bad shapes sx{tuple(sx.shape)} "
                         f"sw{tuple(sw.shape)} for ({M}, {K}) x ({K}, {N})")
    if K % 4 or K > MAX_K:
        raise ValueError(f"int8_matmul: K = {K} must be a multiple of 4 and at "
                         f"most {MAX_K}")
    for name, t, dtype in (("x_q", x_q, torch.int8), ("w_q", w_q, torch.int8),
                           ("sx", sx, torch.float32), ("sw", sw, torch.float32)):
        if not t.is_cuda or t.dtype != dtype or t.device != x_q.device:
            raise ValueError(f"int8_matmul: {name} must be a {dtype} tensor on "
                             f"the card of x_q, got {t.device} {t.dtype}")
    x_q, w_q, sx, sw = (t.contiguous() for t in (x_q, w_q, sx, sw))
    if x_q.data_ptr() % 16 or w_q.data_ptr() % 16:
        raise ValueError("int8_matmul: x_q and w_q must be 16-byte aligned")
    out = torch.empty((M, N), dtype=torch.float32, device=x_q.device)
    err = _lib().int8_matmul_fwd(
        x_q.data_ptr(), w_q.data_ptr(), sx.data_ptr(), sw.data_ptr(), out.data_ptr(),
        M, N, K, torch.cuda.current_stream(x_q.device).cuda_stream)
    _build.check(err, "int8_matmul")
    launches += 1
    return out
