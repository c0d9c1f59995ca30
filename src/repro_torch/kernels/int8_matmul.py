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
# TMA reads rows whose stride is a multiple of 16 bytes: K is padded to one
K_ALIGN = 16

launches = 0

# The plain PyTorch version of the kernel: the CPU path, and the card-side
# check of the kernel (bitwise: both sum exactly and round as the kernel does).
plain = int8_matmul_exact


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library("int8_matmul")
    fn = lib.int8_matmul_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    return lib


def padded_k(K: int) -> int:
    """The K extent the kernel reads: K rounded up to ``K_ALIGN`` (at least
    one row of it); past K both operands are zeros."""
    return max(K_ALIGN, -(-K // K_ALIGN) * K_ALIGN)


def k_major(w_q: torch.Tensor) -> bool:
    """Whether ``w_q`` (K, N) arrives column-major with a K the kernel can
    read in place, so that the transposing pass is skipped."""
    K = w_q.shape[0]
    return K % K_ALIGN == 0 and K > 0 and w_q.T.is_contiguous()


def int8_matmul(x_q: torch.Tensor, w_q: torch.Tensor, sx: torch.Tensor,
                sw: torch.Tensor) -> torch.Tensor:
    """Launch the kernel.  x_q: (M, K) and w_q: (K, N) int8, sx: (M,) and
    sw: (N,) float32, all on one card; any M and N, K a multiple of 4 up
    to ``MAX_K`` → (M, N) float32.  A w_q stored column-major (``k_major``)
    is read in place; any other is first copied K-major into scratch by the
    kernel's transposing pass.  x_q is copied zero-padded when K is not a
    multiple of ``K_ALIGN``.  One launch is counted per call."""
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
    Kp = padded_k(K)
    if Kp != K:
        padded = torch.zeros((M, Kp), dtype=torch.int8, device=x_q.device)
        padded[:, :K] = x_q
        x_q = padded
    else:
        x_q = x_q.contiguous()
    kmajor = k_major(w_q)
    w_q = w_q.T if kmajor else w_q.contiguous()
    if x_q.data_ptr() % 16 or w_q.data_ptr() % 16:
        raise ValueError("int8_matmul: x_q and w_q must be 16-byte aligned")
    out = _launch(x_q, w_q, sx.contiguous(), sw.contiguous(), K, kmajor)
    launches += 1
    return out


def _launch(x_p: torch.Tensor, w: torch.Tensor, sx: torch.Tensor, sw: torch.Tensor,
            K: int, kmajor: bool) -> torch.Tensor:
    """The kernel on operands as ``int8_matmul`` hands them over, unchecked
    and uncounted: x_p (M, Kp) with zeros past K; w (K, N) row-major, or with
    ``kmajor`` its K-major form (N, Kp), zeros past K, read in place."""
    (M, Kp), N = x_p.shape, w.shape[0] if kmajor else w.shape[1]
    wt = w if kmajor else torch.empty((N, Kp), dtype=torch.int8, device=x_p.device)
    out = torch.empty((M, N), dtype=torch.float32, device=x_p.device)
    err = _lib().int8_matmul_fwd(
        x_p.data_ptr(), w.data_ptr(), wt.data_ptr(), sx.data_ptr(), sw.data_ptr(),
        out.data_ptr(), M, N, K, Kp, int(kmajor),
        torch.cuda.current_stream(x_p.device).cuda_stream)
    _build.check(err, "int8_matmul")
    return out
