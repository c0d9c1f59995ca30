"""RG-LRU scan: the CUDA kernel's wrapper and its plain version.

The kernel (``csrc/rglru_scan.cu``) replaces the Pallas TPU kernel
``repro.kernels.rglru_scan.rglru_scan``; its source says what bounds it on
the H100 and how its design answers that.  ``launches`` counts the kernel's
launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import rglru_reference

DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0


def plain(a: torch.Tensor, b: torch.Tensor,
          s0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of the kernel: the CPU path, and the
    card-side check of the kernel.  As the Pallas kernel does, a and b are
    widened to fp32, the recurrence runs in fp32, and the states come back in
    a's dtype (the last one in fp32)."""
    seq, last = rglru_reference(a.float(), b.float(), s0.float())
    return seq.to(a.dtype), last


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library("rglru_scan")
    fn = lib.rglru_scan_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    return lib


def rglru_scan(a: torch.Tensor, b: torch.Tensor,
               s0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel.  a/b: (B, S, R) float32 or bfloat16, one dtype,
    and s0: (B, R) float32, on one card; any B ≤ 65535, S and R → (seq
    (B, S, R) in a's dtype, last (B, R) float32)."""
    global launches
    if a.dim() != 3 or b.shape != a.shape or s0.shape != (a.shape[0], a.shape[2]):
        raise ValueError(f"rglru_scan: bad shapes a{tuple(a.shape)} "
                         f"b{tuple(b.shape)} s0{tuple(s0.shape)}")
    if a.dtype not in DTYPES:
        raise ValueError(f"rglru_scan: dtype {a.dtype} not supported")
    for name, t, dtype in (("a", a, a.dtype), ("b", b, a.dtype),
                           ("s0", s0, torch.float32)):
        if not t.is_cuda or t.dtype != dtype or t.device != a.device:
            raise ValueError(f"rglru_scan: {name} must be a {dtype} tensor on "
                             f"the card of a, got {t.device} {t.dtype}")
    B, S, R = a.shape
    a, b, s0 = a.contiguous(), b.contiguous(), s0.contiguous()
    seq = torch.empty_like(a)
    last = torch.empty_like(s0)
    err = _lib().rglru_scan_fwd(
        a.data_ptr(), b.data_ptr(), s0.data_ptr(), seq.data_ptr(),
        last.data_ptr(), B, S, R, DTYPES[a.dtype],
        torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(err, "rglru_scan")
    launches += 1
    return seq, last
