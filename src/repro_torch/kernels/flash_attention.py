"""Flash attention (prefill): the CUDA kernel's wrapper and its plain version.

The kernel (``csrc/flash_attention.cu``) replaces the Pallas TPU kernel
``repro.kernels.flash_attention.flash_attention``; its source says what
bounds it on the H100 and how its design answers that.  ``launches`` counts
the kernel's launches, so a run can show that its main path went through it.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import mha_reference

HEAD_DIMS = (64, 128, 256)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# keys per kv tile of each instantiation (BK and kv_tile<D> in the source)
KV_TILE = {**{(torch.float32, d): 32 for d in HEAD_DIMS},
           **{(torch.bfloat16, d): 32 if d == 256 else 64 for d in HEAD_DIMS}}

launches = 0

# The plain PyTorch version of the kernel: the CPU path, and the card-side
# check of the kernel.
plain = mha_reference


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library("flash_attention")
    fn = lib.flash_attention_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 9
                   + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
    return lib


def _check_operand(name: str, t: torch.Tensor, dtype) -> None:
    if not t.is_cuda or t.dtype != dtype:
        raise ValueError(f"{name}: want a CUDA {dtype} tensor, got "
                         f"{t.device} {t.dtype}")
    if t.stride(-1) != 1 or any(s * t.element_size() % 16 for s in t.stride()[:-1]) \
            or t.data_ptr() % 16:
        raise ValueError(f"{name}: the head dimension must be contiguous and "
                         "rows 16-byte aligned")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0,
                    lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the kernel.  q: (B, H, Sq, d); k/v: (B, K, Skv, d) on the card,
    float32 or bfloat16, H % K == 0, d in {64, 128, 256}; ``lengths`` (B,)
    int32 masks keys ≥ lengths[b]; ``window`` 0 = global.  Any strides with a
    contiguous head dimension.  → (B, H, Sq, d), strided like q."""
    global launches
    B, H, Sq, d = q.shape
    K, Skv = k.shape[1], k.shape[2]
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {d} not in {HEAD_DIMS}")
    if H % K or k.shape != (B, K, Skv, d) or v.shape != k.shape:
        raise ValueError(f"flash_attention: bad shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)}")
    if q.dtype not in DTYPES:
        raise ValueError(f"flash_attention: dtype {q.dtype} not supported")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_operand(name, t, q.dtype)
    if lengths is not None:
        if lengths.shape != (B,) or lengths.dtype != torch.int32 or not lengths.is_cuda:
            raise ValueError("flash_attention: lengths must be a CUDA (B,) int32")
        lengths = lengths.contiguous()
    out = torch.empty_like(q)
    strides = (ctypes.c_longlong * 12)(*(q.stride()[:3] + k.stride()[:3]
                                         + v.stride()[:3] + out.stride()[:3]))
    lib = _lib()
    err = lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lengths.data_ptr() if lengths is not None else None, strides,
        B, H, K, Sq, Skv, d, DTYPES[q.dtype], int(causal), int(window),
        float(softcap), 1.0 / math.sqrt(d),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_attention")
    launches += 1
    return out
