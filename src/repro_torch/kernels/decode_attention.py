"""Decode attention: the CUDA kernel's wrapper and its plain version.

The kernel (``csrc/decode_attention.cu``) replaces the Pallas TPU kernel
``repro.kernels.decode_attention.decode_attention`` and adds the window and
slot positions that decoding against the model's cache needs; its source
says what bounds it on the H100 and how its design answers that.
``launches`` counts the wrapper's calls that launch it (one per call, with
or without the kernel that combines the splits).  :func:`plan_splits`
chooses how the cache is cut across blocks.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import DTYPES, HEAD_DIMS, _check_operand
from repro_torch.kernels.ref import decode_attention_reference

# query heads per kv head, H/K: any from 1 to the kernel's MAXG (16), as the
# reference takes any H % K == 0 (granite-moe-3b-a800m has 3, dbrx-132b 6)
GROUP_SIZES = tuple(range(1, 17))
# slots per tile of each instantiation (Shape::TS in the source)
TILE = {**{(torch.float32, d): 32 for d in HEAD_DIMS},
        **{(torch.bfloat16, d): 32 if d == 256 else 64 for d in HEAD_DIMS}}
SPLIT_SLOTS = math.lcm(*TILE.values())   # a split is a whole number of tiles
BLOCKS_PER_SM = 2        # the grid the planner aims at: about 2 blocks per SM
MIN_SPLIT_BYTES = 256 * 1024

launches = 0


def plan_splits(B: int, K: int, T: int, d: int, itemsize: int,
                sms: int = _build.H100_SMS) -> Tuple[int, int]:
    """How the kernel cuts each (b, kv head)'s cache of T slots across
    blocks: (number of splits, slots per split).  Split s holds slots
    [s·chunk, min((s + 1)·chunk, T)); every slot lies in exactly one split
    and none is empty unless T is 0 (one empty split).  ``chunk`` is a
    multiple of SPLIT_SLOTS.

    The grid, B·K·splits blocks, aims at BLOCKS_PER_SM·``sms`` blocks where
    T allows: at d = 256 an SM holds three blocks, so the live ones (those
    past a short sequence's length return at once) run in one round
    (``chip_smoke.py`` phase 3 at gemma2-2b's decode shape ran 2 faster
    than 1, 3 and 4).

    A (b, kv head) whose K and V are at most MIN_SPLIT_BYTES (256 slots of
    d = 256 in bf16) is not split: one block reads it in a few
    microseconds, about what the combining kernel's launch would add."""
    tiles = -(-T // SPLIT_SLOTS)
    if tiles <= 1 or 2 * T * d * itemsize <= MIN_SPLIT_BYTES:
        return 1, max(tiles, 1) * SPLIT_SLOTS
    want = -(-BLOCKS_PER_SM * sms // (B * K))
    per = -(-tiles // min(want, tiles))
    return -(-tiles // per), per * SPLIT_SLOTS


# The plain PyTorch version of the kernel: the CPU path, and the card-side
# check of the kernel.
plain = decode_attention_reference


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library("decode_attention")
    fn = lib.decode_attention_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 9
                   + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
    return lib


def _int32_vector(name: str, t: torch.Tensor, shape) -> torch.Tensor:
    if t.shape != shape or t.dtype != torch.int32 or not t.is_cuda:
        raise ValueError(f"decode_attention: {name} must be a CUDA int32 "
                         f"tensor of shape {shape}")
    return t.contiguous()


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor, *, softcap: float = 0.0,
                     window: int = 0, q_pos: Optional[torch.Tensor] = None,
                     slot_pos: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the kernel.  q: (B, H, d); k/v: (B, K, T, d) on the card,
    float32 or bfloat16, H/K in 1..16 (GROUP_SIZES), d in {64, 128, 256};
    lengths (B,) int32 bounds the slots scanned; ``slot_pos`` (B, T) int32
    and ``q_pos`` (B,) int32 give the mask of
    :func:`repro_torch.kernels.ref.decode_mask`.  Any strides with a
    contiguous head dimension and 16-byte aligned rows.  The cache is split
    across blocks as :func:`plan_splits` says, with fp32 scratch for the
    splits' partial results.  → (B, H, d)."""
    global launches
    B, H, d = q.shape
    K, T = k.shape[1], k.shape[2]
    if d not in HEAD_DIMS:
        raise ValueError(f"decode_attention: head_dim {d} not in {HEAD_DIMS}")
    if H % K or H // K not in GROUP_SIZES or k.shape != (B, K, T, d) \
            or v.shape != k.shape:
        raise ValueError(f"decode_attention: bad shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)}")
    if q.dtype not in DTYPES:
        raise ValueError(f"decode_attention: dtype {q.dtype} not supported")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_operand(name, t, q.dtype)
    lengths = _int32_vector("lengths", lengths, (B,))
    if slot_pos is not None:
        if q_pos is None:
            raise ValueError("decode_attention: slot_pos needs q_pos")
        slot_pos = _int32_vector("slot_pos", slot_pos, (B, T))
    if q_pos is not None:
        q_pos = _int32_vector("q_pos", q_pos, (B,))
    out = torch.empty((B, H, d), dtype=q.dtype, device=q.device)
    nsplit, chunk = plan_splits(B, K, T, d, q.element_size(), _build.sm_count(q.device.index))
    part = (torch.empty(B * K * nsplit * (H // K) * (d + 2), dtype=torch.float32,
                        device=q.device) if nsplit > 1 else None)
    strides = (ctypes.c_longlong * 10)(*(q.stride()[:2] + k.stride()[:3]
                                         + v.stride()[:3] + out.stride()[:2]))
    lib = _lib()
    err = lib.decode_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        part.data_ptr() if part is not None else None, lengths.data_ptr(),
        q_pos.data_ptr() if q_pos is not None else None,
        slot_pos.data_ptr() if slot_pos is not None else None, strides,
        B, H, K, T, d, DTYPES[q.dtype], int(window), nsplit, chunk, float(softcap),
        1.0 / math.sqrt(d), torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "decode_attention")
    launches += 1
    return out
