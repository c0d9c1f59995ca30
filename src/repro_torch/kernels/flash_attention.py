"""Flash attention (prefill): the CUDA kernels' wrappers and their plain
versions.

The forward kernel (``csrc/flash_attention.cu``) replaces the Pallas TPU
kernel ``repro.kernels.flash_attention.flash_attention``; the backward
kernel (``csrc/flash_attention_bwd.cu``) computes dQ, dK and dV of the same
function and replaces no TPU kernel (the reference takes the gradient from
XLA's autodiff).  Each source says what bounds it on the H100 and how its
design answers that: in bf16 both run their products on ``wgmma`` fed by
TMA, the forward's launch being :func:`plan` and the backward's two
:func:`plan_bwd`, with P and dS fed to the backward's gradient products in
bf16 parts; in fp32 on the CUDA cores.  The bf16 backward takes the
forward's state: each row's log-sum-exp and the output in fp32, which
:func:`flash_attention` returns with ``return_stats=True``.  ``launches``
and ``launches_bwd`` count the calls (the backward's passes once), so a run
can show that its main path went through them.  :class:`FlashAttention`
ties the two together for autograd; :func:`plain_grad` is the backward's
plain version.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import mha_reference

HEAD_DIMS = (64, 128, 256)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# keys per kv tile of each instantiation (BK and kv_tile<D> in the source)
KV_TILE = {**{(torch.float32, d): 32 for d in HEAD_DIMS},
           **{(torch.bfloat16, d): 32 if d == 256 else 64 for d in HEAD_DIMS}}
# The forward kernels' launch, as the source lays it out: fp32 blocks of 64
# query rows on 256 threads (BQ, NTHREADS), each kv tile loaded, then used;
# bf16 blocks of 128 rows (BQ_WG), two consumer warpgroups of 64 and the
# producer's warpgroup, a ring of 3 K/V tiles (WG_STAGES), longest causal
# rows first.
BLOCK_ROWS = {torch.float32: 64, torch.bfloat16: 128}
THREADS = {torch.float32: 256, torch.bfloat16: 384}
STAGES = {torch.float32: 1, torch.bfloat16: 3}
SMEM_LIMIT = 232448   # shared bytes a block may take on an H100 (227 KB)
# rows of the forward's lse and the backward's D are padded to a multiple of
# this (kStatsRows in flash_attention_bwd.cu; BQ_WG, the bf16 forward's
# block rows, in flash_attention.cu)
STATS_ROWS = 128
# The bf16 backward's two launches, as flash_attention_bwd.cu lays them out:
# blocks of two consumer warpgroups of 64 rows and the producer's warpgroup
# (WG_ROWS, WG_THREADS), a ring of 3 tiles (STAGES).  The dQ kernel: 128
# query rows a block (DqTiles::BQ), kv tiles of 64 keys, 32 at d = 256
# (DqTiles::BKV); the dK/dV kernel: 128 keys a block at d = 64, 64 a
# consumer warpgroup, else 64 (DkvTiles::BKV), query tiles of 64 rows, 32
# at d = 256 (DkvTiles::BQ).
BWD_THREADS = 384
BWD_STAGES = 3
BWD_DQ_ROWS = 128
BWD_DKV_KEYS = {d: 128 if d == 64 else 64 for d in HEAD_DIMS}
BWD_TILE = {d: 32 if d == 256 else 64 for d in HEAD_DIMS}

launches = 0
launches_bwd = 0

# The plain PyTorch version of the kernel: the CPU path, and the card-side
# check of the kernel.
plain = mha_reference


class Plan(NamedTuple):
    """A forward call's launch: a ``grid`` (q tiles, heads, sequences) of
    blocks of ``threads``, each of ``rows`` query rows of one head of one
    sequence, walking kv tiles of ``kv_tile`` keys through ``stages``
    buffers in ``smem`` bytes of shared memory."""
    grid: tuple
    rows: int
    kv_tile: int
    stages: int
    smem: int
    threads: int
    longest_first: bool

    def block_rows(self, x: int) -> range:
        """The query rows of the blocks at grid index x."""
        tile = self.grid[0] - 1 - x if self.longest_first else x
        return range(tile * self.rows, (tile + 1) * self.rows)

    def kv_range(self, x: int, Sq: int, length: int, causal: bool, window: int) -> range:
        """The keys the blocks at grid index x read: whole tiles from the
        tile of the window's first key to the last key a row of the block
        may see (``length`` keys live); the kernel masks the rest."""
        rows = self.block_rows(x)
        end = min(length, rows.stop, Sq) if causal else length
        begin = max(0, rows.start - window + 1) if window > 0 else 0
        begin -= begin % self.kv_tile
        if begin >= end:
            return range(begin, begin)
        return range(begin, begin + -(-(end - begin) // self.kv_tile) * self.kv_tile)


def plan(B: int, H: int, Sq: int, d: int, dtype: torch.dtype) -> Plan:
    """The launch :func:`flash_attention` makes for q of (B, H, Sq, d)."""
    rows, tile = BLOCK_ROWS[dtype], KV_TILE[dtype, d]
    if dtype == torch.float32:   # Q, K and V at pitch d + 1, P at pitch BK + 1
        smem = ((rows + 2 * tile) * (d + 1) + rows * (tile + 1)) * 4
    else:   # 1024-byte alignment, Q, the ring of K and V, its mbarriers
        stages = STAGES[dtype]
        smem = 1024 + rows * d * 2 + 2 * stages * tile * d * 2 + 8 * (1 + 3 * stages)
    return Plan((-(-Sq // rows), H, B), rows, tile, STAGES[dtype], smem, THREADS[dtype],
                dtype == torch.bfloat16)


class BwdPlan(NamedTuple):
    """A bf16 backward call's two launches, each a grid of blocks of
    ``threads`` walking tiles through ``stages`` buffers.  The dQ kernel:
    ``dq_grid`` (heads, sequences, query tiles), blocks of ``dq_rows`` query
    rows of one head, longest causal rows first, over kv tiles of
    ``dq_kv_tile`` keys, in ``dq_smem`` bytes.  The dK/dV kernel:
    ``dkv_grid`` (kv heads, sequences, key tiles), blocks of ``dkv_keys``
    keys of one kv head over query tiles of ``dkv_q_tile`` rows of each of
    its query heads, in ``dkv_smem`` bytes."""
    dq_grid: tuple
    dq_rows: int
    dq_kv_tile: int
    dq_smem: int
    dkv_grid: tuple
    dkv_keys: int
    dkv_q_tile: int
    dkv_smem: int
    stages: int
    threads: int

    def dq_block_rows(self, z: int) -> range:
        """The query rows of the dQ blocks at grid index z."""
        tile = self.dq_grid[2] - 1 - z
        return range(tile * self.dq_rows, (tile + 1) * self.dq_rows)

    def dkv_block_keys(self, z: int) -> range:
        """The keys of the dK/dV blocks at grid index z."""
        return range(z * self.dkv_keys, (z + 1) * self.dkv_keys)


def plan_bwd(B: int, H: int, K: int, Sq: int, Skv: int, d: int) -> BwdPlan:
    """The launches :func:`flash_attention_bwd` makes in bf16 for q of (B,
    H, Sq, d) and k, v of (B, K, Skv, d)."""
    rows, keys, tile, st = BWD_DQ_ROWS, BWD_DKV_KEYS[d], BWD_TILE[d], BWD_STAGES
    # 1024-byte alignment, the tiles, D of the block's rows, the mbarriers
    dq_smem = 1024 + 2 * rows * d * 2 + 2 * st * tile * d * 2 + 4 * rows + 8 * (1 + 2 * st)
    # 1024-byte alignment, K and V, the ring of Q, dO, lse and D, the mbarriers
    dkv_smem = 1024 + 2 * keys * d * 2 + st * (2 * tile * d * 2 + 2 * tile * 4) + 8 * (1 + 2 * st)
    return BwdPlan((H, B, -(-Sq // rows)), rows, tile, dq_smem,
                   (K, B, -(-Skv // keys)), keys, tile, dkv_smem, st, BWD_THREADS)


def stats_pitch(Sq: int) -> int:
    """Rows of a head's lse and D: Sq padded to a multiple of STATS_ROWS."""
    return -(-Sq // STATS_ROWS) * STATS_ROWS


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library("flash_attention")
    fn = lib.flash_attention_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 9
                   + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
    return lib


@functools.cache
def _lib_bwd() -> ctypes.CDLL:
    lib = _build.library("flash_attention_bwd")
    fn = lib.flash_attention_bwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 9
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


def _check_call(q, k, v, lengths):
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
    return lengths


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0,
                    lengths: Optional[torch.Tensor] = None,
                    return_stats: bool = False):
    """Launch the kernel.  q: (B, H, Sq, d); k/v: (B, K, Skv, d) on the card,
    float32 or bfloat16, H % K == 0, d in {64, 128, 256}; ``lengths`` (B,)
    int32 masks keys ≥ lengths[b]; ``window`` 0 = global.  Any strides with a
    contiguous head dimension.  → (B, H, Sq, d), strided like q.

    ``return_stats`` → (out, out32, lse), the state :func:`flash_attention_bwd`
    takes: in bf16 the output before its rounding, (B, H, Sq, d) fp32, and
    each row's log-sum-exp of the scaled, capped scores, (B, H,
    ``stats_pitch(Sq)``) fp32, written from the kernel's registers (``out``
    keeps its bits); in fp32, whose backward takes no state, None and None."""
    global launches
    B, H, Sq, d = q.shape
    K, Skv = k.shape[1], k.shape[2]
    lengths = _check_call(q, k, v, lengths)
    out = torch.empty_like(q)
    out32 = lse = None
    if return_stats and q.dtype == torch.bfloat16:
        out32 = torch.empty((B, H, Sq, d), dtype=torch.float32, device=q.device)
        lse = torch.empty((B, H, stats_pitch(Sq)), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 12)(*(q.stride()[:3] + k.stride()[:3]
                                         + v.stride()[:3] + out.stride()[:3]))
    lib = _lib()
    err = lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if out32 is None else out32.data_ptr(), None if lse is None else lse.data_ptr(),
        lengths.data_ptr() if lengths is not None else None, strides,
        B, H, K, Sq, Skv, d, DTYPES[q.dtype], int(causal), int(window),
        float(softcap), 1.0 / math.sqrt(d),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_attention")
    launches += 1
    return (out, out32, lse) if return_stats else out


def _check_state(q, out32, lse) -> None:
    B, H, Sq, d = q.shape
    if q.dtype == torch.float32:
        if out32 is not None or lse is not None:
            raise ValueError("flash_attention_bwd: the fp32 kernel takes no forward state")
        return
    want = {"out32": (out32, (B, H, Sq, d)), "lse": (lse, (B, H, stats_pitch(Sq)))}
    for name, (t, shape) in want.items():
        if t is None or t.shape != shape or t.dtype != torch.float32 or not t.is_cuda \
                or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash_attention_bwd: {name} must be the forward's contiguous "
                             f"CUDA float32 {shape} (flash_attention(..., return_stats=True))")


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        dout: torch.Tensor, out32: Optional[torch.Tensor],
                        lse: Optional[torch.Tensor], *, causal: bool = True, window: int = 0,
                        softcap: float = 0.0, lengths: Optional[torch.Tensor] = None):
    """Launch the backward kernel: the gradients (dq, dk, dv) of
    :func:`flash_attention`'s output, given ``dout`` of its shape and the
    forward's state (``out32``, ``lse``: what ``flash_attention(...,
    return_stats=True)`` returned beside the output on the same inputs;
    None, None in fp32), each in the inputs' dtype and strided like its
    input.  Operands as for the forward; ``dout`` with any strides and a
    contiguous head dimension."""
    global launches_bwd
    B, H, Sq, d = q.shape
    K, Skv = k.shape[1], k.shape[2]
    lengths = _check_call(q, k, v, lengths)
    if dout.shape != q.shape:
        raise ValueError(f"flash_attention_bwd: dout {tuple(dout.shape)}, want {tuple(q.shape)}")
    if dout.stride(-1) != 1 or any(s * dout.element_size() % 16 for s in dout.stride()[:-1]) \
            or dout.data_ptr() % 16:
        dout = dout.contiguous()
    _check_operand("dout", dout, q.dtype)
    _check_state(q, out32, lse)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    # bf16: D and lse in the exponent's units, for the dK/dV kernel; fp32:
    # the three passes' lse and D
    scratch = torch.empty((2, B, H, stats_pitch(Sq)), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 21)(*(s for t in (q, k, v, dout, dq, dk, dv)
                                         for s in t.stride()[:3]))
    err = _lib_bwd().flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        None if out32 is None else out32.data_ptr(), None if lse is None else lse.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), scratch.data_ptr(),
        lengths.data_ptr() if lengths is not None else None, strides,
        B, H, K, Sq, Skv, d, DTYPES[q.dtype], int(causal), int(window),
        float(softcap), 1.0 / math.sqrt(d), torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_attention_bwd")
    launches_bwd += 1
    return dq, dk, dv


def plain_grad(q, k, v, dout, *, acc: torch.dtype = torch.float32, **kw):
    """The backward's plain version: ``torch.autograd.grad`` through
    :func:`mha_reference` on q, k and v cast to ``acc`` (float64 where the
    kernel is checked) → (dq, dk, dv) in ``acc``."""
    with torch.enable_grad():
        q, k, v = (t.detach().to(acc).requires_grad_() for t in (q, k, v))
        out = mha_reference(q, k, v, acc=acc, **kw)
        return torch.autograd.grad(out, (q, k, v), dout.to(acc))


class FlashAttention(torch.autograd.Function):
    """The forward kernel, differentiated by the backward kernel: what
    ``ops.flash_attention`` runs on the card when a gradient is wanted.  The
    forward keeps its state for the backward (bf16: 4·d + 4 bytes a query
    row and head, fp32 output and lse)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, lengths):
        ctx.opts = dict(causal=causal, window=window, softcap=softcap, lengths=lengths)
        out, out32, lse = flash_attention(q, k, v, return_stats=True, **ctx.opts)
        ctx.save_for_backward(q, k, v, out32, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out32, lse = ctx.saved_tensors
        return (*flash_attention_bwd(q, k, v, dout, out32, lse, **ctx.opts),
                None, None, None, None)

