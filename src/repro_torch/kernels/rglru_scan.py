"""RG-LRU scan: the CUDA kernel's wrapper, its planner and its plain version.

The kernel (``csrc/rglru_scan.cu``) replaces the Pallas TPU kernel
``repro.kernels.rglru_scan.rglru_scan``; its source says what bounds it on
the H100 and how its design answers that.  It has two variants, both
bitwise equal to :func:`plain`: a ring of bulk copies in shared memory, and
the register body for the shapes bulk copies cannot take and for small
problems.  :func:`plan`
chooses one before each launch; ``last_plan`` holds the plan of the latest
launch and ``launches`` counts the launches.

The backward kernel (``csrc/rglru_scan_bwd.cu``) computes the gradient of
the same function and replaces no TPU kernel (the reference differentiates
its scan with XLA).  It has the same two variants, both bitwise equal to
:func:`plain_grad`'s sequential fp32 walk: :func:`plan_bwd` chooses one,
``last_bwd_plan`` holds the plan of the latest launch and ``launches_bwd``
counts the launches.
:class:`RGLRUScan` ties the two together for autograd; :func:`plain_grad`
is the backward's plain version.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import H100_SMS
from repro_torch.kernels.ref import rglru_backward_reference, rglru_reference

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
VARIANTS = {"register": 0, "ring": 1}
SMALL = 4 * 256 * 256           # B·S·R at most that the register body takes
RING_CHANNELS = (128, 32)       # C, channels a block of the ring variant
MAX_STEPS = 128                 # T at most
STAGE_BYTES = 32 * 1024         # a stage's a and b rows at most
RING_BYTES_PER_SM = 64 * 1024   # the ring's shared memory an SM aims at
MAX_STAGES = 32                 # P at most (the kernel's mbarrier slots)
BARRIER_BYTES = 2 * MAX_STAGES * 8
PRODUCERS = 8                   # producer warps a block of the ring
SMEM_PER_SM = 233472            # 228 KB an SM, of which each block reserves
SMEM_RESERVED = 1024            # 1 KB for the system
SMEM_PER_BLOCK = 232448         # 227 KB, a block's most
BLOCKS_PER_SM = 32              # resident blocks an SM holds at most
THREADS_PER_SM = 2048

launches = 0
launches_bwd = 0
BWD_CHUNK = 16                  # steps between the states the register backward stores (CH)
BWD_TILES = 3                   # a, b and g a stage of the backward's ring


class Plan(NamedTuple):
    """How one call runs: ``variant`` "ring" or "register"; ``channels`` (C)
    a block; ``steps`` (T) a stage of the ring (the register body: steps
    whose loads it holds in registers at once); ``stages`` (P) of the ring
    (1 for the register body)."""
    variant: str
    channels: int
    steps: int
    stages: int

    def smem_bytes(self, itemsize: int) -> int:
        """Dynamic shared memory a block takes."""
        if self.variant == "register":
            return 0
        return BARRIER_BYTES + 2 * self.stages * self.steps * self.channels * itemsize

    def threads(self) -> int:
        """Threads a block."""
        return self.channels + (32 * PRODUCERS if self.variant == "ring" else 0)

    def blocks(self, B: int, R: int) -> int:
        return B * -(-R // self.channels)


REGISTER = Plan("register", 128, 16, 1)
last_plan: Optional[Plan] = None
last_bwd_plan: Optional[Plan] = None


@functools.lru_cache(maxsize=1024)   # a lookup, not a plan, on the host's path
def plan(B: int, S: int, R: int, itemsize: int, sm_count: int = H100_SMS,
         aligned: bool = True) -> Plan:
    """The variant and shape of one call on a card of ``sm_count`` SMs.

    The register body when bulk copies cannot take the call (a row of
    ``R * itemsize`` bytes that is not a multiple of 16, or a base of a or b
    off 16-byte alignment: ``aligned`` False), and for problems of at most
    ``SMALL`` elements B·S·R, the calibration grid's largest (B ≤ 4,
    S ≤ 256, R = 256).  On that grid a synchronised call, the calibration's
    own measure, took 1-19 µs less with the register body than with the
    ring at all 9 points in fp32 and at 7 of 9 in bf16 (medians of 9 sweeps,
    ``launch/sweep_rglru.py --calibration``; ``PERF.md`` §6), while at
    ``profile_step.py``'s 8 × 512 × 4096 the ring took 0.075 ms to the
    register body's 0.093; sizes in between are not measured.  The ring's
    shape, from ``launch/sweep_rglru.py`` on an H100:
    - C, channels a block, the one of ``RING_CHANNELS`` that puts the fewest
      channels on the busiest SM (ceil(blocks / SMs) · C), the larger C on a
      tie (wider rows, fewer copies): C = 128 at B = 4, R = 4096; C = 32 at
      B = 1, R = 4096 (128 blocks, where C = 128 would give 32).  C = 64
      was slower than both at B = 1 and at B = 4 in development builds,
      and is not built;
    - T steps a stage: as many as fit ``STAGE_BYTES`` of a and b rows, at
      most ``MAX_STEPS`` and at most S (T = 32 in fp32 and 64 in bf16 at
      C = 128; 128 at C = 32);
    - P stages, so that the blocks an SM holds take about
      ``RING_BYTES_PER_SM`` of ring between them: at least 2 (1 when the
      sequence is one stage), at most ``MAX_STAGES``, no more than the
      sequence has, and within the shared memory of a block and of an SM.
      At B = 4, R = 4096 a deeper ring was slower in both types.
    Every block is then resident in one wave while ceil(blocks / SMs) stays
    within what an SM holds (32 blocks, 2048 threads, 228 KB)."""
    if not aligned or (R * itemsize) % 16 or B * S * R <= SMALL:
        return REGISTER
    C = min(RING_CHANNELS, key=lambda c: (-(-(B * -(-R // c)) // sm_count) * c, -c))
    per_sm = min(-(-(B * -(-R // C)) // sm_count),
                 BLOCKS_PER_SM, THREADS_PER_SM // (C + 32 * PRODUCERS))
    T = max(1, min(MAX_STEPS, S, STAGE_BYTES // (2 * C * itemsize)))
    stage = 2 * T * C * itemsize
    room = min(SMEM_PER_BLOCK, SMEM_PER_SM // max(per_sm, 1) - SMEM_RESERVED) - BARRIER_BYTES
    want = RING_BYTES_PER_SM // max(per_sm, 1) // stage
    P = min(MAX_STAGES, max(-(-S // T), 1), max(2, want), max(1, room // stage))
    return Plan("ring", C, T, P)


@functools.lru_cache(maxsize=1024)
def plan_bwd(B: int, S: int, R: int, itemsize: int, sm_count: int = H100_SMS,
             aligned: bool = True) -> Plan:
    """The variant and shape of one backward call: :func:`plan`'s variant,
    C and T, and P stages of ``BWD_TILES`` tiles (a, b and g), chosen as
    :func:`plan` chooses them, beside each block's fp32 area of T x C for
    the states of the stage being walked back."""
    fwd = plan(B, S, R, itemsize, sm_count, aligned)
    if fwd.variant == "register":
        return REGISTER
    C, T = fwd.channels, fwd.steps
    per_sm = min(-(-(B * -(-R // C)) // sm_count),
                 BLOCKS_PER_SM, THREADS_PER_SM // (C + 32 * PRODUCERS))
    stage = BWD_TILES * T * C * itemsize
    room = (min(SMEM_PER_BLOCK, SMEM_PER_SM // max(per_sm, 1) - SMEM_RESERVED)
            - BARRIER_BYTES - 4 * T * C)
    want = RING_BYTES_PER_SM // max(per_sm, 1) // stage
    P = min(MAX_STAGES, max(-(-S // T), 1), max(2, want), max(1, room // stage))
    return Plan("ring", C, T, P)


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
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    return lib


def rglru_scan(a: torch.Tensor, b: torch.Tensor, s0: torch.Tensor,
               use: Optional[Plan] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel.  a/b: (B, S, R) float32 or bfloat16, one dtype,
    and s0: (B, R) float32, on one card; any B ≤ 65535, S and R → (seq
    (B, S, R) in a's dtype, last (B, R) float32).  ``use`` overrides
    :func:`plan` (for measurements; a plan the kernel cannot take raises)."""
    global launches, last_plan
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
    p = use or plan(B, S, R, a.element_size(), _build.sm_count(a.device.index),
                    aligned=a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0)
    seq = torch.empty_like(a)
    last = torch.empty_like(s0)
    err = _lib().rglru_scan_fwd(
        a.data_ptr(), b.data_ptr(), s0.data_ptr(), seq.data_ptr(),
        last.data_ptr(), B, S, R, DTYPES[a.dtype], VARIANTS[p.variant], p.channels,
        p.steps, p.stages, torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(err, f"rglru_scan ({p})")
    launches += 1
    last_plan = p
    return seq, last


@functools.cache
def _lib_bwd() -> ctypes.CDLL:
    lib = _build.library("rglru_scan_bwd")
    fn = lib.rglru_scan_bwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    return lib


def rglru_scan_bwd(a: torch.Tensor, b: torch.Tensor, s0: torch.Tensor, g: torch.Tensor,
                   g_last: Optional[torch.Tensor] = None, use: Optional[Plan] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the backward kernel: the gradients (da, db, ds0) of
    :func:`rglru_scan` given ``g`` (B, S, R), the gradient of its states,
    and ``g_last`` (B, R) fp32, that of the last one (None: zero).  Operands
    as for the forward, ``g`` in a's dtype; da and db come back in a's dtype,
    ds0 in fp32.  The fp32 states are recomputed from a, b and s0.  ``use``
    overrides :func:`plan_bwd` (for measurements; a plan the kernel cannot
    take raises)."""
    global launches_bwd, last_bwd_plan
    if g_last is None:
        g_last = torch.zeros_like(s0)
    if a.dim() != 3 or b.shape != a.shape or g.shape != a.shape \
            or s0.shape != (a.shape[0], a.shape[2]) or g_last.shape != s0.shape:
        raise ValueError(f"rglru_scan_bwd: bad shapes a{tuple(a.shape)} b{tuple(b.shape)} "
                         f"s0{tuple(s0.shape)} g{tuple(g.shape)} g_last{tuple(g_last.shape)}")
    if a.dtype not in DTYPES:
        raise ValueError(f"rglru_scan_bwd: dtype {a.dtype} not supported")
    for name, t, dtype in (("a", a, a.dtype), ("b", b, a.dtype), ("g", g, a.dtype),
                           ("s0", s0, torch.float32), ("g_last", g_last, torch.float32)):
        if not t.is_cuda or t.dtype != dtype or t.device != a.device:
            raise ValueError(f"rglru_scan_bwd: {name} must be a {dtype} tensor on the "
                             f"card of a, got {t.device} {t.dtype}")
    B, S, R = a.shape
    a, b, s0, g, g_last = (t.contiguous() for t in (a, b, s0, g, g_last))
    p = use or plan_bwd(B, S, R, a.element_size(), _build.sm_count(a.device.index),
                        aligned=all(t.data_ptr() % 16 == 0 for t in (a, b, g)))
    da, db, ds0 = torch.empty_like(a), torch.empty_like(b), torch.empty_like(s0)
    every = BWD_CHUNK if p.variant == "register" else p.steps   # steps between stored states
    starts = torch.empty((B, -(-S // every), R), dtype=torch.float32, device=a.device)
    err = _lib_bwd().rglru_scan_bwd(
        a.data_ptr(), b.data_ptr(), s0.data_ptr(), g.data_ptr(), g_last.data_ptr(),
        da.data_ptr(), db.data_ptr(), ds0.data_ptr(), starts.data_ptr(), B, S, R,
        DTYPES[a.dtype], VARIANTS[p.variant], p.channels, p.steps, p.stages,
        torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(err, f"rglru_scan_bwd ({p})")
    launches_bwd += 1
    last_bwd_plan = p
    return da, db, ds0


def plain_grad(a, b, s0, g, g_last=None, *, acc: torch.dtype = torch.float32):
    """The backward's plain version: :func:`rglru_backward_reference` on
    every operand cast to ``acc`` (float64 where the kernel is checked) →
    (da, db, ds0) in ``acc``."""
    return rglru_backward_reference(*(None if t is None else t.to(acc)
                                      for t in (a, b, s0, g, g_last)))


class RGLRUScan(torch.autograd.Function):
    """The forward kernel, differentiated by the backward kernel: what
    ``ops.rglru_scan`` runs on the card when a gradient is wanted."""

    @staticmethod
    def forward(ctx, a, b, s0):
        ctx.save_for_backward(a, b, s0)
        return rglru_scan(a, b, s0)

    @staticmethod
    def backward(ctx, g, g_last):
        a, b, s0 = ctx.saved_tensors
        da, db, ds0 = rglru_scan_bwd(a, b, s0, g, g_last)
        return tuple(x if want else None
                     for x, want in zip((da, db, ds0), ctx.needs_input_grad))
