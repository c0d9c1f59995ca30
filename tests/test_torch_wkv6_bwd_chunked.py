"""K4′'s decomposition and its tf32 arithmetic, on the CPU.

``twin_grad`` below is a plain-PyTorch twin of ``kernels/csrc/wkv6_bwd.cu``,
with no CUDA: it follows the kernel's decomposition, not the sequential one.
- The sequence is cut into the backward's segments
  (``wk.plan_bwd_segments``, or a given count) of 32-step chunks.  Each segment's state contribution
  from a zero state and its gradient contribution from a zero gradient at
  its end are chained across segments, then each segment is re-run: its
  chunks' states forward from the state entering it, then its chunks last to
  first from the gradient leaving it, the gradient carried back across each.
- Within a chunk, the intra-chunk sums of dr′ and dk′ and the forward's
  matrix A by the block-boundary factorisation: the blocks below the
  diagonal as products of a row factor Π_{b<=j<t} e_j and a column factor
  Π_{s<j<b} e_j at b = 16 (rows 16.. against columns ..15), 8 and 24 (the
  two 8 x 8 blocks left); the diagonal 8 x 8 blocks by their walks.
- Every product that the kernel runs on the tensor cores takes its operands
  as fp32 values split into tf32 parts (round to nearest, ties away, to 10
  bits; then the rounding of what that leaves), in the kernel's passes: one
  where both operands hold bf16 values, two where one does, three where
  neither does (``WKV_BWD_TF32_PASSES``, read from the source); the parts'
  products summed in float64.  The tensor cores' truncating sums are not
  modelled: ``parity_probe.py --kernel recurrent_bwd`` measures the kernel
  at each number of passes on the card.

``twin_grad_wgmma`` is the twin of the wgmma kernel (bf16 at N = 64, B·H
at least ``wk.BWD_WGMMA_HEADS``, ``wk.backward_plan``): one segment of 64-step
chunks, the states forward (their increment's k ⊙ sd in ``CPARTS`` bf16
parts), then each chunk last to first: P and Pᵀ exact, S_c and Go in
``WKV_BWD_PARTS`` parts against dO and V, the levels 32, 16 and 8 (F_L =
r ⊙ Π e from the start of a row's L-block where the row has bit L set, k ⊙
Π e to its end elsewhere; P masked to the level's pairs against F_L, Aᵀ
from F_L F_Lᵀ, every product on the parts' pairs whose indices sum to
``WKV_BWD_PARTS`` − 1 or more), the diagonal 8 x 8 blocks by their walks,
dv, the gradient's chain in ``CPARTS`` parts, and dlogw by the identity
per half of 32 steps; both part counts read from the source.

The tests hold the twin
- with exact products (no split), on numpy-seeded inputs, to float64
  autograd through ``ref.wkv6_reference`` within F64_TOL of each gradient's
  largest entry, at S ∈ {0, 1, 31, 33, 300} and N ∈ {16, 32, 64} (16 run
  zero-padded to 32, as ``wk.pad_heads`` runs it), in one segment and in the
  planner's segments;
- in the kernel's passes, on bf16-valued and fp32 inputs, to ``jax.vjp`` of
  the JAX package's sequential ``repro.kernels.ref.wkv6_reference`` and of
  its chunked ``repro.models.rwkv6.wkv_chunked`` within FP32_TOL, the
  tolerances of ``tests/test_torch_recurrent_grad.py``, and with logw down
  to −e³ (sums far below fp32's exponential range) finite and within
  FP32_TOL of the float64 formulas;
- rounded to the kernel's output types, within ``chip_smoke.py`` phase 19's
  limits (``wkv_bwd_limits``); and show that one tf32 pass, or two where
  both operands are fp32 values, exceeds them, which is why the kernel takes
  the passes it takes;
and the wgmma twin (``"wgmma"`` cases of the same tests) with exact
products to float64 autograd (S ∈ {0, 1, 31, 33, 63, 65, 300}), in its
parts to ``jax.vjp`` of the sequential reference within FP32_TOL, with
logw down to −e³ finite, and within phase 19's limits, which one part fewer
exceeds (~19x).
"""
import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.models import rwkv6 as jrwkv  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import wkv6 as wk  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CSRC = Path(wk.__file__).resolve().parent / "csrc"
FP32_TOL = 1e-5     # tests/test_torch_recurrent_grad.py: against JAX in fp32
F64_TOL = 1e-12     # and against float64 autograd
T, Q, H2 = 32, 8, 16   # the kernel's chunk, diagonal block and half chunk


def shipped_passes() -> int:
    """``WKV_BWD_TF32_PASSES`` as the kernel ships it."""
    src = (CSRC / "wkv6_bwd.cu").read_text()
    return int(re.search(r"#ifndef WKV_BWD_TF32_PASSES\n#define WKV_BWD_TF32_PASSES (\d+)",
                         src)[1])


def chip_smoke():
    """``chip_smoke.py`` (at the repository root) as a module, for its
    phase 19 limits."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 ``x`` rounded to tf32 (10 explicit bits), to nearest, ties away
    from zero (cvt.rna.tf32.f32)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor):
    """The float64 ``x``'s fp32 value as its tf32 part and the tf32 rounding
    of what that leaves (``tf32_split``), in float64."""
    x32 = x.float()
    big = tf32(x32)
    return big.double(), tf32(x32 - big).double()


def mm(a, b, a_exact: bool, b_exact: bool, passes):
    """a @ b as the kernel's tensor cores take it: each operand as its fp32
    value, split unless it holds bf16 values (exact in tf32), and the parts'
    products in the kernel's passes (``mma_parts``), summed in float64;
    ``passes`` None: a @ b in float64."""
    if passes is None:
        return a @ b
    ab, asm = (a.float().double(), None) if a_exact else split(a)
    bb, bsm = (b.float().double(), None) if b_exact else split(b)
    out = ab @ bb
    if (a_exact and b_exact) or passes == 1:
        return out
    if a_exact:
        return out + ab @ bsm
    if b_exact or passes == 2:
        return out + asm @ bb
    return out + asm @ bb + ab @ bsm


def excl_cumprod(e):
    """Π_{j<i} e_j along dim −2 (1 at i = 0)."""
    ones = torch.ones_like(e[..., :1, :])
    return torch.cat([ones, e[..., :-1, :]], dim=-2).cumprod(dim=-2)


def excl_rev_cumprod(e):
    """Π_{j>i} e_j along dim −2 (1 at the last i)."""
    return excl_cumprod(e.flip(-2)).flip(-2)


def diagonal_decays(e):
    """between[..., t, s, d] = Π_{s<j<t} e_j for s < t in one 8-step block
    (the diagonal blocks' walks), 0 elsewhere."""
    between = torch.zeros(e.shape[:-2] + (T, T, e.shape[-1]), dtype=e.dtype)
    for b0 in range(0, T, Q):
        for s in range(b0, b0 + Q):
            f = torch.ones_like(e[..., 0, :])
            for t in range(s + 1, b0 + Q):
                between[..., t, s, :] = f
                f = f * e[..., t, :]
    return between


def chunk_grads(r, k, v, o, w, u, S_c, Go, exact, passes):
    """One chunk (r, k, v, o, w: (B, H, T, N) float64; S_c, Go: (B, H, N,
    N)) as the grads kernel takes it → (dr, dk, dv, dlogw, the chunk's du,
    the gradient of the state entering it)."""
    e = torch.exp(w)
    pd, sd = excl_cumprod(e), excl_rev_cumprod(e)
    D = torch.exp(w.sum(dim=-2))[..., :, None]                   # (B, H, N, 1)
    rh = excl_cumprod(e[..., H2:, :])                            # t in 16..31
    rq = [excl_cumprod(e[..., Q:H2, :]), excl_cumprod(e[..., 3 * Q:, :])]      # 8.., 24..
    kh = excl_rev_cumprod(e[..., :H2, :])                        # s in 0..15
    kq = [excl_rev_cumprod(e[..., :Q, :]), excl_rev_cumprod(e[..., H2:3 * Q, :])]  # 0.., 16..
    between = diagonal_decays(e)
    tr = lambda x: x.transpose(-1, -2)  # noqa: E731

    P = mm(o, tr(v), exact, exact, passes)
    # A: the blocks below the diagonal, then the diagonal blocks and the bonus
    A = torch.zeros(P.shape, dtype=P.dtype)
    A[..., H2:, :H2] = mm(r[..., H2:, :] * rh, tr(k[..., :H2, :] * kh), False, False, passes)
    for i, (t0, s0) in enumerate(((Q, 0), (3 * Q, H2))):
        A[..., t0:t0 + Q, s0:s0 + Q] = mm(r[..., t0:t0 + Q, :] * rq[i],
                                          tr(k[..., s0:s0 + Q, :] * kq[i]), False, False,
                                          passes)
    A = A + torch.einsum("...td,...sd,...tsd->...ts", r, k, between)
    A = A + torch.diag_embed(((r * u[:, None, :]) * k).sum(-1))
    dv = mm(k * sd, Go, False, False, passes) + mm(tr(A), o, False, exact, passes)
    # dr′ and dk′: the state terms, the blocks below the diagonal, the walks
    dr_state = pd * mm(o, tr(S_c), exact, False, passes)
    gv = mm(v, tr(Go), exact, False, passes)
    dr_in = torch.einsum("...ts,...sd,...tsd->...td", P, k, between)
    dk_in = torch.einsum("...ts,...td,...tsd->...sd", P, r, between)
    dr_in[..., H2:, :] += rh * mm(P[..., H2:, :H2], k[..., :H2, :] * kh, False, False, passes)
    dk_in[..., :H2, :] += kh * mm(tr(P[..., H2:, :H2]), r[..., H2:, :] * rh, False, False,
                                  passes)
    for i, (t0, s0) in enumerate(((Q, 0), (3 * Q, H2))):
        block = P[..., t0:t0 + Q, s0:s0 + Q]
        dr_in[..., t0:t0 + Q, :] += rq[i] * mm(block, k[..., s0:s0 + Q, :] * kq[i], False,
                                               False, passes)
        dk_in[..., s0:s0 + Q, :] += kq[i] * mm(tr(block), r[..., t0:t0 + Q, :] * rq[i], False,
                                               False, passes)
    ptt = torch.diagonal(P, dim1=-2, dim2=-1)[..., None]         # P[t, t]
    drp, dk_state = dr_state + dr_in, sd * gv
    dr = drp + ptt * u[:, None, :] * k
    dk = dk_state + dk_in + ptt * u[:, None, :] * r
    du = (ptt * r * k).sum(dim=-2)
    ks, rdr, ki = k * dk_state, r * drp, k * dk_in
    total = D[..., 0][..., None, :] * (Go * S_c).sum(-1)[..., None, :]
    dlogw = (total + (ks.cumsum(-2) - ks) + (rdr.flip(-2).cumsum(-2).flip(-2) - rdr)
             - ki.flip(-2).cumsum(-2).flip(-2))
    go_before = D * Go + mm(tr(r * pd), o, False, exact, passes)
    return dr, dk, dv, dlogw, du, go_before


def state_step(k, v, w, M, exact, passes):
    """M = D ⊙ M + (k ⊙ sd)^T V for one chunk."""
    e = torch.exp(w)
    D = torch.exp(w.sum(dim=-2))[..., :, None]
    return D * M + mm((k * excl_rev_cumprod(e)).transpose(-1, -2), v, False, exact, passes)


def grad_step(r, o, w, M, exact, passes):
    """M = D ⊙ M + (r ⊙ pd)^T dO for one chunk, carried back across it."""
    e = torch.exp(w)
    D = torch.exp(w.sum(dim=-2))[..., :, None]
    return D * M + mm((r * excl_cumprod(e)).transpose(-1, -2), o, False, exact, passes)


def twin_grad(r, k, v, logw, u, state0, dout, dstate, *, exact=False, passes=None,
              segments=None):
    """K4′ as the kernel decomposes it (module docstring), on the operands'
    values in float64 (r, k, v, dout holding bf16 values where ``exact``);
    ``segments`` None: ``wk.plan_bwd_segments``'.  Heads below 32 run
    zero-padded, as the wrapper runs them.  → (dr, dk, dv, dlogw, du,
    dstate0) in float64."""
    B, S, H, N = r.shape
    if N not in wk.HEAD_SIZES:
        grads = twin_grad(*wk.pad_heads(wk.kernel_head_size(N), r, k, v, logw, u, state0,
                                        dout, dstate),
                          exact=exact, passes=passes, segments=segments)
        return (*(g[..., :N] for g in grads[:5]), grads[5][..., :N, :N])
    C = -(-S // T)
    P, Lc = wk.plan_bwd_segments(B, H, S)
    if segments is not None and C:
        Lc = -(-C // segments)
        P = -(-C // Lc)

    def chunks(x):   # (B, S, H, N) → C x (B, H, T, N), zeros past S
        x = torch.nn.functional.pad(x.double(), (0, 0, 0, 0, 0, C * T - S))
        return list(x.reshape(B, C, T, H, N).permute(1, 0, 3, 2, 4))
    rr, kk, vv, oo, ww = (chunks(x) for x in (r, k, v, dout, logw))
    u = u.double()
    bounds = [(p * Lc, min((p + 1) * Lc, C)) for p in range(P)]
    zero = torch.zeros((B, H, N, N), dtype=torch.float64)
    # each segment's contributions from zero, its decay, then the chains
    decay = [torch.exp(sum(ww[c].sum(dim=-2) for c in range(c0, c1)))[..., :, None]
             if c1 > c0 else torch.ones((B, H, N, 1), dtype=torch.float64)
             for c0, c1 in bounds]
    s_in, g_end = [state0.double()], [None] * P
    for p, (c0, c1) in enumerate(bounds[:-1]):
        M = zero
        for c in range(c0, c1):
            M = state_step(kk[c], vv[c], ww[c], M, exact, passes)
        s_in.append(decay[p] * s_in[-1] + M)
    g_end[-1] = dstate.double()
    for p in range(P - 1, 0, -1):
        M = zero
        for c in reversed(range(*bounds[p])):
            M = grad_step(rr[c], oo[c], ww[c], M, exact, passes)
        g_end[p - 1] = decay[p] * g_end[p] + M
    # each segment re-run: its states forward, then its chunks last to first
    out = [[None] * C for _ in range(4)]
    du = torch.zeros((H, N), dtype=torch.float64)
    dstate0 = dstate.double()
    for p, (c0, c1) in enumerate(bounds):
        states, M = {}, s_in[p]
        for c in range(c0, c1):
            states[c] = M
            M = state_step(kk[c], vv[c], ww[c], M, exact, passes)
        Go = g_end[p]
        for c in reversed(range(c0, c1)):
            *grads, du_c, Go = chunk_grads(rr[c], kk[c], vv[c], oo[c], ww[c], u, states[c], Go,
                                           exact, passes)
            for i, x in enumerate(grads):
                out[i][c] = x
            du = du + du_c.sum(dim=0)
        if p == 0:
            dstate0 = Go

    def unchunk(xs):
        if not xs:
            return torch.zeros((B, S, H, N), dtype=torch.float64)
        return torch.stack(xs).permute(1, 0, 3, 2, 4).reshape(B, C * T, H, N)[:, :S]
    return (*(unchunk(x) for x in out), du, dstate0)


# ---- the wgmma kernel (bf16 at N = 64, one segment, chunks of 64) ----

TW = 64   # the wgmma kernel's chunk


def shipped_parts():
    """(``WKV_BWD_PARTS``, ``CPARTS``) as the kernel ships them: the bf16
    parts of an fp32 operand in its products, and in the two that feed the
    carried state and gradient."""
    src = (CSRC / "wkv6_bwd.cu").read_text()
    return (int(re.search(r"#ifndef WKV_BWD_PARTS\n#define WKV_BWD_PARTS (\d+)", src)[1]),
            int(re.search(r"constexpr int CPARTS = (\d+);", src)[1]))


def bf16_parts(x: torch.Tensor, n: int):
    """The fp32 value of ``x`` as n bf16 parts (``split_bf16``: the largest
    its rounding, each next the rounding of what the ones before leave), in
    float64, smallest first as the kernel indexes them."""
    x = x.float()
    parts = []
    for _ in range(n):
        h = x.bfloat16().float()
        parts.append(h.double())
        x = x - h
    return parts[::-1]


def mm_bf16(a, b, na, nb):
    """a @ b as the kernel's wgmma takes it: an operand with n parts split
    into them (None: exact, a bf16 value or the twin's float64), the
    products of every part against an exact operand, and of the pairs whose
    indices sum to n - 1 or more of two split ones; summed in float64."""
    A = [a.double()] if na is None else bf16_parts(a, na)
    B = [b.double()] if nb is None else bf16_parts(b, nb)
    if na is None or nb is None:
        return sum(x @ y for x in A for y in B)
    return sum(A[i] @ B[j] for i in range(na) for j in range(nb) if i + j >= na - 1)


def block_prefix(e, L):
    """Π e_j from the start of each step's aligned block of L steps to it
    (excluded), along dim -2."""
    shape = e.shape
    x = e.reshape(shape[:-2] + (shape[-2] // L, L, shape[-1]))
    return excl_cumprod(x).reshape(shape)


def block_suffix(e, L):
    """Π e_j from a step (excluded) to the end of its aligned block of L."""
    shape = e.shape
    x = e.reshape(shape[:-2] + (shape[-2] // L, L, shape[-1]))
    return excl_rev_cumprod(x).reshape(shape)


def level_mask(lb, T=TW):
    """M[t, s] = 1 where s < t and the steps first differ in bit lb."""
    t = torch.arange(T)[:, None]
    s = torch.arange(T)[None, :]
    x = t ^ s
    hb = torch.where(x > 0, torch.floor(torch.log2(x.double().clamp(min=1))).long(), -1)
    return ((s < t) & (hb == lb)).double()


def diagonal_decays_in(e, T):
    """between[..., t, s, d] = Π_{s<j<t} e_j for s < t in one 8-step block,
    0 elsewhere, over chunks of T."""
    between = torch.zeros(e.shape[:-2] + (T, T, e.shape[-1]), dtype=e.dtype)
    for b0 in range(0, T, Q):
        for s in range(b0, b0 + Q):
            f = torch.ones_like(e[..., 0, :])
            for t in range(s + 1, b0 + Q):
                between[..., t, s, :] = f
                f = f * e[..., t, :]
    return between


def wgmma_chunk(r, k, v, o, w, u, S_c, Go, parts):
    """One 64-step chunk as wkv6_bwd_wgmma_kernel takes it (module docstring;
    ``parts`` None: exact float64) → (dr, dk, dv, dlogw, the chunk's du, the
    gradient of the state entering it)."""
    npart, cpart = (None, None) if parts is None else parts
    tr = lambda x: x.transpose(-1, -2)  # noqa: E731
    e = torch.exp(w)
    pd, sd = excl_cumprod(e), excl_rev_cumprod(e)
    D = torch.exp(w.sum(dim=-2))[..., :, None]                   # (B, H, N, 1)
    P = o @ tr(v)                                                # exact: bf16 values
    X1 = tr(mm_bf16(S_c, tr(o), npart, None))                    # dO S_cᵀ, as S_c dOᵀ
    X2 = mm_bf16(v, tr(Go), None, npart)
    rows = torch.arange(TW)
    drp = pd * X1
    dks = sd * X2
    dki = torch.zeros_like(drp)
    AT = torch.zeros(P.shape, dtype=P.dtype)
    for lb in (5, 4, 3):
        L = 1 << lb
        bit = ((rows >> lb) & 1).bool()[:, None]
        RF, KF = block_prefix(e, L), block_suffix(e, L)
        F = torch.where(bit, r * RF, k * KF)
        M = level_mask(lb)
        dr_l = RF * mm_bf16(P * M, F, npart, npart)
        dk_l = KF * mm_bf16(tr(P * M), F, npart, npart)
        drp = drp + dr_l
        if lb == 5:   # the first half's level 32 counts with the state's term
            dks = dks + dk_l
        else:
            dki = dki + dk_l
        AT = AT + mm_bf16(F, tr(F), npart, npart) * tr(M)
    between = diagonal_decays_in(e, TW)
    drp = drp + torch.einsum("...ts,...sd,...tsd->...td", P, k, between)
    dki = dki + torch.einsum("...ts,...td,...tsd->...sd", P, r, between)
    A_diag = torch.einsum("...td,...sd,...tsd->...ts", r, k, between) \
        + torch.diag_embed(((r * u[:, None, :]) * k).sum(-1))
    AT = AT + tr(A_diag)
    ptt = torch.diagonal(P, dim1=-2, dim2=-1)[..., None]
    dr = drp + ptt * u[:, None, :] * k
    dk = dks + dki + ptt * u[:, None, :] * r
    du = (ptt * r * k).sum(dim=-2)
    dv = mm_bf16(k * sd, Go, npart, npart) + mm_bf16(AT, o, npart, None)
    tot = D[..., 0] * (Go * S_c).sum(-1)                         # (B, H, N)
    rr, ks, ki = r * drp, k * dks, k * dki
    rs, ks64 = r * pd * X1, k * sd * X2
    dlogw = torch.empty_like(drp)
    for h in range(2):
        lo, hi = 32 * h, 32 * h + 32
        other = rs[..., 32:, :].sum(-2) if h == 0 else ks64[..., :32, :].sum(-2)
        ksh, rrh, kih = ks[..., lo:hi, :], rr[..., lo:hi, :], ki[..., lo:hi, :]
        dlogw[..., lo:hi, :] = ((tot + other)[..., None, :] + (ksh.cumsum(-2) - ksh)
                                + (rrh.flip(-2).cumsum(-2).flip(-2) - rrh)
                                - kih.flip(-2).cumsum(-2).flip(-2))
    go_before = D * Go + mm_bf16(tr(r * pd), o, cpart, None)
    return dr, dk, dv, dlogw, du, go_before


def twin_grad_wgmma(r, k, v, logw, u, state0, dout, dstate, *, parts=None):
    """K4′'s wgmma kernel as it decomposes the gradient, on the operands'
    values in float64: one segment of 64-step chunks (zeros past S), the
    states forward from state0 (their increment in ``parts[1]`` parts), then
    the chunks last to first (``wgmma_chunk``); ``parts`` None: every
    product exact.  → (dr, dk, dv, dlogw, du, dstate0) in float64."""
    B, S, H, N = r.shape
    C = -(-S // TW)

    def chunks(x):   # (B, S, H, N) → C x (B, H, TW, N), zeros past S
        x = torch.nn.functional.pad(x.double(), (0, 0, 0, 0, 0, C * TW - S))
        return list(x.reshape(B, C, TW, H, N).permute(1, 0, 3, 2, 4))
    rr, kk, vv, oo, ww = (chunks(x) for x in (r, k, v, dout, logw))
    u = u.double()
    cpart = None if parts is None else parts[1]
    states, M = [], state0.double()
    for c in range(C):
        states.append(M)
        e = torch.exp(ww[c])
        D = torch.exp(ww[c].sum(dim=-2))[..., :, None]
        M = D * M + mm_bf16((kk[c] * excl_rev_cumprod(e)).transpose(-1, -2), vv[c], cpart, None)
    out = [[None] * C for _ in range(4)]
    du = torch.zeros((H, N), dtype=torch.float64)
    Go = dstate.double()
    for c in reversed(range(C)):
        *grads, du_c, Go = wgmma_chunk(rr[c], kk[c], vv[c], oo[c], ww[c], u, states[c], Go,
                                       parts)
        for i, x in enumerate(grads):
            out[i][c] = x
        du = du + du_c.sum(dim=0)

    def unchunk(xs):
        if not xs:
            return torch.zeros((B, S, H, N), dtype=torch.float64)
        return torch.stack(xs).permute(1, 0, 3, 2, 4).reshape(B, C * TW, H, N)[:, :S]
    return (*(unchunk(x) for x in out), du, Go)


def inputs(seed, B, S, H, N, *, bf16: bool, logw_mean: float = 0.0, logw_scale: float = 1.0):
    """Numpy-seeded operands as float32 tensors: r, k at 0.5 and v, dout at
    1 normal (rounded to bf16 values where ``bf16``), logw =
    −exp(``logw_scale``·normal + ``logw_mean``), u and state0 at 0.1 and
    dstate at 1 normal."""
    rng = np.random.default_rng(seed)

    def normal(shape, scale=1.0):
        return torch.from_numpy((scale * rng.standard_normal(shape)).astype(np.float32))
    shape = (B, S, H, N)
    r, k, v, do = normal(shape, 0.5), normal(shape, 0.5), normal(shape), normal(shape)
    if bf16:
        r, k, v, do = (x.bfloat16().float() for x in (r, k, v, do))
    logw = -torch.exp(normal(shape, logw_scale) + logw_mean)
    return (r, k, v, logw, normal((H, N), 0.1), normal((B, H, N, N), 0.1), do,
            normal((B, H, N, N)))


def close(got, want, tol):
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    scale = max(float(np.abs(want).max()), 1e-30) if want.size else 1.0
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= tol * scale, f"max |err| {err} > {tol} x {scale}"


def float64_autograd(r, k, v, logw, u, state0, dout, dstate):
    xs = [t.double().clone().requires_grad_() for t in (r, k, v, logw, u, state0)]
    out, state = ref.wkv6_reference(*xs, acc=torch.float64)
    return torch.autograd.grad((out * dout.double()).sum() + (state * dstate.double()).sum(),
                               xs, allow_unused=True)


def test_passes_are_read_from_the_source():
    assert shipped_passes() == 3


def test_wgmma_parts_are_read_from_the_source():
    """Two bf16 parts of an fp32 operand, three in the products that feed
    the carried state and gradient."""
    assert shipped_parts() == (2, 3)


@pytest.mark.parametrize("segments", [None, 1, "wgmma"])
@pytest.mark.parametrize("N", [16, 32, 64])
@pytest.mark.parametrize("S", [0, 1, 31, 33, 300, 63, 65])
def test_twin_matches_float64_autograd(S, N, segments):
    """With exact products, the decomposition (segments, the chains, the
    block-boundary factors, the walks, dlogw's identity) is the gradient;
    ``"wgmma"``: the wgmma kernel's (64-step chunks in one segment, the
    levels 32, 16 and 8, dlogw's identity per half)."""
    args = inputs(20 + S + N, 2, S, 2, N, bf16=False)
    want = float64_autograd(*args)
    got = (twin_grad_wgmma(*args) if segments == "wgmma"
           else twin_grad(*args, segments=segments))
    for x, w in zip(got, want):
        close(x.numpy(), (torch.zeros_like(x) if w is None else w).numpy(), F64_TOL)


def test_twin_cuts_300_steps_into_several_segments():
    """The 300-step sequence in three segments of four chunks (one short)
    gives the one-segment gradient, and the planner's cut (ten segments at
    B·H = 4) too."""
    args = inputs(7, 2, 300, 2, 32, bf16=False)
    assert wk.plan_bwd_segments(2, 2, 300) == (10, 1)
    one = twin_grad(*args, segments=1)
    for segments in (3, None):
        for x, w in zip(twin_grad(*args, segments=segments), one):
            close(x.numpy(), w.numpy(), F64_TOL)


@pytest.mark.parametrize("bf16", [True, False, "wgmma"])
@pytest.mark.parametrize("N", [16, 32, 64])
@pytest.mark.parametrize("S", [1, 33, 300, 65])
def test_twin_in_the_kernels_passes_matches_jax_vjp(S, N, bf16):
    """``"wgmma"``: the wgmma kernel's twin in its bf16 parts, on
    bf16-valued inputs (the kernel's only dtype)."""
    args = inputs(40 + S + N, 2, S, 2, N, bf16=bool(bf16))
    _, vjp = jax.vjp(jref.wkv6_reference, *(jnp.asarray(x.numpy()) for x in args[:6]))
    want = vjp((jnp.asarray(args[6].numpy()), jnp.asarray(args[7].numpy())))
    got = (twin_grad_wgmma(*args, parts=shipped_parts()) if bf16 == "wgmma"
           else twin_grad(*args, exact=bf16, passes=shipped_passes()))
    for x, w in zip(got, want):
        close(x.numpy(), np.asarray(w), FP32_TOL)


@pytest.mark.parametrize("S,N", [(64, 32), (96, 64)])
def test_twin_in_the_kernels_passes_matches_jax_vjp_of_wkv_chunked(S, N):
    """``wkv_chunked`` takes e^{Σ w} over pairs above the diagonal too, before
    masking them, so its gradient is NaN once a chunk's |Σ logw| passes
    fp32's exponential range: logw here stays above −3 a step."""
    args = inputs(60 + S, 2, S, 2, N, bf16=True, logw_mean=-1.5, logw_scale=0.5)
    assert float(args[3].min()) > -3.0
    _, vjp = jax.vjp(lambda *xs: jrwkv.wkv_chunked(*xs, chunk=T),
                     *(jnp.asarray(x.numpy()) for x in args[:6]))
    want = vjp((jnp.asarray(args[6].numpy()), jnp.asarray(args[7].numpy())))
    got = twin_grad(*args, exact=True, passes=shipped_passes())
    for x, w in zip(got, want):
        close(x.numpy(), np.asarray(w), FP32_TOL)


@pytest.mark.parametrize("N", [32, 64])
def test_twin_survives_extreme_decays(N):
    """logw down to −e³ ≈ −20 a step (a chunk's sum far below fp32's
    exponential range): every factor is a product of e^w ≤ 1, so nothing
    overflows, and the twin still agrees with the float64 formulas."""
    args = inputs(80 + N, 2, 100, 2, N, bf16=True, logw_mean=2.0)
    assert float(args[3].min()) < -np.exp(3.0)
    got = twin_grad(*args, exact=True, passes=shipped_passes())
    want = ref.wkv6_backward_reference(*(t.double() for t in args))
    for x, w in zip(got, want):
        assert torch.isfinite(x).all()
        close(x.numpy(), w.numpy(), FP32_TOL)


def test_wgmma_twin_survives_extreme_decays():
    """logw down to −e³ a step: the wgmma kernel's factors (the levels' and
    the chunk's running products) are products of e^w ≤ 1, so nothing
    overflows, and its twin in its parts agrees with the float64 formulas."""
    args = inputs(85, 2, 200, 2, 64, bf16=True, logw_mean=2.0)
    assert float(args[3].min()) < -np.exp(3.0)
    got = twin_grad_wgmma(*args, parts=shipped_parts())
    want = ref.wkv6_backward_reference(*(t.double() for t in args))
    for x, w in zip(got, want):
        assert torch.isfinite(x).all()
        close(x.numpy(), w.numpy(), FP32_TOL)


@pytest.mark.parametrize("bf16,passes,within", [(True, None, True), (True, 1, False),
                                               (False, None, True), (False, 1, False),
                                               (False, 2, False), ("wgmma", None, True),
                                               ("wgmma", "one part fewer", False)])
def test_passes_against_the_chip_limit(bf16, passes, within):
    """Rounded to the kernel's output types, the twin in the kernel's passes
    is within phase 19's limits; in one pass, or in two where both operands
    are fp32 values, it is not.  (In two passes on bf16 values the twin comes
    near the limit without passing it; on the card, whose tensor cores
    truncate their sums, that build fails it, ``parity_probe.py``.)"""
    cs = chip_smoke()
    args = inputs(90, 2, 300, 3, 64, bf16=bool(bf16))
    dt = torch.bfloat16 if bf16 else torch.float32
    typed = [x.to(dt) for x in args[:3]] + list(args[3:6]) + [args[6].to(dt), args[7]]
    want = ref.wkv6_backward_reference(*(t.double() for t in args))
    limits = cs.wkv_bwd_limits(*typed)
    if bf16 == "wgmma":   # the wgmma kernel's parts, or one part fewer where not chained
        parts, chain = shipped_parts()
        got = twin_grad_wgmma(*args, parts=(parts, chain) if passes is None
                              else (parts - 1, chain))
    else:
        got = twin_grad(*args, exact=bf16, passes=shipped_passes() if passes is None else passes)
    got = [x.to(dt) for x in got[:3]] + [x.float() for x in got[3:]]
    ratio = cs.held_bwd(got, want, limits)[1]
    assert (ratio <= 1.0) == within, ratio
