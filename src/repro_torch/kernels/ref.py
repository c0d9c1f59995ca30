"""Plain PyTorch versions of the kernels (naive, obviously-correct math),
ported from ``repro.kernels.ref``.

They are direct definitions — dense logits, dense softmax, fp32 throughout;
the recurrence one step at a time — independent of the tiled algorithms of
the CUDA kernels, so comparing the two is meaningful.  The CPU path of ``repro_torch.kernels.ops``
runs them; on the card they serve only as the check of the kernels.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

NEG_INF = -1e30


def _softcap(logits: torch.Tensor, cap: float) -> torch.Tensor:
    if cap and cap > 0.0:
        return cap * torch.tanh(logits / cap)
    return logits


def mha_reference(q, k, v, *, causal: bool = True, window: int = 0,
                  softcap: float = 0.0,
                  lengths: Optional[torch.Tensor] = None,
                  acc: torch.dtype = torch.float32) -> torch.Tensor:
    """q: (B, H, Sq, d); k/v: (B, K, Skv, d) (GQA) → (B, H, Sq, d).

    ``window`` 0 means global; ``lengths`` (B,) masks keys ≥ lengths[b].
    It computes in ``acc`` and rounds once to q's dtype: fp32, or float64
    where a kernel is held to one bf16 ulp of it (``chip_smoke.py``): on a
    cancelling output the fp32 sums' own error can exceed that ulp.
    """
    B, H, Sq, d = q.shape
    K, Skv = k.shape[1], k.shape[2]
    G = H // K
    qg = q.reshape(B, K, G, Sq, d).to(acc)
    logits = torch.einsum("bkgsd,bktd->bkgst", qg, k.to(acc)) / math.sqrt(d)
    logits = _softcap(logits, softcap)
    q_pos = torch.arange(Sq, device=q.device)
    k_pos = torch.arange(Skv, device=q.device)
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos[None, :] <= q_pos[:, None]
    if window > 0:
        mask &= k_pos[None, :] > q_pos[:, None] - window
    mask = mask.expand(B, Sq, Skv)
    if lengths is not None:
        mask = mask & (k_pos[None, None, :] < lengths[:, None, None])
    logits = torch.where(mask[:, None, None], logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgst,bktd->bkgsd", p, v.to(acc))
    return out.reshape(B, H, Sq, d).to(q.dtype)


def decode_mask(lengths, T: int, *, window: int = 0, q_pos=None,
                slot_pos=None) -> torch.Tensor:
    """(B, T) bool: which cache slots one decoding query may attend to.

    A slot holds position ``slot_pos[b, t]`` (−1 when empty); without
    ``slot_pos`` slot t holds position t and the query sits at
    ``lengths − 1``.  The mask is ``pos ≥ 0 ∧ pos ≤ q_pos ∧ pos > q_pos −
    window`` (window 0 = global) and ``t < lengths[b]`` — exactly the
    decode mask of ``repro.models.transformer.DecoderLM._attn_decode``.
    """
    t = torch.arange(T, device=lengths.device)
    pos = slot_pos if slot_pos is not None else t[None, :].expand(len(lengths), T)
    qp = (q_pos if q_pos is not None else lengths - 1)[:, None]
    mask = (pos >= 0) & (pos <= qp) & (t[None, :] < lengths[:, None])
    if window > 0:
        mask &= pos > qp - window
    return mask


def decode_attention_reference(q, k, v, lengths, *, softcap: float = 0.0,
                               window: int = 0, q_pos=None,
                               slot_pos=None,
                               acc: torch.dtype = torch.float32) -> torch.Tensor:
    """q: (B, H, d); k/v: (B, K, T, d); lengths: (B,) → (B, H, d).

    Unlike ``repro.kernels.ref.decode_attention_reference`` this keeps
    ``softcap``, and takes the window and slot positions that decoding
    against a ring-buffer cache needs (see :func:`decode_mask`).  ``acc``
    as in :func:`mha_reference`.
    """
    B, H, d = q.shape
    K, T = k.shape[1], k.shape[2]
    G = H // K
    qg = q.reshape(B, K, G, d).to(acc)
    logits = torch.einsum("bkgd,bktd->bkgt", qg, k.to(acc)) / math.sqrt(d)
    logits = _softcap(logits, softcap)
    mask = decode_mask(lengths, T, window=window, q_pos=q_pos,
                       slot_pos=slot_pos)
    logits = torch.where(mask[:, None, None], logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgt,bktd->bkgd", p, v.to(acc))
    return out.reshape(B, H, d).to(q.dtype)


def rglru_reference(a, b, s0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Naive gated linear recurrence: s_t = a_t s_{t-1} + b_t.

    a/b: (B, S, R) fp32; s0: (B, R) fp32 → (seq (B, S, R), last (B, R)).
    With bf16 a/b each step promotes to fp32, as in the reference.
    """
    s, seq = s0, []
    for t in range(a.shape[1]):
        s = a[:, t] * s + b[:, t]
        seq.append(s)
    return torch.stack(seq, dim=1), s


def rglru_backward_reference(a, b, s0, g, g_last=None
                             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradient of :func:`rglru_reference`, as explicit formulas (no
    autograd): given g_t, the gradient of state t, and ``g_last`` that of
    the last state (None: zero), the reversed scan

        ds_{S−1} = g_{S−1} + g_last,  ds_t = g_t + a_{t+1}·ds_{t+1},
        da_t = ds_t·s_{t−1},  db_t = ds_t,  ds0 = a_0·ds_0

    (ds0 = g_last when S = 0).  a/b/g: (B, S, R) and s0/g_last: (B, R), one
    float dtype, in which it computes (float64 for the checks) → (da, db,
    ds0) in that dtype.
    """
    prev, s = [], s0                                            # s_{t-1}
    for t in range(a.shape[1]):
        prev.append(s)
        s = a[:, t] * s + b[:, t]
    carry = torch.zeros_like(s0) if g_last is None else g_last
    da, db = torch.empty_like(a), torch.empty_like(b)
    for t in reversed(range(a.shape[1])):
        ds = g[:, t] + carry
        da[:, t] = ds * prev[t]
        db[:, t] = ds
        carry = a[:, t] * ds
    return da, db, carry


def wkv6_backward_reference(r, k, v, logw, u, state0, dout, dstate=None, *,
                            chunk: int = 32):
    """The gradient of :func:`wkv6_reference`, as explicit sequential
    formulas (no autograd).  With G_t the gradient of S_t (G_{S−1} =
    ``dstate``, None: zero), w_t = e^{logw_t} and do_t = ``dout``[:, t]:

        G_{t−1} = diag(w_t) G_t + r_t do_tᵀ
        dr_t = S_{t−1} do_t + (u ⊙ k_t)(v_t·do_t)
        dk_t = G_t v_t + (r_t ⊙ u)(v_t·do_t)
        dv_t = G_tᵀ k_t + (r_t·(u ⊙ k_t)) do_t
        du = Σ_t (r_t ⊙ k_t)(v_t·do_t)   (summed over the batch too)
        dlogw_t = w_t ⊙ rowsum(G_t ⊙ S_{t−1})
        dstate0 = G_{−1}

    The states S_{t−1} are recomputed from those at every ``chunk``-th step,
    kept on the way forward, so memory stays at S/chunk states.  Inputs of
    one float dtype, in which it computes (float64 for the checks) → (dr, dk,
    dv, dlogw, du, dstate0) in that dtype.
    """
    B, S, H, N = r.shape
    w = torch.exp(logw)
    starts, state = [], state0
    for t in range(S):
        if t % chunk == 0:
            starts.append(state)
        state = w[:, t, :, :, None] * state + k[:, t, :, :, None] * v[:, t, :, None, :]
    G = torch.zeros_like(state0) if dstate is None else dstate
    dr, dk, dv, dlogw = (torch.empty_like(x) for x in (r, k, v, logw))
    du = torch.zeros_like(u)
    for c0 in reversed(range(0, S, chunk)):
        prevs, state = [], starts[c0 // chunk]
        for t in range(c0, min(c0 + chunk, S)):
            prevs.append(state)
            state = w[:, t, :, :, None] * state + k[:, t, :, :, None] * v[:, t, :, None, :]
        for t in reversed(range(c0, min(c0 + chunk, S))):
            rt, kt, vt, dot, sp = r[:, t], k[:, t], v[:, t], dout[:, t], prevs[t - c0]
            vdo = (vt * dot).sum(-1, keepdim=True)                   # (B, H, 1)
            dr[:, t] = torch.einsum("bhde,bhe->bhd", sp, dot) + u * kt * vdo
            dk[:, t] = torch.einsum("bhde,bhe->bhd", G, vt) + rt * u * vdo
            dv[:, t] = (torch.einsum("bhde,bhd->bhe", G, kt)
                        + (rt * u * kt).sum(-1, keepdim=True) * dot)
            du = du + (rt * kt * vdo).sum(0)
            dlogw[:, t] = w[:, t] * (G * sp).sum(-1)
            G = w[:, t, :, :, None] * G + rt[..., :, None] * dot[..., None, :]
    return dr, dk, dv, dlogw, du, G


def wkv6_reference(r, k, v, logw, u, state0, *,
                   acc: torch.dtype = torch.float32) -> Tuple[torch.Tensor, torch.Tensor]:
    """Naive sequential WKV recurrence, one step at a time:

        o_t = r_tᵀ S_{t−1} + (r_t ⊙ u ⊙ k_t)ᵀ 1 · v_t
        S_t = diag(e^{w_t}) S_{t−1} + k_t v_tᵀ

    r/k/v: (B, S, H, N), any float dtype; logw: (B, S, H, N) fp32; u: (H, N)
    fp32; state0: (B, H, N, N) fp32 → (out (B, S, H, N) in r's dtype, final
    state (B, H, N, N) fp32).  Any S.  It computes in ``acc`` and rounds
    once at the end: fp32 (the CPU path), or float64 where the chunked
    kernel, which sums in another order, is held to it (``chip_smoke.py``).
    """
    rr, kk, vv = r.to(acc), k.to(acc), v.to(acc)
    decay = torch.exp(logw.to(acc))
    uf = u.to(acc)
    state = state0.to(acc)
    outs = []
    for t in range(r.shape[1]):
        rt, kt, vt = rr[:, t], kk[:, t], vv[:, t]                # (B, H, N)
        o = (torch.einsum("bhd,bhde->bhe", rt, state)
             + (rt * uf * kt).sum(-1, keepdim=True) * vt)
        state = decay[:, t, :, :, None] * state + kt[..., :, None] * vt[..., None, :]
        outs.append(o)
    out = torch.stack(outs, dim=1) if outs else rr.clone()
    return out.to(r.dtype), state.float()


def wkv6_chunked_reference(r, k, v, logw, u, state0, *, chunk: int = 32,
                           segments: int = 1,
                           acc: torch.dtype = torch.float32
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chunked, segmented WKV of K4's CUDA kernels (``csrc/wkv6.cu``),
    in plain PyTorch: the kernels' decomposition, not their summation order.
    The tests hold it to the sequential reference; nothing on the main path
    calls it.

    The sequence is cut into chunks of ``chunk`` steps (the tail padded with
    r = k = v = 0, logw = 0, which leave the state as it is) and into
    ``segments`` segments of whole chunks, as ``wkv6``'s planners cut it
    (the last segment may hold fewer chunks).  Every segment but the last
    is run from a zero state to its contribution U_p, with its decay d_p =
    e^{Σ logw}, the sum taken in float64; the segments' incoming states
    chain as S_{p+1} = d_p ⊙ S_p + U_p; each segment is then run from its
    incoming state.  Within a chunk, with e = e^{logw} and every decay a
    running product of e (no factor exceeds 1, so nothing overflows; a
    product underflows to 0):
        o  = (r ⊙ Π_{j<t} e_j) S + A V
        S' = e^{Σ_j logw_j} ⊙ S + (k ⊙ Π_{j>s} e_j)ᵀ V
    with the chunk's own decay from a float64 sum rounded once, A[t, s] =
    Σ_d r_td k_sd Π_{s<j<t} e_jd for s < t, A[t, t] = Σ_d r_td u_d k_td and 0
    above the diagonal.
    - ``chunk`` = 32 (the tf32 kernel, fp32 and N = 32): A's diagonal
      blocks of T/4 by running products, each block below them, as the
      kernel forms it on its tensor cores, as the product of r_t Π_{b<=j<t}
      e_j and k_s Π_{s<j<b} e_j at a block boundary b between s and t.
    - ``chunk`` = 64 (the wgmma kernel, bf16 at N = 64): the decays by
      halves of 32 steps, rd = r ⊙ Π from the half's start and kd = k ⊙ Π
      to the half's end, the second half's rd then times e0 = Π over the
      first half and the first half's kd times e1 = Π over the second; A
      within each half by running products (k_s ⊙ Π_{s<j<t} walked over t),
      and below the halves as rd (second half) · kd (first half)ᵀ.
    With ``acc`` float64 (a check's want) the walks' decays are taken at
    once from the running sums of logw: the same function, a few launches
    a chunk instead of several a step.
    Shapes and dtypes as :func:`wkv6_reference`.
    """
    if chunk not in (32, 64):
        raise ValueError(f"wkv6_chunked_reference: chunk {chunk} is not 32 or 64")
    B, S, H, N = r.shape
    T, T2, Q = chunk, chunk // 2, chunk // 4
    C = -(-S // T)
    Lc = -(-C // max(1, segments)) if C else 0
    P = -(-C // Lc) if C else 1

    def chunks(x, dtype):
        # (B, S, H, N) → (C, B, H, T, N), zero-padded to C·T steps
        x = torch.nn.functional.pad(x.to(dtype), (0, 0, 0, 0, 0, C * T - S))
        return x.reshape(B, C, T, H, N).permute(1, 0, 3, 2, 4)

    rr, kk, vv = chunks(r, acc), chunks(k, acc), chunks(v, acc)
    ww = chunks(logw, torch.float64)
    uf = u.to(acc)

    def exclusive_cumprod(e):                            # Π_{j<t} e_j along dim 2
        return torch.nn.functional.pad(e.cumprod(dim=2)[:, :, :-1], (0, 0, 1, 0), value=1.0)

    def suffix(e):                                       # Π_{j>s} e_j along dim 2
        return exclusive_cumprod(e.flip(2)).flip(2)

    def walked(rows, ks, ew, lw):
        """A of steps ``rows`` against themselves by running products: k_s
        ⊙ Π_{s<j<t} e_j walked over t, the bonus on the diagonal.  In
        float64 (a check's want, whose rounding order does not matter) the
        decays come at once as e^{Σ_{s<j<t} logw_j} from lw's running sums
        (each ≤ 0, so nothing overflows): a few launches instead of a walk
        of several a step."""
        L = ks.shape[2]
        if acc == torch.float64:
            c = lw.cumsum(dim=2)                         # Σ_{j<=t} logw_j
            below = torch.ones(L, L, dtype=torch.bool, device=r.device).tril(-1)
            expo = torch.where(below[:, :, None], (c - lw)[:, :, :, None] - c[:, :, None],
                               torch.tensor(-torch.inf, dtype=acc, device=r.device))
            a = torch.einsum("bhtd,bhsd,bhtsd->bhts", rows, ks, torch.exp(expo))
            a = a + torch.diag_embed((rows * uf[:, None] * ks).sum(-1))
            return a, ks * suffix(ew)
        a = torch.zeros((B, H, L, L), dtype=acc, device=r.device)
        k_run = torch.zeros_like(ks)
        for t in range(L):
            a[:, :, t] = torch.einsum("bhd,bhsd->bhs", rows[:, :, t], k_run)
            a[:, :, t, t] = (rows[:, :, t] * uf * ks[:, :, t]).sum(-1)
            k_run = k_run * ew[:, :, t, None]
            k_run[:, :, t] = ks[:, :, t]
        return a, k_run

    def factors(c):
        """(rd, kd) of chunk c: r ⊙ Π_{j<t} e_j and k ⊙ Π_{j>s} e_j."""
        ew = torch.exp(ww[c].to(acc))
        if T == 32:
            return rr[c] * exclusive_cumprod(ew), kk[c] * suffix(ew)
        lo, hi = slice(0, T2), slice(T2, T)
        e0 = ew[:, :, lo].prod(dim=2, keepdim=True)
        e1 = ew[:, :, hi].prod(dim=2, keepdim=True)
        rd = torch.cat([rr[c][:, :, lo] * exclusive_cumprod(ew[:, :, lo]),
                        rr[c][:, :, hi] * exclusive_cumprod(ew[:, :, hi]) * e0], dim=2)
        kd = torch.cat([kk[c][:, :, lo] * suffix(ew[:, :, lo]) * e1,
                        kk[c][:, :, hi] * suffix(ew[:, :, hi])], dim=2)
        return rd, kd

    def amat(c):
        ew = torch.exp(ww[c].to(acc))
        if T == 64:
            a = torch.zeros((B, H, T, T), dtype=acc, device=r.device)
            lo, hi = slice(0, T2), slice(T2, T)
            a[:, :, lo, lo] = walked(rr[c][:, :, lo], kk[c][:, :, lo], ew[:, :, lo],
                                     ww[c][:, :, lo])[0]
            a[:, :, hi, hi] = walked(rr[c][:, :, hi], kk[c][:, :, hi], ew[:, :, hi],
                                     ww[c][:, :, hi])[0]
            a[:, :, hi, lo] = torch.einsum(
                "bhtd,bhsd->bhts", rr[c][:, :, hi] * exclusive_cumprod(ew[:, :, hi]),
                kk[c][:, :, lo] * suffix(ew[:, :, lo]))
            return a
        a = torch.zeros((B, H, T, T), dtype=acc, device=r.device)
        k_end = torch.zeros_like(kk[c])                  # k_s Π_{s<j<end of its block}
        for lo in range(0, T, Q):                        # the diagonal blocks
            blk = slice(lo, lo + Q)
            a[:, :, blk, blk], k_end[:, :, blk] = walked(rr[c][:, :, blk], kk[c][:, :, blk],
                                                         ew[:, :, blk], ww[c][:, :, blk])

        def r_from(rows):                                # r_t Π_{rows.start<=j<t} e_j
            return rr[c][:, :, rows] * exclusive_cumprod(ew[:, :, rows])

        def block(t_rows, s_cols, r_fac, k_fac):
            a[:, :, t_rows, s_cols] = torch.einsum("bhtd,bhsd->bhts", r_fac, k_fac)

        q1, q2, q3 = slice(Q, 2 * Q), slice(2 * Q, 3 * Q), slice(3 * Q, T)
        s0, high = slice(0, Q), slice(T2, T)
        r_high = r_from(high)
        p8 = ew[:, :, q1].prod(dim=2, keepdim=True)      # Π_{Q<=j<T/2} e_j
        block(high, s0, r_high * p8, k_end[:, :, s0])
        block(high, q1, r_high, k_end[:, :, q1])
        block(q1, s0, r_from(q1), k_end[:, :, s0])
        block(q3, q2, r_from(q3), k_end[:, :, q2])
        return a

    def state_step(c, state):
        d_chunk = torch.exp(ww[c].sum(dim=2).to(acc))
        return d_chunk[..., None] * state + torch.einsum("bhsd,bhse->bhde", factors(c)[1], vv[c])

    def out_step(c, state):
        return torch.einsum("bhtd,bhde->bhte", factors(c)[0], state) + amat(c) @ vv[c]

    state = state0.to(acc)
    incoming = [state]
    for p in range(P - 1):                               # each segment's U_p, d_p
        contrib = torch.zeros_like(state)
        total = torch.zeros((B, H, N), dtype=torch.float64, device=r.device)
        for c in range(p * Lc, (p + 1) * Lc):
            contrib = state_step(c, contrib)
            total = total + ww[c].sum(dim=2)
        incoming.append(torch.exp(total.to(acc))[..., None] * incoming[-1] + contrib)
    outs = []
    for p in range(P):
        state = incoming[p]
        for c in range(p * Lc, min((p + 1) * Lc, C)):
            outs.append(out_step(c, state))
            state = state_step(c, state)
    if not outs:
        return r.clone(), state.float()
    out = torch.stack(outs).permute(1, 0, 3, 2, 4).reshape(B, C * T, H, N)[:, :S]
    return out.to(r.dtype), state.float()


def int8_matmul_reference(x_q, w_q, sx, sw) -> torch.Tensor:
    """Dequantize-then-matmul oracle.

    x_q: (M, K) int8; w_q: (K, N) int8; sx: (M,) fp32; sw: (N,) fp32 →
    (M, N) fp32.
    """
    x = x_q.float() * sx[:, None]
    w = w_q.float() * sw[None, :]
    return x @ w


def int8_matmul_exact(x_q, w_q, sx, sw) -> torch.Tensor:
    """The function of the int8 kernels: the exact integer product (int32
    on the TPU and the card; here float64, exact for any K the kernels
    take), rounded once to fp32, then ``(acc · sx[:, None]) · sw[None, :]``
    in fp32, one rounding per product.

    x_q: (M, K) int8; w_q: (K, N) int8; sx: (M,) fp32; sw: (N,) fp32 →
    (M, N) fp32.
    """
    acc = (x_q.double() @ w_q.double()).float()
    return (acc * sx[:, None]) * sw[None, :]


def quantize_rowwise(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row int8 quantization → (q, scales).  ``torch.round``
    rounds half to even, as ``jnp.round`` does."""
    amax = x.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale[..., 0].float()
