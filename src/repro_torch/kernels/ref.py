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


def wkv6_reference(r, k, v, logw, u, state0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Naive sequential WKV recurrence, fp32 throughout, one step at a time:

        o_t = r_tᵀ S_{t−1} + (r_t ⊙ u ⊙ k_t)ᵀ 1 · v_t
        S_t = diag(e^{w_t}) S_{t−1} + k_t v_tᵀ

    r/k/v: (B, S, H, N), any float dtype; logw: (B, S, H, N) fp32; u: (H, N)
    fp32; state0: (B, H, N, N) fp32 → (out (B, S, H, N) in r's dtype, final
    state (B, H, N, N) fp32).  Any S.
    """
    rr, kk, vv = r.float(), k.float(), v.float()
    decay = torch.exp(logw.float())
    uf = u.float()
    state = state0.float()
    outs = []
    for t in range(r.shape[1]):
        rt, kt, vt = rr[:, t], kk[:, t], vv[:, t]                # (B, H, N)
        o = (torch.einsum("bhd,bhde->bhe", rt, state)
             + (rt * uf * kt).sum(-1, keepdim=True) * vt)
        state = decay[:, t, :, :, None] * state + kt[..., :, None] * vt[..., None, :]
        outs.append(o)
    out = torch.stack(outs, dim=1) if outs else rr.clone()
    return out.to(r.dtype), state


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
