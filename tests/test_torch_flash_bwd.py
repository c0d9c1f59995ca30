"""The arithmetic of K1's backward kernel in bf16, on the CPU.

``twin_grad`` below is a plain-PyTorch twin of ``flash_attention_bwd.cu``'s
bf16 path, with no CUDA: it follows the kernel's decomposition, not the
autograd one.
- lse and the fp32 output come from the forward (``forward_state``: K1's
  online softmax over its kv tiles, 64 keys, 32 at d = 256), and D =
  rowsum(dO ∘ O) from that fp32 output, as the dQ kernel's prologue takes
  it; S and dP are summed in fp32 (the products of bf16 inputs are exact
  in fp32).
- P = exp(s - lse) and dS = P (dP - D) times the softcap's derivative are
  fp32 values that enter the gradient products in ``PARITY_BWD_PARTS`` bf16
  parts, as ``split_bf16`` makes them.
- dQ += dS·K over k16 steps of keys; dV += Pᵀ·dO and dK += dSᵀ·Q over the G
  query heads of a kv head, one after the other, and k16 steps of queries.
  Each chain of ``PARITY_BWD_FRESH`` steps has its parts summed in fp32 from
  zero, smallest first, and is added to the accumulator, or (0) every step
  is chained into it.
The switches are read from the kernel's source, so the twin follows what
ships.  The tensor cores' truncating sums are not modelled: ``parity_probe.py
--kernel flash_bwd`` measures those on the card.

The tests hold the twin
- to ``jax.vjp`` of ``repro.kernels.ref.mha_reference`` in fp32, within
  FP32_TOL of each gradient's largest entry (JAX's own fp32 sums over up to
  600 terms and the twin's leave up to 6.2e-6 of it, measured);
- rounded to bf16 as the kernel rounds, to the float64 plain version
  (``fa.plain_grad``) within ``chip_smoke.py`` phase 18's limit,
  2^-14·max|want| + 2^-7·|want| per entry;
- and show that P and dS rounded once to bf16 (one part) exceed that limit,
  which is why the kernel splits them, and that D taken from the forward's
  bf16 output exceeds it, which is why the forward hands over its output in
  fp32.
Inputs are bf16 values made from numpy seeds, at small sizes (S ≤ 256, d in
{64, 128, 256}, G in {1, 4}), causal, windowed, softcapped, ragged and
cross-shaped (Sq ≠ Skv).
"""
import math
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402

CSRC = Path(fa.__file__).resolve().parent / "csrc"
FP32_TOL = 1e-5
BWD_ATOL_SHARE = 2.0 ** -14    # chip_smoke.py phase 18's limit
RTOL = 2.0 ** -7
FWD_TILE = {64: 64, 128: 64, 256: 32}   # keys a kv tile of K1's bf16 forward (kv_tile<D>)
K16 = 16


def shipped_switch(name: str) -> int:
    """The value of a parity switch as the backward kernel ships it: its own
    define, else common.cuh's default."""
    for src in ("flash_attention_bwd.cu", "common.cuh"):
        found = re.search(rf"#ifndef {name}\n#define {name} (\d+)", (CSRC / src).read_text())
        if found:
            return int(found[1])
    raise LookupError(name)


@pytest.fixture(autouse=True)
def one_thread():
    """The twin's products are small: one thread each, so that this file
    leaves the cores to the test files that run beside it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


PARTS = shipped_switch("PARITY_BWD_PARTS")
FRESH = shipped_switch("PARITY_BWD_FRESH")   # k16 steps a fresh chain; 0 chained


def bf16_parts(x, n):
    """fp32 ``x`` as ``n`` bf16 parts, smallest first: the largest the
    rounding of x, each smaller one the rounding of what those above leave
    (split_bf16)."""
    parts = []
    for _ in range(n):
        h = x.to(torch.bfloat16).float()
        parts.append(h)
        x = x - h
    return parts[::-1]


def chain_product(acc, a, b, parts, fresh):
    """acc + a·b over the k16 steps of a's last dimension (b's rows), a
    fp32 in ``parts`` bf16 parts, b bf16 values, each part's product summed
    in fp32: in chains of ``fresh`` steps from zero, each then added, or
    (0) every step chained into acc."""
    steps = -(-a.shape[-1] // K16)
    span = fresh or steps
    for c0 in range(0, steps, span):
        t = acc if not fresh else torch.zeros_like(acc)
        for j in range(c0, min(c0 + span, steps)):
            cols = slice(j * K16, (j + 1) * K16)
            for part in bf16_parts(a[..., cols], parts):
                t = t + part @ b[..., cols, :]
        acc = t if not fresh else acc + t
    return acc


def live_mask(B, Sq, Skv, causal, window, lengths):
    qp, kp = torch.arange(Sq)[:, None], torch.arange(Skv)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool)
    if causal:
        mask &= kp <= qp
    if window > 0:
        mask &= kp > qp - window
    mask = mask.expand(B, Sq, Skv)
    if lengths is not None:
        mask = mask & (kp[None] < lengths[:, None, None])
    return mask


def forward_state(q, k, v, *, causal=True, window=0, softcap=0.0, lengths=None):
    """(out32, lse) as K1's bf16 forward hands them to the backward: the
    online softmax over its kv tiles (the running max and sum, the output
    rescaled where the max moved), each row's m + log l (1e30 for a row with
    no live key) and the output before its bf16 rounding, in fp32."""
    B, H, Sq, d = q.shape
    G = H // k.shape[1]
    kx, vx = k.repeat_interleave(G, 1), v.repeat_interleave(G, 1)
    live = live_mask(B, Sq, k.shape[2], causal, window, lengths)[:, None]
    s = q @ kx.transpose(-1, -2) / math.sqrt(d)
    sc = softcap * torch.tanh(s / softcap) if softcap > 0 else s
    m = torch.full((B, H, Sq), -math.inf)
    l, acc = torch.zeros_like(m), torch.zeros_like(q)
    tile = FWD_TILE[d]
    for k0 in range(0, k.shape[2], tile):
        x = torch.where(live[..., k0:k0 + tile], sc[..., k0:k0 + tile], -math.inf)
        m_new = torch.maximum(m, x.amax(-1))
        m_use = torch.where(m_new > -math.inf, m_new, 0.0)
        alpha = torch.exp(m - m_use)
        p = torch.exp(x - m_use[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + p @ vx[..., k0:k0 + tile, :]
        m = m_new
    lse = torch.where(l > 0, m + torch.log(l), 1e30)
    out32 = torch.where(l[..., None] > 0, acc / l[..., None], 0.0)
    return out32, lse


def twin_grad(q, k, v, dout, *, causal=True, window=0, softcap=0.0, lengths=None,
              parts=PARTS, fresh=FRESH, out=None):
    """(dq, dk, dv) as the bf16 kernel computes them, before it rounds them
    to bf16: q, dout (B, H, Sq, d) and k, v (B, K, Skv, d) fp32 tensors of
    bf16 values.  D from ``out`` where given (the forward's output as some
    other rounding leaves it), else from the forward's fp32 output."""
    B, H, Sq, d = q.shape
    K, Skv = k.shape[1], k.shape[2]
    G = H // K
    scale = 1.0 / math.sqrt(d)
    kx, vx = k.repeat_interleave(G, 1), v.repeat_interleave(G, 1)
    live = live_mask(B, Sq, Skv, causal, window, lengths)[:, None]
    out32, lse = forward_state(q, k, v, causal=causal, window=window, softcap=softcap,
                               lengths=lengths)
    # the dQ kernel's prologue: D = rowsum(dO ∘ O)
    delta = (dout * (out32 if out is None else out)).sum(-1)
    s = q @ kx.transpose(-1, -2) * scale
    sc = softcap * torch.tanh(s / softcap) if softcap > 0 else s
    dp = dout @ vx.transpose(-1, -2)
    p = torch.where(live, torch.exp(sc - lse[..., None]), 0.0)
    ds = p * (dp - delta[..., None])
    if softcap > 0:
        ds = ds * (1.0 - (sc / softcap) ** 2)
    # the dQ kernel: dQ over k16 steps of keys
    dq = chain_product(torch.zeros_like(q), ds, kx, parts, fresh)
    # the dK/dV kernel: the G heads of a kv head one after the other, each
    # over k16 steps of queries
    p, ds = (t.reshape(B, K, G, Sq, Skv).transpose(-1, -2) for t in (p, ds))
    qg, og = (t.reshape(B, K, G, Sq, d) for t in (q, dout))
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for g in range(G):
        dv = chain_product(dv, p[:, :, g], og[:, :, g], parts, fresh)
        dk = chain_product(dk, ds[:, :, g], qg[:, :, g], parts, fresh)
    return dq * scale, dk * scale, dv


def inputs(seed, B, H, K, Sq, Skv, d, q_scale=1.0, lengths=None):
    """q, k, v, dout as bf16 values in fp32 tensors; dout zero on the rows
    past a sequence's length, which carry no loss."""
    rng = np.random.default_rng(seed)
    shapes = ((B, H, Sq, d), (B, K, Skv, d), (B, K, Skv, d), (B, H, Sq, d))
    q, k, v, dout = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
                     .mul(q_scale if i == 0 else 1.0).to(torch.bfloat16).float()
                     for i, s in enumerate(shapes))
    if lengths is not None:
        for b, n in enumerate(lengths):
            dout[b, :, n:] = 0
    return q, k, v, dout


# (name, options): causal, a window across tiles, the softcap reached (q at
# 4x, s/cap ~ 0.5), ragged lengths, and a cross shape (Sq ≠ Skv, not causal)
CASES = {"causal": dict(causal=True),
         "window": dict(causal=True, window=48),
         "softcap": dict(causal=True, softcap=5.0, q_scale=4.0),
         "lengths": dict(causal=True, lengths=(150, 78, 5)),
         "cross": dict(causal=False, Sq=75)}


def case(name, d, G, seed=0):
    """(q, k, v, dout, kernel options) of CASES[name]: B 3, K 2 kv heads of
    G query heads, S 150."""
    opts = dict(CASES[name])
    Sq, q_scale, lens = opts.pop("Sq", 150), opts.pop("q_scale", 1.0), opts.pop("lengths", None)
    q, k, v, dout = inputs(seed, 3, 2 * G, 2, Sq, 150, d, q_scale, lens)
    opts.setdefault("window", 0)
    opts.setdefault("softcap", 0.0)
    opts["lengths"] = None if lens is None else torch.tensor(lens, dtype=torch.int32)
    return q, k, v, dout, opts


def jax_grads(q, k, v, dout, *, causal, window, softcap, lengths):
    lens = None if lengths is None else jnp.asarray(lengths.numpy())
    _, vjp = jax.vjp(lambda q_, k_, v_: jref.mha_reference(
        q_, k_, v_, causal=causal, window=window, softcap=softcap, lengths=lens),
        *(jnp.asarray(t.numpy()) for t in (q, k, v)))
    return [np.asarray(g) for g in vjp(jnp.asarray(dout.numpy()))]


def limit_ratio(got, want):
    """Worst |got − want| / (2^-14·max|want| + 2^-7·|want|) over (dq, dk, dv)."""
    return max(float(((g.double() - w).abs()
                      / (BWD_ATOL_SHARE * w.abs().max() + RTOL * w.abs())).max())
               for g, w in zip(got, want))


def rounded(grads):
    """The kernel's outputs: its fp32 sums rounded once to bf16."""
    return [g.to(torch.bfloat16) for g in grads]


def test_switches_are_read_from_the_source():
    assert PARTS in (1, 2, 3) and FRESH >= 0
    assert shipped_switch("PARITY_QK_CHAIN") == 16


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("d", fa.HEAD_DIMS)
def test_twin_matches_jax_vjp(d, G, name):
    """The twin's fp32 gradients (before the bf16 rounding) within FP32_TOL
    of each gradient's largest entry of ``jax.vjp`` of the reference."""
    q, k, v, dout, opts = case(name, d, G)
    got = twin_grad(q, k, v, dout, **opts)
    want = jax_grads(q, k, v, dout, **opts)
    for g, w in zip(got, want):
        err = float(np.abs(g.numpy() - w).max())
        assert err <= FP32_TOL * float(np.abs(w).max()), (err, float(np.abs(w).max()))


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("d", fa.HEAD_DIMS)
def test_twin_within_the_chip_limit(d, G, name):
    """Rounded to bf16 as the kernel rounds, the twin is within phase 18's
    limit of the float64 plain version."""
    q, k, v, dout, opts = case(name, d, G)
    want = fa.plain_grad(q, k, v, dout, acc=torch.float64, **opts)
    assert limit_ratio(rounded(twin_grad(q, k, v, dout, **opts)), want) <= 1.0


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("d", fa.HEAD_DIMS)
def test_one_part_exceeds_the_chip_limit(d, name):
    """P and dS rounded once to bf16 (one part) exceed phase 18's limit at
    4 query heads per kv head, where the shipped parts keep within it: the
    reason the kernel splits them (measured: 12.6 to 22.6 times the limit at
    one part, 0.49 at two or three, the bf16 rounding's half ulp)."""
    q, k, v, dout, opts = case(name, d, 4)
    want = fa.plain_grad(q, k, v, dout, acc=torch.float64, **opts)
    one = limit_ratio(rounded(twin_grad(q, k, v, dout, parts=1, **opts)), want)
    shipped = limit_ratio(rounded(twin_grad(q, k, v, dout, **opts)), want)
    assert one > 1.0 and shipped <= 1.0, (one, shipped)


def test_bf16_parts_rebuild_the_value():
    """Three parts hold an fp32 value exactly, two to within 2^-16 of it,
    one to within 2^-8: split_bf16's parts, largest the rounding of x."""
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(4096, dtype=np.float32))
    for n, tol in ((1, 2.0 ** -8), (2, 2.0 ** -16), (3, 0.0)):
        parts = bf16_parts(x, n)
        assert torch.equal(parts[-1], x.to(torch.bfloat16).float())
        total = sum(p.double() for p in parts)
        assert float(((total - x.double()).abs() / x.double().abs()).max()) <= tol


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("d", fa.HEAD_DIMS)
def test_delta_from_bf16_output_exceeds_the_chip_limit(d, name):
    """D = rowsum(dO ∘ O) from the forward's output rounded to bf16, where
    the kernel takes the fp32 one, exceeds phase 18's limit at 4 query
    heads per kv head, where the shipped D keeps within it: dQ_i = Σ_j
    dS_ij k_j cancels (each row of dS sums to zero), and an error e in D_i
    moves it by −e·(P·K)_i, which does not.  The reason the forward hands
    its output over in fp32."""
    q, k, v, dout, opts = case(name, d, 4)
    want = fa.plain_grad(q, k, v, dout, acc=torch.float64, **opts)
    out16 = forward_state(q, k, v, **opts)[0].to(torch.bfloat16).float()
    rounded_d = limit_ratio(rounded(twin_grad(q, k, v, dout, out=out16, **opts)), want)
    shipped = limit_ratio(rounded(twin_grad(q, k, v, dout, **opts)), want)
    assert rounded_d > 1.0 and shipped <= 1.0, (rounded_d, shipped)
