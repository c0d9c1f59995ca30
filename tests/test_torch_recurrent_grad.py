"""The gradients of the two recurrences, K3 (RG-LRU scan) and K4 (WKV6), on
the CPU.

- The plain backwards, ``ref.rglru_backward_reference`` and
  ``ref.wkv6_backward_reference`` (explicit formulas, no autograd), are held
  to ``jax.vjp`` of ``repro.kernels.ref.rglru_reference``, of
  ``repro.kernels.ref.wkv6_reference`` and of ``repro.models.rwkv6.
  wkv_chunked`` (S a multiple of 32), with a nonzero initial state and a
  gradient on the final state.  The port computes in float64 from the fp32
  inputs and JAX in fp32, so each gradient is held within FP32_TOL of its
  largest entry: JAX's fp32 sums over the sequence (up to 70 steps here) and
  ``wkv_chunked``'s exponentials of cumulative sums lose a few ulps of that
  entry (measured worst 3.1e-6 of it, on the WKV's dlogw; 1.2e-7 on the
  RG-LRU's).
- In float64 they are held to the port's own autograd through the plain
  forwards within F64_TOL of the largest entry (measured 9.4e-16 or less;
  the chunked decomposition below likewise).
- ``wkv6_backward_chunked_reference`` (below), the decomposition of K4's backward
  kernel (chunk states, the gradient carried back across chunks, the
  intra-chunk terms and dlogw by the reverse-cumsum identity), is held to
  the sequential formulas in float64, with a partial last chunk.
- ``RGLRUScan`` and ``WKV6``, the autograd Functions that ``ops`` runs on
  the card, with their kernel calls replaced by the plain versions: gradient
  dtypes (bf16 in, bf16 out; fp32 states), None where no gradient is
  wanted, remat (``torch.utils.checkpoint``) bitwise equal to no remat, and
  a reduced recurrentgemma-9b and rwkv6-7b ``DecoderLM`` trained one step
  through them within FP32_TOL of the plain autograd path.
Inputs come from numpy seeds.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.models import rwkv6 as jrwkv  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import rglru_scan as rg  # noqa: E402
from repro_torch.kernels import wkv6 as wk  # noqa: E402
from repro_torch.models import build_model, reduced  # noqa: E402
from repro_torch.training.data import DataConfig, host_batch  # noqa: E402
from repro_torch.training.step import make_grad_fn  # noqa: E402
from repro_torch.training.tree import flatten  # noqa: E402

FP32_TOL = 1e-5
F64_TOL = 1e-12


def close(got, want, tol):
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    scale = max(float(np.abs(want).max()), 1e-30) if want.size else 1.0
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= tol * scale, f"max |err| {err} > {tol} x {scale}"


def rglru_inputs(seed, B, S, R):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.5, 0.999, (B, S, R)).astype(np.float32)
    b = (0.3 * rng.standard_normal((B, S, R))).astype(np.float32)
    s0 = rng.standard_normal((B, R)).astype(np.float32)
    g = rng.standard_normal((B, S, R)).astype(np.float32)
    g_last = rng.standard_normal((B, R)).astype(np.float32)
    return a, b, s0, g, g_last


def wkv_inputs(seed, B, S, H, N):
    rng = np.random.default_rng(seed)
    r, k, v, do = ((0.5 * rng.standard_normal((B, S, H, N))).astype(np.float32)
                   for _ in range(4))
    logw = (-np.exp(rng.standard_normal((B, S, H, N)))).astype(np.float32)
    u = (0.3 * rng.standard_normal((H, N))).astype(np.float32)
    s0 = (0.3 * rng.standard_normal((B, H, N, N))).astype(np.float32)
    ds = rng.standard_normal((B, H, N, N)).astype(np.float32)
    return r, k, v, logw, u, s0, do, ds


def f64(*xs):
    return [torch.from_numpy(x).double() for x in xs]


@pytest.mark.parametrize("B,S,R,seed", [(2, 37, 16, 0), (1, 1, 8, 1), (3, 64, 5, 2)])
def test_rglru_backward_matches_jax_vjp(B, S, R, seed):
    a, b, s0, g, g_last = rglru_inputs(seed, B, S, R)
    _, vjp = jax.vjp(jref.rglru_reference, jnp.asarray(a), jnp.asarray(b), jnp.asarray(s0))
    want = vjp((jnp.asarray(g), jnp.asarray(g_last)))
    got = ref.rglru_backward_reference(*f64(a, b, s0, g, g_last))
    for x, w in zip(got, want):
        close(x.numpy(), np.asarray(w), FP32_TOL)


@pytest.mark.parametrize("with_last", [True, False])
def test_rglru_backward_matches_float64_autograd(with_last):
    a, b, s0, g, g_last = f64(*rglru_inputs(3, 2, 45, 12))
    xs = [t.clone().requires_grad_() for t in (a, b, s0)]
    seq, last = ref.rglru_reference(*xs)
    loss = (seq * g).sum() + ((last * g_last).sum() if with_last else 0.0)
    want = torch.autograd.grad(loss, xs)
    got = ref.rglru_backward_reference(a, b, s0, g, g_last if with_last else None)
    for x, w in zip(got, want):
        close(x.numpy(), w.numpy(), F64_TOL)


def test_rglru_backward_of_an_empty_sequence_passes_g_last_to_s0():
    a, b, s0, g, g_last = f64(*rglru_inputs(4, 2, 0, 6))
    da, db, ds0 = ref.rglru_backward_reference(a, b, s0, g, g_last)
    assert da.shape == a.shape and db.shape == b.shape and torch.equal(ds0, g_last)


@pytest.mark.parametrize("B,S,H,N,seed", [(2, 64, 2, 8, 0), (1, 32, 3, 16, 1)])
def test_wkv6_backward_matches_jax_vjp_of_wkv_chunked(B, S, H, N, seed):
    r, k, v, logw, u, s0, do, ds = wkv_inputs(seed, B, S, H, N)
    _, vjp = jax.vjp(lambda *xs: jrwkv.wkv_chunked(*xs, chunk=32),
                     *(jnp.asarray(x) for x in (r, k, v, logw, u, s0)))
    want = vjp((jnp.asarray(do), jnp.asarray(ds)))
    got = ref.wkv6_backward_reference(*f64(r, k, v, logw, u, s0, do, ds))
    for x, w in zip(got, want):
        close(x.numpy(), np.asarray(w), FP32_TOL)


@pytest.mark.parametrize("B,S,H,N,seed", [(2, 70, 2, 8, 2), (1, 5, 1, 32, 3)])
def test_wkv6_backward_matches_jax_vjp_of_the_sequential_reference(B, S, H, N, seed):
    r, k, v, logw, u, s0, do, ds = wkv_inputs(seed, B, S, H, N)
    _, vjp = jax.vjp(jref.wkv6_reference, *(jnp.asarray(x) for x in (r, k, v, logw, u, s0)))
    want = vjp((jnp.asarray(do), jnp.asarray(ds)))
    got = ref.wkv6_backward_reference(*f64(r, k, v, logw, u, s0, do, ds))
    for x, w in zip(got, want):
        close(x.numpy(), np.asarray(w), FP32_TOL)


@pytest.mark.parametrize("with_state", [True, False])
def test_wkv6_backward_matches_float64_autograd(with_state):
    r, k, v, logw, u, s0, do, ds = f64(*wkv_inputs(5, 2, 41, 2, 8))
    xs = [t.clone().requires_grad_() for t in (r, k, v, logw, u, s0)]
    out, state = ref.wkv6_reference(*xs, acc=torch.float64)
    # ds is fp32-valued, so the final state's fp32 rounding loses no gradient
    loss = (out * do).sum() + ((state * ds.float()).sum() if with_state else 0.0)
    want = torch.autograd.grad(loss, xs)
    got = ref.wkv6_backward_reference(r, k, v, logw, u, s0, do, ds if with_state else None,
                                      chunk=16)
    for x, w in zip(got, want):
        close(x.numpy(), w.numpy(), F64_TOL)


def wkv6_backward_chunked_reference(r, k, v, logw, u, state0, dout, dstate=None, *,
                                    chunk: int = 32, acc: torch.dtype = torch.float32):
    """The chunked backward of K4′'s CUDA kernel (``csrc/wkv6_bwd.cu``), in
    plain PyTorch: the kernel's decomposition, not its summation order, held
    here to ``ref.wkv6_backward_reference``.

    The sequence is cut into chunks of T = ``chunk`` steps, the tail padded
    as the forward pads it (r = k = v = do = 0, logw = 0).  With e = e^{logw},
    pd_t = Π_{j<t} e_j and sd_s = Π_{j>s} e_j within a chunk (running
    products), D = e^{Σ_j logw_j} its decay (a float64 sum rounded once),
    S_c the state entering chunk c and Go_c the gradient of the state it
    leaves:
    - states, forward:     S_{c+1} = D ⊙ S_c + (k ⊙ sd)ᵀ V
    - gradient, backward:  Go_{c−1} = D ⊙ Go_c + (r ⊙ pd)ᵀ dO  (Go_{C−1} =
      ``dstate``; dstate0 = D_0 ⊙ Go_0 + …, the gradient of S_0)
    - then every chunk on its own, with P = dO Vᵀ (T × T):
        dr′_t = pd_t ⊙ (S_c do_t) + Σ_{s<t} P[t,s] k_s ⊙ Π_{s<j<t} e_j
        dk′_s = sd_s ⊙ (Go_c v_s) + Σ_{τ>s} P[τ,s] r_τ ⊙ Π_{s<j<τ} e_j
        dr = dr′ + P[t,t] u ⊙ k_t,  dk = dk′ + P[t,t] u ⊙ r_t
        dv = (k ⊙ sd) Go_c + Aᵀ dO   (A the forward's intra-chunk matrix,
             A[τ,t] = Σ_d r_τ k_t Π_{t<j<τ} e_j below its diagonal and
             Σ_d r_t u k_t on it)
        du = Σ P[t,t] r_t ⊙ k_t
        dlogw_t = D ⊙ rowsum(Go_c ⊙ S_c) + Σ_{s<t} k_s ⊙ sd_s ⊙ (Go_c v_s)
                  + Σ_{τ>t} r_τ ⊙ dr′_τ − Σ_{s≥t} k_s ⊙ (dk′_s − sd_s ⊙ (Go_c v_s))
      the last by the reverse-cumsum identity of the chunked form: w_t ⊙
      rowsum(G_t ⊙ S_{t−1}) summed over its pairs of terms, with the bonus
      terms (u) left out, as they do not pass through the state.
    Shapes as ``ref.wkv6_backward_reference``; computes in ``acc`` and
    returns (dr, dk, dv, dlogw, du, dstate0) in ``acc``.
    """
    B, S, H, N = r.shape
    T = chunk
    C = -(-S // T)
    if C == 0:
        zero = torch.zeros_like(r, dtype=acc)
        return (zero, zero, zero.clone(), zero.clone(), torch.zeros_like(u, dtype=acc),
                torch.zeros_like(state0, dtype=acc) if dstate is None else dstate.to(acc))

    def chunks(x, dtype):
        # (B, S, H, N) → (C, B, H, T, N), zero-padded to C·T steps
        x = torch.nn.functional.pad(x.to(dtype), (0, 0, 0, 0, 0, C * T - S))
        return x.reshape(B, C, T, H, N).permute(1, 0, 3, 2, 4)

    rr, kk, vv, do = (chunks(x, acc) for x in (r, k, v, dout))
    ww = chunks(logw, torch.float64)
    ew = torch.exp(ww.to(acc))
    uf = u.to(acc)[None, :, None, :]                                 # (1, H, 1, N)
    ones = torch.ones_like(ew[:, :, :, :1])
    pd = torch.cat([ones, ew[:, :, :, :-1]], dim=3).cumprod(dim=3)   # Π_{j<t} e_j
    sd = torch.cat([ew[:, :, :, 1:], ones], dim=3).flip(3).cumprod(dim=3).flip(3)
    decay = torch.exp(ww.sum(dim=3).to(acc))[..., None]              # (C, B, H, N, 1)
    between = torch.zeros((C, B, H, T, T, N), dtype=acc, device=r.device)
    for s in range(T):                      # between[t, s] = Π_{s<j<t} e_j, t > s
        f = torch.ones_like(ew[:, :, :, 0])
        for t in range(s + 1, T):
            between[:, :, :, t, s] = f
            f = f * ew[:, :, :, t]
    below = torch.tril(torch.ones((T, T), dtype=torch.bool, device=r.device), -1)

    states = [state0.to(acc)]
    for c in range(C - 1):
        states.append(decay[c] * states[-1]
                      + torch.einsum("bhsd,bhse->bhde", kk[c] * sd[c], vv[c]))
    go = [None] * C
    G = torch.zeros_like(states[0]) if dstate is None else dstate.to(acc)
    for c in reversed(range(C)):
        go[c] = G
        G = decay[c] * G + torch.einsum("bhtd,bhte->bhde", rr[c] * pd[c], do[c])
    dstate0 = G
    Sc, Go = torch.stack(states), torch.stack(go)                    # (C, B, H, N, N)

    P = torch.einsum("cbhte,cbhse->cbhts", do, vv)
    diag = torch.diagonal(P, dim1=3, dim2=4)[..., None]              # P[t, t], (..., T, 1)
    Pl = P * below
    dr_state = pd * torch.einsum("cbhde,cbhte->cbhtd", Sc, do)
    dr_intra = torch.einsum("cbhts,cbhsd,cbhtsd->cbhtd", Pl, kk, between)
    gv = torch.einsum("cbhde,cbhse->cbhsd", Go, vv)                  # Go_c v_s
    dk_state = sd * gv
    dk_intra = torch.einsum("cbhts,cbhtd,cbhtsd->cbhsd", Pl, rr, between)
    dr = dr_state + dr_intra + diag * uf * kk
    dk = dk_state + dk_intra + diag * uf * rr
    A = (torch.einsum("cbhtd,cbhsd,cbhtsd->cbhts", rr, kk, between) * below
         + torch.diag_embed(torch.einsum("cbhtd,cbhtd->cbht", rr * uf, kk)))
    dv = torch.einsum("cbhsd,cbhde->cbhse", kk * sd, Go) + torch.einsum("cbhts,cbhte->cbhse",
                                                                         A, do)
    du = torch.einsum("cbht,cbhtd->hd", diag[..., 0], rr * kk)
    rdr, ks, ki = rr * (dr_state + dr_intra), kk * dk_state, kk * dk_intra
    total = decay[..., 0][:, :, :, None] * (Go * Sc).sum(-1)[:, :, :, None]   # (C, B, H, 1, N)
    before = ks.cumsum(dim=3) - ks                                   # Σ_{s<t}
    after_r = rdr.flip(3).cumsum(dim=3).flip(3) - rdr                # Σ_{τ>t}
    from_i = ki.flip(3).cumsum(dim=3).flip(3)                        # Σ_{s≥t}
    dlogw = total + before + after_r - from_i

    def unchunk(x):                                                  # → (B, S, H, N)
        return x.permute(1, 0, 3, 2, 4).reshape(B, C * T, H, N)[:, :S]
    return (unchunk(dr), unchunk(dk), unchunk(dv), unchunk(dlogw), du, dstate0)



@pytest.mark.parametrize("B,S,H,N,seed", [(2, 70, 2, 8, 6), (1, 32, 1, 32, 7),
                                          (2, 9, 3, 4, 8), (1, 96, 2, 8, 9)])
def test_wkv6_chunked_backward_matches_the_sequential_formulas(B, S, H, N, seed):
    args = f64(*wkv_inputs(seed, B, S, H, N))
    want = ref.wkv6_backward_reference(*args)
    got = wkv6_backward_chunked_reference(*args, acc=torch.float64)
    for x, w in zip(got, want):
        close(x.numpy(), w.numpy(), F64_TOL)


def test_wkv6_chunked_backward_of_an_empty_sequence():
    r, k, v, logw, u, s0, do, ds = f64(*wkv_inputs(10, 2, 0, 2, 8))
    got = wkv6_backward_chunked_reference(r, k, v, logw, u, s0, do, ds,
                                              acc=torch.float64)
    want = ref.wkv6_backward_reference(r, k, v, logw, u, s0, do, ds)
    assert all(x.shape == w.shape for x, w in zip(got, want))
    assert torch.equal(got[5], ds) and torch.equal(want[5], ds)
    assert not got[4].any() and not want[4].any()


# ---- the autograd Functions, their kernel calls the plain versions ----

def plain_rglru_bwd(a, b, s0, g, g_last=None):
    da, db, ds0 = rg.plain_grad(a, b, s0, g, g_last)
    return da.to(a.dtype), db.to(b.dtype), ds0


def plain_wkv6_bwd(r, k, v, logw, u, state0, dout, dstate=None):
    grads = wk.plain_grad(r, k, v, logw, u, state0, dout, dstate)
    return tuple(g.to(x.dtype) for g, x in zip(grads, (r, k, v, logw, u, state0)))


@pytest.fixture
def plain_kernels(monkeypatch):
    """The Functions' kernel calls replaced by the plain versions, each call
    counted."""
    calls = {"rglru_scan": 0, "rglru_scan_bwd": 0, "wkv6": 0, "wkv6_bwd": 0}

    def counted(name, fn):
        def call(*args):
            calls[name] += 1
            return fn(*args)
        return call
    monkeypatch.setattr(rg, "rglru_scan", counted("rglru_scan", rg.plain))
    monkeypatch.setattr(rg, "rglru_scan_bwd", counted("rglru_scan_bwd", plain_rglru_bwd))
    monkeypatch.setattr(wk, "wkv6", counted("wkv6", wk.plain))
    monkeypatch.setattr(wk, "wkv6_bwd", counted("wkv6_bwd", plain_wkv6_bwd))
    return calls


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rglru_function_gradients_dtypes_and_nones(plain_kernels, dtype):
    a, b, s0, g, g_last = (torch.from_numpy(x) for x in rglru_inputs(11, 2, 20, 8))
    a, b, g = a.to(dtype), b.to(dtype), g.to(dtype)
    xs = [t.clone().requires_grad_() for t in (a, b, s0)]
    seq, last = rg.RGLRUScan.apply(*xs)
    assert seq.dtype == dtype and last.dtype == torch.float32
    grads = torch.autograd.grad((seq.float() * g.float()).sum() + (last * g_last).sum(), xs)
    assert [x.dtype for x in grads] == [dtype, dtype, torch.float32]
    want = plain_rglru_bwd(a, b, s0, g, g_last)
    assert all(torch.equal(x, w) for x, w in zip(grads, want))
    assert plain_kernels["rglru_scan"] == 1 and plain_kernels["rglru_scan_bwd"] == 1
    # only b wants a gradient: None for a and s0
    bb = b.clone().requires_grad_()
    seq, _ = rg.RGLRUScan.apply(a, bb, s0)
    seq.float().sum().backward()
    assert bb.grad is not None and bb.grad.dtype == dtype


def test_rglru_function_against_autograd_through_the_plain_version(plain_kernels):
    a, b, s0, g, g_last = (torch.from_numpy(x) for x in rglru_inputs(12, 2, 33, 8))
    xs = [t.clone().requires_grad_() for t in (a, b, s0)]
    loss = lambda seq, last: (seq * g).sum() + (last * g_last).sum()  # noqa: E731
    got = torch.autograd.grad(loss(*rg.RGLRUScan.apply(*xs)), xs)
    want = torch.autograd.grad(loss(*rg.plain(*xs)), xs)
    for x, w in zip(got, want):
        close(x.detach().numpy(), w.numpy(), FP32_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wkv6_function_gradients_dtypes_and_nones(plain_kernels, dtype):
    r, k, v, logw, u, s0, do, ds = (torch.from_numpy(x) for x in wkv_inputs(13, 2, 40, 2, 8))
    r, k, v, do = (t.to(dtype) for t in (r, k, v, do))
    xs = [t.clone().requires_grad_() for t in (r, k, v, logw, u, s0)]
    out, state = wk.WKV6.apply(*xs)
    assert out.dtype == dtype and state.dtype == torch.float32
    grads = torch.autograd.grad((out.float() * do.float()).sum() + (state * ds).sum(), xs)
    assert [x.dtype for x in grads] == [dtype] * 3 + [torch.float32] * 3
    want = plain_wkv6_bwd(r, k, v, logw, u, s0, do, ds)
    assert all(torch.equal(x, w) for x, w in zip(grads, want))
    assert plain_kernels["wkv6"] == 1 and plain_kernels["wkv6_bwd"] == 1
    # the model's case: u and the state want no gradient
    kk, ww = k.clone().requires_grad_(), logw.clone().requires_grad_()
    out, _ = wk.WKV6.apply(r, kk, v, ww, u, s0)
    dk, dlogw = torch.autograd.grad(out.float().sum(), (kk, ww))
    assert dk.dtype == dtype and dlogw.dtype == torch.float32


def test_wkv6_function_against_autograd_through_the_plain_version(plain_kernels):
    r, k, v, logw, u, s0, do, ds = (torch.from_numpy(x) for x in wkv_inputs(14, 1, 45, 2, 8))
    xs = [t.clone().requires_grad_() for t in (r, k, v, logw, u, s0)]
    loss = lambda out, st: (out * do).sum() + (st * ds).sum()  # noqa: E731
    got = torch.autograd.grad(loss(*wk.WKV6.apply(*xs)), xs)
    want = torch.autograd.grad(loss(*wk.plain(*xs)), xs)
    for x, w in zip(got, want):
        close(x.detach().numpy(), w.numpy(), FP32_TOL)


@pytest.mark.parametrize("kernel", ["rglru_scan", "wkv6"])
def test_remat_is_bitwise_no_remat(plain_kernels, kernel):
    """A layer-like function around each Function, under
    ``torch.utils.checkpoint`` and without: the forward runs twice, the
    backward once, and the gradients are bitwise the same."""
    from torch.utils.checkpoint import checkpoint
    if kernel == "rglru_scan":
        a, b, s0, g, _ = (torch.from_numpy(x) for x in rglru_inputs(15, 2, 24, 8))
        w = torch.randn((8, 8), generator=torch.Generator().manual_seed(0), requires_grad=True)

        def layer(x, w):
            seq, last = rg.RGLRUScan.apply(torch.sigmoid(x @ w), b, s0)
            return (seq * g).sum() + last.sum()
        x = a
    else:
        r, k, v, logw, u, s0, do, _ = (torch.from_numpy(x) for x in wkv_inputs(16, 1, 40, 2, 8))
        w = torch.randn((8, 8), generator=torch.Generator().manual_seed(0), requires_grad=True)

        def layer(x, w):
            out, _ = wk.WKV6.apply(x @ w, k, v, logw, u, s0)
            return (out * do).sum()
        x = r
    got = {}
    for remat in (False, True):
        for name in plain_kernels:
            plain_kernels[name] = 0
        loss = checkpoint(layer, x, w, use_reentrant=False) if remat else layer(x, w)
        got[remat] = torch.autograd.grad(loss, w)[0]
        assert (plain_kernels[kernel], plain_kernels[kernel + "_bwd"]) == (2 if remat else 1, 1)
    assert torch.equal(got[False], got[True])


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "rwkv6-7b"])
def test_model_train_step_through_the_functions(plain_kernels, monkeypatch, arch):
    """The reduced hybrid and RWKV6 models' gradient, with ``ops`` sending
    the recurrences through ``RGLRUScan`` and ``WKV6`` (what it does on the
    card), with remat, against the plain autograd path without."""
    cfg = dataclasses.replace(reduced(get_config(arch)), dtype="float32")
    model = build_model(cfg, "cpu")
    params = model.init(torch.Generator().manual_seed(0))
    batch = host_batch(DataConfig(global_batch=2, seq_len=40), cfg, 0)
    want, _ = make_grad_fn(model, remat=False)(params, batch)
    monkeypatch.setattr(ops, "rglru_scan", rg.RGLRUScan.apply)
    monkeypatch.setattr(ops, "wkv6", wk.WKV6.apply)
    got, _ = make_grad_fn(model, remat=True)(params, batch)
    kinds = cfg.layer_kinds()
    n = kinds.count("rglru") if arch == "recurrentgemma-9b" else kinds.count("rwkv6")
    name = "rglru_scan" if arch == "recurrentgemma-9b" else "wkv6"
    assert n > 0 and (plain_kernels[name], plain_kernels[name + "_bwd"]) == (2 * n, n)
    for (path, g), (_, w) in zip(flatten(got), flatten(want)):
        close(g.numpy(), w.numpy(), FP32_TOL)


@pytest.mark.parametrize("arch,layers,params", [("recurrentgemma-9b", 6, 2_361_561_088),
                                                ("rwkv6-7b", 8, 2_017_857_536)])
def test_trainer_layers_flag_cuts_depth_at_full_width(arch, layers, params):
    """``launch/train.py --layers``: the configs the card trains (their whole
    state, 16 bytes a parameter, 37.8 and 32.3 GB, fits one card; all 38 and
    32 layers do not)."""
    from repro_torch.launch import train
    from repro_torch.models.registry import count_params, param_shapes
    full = train.model_config(arch)
    cfg = train.model_config(arch, layers=layers)
    assert (cfg.num_layers, cfg.d_model, cfg.d_ff) == (layers, full.d_model, full.d_ff)
    assert count_params(param_shapes(build_model(cfg, "cpu"))) == params
    assert train.model_config(arch, reduce=True, layers=2).num_layers == 2


@pytest.mark.parametrize("N", [16, 5, 48])
def test_wkv6_padded_heads_compute_the_same_function(N):
    """K4 and K4′ run a head of N outside ``HEAD_SIZES`` (rwkv6-7b's ~100M
    config has heads of 16) zero-padded to the next size: the padded
    forward's and backward's first N channels are the unpadded ones (the
    plain versions in float64 here; the kernels on the card)."""
    args = f64(*wkv_inputs(17, 2, 45, 2, N))
    size = wk.kernel_head_size(N)
    assert size == (32 if N <= 32 else 64)
    padded = wk.pad_heads(size, *args)
    assert [t.shape[-1] for t in padded] == [size] * 8
    out, state = ref.wkv6_reference(*padded[:6], acc=torch.float64)
    want_out, want_state = ref.wkv6_reference(*args[:6], acc=torch.float64)
    close(out[..., :N].numpy(), want_out.numpy(), F64_TOL)
    close(state[..., :N, :N].numpy(), want_state.numpy(), 2.0 ** -23)   # rounded to fp32 once
    got, want = ref.wkv6_backward_reference(*padded), ref.wkv6_backward_reference(*args)
    for g, w in zip(got[:5], want[:5]):
        close(g[..., :N].numpy(), w.numpy(), F64_TOL)
    close(got[5][..., :N, :N].numpy(), want[5].numpy(), F64_TOL)
    for bad in (0, 65):
        with pytest.raises(ValueError, match="head size"):
            wk.kernel_head_size(bad)
