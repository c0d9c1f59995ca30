"""Property tests of the recurrences' plain backwards (hypothesis; skipped
where it is not installed, as ``tests/conftest.py`` skips the reference's
property tests): over random shapes, the explicit formulas equal float64
autograd through the plain forwards, and K4's chunked decomposition equals
the sequential formulas at any chunk length, empty and partial chunks
included, within F64_TOL of the largest entry."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
hypothesis = pytest.importorskip("hypothesis")

from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro_torch.kernels import ref  # noqa: E402
from test_torch_recurrent_grad import wkv6_backward_chunked_reference  # noqa: E402

F64_TOL = 1e-12
SETTINGS = settings(max_examples=25, deadline=None)


def close(got, want):
    for x, w in zip(got, want):
        assert x.shape == w.shape
        if w.numel():
            assert float((x - w).abs().max()) <= F64_TOL * max(float(w.abs().max()), 1e-30)


def wkv_args(seed, B, S, H, N):
    rng = np.random.default_rng(seed)

    def normal(*shape, scale=1.0):
        return torch.from_numpy(scale * rng.standard_normal(shape))
    return (normal(B, S, H, N, scale=0.5), normal(B, S, H, N, scale=0.5), normal(B, S, H, N),
            -torch.exp(normal(B, S, H, N)), normal(H, N, scale=0.3),
            normal(B, H, N, N, scale=0.3), normal(B, S, H, N),
            normal(B, H, N, N).float().double())


@SETTINGS
@given(seed=st.integers(0, 2**31 - 1), B=st.integers(1, 3), S=st.integers(0, 40),
       R=st.integers(1, 9), last=st.booleans())
def test_rglru_formulas_are_float64_autograd(seed, B, S, R, last):
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(rng.uniform(0.0, 1.0, (B, S, R)))
    b, g = (torch.from_numpy(rng.standard_normal((B, S, R))) for _ in range(2))
    s0, g_last = (torch.from_numpy(rng.standard_normal((B, R))) for _ in range(2))
    got = ref.rglru_backward_reference(a, b, s0, g, g_last if last else None)
    if S == 0:
        assert torch.equal(got[2], g_last if last else torch.zeros_like(s0))
        return
    xs = [t.clone().requires_grad_() for t in (a, b, s0)]
    seq, fin = ref.rglru_reference(*xs)
    loss = (seq * g).sum() + ((fin * g_last).sum() if last else 0.0)
    close(got, torch.autograd.grad(loss, xs))


@SETTINGS
@given(seed=st.integers(0, 2**31 - 1), B=st.integers(1, 2), S=st.integers(1, 50),
       H=st.integers(1, 2), N=st.sampled_from([2, 4, 8]), chunk=st.sampled_from([4, 16, 32]))
def test_wkv6_formulas_are_float64_autograd(seed, B, S, H, N, chunk):
    args = wkv_args(seed, B, S, H, N)
    xs = [t.clone().requires_grad_() for t in args[:6]]
    out, state = ref.wkv6_reference(*xs, acc=torch.float64)
    loss = (out * args[6]).sum() + (state * args[7].float()).sum()
    close(ref.wkv6_backward_reference(*args, chunk=chunk), torch.autograd.grad(loss, xs))


@SETTINGS
@given(seed=st.integers(0, 2**31 - 1), B=st.integers(1, 2), S=st.integers(0, 100),
       H=st.integers(1, 2), N=st.sampled_from([2, 4, 8]), chunk=st.sampled_from([4, 8, 32]),
       with_state=st.booleans())
def test_wkv6_chunked_decomposition_is_the_sequential_formulas(seed, B, S, H, N, chunk,
                                                               with_state):
    args = list(wkv_args(seed, B, S, H, N))
    if not with_state:
        args[7] = None
    close(wkv6_backward_chunked_reference(*args, chunk=chunk, acc=torch.float64),
          ref.wkv6_backward_reference(*args))
