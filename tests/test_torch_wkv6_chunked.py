"""K4's chunked, segmented decomposition, on the CPU.

``ref.wkv6_chunked_reference`` is the plain-PyTorch twin of the CUDA
kernel's algorithm (``kernels/csrc/wkv6.cu``): chunks of 32 steps, a tail
chunk, segments chained through their decays, decays from float64 sums and
A's pairwise decays as running products.  Here it is held, on numpy-seeded
inputs, to the Pallas ``wkv6`` in interpret mode (S % 32 == 0, as that
kernel asks) and to the sequential ``wkv6_reference`` of the JAX package at
S ∈ {0, 1, 31, 33, 300}, at both head sizes, within the reference's own
2e-4 / 1e-3 (``tests/test_kernels.py``); with logw down to −exp(3) its
outputs stay finite and agree.  ``wkv6.plan_segments`` cuts every sequence
into whole chunks.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.wkv6 import wkv6 as jax_wkv6  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import wkv6 as wk  # noqa: E402

ATOL, RTOL = 2e-4, 1e-3          # tests/test_kernels.py::test_wkv6_kernel


def wkv_inputs(B, S, H, N, seed, logw_mean=0.0, logw_scale=0.5):
    """The distributions of tests/test_kernels.py::test_wkv6_kernel; logw =
    −exp(normal(logw_mean, logw_scale))."""
    rng = np.random.default_rng(seed)

    def normal(shape, scale=1.0):
        return (scale * rng.standard_normal(shape)).astype(np.float32)
    shape = (B, S, H, N)
    logw = -np.exp(logw_mean + normal(shape, logw_scale))
    return (normal(shape, 0.5), normal(shape, 0.5), normal(shape), logw.astype(np.float32),
            normal((H, N), 0.1), normal((B, H, N, N), 0.1))


def chunked(xs, segments):
    out, state = ref.wkv6_chunked_reference(*(torch.from_numpy(x) for x in xs),
                                            segments=segments)
    assert out.dtype == state.dtype == torch.float32
    return out.numpy(), state.numpy()


def assert_close(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("B,S,H,N,segments", [
    (2, 128, 4, 64, 1), (2, 128, 4, 64, 3), (1, 64, 2, 32, 2), (2, 96, 2, 32, 1),
])
def test_chunked_twin_matches_pallas_interpret(B, S, H, N, segments):
    xs = wkv_inputs(B, S, H, N, seed=S + N + segments)
    want = jax_wkv6(*(jnp.asarray(x) for x in xs), chunk=32, interpret=True)
    assert_close(chunked(xs, segments), want)


@pytest.mark.parametrize("N", wk.HEAD_SIZES)
@pytest.mark.parametrize("S", [0, 1, 31, 33, 300])
def test_chunked_twin_matches_sequential_reference(S, N):
    """Any S: empty, one step, one short of a chunk, one past it, and a
    300-step sequence with a 12-step tail cut into the kernel's segments."""
    B, H = 2, 3
    xs = wkv_inputs(B, S, H, N, seed=10 * S + N)
    segments = wk.plan_segments(B, H, S)[0]
    got = chunked(xs, segments)
    assert got[0].shape == (B, S, H, N) and got[1].shape == (B, H, N, N)
    assert_close(got, jref.wkv6_reference(*(jnp.asarray(x) for x in xs)))


@pytest.mark.parametrize("N", wk.HEAD_SIZES)
def test_chunked_twin_survives_extreme_decays(N):
    """logw down to −exp(3) ≈ −20 a step (sums past −600 a chunk, far below
    fp32's exp range): no decay factor exceeds 1, so nothing overflows, and
    the result still agrees with the sequential reference."""
    B, S, H = 2, 100, 2
    xs = wkv_inputs(B, S, H, N, seed=N, logw_mean=1.5, logw_scale=1.0)
    assert xs[3].min() < -np.exp(3.0)
    got = chunked(xs, segments=3)
    assert all(np.isfinite(x).all() for x in got)
    assert_close(got, jref.wkv6_reference(*(jnp.asarray(x) for x in xs)))


@pytest.mark.parametrize("segments", [1, 2, 5, 10])
def test_chunked_twin_is_independent_of_the_segment_cut(segments):
    """The chained segment states reproduce the one-segment run."""
    xs = wkv_inputs(2, 300, 2, 32, seed=3)
    base = chunked(xs, 1)
    assert_close(chunked(xs, segments), base)


@pytest.mark.parametrize("B,H,S", [(4, 64, 4700), (4, 2, 256), (1, 1, 33), (3, 5, 0),
                                   (1, 1, 1), (65535, 1, 64)])
def test_plan_segments_cuts_whole_chunks(B, H, S):
    P, Lc = wk.plan_segments(B, H, S)
    chunks = -(-S // wk.CHUNK)
    if chunks == 0:
        assert (P, Lc) == (1, 0)
        return
    assert 1 <= P <= chunks and (P - 1) * Lc < chunks <= P * Lc
    # enough blocks to fill the card, or one segment a chunk
    assert B * H * P >= min(wk.TARGET_BLOCKS, B * H * chunks) // 2
