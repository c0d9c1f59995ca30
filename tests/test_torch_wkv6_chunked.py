"""K4's chunked, segmented decomposition, on the CPU.

``ref.wkv6_chunked_reference`` is the plain-PyTorch twin of the CUDA
kernels' algorithm (``kernels/csrc/wkv6.cu``): chunks of 32 steps (the
tf32 kernel, fp32 and N = 32) or 64 (the wgmma kernel, bf16 at N = 64: its
decays by halves, A walked within each half and a product below them), a
tail chunk, segments chained through their decays, decays from float64
sums and A's pairwise decays as running products.  Here it is held, at both
chunk lengths, on numpy-seeded inputs, to the Pallas ``wkv6`` in interpret
mode (S % 32 == 0, as that kernel asks) and to the sequential
``wkv6_reference`` of the JAX package at S ∈ {0, 1, 31, 33, 63, 65, 300},
at both head sizes, within the reference's own 2e-4 / 1e-3
(``tests/test_kernels.py``); with logw down to −exp(3) its outputs stay
finite and agree.  ``wkv6.plan_segments`` and ``wkv6.plan_bwd_segments``
cut every sequence into whole chunks, and the backward's plan and scratch
keep their values; ``wkv6.backward_plan`` routes bf16 at N = 64 with B·H ≥
``BWD_WGMMA_HEADS`` to the wgmma kernel (one segment of 64-step chunks) and everything
else to the tf32 kernel, and ``meta._wkv_bwd_scratch`` counts what the
wrapper allocates on either route.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.wkv6 import wkv6 as jax_wkv6  # noqa: E402
from repro_torch.kernels import meta  # noqa: E402
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


CHUNKS = (wk.BWD_CHUNK, wk.CHUNK)   # the tf32 kernel's, the wgmma kernel's


def plan(chunk):
    """The planner of the kernel that runs chunks of ``chunk`` steps."""
    return wk.plan_segments if chunk == wk.CHUNK else wk.plan_bwd_segments


def chunked(xs, segments, chunk=wk.BWD_CHUNK):
    out, state = ref.wkv6_chunked_reference(*(torch.from_numpy(x) for x in xs),
                                            segments=segments, chunk=chunk)
    assert out.dtype == state.dtype == torch.float32
    return out.numpy(), state.numpy()


def assert_close(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("B,S,H,N,segments", [
    (2, 128, 4, 64, 1), (2, 128, 4, 64, 3), (1, 64, 2, 32, 2), (2, 96, 2, 32, 1),
])
def test_chunked_twin_matches_pallas_interpret(B, S, H, N, segments, chunk):
    xs = wkv_inputs(B, S, H, N, seed=S + N + segments)
    want = jax_wkv6(*(jnp.asarray(x) for x in xs), chunk=32, interpret=True)
    assert_close(chunked(xs, segments, chunk), want)


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("N", wk.HEAD_SIZES)
@pytest.mark.parametrize("S", [0, 1, 31, 33, 63, 65, 300])
def test_chunked_twin_matches_sequential_reference(S, N, chunk):
    """Any S: empty, one step, one short of a chunk of either length, one
    past it, and a 300-step sequence with a 12- or 44-step tail cut into
    the kernel's segments."""
    B, H = 2, 3
    xs = wkv_inputs(B, S, H, N, seed=10 * S + N)
    segments = plan(chunk)(B, H, S)[0]
    got = chunked(xs, segments, chunk)
    assert got[0].shape == (B, S, H, N) and got[1].shape == (B, H, N, N)
    assert_close(got, jref.wkv6_reference(*(jnp.asarray(x) for x in xs)))


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("N", wk.HEAD_SIZES)
def test_chunked_twin_survives_extreme_decays(N, chunk):
    """logw down to −exp(3) ≈ −20 a step (sums past −600 a chunk, far below
    fp32's exp range): no decay factor exceeds 1, so nothing overflows, and
    the result still agrees with the sequential reference."""
    B, S, H = 2, 100, 2
    xs = wkv_inputs(B, S, H, N, seed=N, logw_mean=1.5, logw_scale=1.0)
    assert xs[3].min() < -np.exp(3.0)
    got = chunked(xs, 3, chunk)
    assert all(np.isfinite(x).all() for x in got)
    assert_close(got, jref.wkv6_reference(*(jnp.asarray(x) for x in xs)))


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("segments", [1, 2, 5, 10])
def test_chunked_twin_is_independent_of_the_segment_cut(segments, chunk):
    """The chained segment states reproduce the one-segment run."""
    xs = wkv_inputs(2, 300, 2, 32, seed=3)
    base = chunked(xs, 1, chunk)
    assert_close(chunked(xs, segments, chunk), base)


def test_chunked_twin_takes_only_the_kernels_chunks():
    xs = wkv_inputs(1, 8, 1, 32, seed=0)
    with pytest.raises(ValueError, match="chunk 16"):
        chunked(xs, 1, 16)


@pytest.mark.parametrize("planner", ["forward", "backward"])
@pytest.mark.parametrize("B,H,S", [(4, 64, 4700), (4, 2, 256), (1, 1, 33), (3, 5, 0),
                                   (1, 1, 1), (65535, 1, 64), (1, 64, 512), (2, 3, 300)])
def test_plan_segments_cuts_whole_chunks(B, H, S, planner):
    """Both planners cut whole chunks.  The wgmma kernel's (a block an SM)
    keeps B·H·P within one wave of ``wk.SMS`` blocks and fills it where the
    chunks allow: one segment at rwkv6-7b's prefill (B·H = 256); the
    backward's (and the tf32 forward's) aims at ``TARGET_BLOCKS``."""
    fn, chunk = ((wk.plan_segments, wk.CHUNK) if planner == "forward"
                 else (wk.plan_bwd_segments, wk.BWD_CHUNK))
    P, Lc = fn(B, H, S)
    chunks = -(-S // chunk)
    if chunks == 0:
        assert (P, Lc) == (1, 0)
        return
    assert 1 <= P <= chunks and (P - 1) * Lc < chunks <= P * Lc
    if planner == "forward":
        assert B * H * P <= max(wk.SMS, B * H)
        assert B * H * P >= min(wk.SMS, B * H * chunks) // 2
        if B * H >= wk.SMS:
            assert P == 1
    else:
        # enough blocks to fill the card, or one segment a chunk
        assert B * H * P >= min(wk.TARGET_BLOCKS, B * H * chunks) // 2


@pytest.mark.parametrize("N,dtype,want", [
    (64, torch.bfloat16, (1, 74, 64)), (48, torch.bfloat16, (1, 74, 64)),
    (64, torch.float32, (8, 19, 32)), (32, torch.bfloat16, (8, 19, 32)),
    (16, torch.float32, (8, 19, 32))])
def test_forward_plan_follows_the_kernel_launched(N, dtype, want):
    """rwkv6-7b's prefill (B 4 × 4700, 64 heads): the wgmma kernel in bf16
    at N = 64 (and heads padded to 64), the tf32 kernel otherwise."""
    assert wk.forward_plan(4, 64, 4700, N, dtype) == want


@pytest.mark.parametrize("B,H,S,want", [
    (4, 64, 4700, (8, 19)), (4, 64, 2048, (8, 8)), (2, 2, 300, (10, 1)), (16, 128, 300, (1, 10)),
    (4, 128, 2048, (4, 16)), (8, 32, 256, (8, 1)), (1, 1, 0, (1, 0))])
def test_backward_plan_and_scratch_keep_their_values(B, H, S, want):
    """K4′'s segments (chunks of 32, ~2048 blocks) and its scratch keep
    their values, whatever the forward's plan: its gradients keep their bits."""
    assert wk.BWD_CHUNK == 32 and wk.TARGET_BLOCKS == 2048
    assert wk.plan_bwd_segments(B, H, S) == want
    P, N = want[0], 64
    r = torch.empty((B, S, H, N), device="meta")
    assert meta._wkv_bwd_scratch(r) == 4 * B * H * ((-(-S // 32) + 2 * (P - 1)) * N * N
                                                    + 2 * P * N)


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("logw_mean", [0.0, 2.0])
def test_float64_chunked_twin_is_the_sequential_recurrence(chunk, logw_mean):
    """In float64 (the want of ``chip_smoke.py`` phase 8's checks) the
    chunked form, its walks' decays from logw's running sums, is the
    sequential recurrence to ~1e-15 relative, also with logw down to −e³
    a step; phase 8 holds it to 1e-10 on the card."""
    xs = [torch.from_numpy(x).double()
          for x in wkv_inputs(2, 150, 3, 64, seed=7 + chunk, logw_mean=logw_mean)]
    o_c, s_c = ref.wkv6_chunked_reference(*xs, chunk=chunk, acc=torch.float64)
    o_s, s_s = wk.plain(*xs, acc=torch.float64)
    assert o_c.dtype == torch.float64 and torch.isfinite(o_c).all()
    assert float((o_c - o_s).abs().max() / o_s.abs().max()) <= 1e-13
    assert float((s_c - s_s).abs().max() / s_s.abs().max()) <= 2.0 ** -23


@pytest.mark.parametrize("B,H,S,N,dtype,want", [
    (4, 64, 2048, 64, torch.bfloat16, (1, 32, 64)),     # rwkv6-7b's training row
    (4, 64, 300, 64, torch.bfloat16, (1, 5, 64)),       # phase 19 (a)'s partial chunk
    (2, 66, 100, 48, torch.bfloat16, (1, 2, 64)),       # B·H = SMS, heads padded to 64
    (4, 64, 0, 64, torch.bfloat16, (1, 0, 64)),
    (1, 96, 2048, 64, torch.bfloat16, (1, 32, 64)),     # B·H at the cut
    (1, 95, 2048, 64, torch.bfloat16, (22, 3, 32)),     # B·H below it: the tf32 kernel
    (1, 64, 1024, 64, torch.bfloat16, (32, 1, 32)),     # rwkv6-7b at batch 1: the tf32 kernel
    (4, 128, 2048, 32, torch.bfloat16, (4, 16, 32)),    # N 32
    (4, 64, 2048, 64, torch.float32, (8, 8, 32)),       # fp32
    (8, 32, 256, 16, torch.float32, (8, 1, 32))])       # the ~100M config's heads of 16
def test_backward_plan_routes(B, H, S, N, dtype, want):
    """bf16 at N = 64 with B·H ≥ ``BWD_WGMMA_HEADS`` takes the wgmma kernel,
    one segment of 64-step chunks; every other call the tf32 kernel in
    ``plan_bwd_segments``' segments of 32-step chunks, as before."""
    assert wk.BWD_WGMMA_HEADS == 96 and wk.CHUNK == 64
    assert wk.backward_plan(B, H, S, N, dtype) == want
    if want[2] == wk.BWD_CHUNK:
        assert want[:2] == wk.plan_bwd_segments(B, H, S)


@pytest.mark.parametrize("B,H,S,N,dtype", [(4, 64, 300, 64, torch.bfloat16),
                                           (2, 66, 130, 48, torch.bfloat16),
                                           (1, 64, 100, 64, torch.bfloat16),
                                           (2, 4, 300, 32, torch.float32),
                                           (2, 4, 300, 16, torch.float32)])
def test_backward_scratch_is_what_the_wrapper_allocates(monkeypatch, B, H, S, N, dtype):
    """``meta._wkv_bwd_scratch`` against the scratch ``wk.wkv6_bwd``
    allocates (its torch.empty calls; the outputs are empty_like) on either
    route, the launch itself stubbed out: the dry-run counts what a call
    holds."""
    calls = []
    real_empty = torch.empty

    def empty(*shape, **kw):
        t = real_empty(*shape, **kw)
        calls.append(t.numel() * t.element_size())
        return t

    class Lib:
        def wkv6_bwd(self, *args):
            return 0

        def wkv6_bwd_wgmma(self, *args):
            return 0

    class Stream:
        cuda_stream = 0
    monkeypatch.setattr(wk, "_lib_bwd", lambda: Lib())
    monkeypatch.setattr(wk, "_check_call", lambda *args: None)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: Stream())
    monkeypatch.setattr(torch, "empty", empty)
    args = [real_empty(shape, dtype=dt) for shape, dt in (
        ((B, S, H, N), dtype), ((B, S, H, N), dtype), ((B, S, H, N), dtype),
        ((B, S, H, N), torch.float32), ((H, N), torch.float32), ((B, H, N, N), torch.float32),
        ((B, S, H, N), dtype), ((B, H, N, N), torch.float32))]
    wk.wkv6_bwd(*args)
    monkeypatch.undo()
    r = torch.empty((B, S, H, N), dtype=dtype, device="meta")
    assert sum(calls) == meta._wkv_bwd_scratch(r)
