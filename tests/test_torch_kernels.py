"""The port's attention kernels against the JAX kernels and references.

On the CPU the port's ``ops`` run each kernel's plain PyTorch version; they
are held to the Pallas kernels (interpret mode) and ``repro.kernels.ref`` on
a subset of the ``tests/test_kernels.py`` grid, with its tolerances: 2e-5
for fp32, 2e-2 for bf16.  The decode version also takes softcap, window and
slot positions, which the JAX decode kernel lacks; those are held to
``repro.models.layers.attend``, the reference model's decode attention.
``tests/test_torch_cuda.py`` holds the CUDA kernels to these plain versions
on a card.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402,F401  (JAX stays on the CPU: JAX_PLATFORMS=cpu)
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.decode_attention import decode_attention as jax_decode  # noqa: E402
from repro.kernels.flash_attention import flash_attention as jax_flash  # noqa: E402
from repro.models.layers import attend as jax_attend  # noqa: E402
from repro_torch.kernels import decode_attention as da  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def arrays(seed, dtype, *shapes):
    """numpy arrays from a seed, already rounded to ``dtype`` so both
    frameworks see the same values; returned as (jax arrays, torch tensors)."""
    rng = np.random.default_rng(seed)
    js, ts = [], []
    for shape in shapes:
        x = jnp.asarray(rng.standard_normal(shape, dtype=np.float32)).astype(dtype)
        js.append(x)
        ts.append(torch.from_numpy(np.array(x, np.float32)).to(TORCH_DT[dtype]))
    return js, ts


def assert_close(port, want, dtype):
    np.testing.assert_allclose(port.float().numpy(), np.asarray(want, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype] * 10)


@pytest.mark.parametrize("B,H,K,S,d", [(1, 4, 4, 128, 64), (2, 4, 1, 128, 256)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("opts", [
    dict(causal=True), dict(causal=True, window=64),
    dict(causal=True, softcap=30.0), dict(causal=False),
])
def test_flash_plain_matches_pallas_and_ref(B, H, K, S, d, dtype, opts):
    (q, k, v), (tq, tk, tv) = arrays(0, dtype, (B, H, S, d), (B, K, S, d),
                                     (B, K, S, d))
    got = ops.flash_attention(tq, tk, tv, **opts)
    assert got.dtype == TORCH_DT[dtype] and got.shape == (B, H, S, d)
    assert_close(got, jax_flash(q, k, v, interpret=True, **opts), dtype)
    assert_close(got, jref.mha_reference(q, k, v, **opts), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_lengths_window_softcap_match_ref(dtype):
    """Ragged lengths, a window and softcap together (the gemma2 prefill
    case), on an S not divisible by any tile; valid query rows compared."""
    B, H, K, S, d = 3, 4, 2, 100, 64
    (q, k, v), (tq, tk, tv) = arrays(1, dtype, (B, H, S, d), (B, K, S, d),
                                     (B, K, S, d))
    lengths = np.array([100, 57, 9], np.int32)
    opts = dict(causal=True, window=16, softcap=50.0)
    got = ops.flash_attention(tq, tk, tv, lengths=torch.from_numpy(lengths), **opts)
    want = jref.mha_reference(q, k, v, lengths=jnp.asarray(lengths), **opts)
    for b, n in enumerate(lengths):
        assert_close(got[b, :, :n], want[b, :, :n], dtype)


@pytest.mark.parametrize("B,H,K,T,d", [(2, 8, 2, 1024, 64), (1, 4, 4, 512, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_plain_matches_pallas_and_ref(B, H, K, T, d, dtype):
    (q, k, v), (tq, tk, tv) = arrays(2, dtype, (B, H, d), (B, K, T, d),
                                     (B, K, T, d))
    lengths = np.random.default_rng(0).integers(1, T + 1, size=B).astype(np.int32)
    got = ops.decode_attention(tq, tk, tv, torch.from_numpy(lengths))
    jl = jnp.asarray(lengths)
    assert_close(got, jax_decode(q, k, v, jl, interpret=True), dtype)
    assert_close(got, jref.decode_attention_reference(q, k, v, jl), dtype)


def ring_slots(T, q_pos, seed):
    """slot_pos of a cache in ring layout: slot t holds the latest position
    ≡ t (mod T) up to q_pos, with a few empty (padded) slots."""
    rng = np.random.default_rng(seed)
    t = np.arange(T)[None, :]
    qp = q_pos[:, None]
    pos = qp - ((qp - t) % T)
    pos = np.where(pos >= 0, pos, -1)
    pos[rng.random(pos.shape) < 0.1] = -1
    return pos.astype(np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window,softcap", [(0, 0.0), (0, 50.0), (24, 50.0),
                                            (200, 30.0)])
def test_decode_plain_matches_attend(dtype, window, softcap):
    """Softcap, window and slot positions as the model decodes: held to the
    reference's ``attend`` on the cache layout (B, T, K, d), with q_pos past
    T for one sequence so its ring has wrapped."""
    B, H, K, T, d = 3, 8, 4, 96, 64
    (q, k, v), (tq, tk, tv) = arrays(3, dtype, (B, 1, H, d), (B, T, K, d),
                                     (B, T, K, d))
    q_pos = np.array([40, 95, 130], np.int32)
    slot_pos = ring_slots(T, q_pos, seed=4)
    w = window if window else 1 << 30       # the reference's GLOBAL_WINDOW
    want = jax_attend(q, k, v, jnp.asarray(q_pos)[:, None], jnp.asarray(slot_pos),
                      causal=True, window=w, softcap=softcap,
                      k_valid=jnp.asarray(slot_pos >= 0))
    got = ops.decode_attention(
        tq[:, 0], tk.transpose(1, 2), tv.transpose(1, 2),
        torch.full((B,), T, dtype=torch.int32), softcap=softcap, window=window,
        q_pos=torch.from_numpy(q_pos), slot_pos=torch.from_numpy(slot_pos))
    assert_close(got, want[:, 0], dtype)


def test_decode_mask_without_slots_is_the_lengths_mask():
    """Without slot_pos (and window 0) the decode mask reduces to the JAX
    kernel's ``t < lengths`` mask; with a window it keeps the last keys."""
    from repro_torch.kernels.ref import decode_mask
    lengths = torch.tensor([5, 1, 8], dtype=torch.int32)
    t = torch.arange(8)[None, :]
    assert torch.equal(decode_mask(lengths, 8), t < lengths[:, None])
    m = decode_mask(lengths, 8, window=3)
    assert torch.equal(m, (t < lengths[:, None]) & (t > lengths[:, None] - 4))


def test_cpu_tensors_take_the_plain_version():
    """On CPU tensors ops never reaches a kernel: the launch counts stay."""
    before = (fa.launches, da.launches)
    _, (tq, tk, tv) = arrays(5, "float32", (1, 2, 8, 64), (1, 1, 8, 64),
                             (1, 1, 8, 64))
    ops.flash_attention(tq, tk, tv)
    ops.decode_attention(tq[:, :, 0], tk, tv, torch.tensor([8], dtype=torch.int32))
    assert (fa.launches, da.launches) == before
