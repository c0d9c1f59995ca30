"""The port's int8 matmul and quantization, and K3 with bf16 inputs, against
the JAX package on the same inputs.

K5's plain version (``ops.int8_matmul`` on the CPU, the exact integer
product with the kernel's fp32 epilogue) must equal the Pallas
``int8_matmul`` in interpret mode bit for bit, and lie within
``2e-5·max(1, max|want|)`` of the dequantizing ``int8_matmul_reference``
(the calibration's int8 tolerance, scaled as it scales it).
``quantize_rowwise`` must equal the JAX one bit for bit.  K3's plain version
with bf16 a/b must match the Pallas kernel in interpret mode at 2e-2, the
tolerance of ``tests/test_kernels.py``, with the states in bf16.  Inputs come
from a numpy seed.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.int8_matmul import int8_matmul as jax_int8_matmul  # noqa: E402
from repro.kernels.rglru_scan import rglru_scan as jax_rglru_scan  # noqa: E402
from repro_torch.kernels import int8_matmul as i8  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

INT8_TOL = 2e-5


def normals(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def quantized(M, K, N, seed):
    """(x_q, w_q, sx, sw) as numpy arrays, quantized by the port."""
    x, w = normals(seed, (M, K), (K, N))
    x_q, sx = ops.quantize_rowwise(torch.from_numpy(x))
    w_q_t, sw = ops.quantize_rowwise(torch.from_numpy(w).T)
    return x_q.numpy(), w_q_t.T.contiguous().numpy(), sx.numpy(), sw.numpy()


@pytest.mark.parametrize("M,K,N", [(64, 512, 128), (128, 1024, 256)])
def test_int8_plain_is_the_pallas_kernel_bit_for_bit(M, K, N):
    x_q, w_q, sx, sw = quantized(M, K, N, seed=M + K + N)
    got = ops.int8_matmul(*(torch.from_numpy(a) for a in (x_q, w_q, sx, sw)))
    assert got.dtype == torch.float32 and got.shape == (M, N)
    jx = [jnp.asarray(a) for a in (x_q, w_q, sx, sw)]
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_int8_matmul(*jx, interpret=True)))
    want = np.asarray(jref.int8_matmul_reference(*jx))
    assert np.abs(got.numpy() - want).max() <= INT8_TOL * max(1.0, np.abs(want).max())


def test_int8_exact_is_the_integer_product_then_the_epilogue():
    """An independent count in numpy: int64 sums, one rounding to fp32, two
    fp32 products — at a K where the sums pass 2^24 and fp32 sums would not
    be exact."""
    rng = np.random.default_rng(3)
    M, K, N = 5, 4096, 7
    x_q = rng.integers(-128, 128, (M, K)).astype(np.int8)
    w_q = rng.integers(-128, 128, (K, N)).astype(np.int8)
    sx, sw = (rng.uniform(0.001, 0.1, n).astype(np.float32) for n in (M, N))
    acc = (x_q.astype(np.int64) @ w_q.astype(np.int64)).astype(np.float32)
    want = (acc * sx[:, None]) * sw[None, :]
    got = ref.int8_matmul_exact(*(torch.from_numpy(a) for a in (x_q, w_q, sx, sw)))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape", [(6, 33), (2, 3, 512)])
def test_quantize_rowwise_is_the_reference_bit_for_bit(shape):
    (x,) = normals(7, shape)
    x[..., 1, :] = 0.0                       # an all-zero row: scale 1
    q, s = ops.quantize_rowwise(torch.from_numpy(x))
    jq, js = jref.quantize_rowwise(jnp.asarray(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert np.all(s.numpy()[..., 1] == 1.0) and np.all(q.numpy()[..., 1, :] == 0)


def test_int8_wrapper_takes_only_card_tensors():
    x_q, w_q, sx, sw = (torch.from_numpy(a) for a in quantized(8, 64, 16, seed=0))
    with pytest.raises(ValueError, match="card"):
        i8.int8_matmul(x_q, w_q, sx, sw)
    with pytest.raises(ValueError, match="multiple of 4"):
        i8.int8_matmul(x_q[:, :62], w_q[:62], sx, sw)
    with pytest.raises(ValueError, match="shapes"):
        i8.int8_matmul(x_q, w_q, sx[:4], sw)


@pytest.mark.parametrize("B,S,R,chunk,block_r", [(2, 128, 256, 64, 256),
                                                 (1, 64, 512, 64, 128)])
def test_rglru_plain_bf16_matches_pallas(B, S, R, chunk, block_r):
    rng = np.random.default_rng(S + R)
    a = rng.uniform(0.2, 0.9, (B, S, R)).astype(np.float32)
    b = rng.standard_normal((B, S, R)).astype(np.float32)
    s0 = rng.standard_normal((B, R)).astype(np.float32)
    ta, tb = (torch.from_numpy(x).to(torch.bfloat16) for x in (a, b))
    seq, last = ops.rglru_scan(ta, tb, torch.from_numpy(s0))
    assert seq.dtype == torch.bfloat16 and last.dtype == torch.float32
    ja, jb = (jnp.asarray(x, dtype=jnp.bfloat16) for x in (a, b))
    want_seq, want_last = jax_rglru_scan(ja, jb, jnp.asarray(s0), chunk=chunk,
                                         block_r=block_r, interpret=True)
    assert want_seq.dtype == jnp.bfloat16
    np.testing.assert_allclose(seq.float().numpy(), np.asarray(want_seq, np.float32),
                               atol=2e-2, rtol=2e-2)
    np.testing.assert_allclose(last.numpy(), np.asarray(want_last), atol=2e-2, rtol=2e-2)
    # and the fp32 reference twin on the same bf16 values
    ref_seq, ref_last = jref.rglru_reference(ja, jb, jnp.asarray(s0))
    np.testing.assert_allclose(seq.float().numpy(), np.asarray(ref_seq), atol=2e-2, rtol=2e-2)
    np.testing.assert_allclose(last.numpy(), np.asarray(ref_last), atol=2e-2, rtol=2e-2)
