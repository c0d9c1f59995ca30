"""The port's RWKV6 path against the JAX package on the same inputs.

K4's plain version is held to the Pallas kernel (interpret mode) and
``repro.kernels.ref.wkv6_reference`` at ``tests/test_kernels.py``'s shapes
and tolerance (atol 2e-4, rtol 1e-3), with bf16 r/k/v and with an S that is
no multiple of 32; the time-mix and channel-mix blocks, sequence and step
form, to ``repro.models.rwkv6`` on the same weights with ragged ``valid``;
and the RWKV6 ``DecoderLM`` to the JAX ``DecoderLM`` at
``reduced(rwkv6-7b, num_layers=4)`` within the reference's 1e-3 on logits.
The reference's sequence path (``wkv_chunked``) takes only S % 32 == 0, so
every model-level comparison uses such an S.  Inputs come from a numpy seed,
weights from the reference's ``init`` through ``convert.py``.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import ARCHS as REF_ARCHS  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.wkv6 import wkv6 as jax_wkv6  # noqa: E402
from repro.models import build_model as ref_build_model  # noqa: E402
from repro.models import reduced as ref_reduced  # noqa: E402
from repro.models import rwkv6 as jrwkv  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import wkv6 as wk  # noqa: E402
from repro_torch.models import build_model, reduced  # noqa: E402
from repro_torch.models import rwkv6  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402

ATOL, RTOL = 2e-4, 1e-3          # tests/test_kernels.py::test_wkv6_kernel
# bf16 outputs: both sides sum in fp32 and round once to bf16, so where both
# are right they may differ by one bf16 ulp (2^-7 relative) — the limit of
# the port's other bf16 kernel checks
BF16_RTOL = 2.0 ** -7
TOL = 1e-3
NAME = "rwkv6-7b"


def t(x):
    return torch.from_numpy(np.array(x, np.float32))


def wkv_inputs(B, S, H, N, seed):
    """The distributions of tests/test_kernels.py::test_wkv6_kernel."""
    rng = np.random.default_rng(seed)

    def normal(shape, scale=1.0):
        return (scale * rng.standard_normal(shape)).astype(np.float32)
    shape = (B, S, H, N)
    return (normal(shape, 0.5), normal(shape, 0.5), normal(shape),
            -np.exp(normal(shape, 0.5)), normal((H, N), 0.1), normal((B, H, N, N), 0.1))


@pytest.mark.parametrize("B,S,H,N,chunk", [
    (2, 128, 4, 64, 32), (1, 64, 2, 32, 16), (2, 96, 4, 64, 32),
])
def test_wkv6_plain_matches_pallas_and_ref(B, S, H, N, chunk):
    xs = wkv_inputs(B, S, H, N, seed=S + H)
    out, state = ops.wkv6(*(t(x) for x in xs))
    assert out.dtype == state.dtype == torch.float32
    assert out.shape == (B, S, H, N) and state.shape == (B, H, N, N)
    jx = [jnp.asarray(x) for x in xs]
    for want_out, want_state in (jax_wkv6(*jx, chunk=chunk, interpret=True),
                                 jref.wkv6_reference(*jx)):
        np.testing.assert_allclose(out.numpy(), want_out, atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(state.numpy(), want_state, atol=ATOL, rtol=RTOL)


def test_wkv6_plain_bf16_rkv():
    """bf16 r/k/v with fp32 logw, u and state, as the model sends them under
    bf16 serving: the output is bf16, the final state fp32."""
    B, S, H, N = 2, 64, 4, 64
    r, k, v, logw, u, s0 = wkv_inputs(B, S, H, N, seed=7)
    r, k, v = (x.astype(ml_dtypes.bfloat16) for x in (r, k, v))
    bf = [torch.from_numpy(x.view(np.int16)).view(torch.bfloat16) for x in (r, k, v)]
    out, state = ops.wkv6(*bf, t(logw), t(u), t(s0))
    assert out.dtype == torch.bfloat16 and state.dtype == torch.float32
    jx = [jnp.asarray(x) for x in (r, k, v, logw, u, s0)]
    for want_out, want_state in (jax_wkv6(*jx, chunk=32, interpret=True),
                                 jref.wkv6_reference(*jx)):
        assert want_out.dtype == jnp.bfloat16
        np.testing.assert_allclose(out.float().numpy(), np.asarray(want_out, np.float32),
                                   atol=ATOL, rtol=BF16_RTOL)
        np.testing.assert_allclose(state.numpy(), want_state, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("S", [37, 1])
def test_wkv6_plain_takes_any_length(S):
    """S no multiple of the Pallas kernel's chunk: against the sequential
    reference only (the Pallas kernel asserts S % chunk == 0)."""
    xs = wkv_inputs(2, S, 3, 16, seed=S)
    out, state = ops.wkv6(*(t(x) for x in xs))
    want_out, want_state = jref.wkv6_reference(*(jnp.asarray(x) for x in xs))
    np.testing.assert_allclose(out.numpy(), want_out, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(state.numpy(), want_state, atol=ATOL, rtol=RTOL)


def test_wkv6_wrapper_takes_only_card_tensors():
    xs = [t(x) for x in wkv_inputs(1, 4, 2, 64, seed=0)]
    with pytest.raises(ValueError, match="card"):
        wk.wkv6(*xs)
    with pytest.raises(ValueError, match="head size"):   # above 64; smaller heads run padded
        wk.wkv6(*(t(x) for x in wkv_inputs(1, 4, 2, 96, seed=0)))
    with pytest.raises(ValueError, match="shapes"):
        wk.wkv6(*xs[:4], xs[4][:1], xs[5])


# ---------------------------------------------------------------- the blocks
D, D_FF, HD = 64, 96, 16


def block_pair(seed=0):
    """(JAX params, port params) of one RWKV6 layer's tm_cm, fp32."""
    jp = jrwkv.rwkv_init(jax.random.key(seed), D, D_FF, HD, jnp.float32)
    assert {k: v.shape for k, v in jp.items()} == rwkv6.rwkv_shapes(D, D_FF, HD)
    return jp, {k: t(v) for k, v in jp.items()}


def block_state(B, seed):
    rng = np.random.default_rng(seed)
    shift = rng.standard_normal((B, D)).astype(np.float32)
    wkv = (0.1 * rng.standard_normal((B, D // HD, HD, HD))).astype(np.float32)
    cm = rng.standard_normal((B, D)).astype(np.float32)
    return ({"tm": {"shift": jnp.asarray(shift), "wkv": jnp.asarray(wkv)},
             "cm": jnp.asarray(cm)},
            {"tm": {"shift": t(shift), "wkv": t(wkv)}, "cm": t(cm)})


def assert_close(port, ref, tol=TOL):
    np.testing.assert_allclose(port.detach().float().numpy(), np.asarray(ref, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("lengths", [None, (32, 19, 1)])
def test_block_seq_matches_reference(lengths):
    jp, p = block_pair()
    B, S = 3, 32
    x = np.random.default_rng(1).standard_normal((B, S, D)).astype(np.float32)
    js, ts = block_state(B, seed=2)
    valid = (None if lengths is None else
             np.arange(S)[None, :] < np.asarray(lengths)[:, None])
    jv = None if valid is None else jnp.asarray(valid)
    tv = None if valid is None else torch.from_numpy(valid)
    want, want_tm = jrwkv.time_mix_seq(jp, jnp.asarray(x), HD, js["tm"], valid=jv)
    got, got_tm = rwkv6.time_mix_seq(p, t(x), HD, ts["tm"], tv)
    assert_close(got, want)
    assert_close(got_tm["shift"], want_tm["shift"])
    assert_close(got_tm["wkv"], want_tm["wkv"])
    want, want_cm = jrwkv.channel_mix_seq(jp, jnp.asarray(x), js["cm"], valid=jv)
    got, got_cm = rwkv6.channel_mix_seq(p, t(x), ts["cm"], tv)
    assert_close(got, want)
    assert_close(got_cm, want_cm)


def test_block_step_matches_reference():
    jp, p = block_pair(seed=3)
    x = np.random.default_rng(4).standard_normal((3, D)).astype(np.float32)
    js, ts = block_state(3, seed=5)
    for _ in range(3):
        want, js["tm"] = jrwkv.time_mix_step(jp, jnp.asarray(x), HD, js["tm"])
        got, ts["tm"] = rwkv6.time_mix_step(p, t(x), HD, ts["tm"])
        assert_close(got, want)
        assert_close(ts["tm"]["wkv"], js["tm"]["wkv"])
        want_c, js["cm"] = jrwkv.channel_mix_step(jp, jnp.asarray(x), js["cm"])
        got_c, ts["cm"] = rwkv6.channel_mix_step(p, t(x), ts["cm"])
        assert_close(got_c, want_c)
        assert_close(ts["cm"], js["cm"])
        x = np.asarray(want) + np.asarray(want_c)


# ---------------------------------------------------------------- the model
def pair(**overrides):
    """(reference model, reference params, port model, port params, numpy
    tree) at reduced(rwkv6-7b, num_layers=4)."""
    ref_cfg = ref_reduced(REF_ARCHS[NAME], num_layers=4, **overrides)
    cfg = reduced(get_config(NAME), num_layers=4, **overrides)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
    ref_model = ref_build_model(ref_cfg)
    ref_params = ref_model.init(jax.random.key(0))
    model = build_model(cfg, "cpu")
    tree = jax.tree.map(np.asarray, ref_params)
    return ref_model, ref_params, model, params_from_reference(tree, model), tree


def tokens_for(cfg, B=2, S=64, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=(B, S)).astype(np.int32)


def test_rwkv6_layout_is_the_reference_layout():
    _, _, model, params, _ = pair()
    assert model.homogeneous
    assert set(params) == {"embed", "final_norm", "layers"}
    assert set(params["layers"]) == {"ln1", "ln2", "tm_cm"}     # no ffn
    assert params["layers"]["tm_cm"]["w_r"].shape == (4, 64, 64)
    assert params["layers"]["tm_cm"]["bonus_u"].shape == (4, 4, 16)
    cache = model.init_cache(3, 40)
    assert cache["layers"]["tm"]["shift"].shape == (4, 3, 64)
    assert cache["layers"]["tm"]["wkv"].shape == (4, 3, 4, 16, 16)
    assert cache["layers"]["tm"]["wkv"].dtype == torch.float32
    assert cache["layers"]["cm"].shape == (4, 3, 64)
    own = model.init(torch.Generator().manual_seed(0))
    assert {k: v.shape for k, v in own["layers"]["tm_cm"].items()} == \
        {k: v.shape for k, v in params["layers"]["tm_cm"].items()}


def test_rwkv6_7b_needs_a_card_unless_cpu_is_asked(monkeypatch):
    """The full-width config builds (no weights are made) on the card by
    default, refuses without one, and builds on the CPU when asked."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config(NAME)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(cfg)
    model = build_model(cfg, "cpu")
    assert model.device.type == "cpu" and model.homogeneous
    shapes = model.param_shapes()["layers"]
    assert shapes["tm_cm"]["w_ck"] == (32, 4096, 14336)
    assert shapes["tm_cm"]["bonus_u"] == (32, 64, 64) and "ffn" not in shapes


def test_rwkv6_forward_matches_reference():
    ref_model, ref_params, model, params, _ = pair()
    toks = tokens_for(model.cfg)
    want, _ = ref_model.forward(ref_params, jnp.asarray(toks))
    got, _ = model.forward(params, torch.from_numpy(toks))
    assert_close(got, want)


def test_rwkv6_prefill_and_decode_match_reference():
    ref_model, ref_params, model, params, _ = pair()
    toks = tokens_for(model.cfg, seed=1)
    B, S = toks.shape
    lengths = np.array([63, 37], np.int32)
    ref_cache, want = ref_model.prefill(ref_params, ref_model.init_cache(B, S + 8),
                                        jnp.asarray(toks), jnp.asarray(lengths))
    cache, got = model.prefill(params, model.init_cache(B, S + 8),
                               torch.from_numpy(toks), torch.from_numpy(lengths))
    assert_close(got, want)

    def same_cache():
        np.testing.assert_array_equal(cache["lengths"].numpy(),
                                      np.asarray(ref_cache["lengths"]))
        assert_close(cache["layers"]["tm"]["wkv"], ref_cache["layers"]["tm"]["wkv"])
        assert_close(cache["layers"]["tm"]["shift"], ref_cache["layers"]["tm"]["shift"])
        assert_close(cache["layers"]["cm"], ref_cache["layers"]["cm"])

    same_cache()
    nxt = np.array(jnp.argmax(want, -1), np.int32)
    for _ in range(3):
        ref_cache, want = ref_model.decode_step(ref_params, ref_cache, jnp.asarray(nxt))
        cache, got = model.decode_step(params, cache, torch.from_numpy(nxt))
        assert_close(got, want)
        ref_next = np.array(jnp.argmax(want, -1), np.int32)
        np.testing.assert_array_equal(np.array(torch.argmax(got, -1), np.int32), ref_next)
        nxt = ref_next
    same_cache()


def test_rwkv6_prefill_decode_matches_forward():
    """The serving invariant in the port alone: prefill + decode ≡ forward,
    for a row padded past its length."""
    _, _, model, params, _ = pair()
    toks = torch.from_numpy(tokens_for(model.cfg, seed=2))
    B, S = toks.shape
    lengths = torch.tensor([S - 1, S - 20], dtype=torch.int32)
    full, _ = model.forward(params, toks)
    cache, pre = model.prefill(params, model.init_cache(B, S + 8), toks, lengths)
    b = torch.arange(B)
    assert float((pre - full[b, lengths.long() - 1]).abs().max()) < TOL
    cache, dec = model.decode_step(params, cache, toks[b, lengths.long()])
    assert float((dec - full[b, lengths.long()]).abs().max()) < TOL


def test_bf16_conversion_keeps_decay_leaves_fp32():
    bf16 = dict(dtype="bfloat16", param_dtype="bfloat16", serve_param_dtype="bfloat16")
    _, _, model, params, _ = pair(**bf16)
    for name, leaf in params["layers"]["tm_cm"].items():
        want = torch.float32 if name in ("decay_w0", "bonus_u") else torch.bfloat16
        assert leaf.dtype == want, name
    p = model._layer(params, 3)["tm_cm"]
    assert p["bonus_u"].dtype == p["decay_w0"].dtype == torch.float32
    assert p["w_r"].dtype == torch.bfloat16
    own = model.init(torch.Generator().manual_seed(0))["layers"]["tm_cm"]
    assert own["bonus_u"].dtype == own["decay_w0"].dtype == torch.float32
    assert own["mu_r"].dtype == torch.bfloat16
    # the bf16 model runs: bf16 r/k/v into K4's plain version, fp32 state
    toks = torch.from_numpy(tokens_for(model.cfg, B=2, S=8))
    cache, logits = model.prefill(params, model.init_cache(2, 12), toks,
                                  torch.tensor([8, 3], dtype=torch.int32))
    assert bool(torch.isfinite(logits).all())
    assert cache["layers"]["tm"]["wkv"].dtype == torch.float32
    assert cache["layers"]["tm"]["shift"].dtype == torch.bfloat16


def test_convert_rejects_an_ffn_on_rwkv6_layers():
    _, _, model, _, tree = pair()
    tree["layers"]["ffn"] = {"wi": np.zeros((4, 64, 128), np.float32)}
    with pytest.raises(ValueError, match="layers"):
        params_from_reference(tree, model)
