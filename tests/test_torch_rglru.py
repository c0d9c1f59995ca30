"""The port's RG-LRU path against the JAX package on the same inputs.

K3's plain version is held to the Pallas kernel (interpret mode) and
``repro.kernels.ref.rglru_reference`` at ``tests/test_kernels.py``'s shapes
and tolerance (1e-5); the RG-LRU block, sequence and step form, to
``repro.models.rglru`` on the same weights; and the hybrid ``DecoderLM`` to
the JAX ``DecoderLM`` at ``reduced(recurrentgemma-9b, num_layers=8)`` — two
(rec, rec, local-attn) periods and a two-layer recurrent tail, like the real
12 + 2, with window 16 < S = 64 so the ring gather runs — within the
reference's 1e-3 on logits.  Inputs come from a numpy seed, weights from the
reference's ``init`` through ``convert.py``.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import ARCHS as REF_ARCHS  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.rglru_scan import rglru_scan as jax_rglru_scan  # noqa: E402
from repro.models import build_model as ref_build_model  # noqa: E402
from repro.models import reduced as ref_reduced  # noqa: E402
from repro.models import rglru as jrglru  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import rglru_scan as rg  # noqa: E402
from repro_torch.models import DecoderLM, EncDecLM, build_model, reduced  # noqa: E402
from repro_torch.models import rglru  # noqa: E402
from repro_torch.models.config import ATTN_LOCAL, RGLRU, RWKV6  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402

SCAN_TOL = 1e-5
TOL = 1e-3
NAME = "recurrentgemma-9b"


def t(x):
    return torch.from_numpy(np.array(x, np.float32))


def scan_inputs(B, S, R, seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.8, 0.999, (B, S, R)).astype(np.float32)
    b = (0.1 * rng.standard_normal((B, S, R))).astype(np.float32)
    s0 = rng.standard_normal((B, R)).astype(np.float32)
    return a, b, s0


@pytest.mark.parametrize("B,S,R,chunk,block_r", [
    (2, 256, 512, 128, 512), (1, 128, 256, 64, 128), (3, 64, 1024, 64, 256),
    (2, 100, 200, 100, 200),          # S and R not multiples of 128
])
def test_rglru_plain_matches_pallas_and_ref(B, S, R, chunk, block_r):
    a, b, s0 = scan_inputs(B, S, R, seed=S + R)
    seq, last = ops.rglru_scan(t(a), t(b), t(s0))
    assert seq.dtype == last.dtype == torch.float32
    assert seq.shape == (B, S, R) and last.shape == (B, R)
    for want_seq, want_last in (
            jax_rglru_scan(jnp.asarray(a), jnp.asarray(b), jnp.asarray(s0),
                           chunk=chunk, block_r=block_r, interpret=True),
            jref.rglru_reference(jnp.asarray(a), jnp.asarray(b), jnp.asarray(s0))):
        np.testing.assert_allclose(seq.numpy(), want_seq, atol=SCAN_TOL, rtol=SCAN_TOL)
        np.testing.assert_allclose(last.numpy(), want_last, atol=SCAN_TOL, rtol=SCAN_TOL)


def test_rglru_wrapper_takes_only_card_tensors():
    a, b, s0 = (t(x) for x in scan_inputs(1, 4, 8, seed=0))
    with pytest.raises(ValueError, match="card"):
        rg.rglru_scan(a, b, s0)
    with pytest.raises(ValueError, match="shapes"):
        rg.rglru_scan(a, b, s0[:, :4])


# ---------------------------------------------------------------- the block
D, R = 32, 48


def block_pair(seed=0):
    """(JAX params, port params) of one RG-LRU block, fp32."""
    jp = jrglru.rglru_init(jax.random.key(seed), D, R, jnp.float32)
    return jp, {k: t(v) for k, v in jp.items()}


def block_state(B, seed):
    rng = np.random.default_rng(seed)
    s = rng.standard_normal((B, R)).astype(np.float32)
    conv = rng.standard_normal((B, rglru.CONV_WIDTH - 1, R)).astype(np.float32)
    return ({"s": jnp.asarray(s), "conv": jnp.asarray(conv)},
            {"s": t(s), "conv": t(conv)})


def assert_close(port, ref, tol=TOL):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("lengths", [None, (40, 23, 1)])
def test_block_seq_matches_reference(lengths):
    jp, p = block_pair()
    B, S = 3, 40
    x = np.random.default_rng(1).standard_normal((B, S, D)).astype(np.float32)
    js, ts = block_state(B, seed=2)
    valid = (None if lengths is None else
             np.arange(S)[None, :] < np.asarray(lengths)[:, None])
    want, want_state = jrglru.rglru_block_seq(
        jp, jnp.asarray(x), js, valid=None if valid is None else jnp.asarray(valid))
    got, got_state = rglru.rglru_block_seq(
        p, t(x), ts, valid=None if valid is None else torch.from_numpy(valid))
    assert_close(got, want)
    for name in ("s", "conv"):
        assert_close(got_state[name], want_state[name])


def test_block_step_matches_reference():
    jp, p = block_pair(seed=3)
    x = np.random.default_rng(4).standard_normal((3, D)).astype(np.float32)
    js, ts = block_state(3, seed=5)
    for _ in range(3):
        want, js = jrglru.rglru_block_step(jp, jnp.asarray(x), js)
        got, ts = rglru.rglru_block_step(p, t(x), ts)
        assert_close(got, want)
        for name in ("s", "conv"):
            assert_close(ts[name], js[name])
        x = np.asarray(want)


# ---------------------------------------------------------------- the model
def pair(**overrides):
    """(reference model, reference params, port model, port params) at
    reduced(recurrentgemma-9b, num_layers=8)."""
    ref_cfg = ref_reduced(REF_ARCHS[NAME], num_layers=8, **overrides)
    cfg = reduced(get_config(NAME), num_layers=8, **overrides)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
    ref_model = ref_build_model(ref_cfg)
    ref_params = ref_model.init(jax.random.key(0))
    model = build_model(cfg, "cpu")
    tree = jax.tree.map(np.asarray, ref_params)
    return ref_model, ref_params, model, params_from_reference(tree, model), tree


def tokens_for(cfg, B=2, S=64, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=(B, S)).astype(np.int32)


def test_hybrid_layout_is_the_reference_layout():
    _, _, model, params, _ = pair()
    assert not model.homogeneous
    assert (model.n_periods, model.tail_kinds) == (2, (RGLRU, RGLRU))
    assert set(params) == {"embed", "final_norm", "periods", "tail"}
    assert sorted(params["periods"]) == ["l0", "l1", "l2"]
    assert sorted(params["tail"]) == ["t0", "t1"]
    assert params["periods"]["l0"]["rec"]["w_a"].shape == (2, 64, 64)
    assert params["periods"]["l2"]["attn"]["wq"].shape == (2, 64, 4, 16)


def test_hybrid_forward_matches_reference():
    ref_model, ref_params, model, params, _ = pair()
    toks = tokens_for(model.cfg)
    want, _ = ref_model.forward(ref_params, jnp.asarray(toks))
    got, _ = model.forward(params, torch.from_numpy(toks))
    assert_close(got, want)


def test_hybrid_prefill_and_decode_match_reference():
    ref_model, ref_params, model, params, _ = pair()
    toks = tokens_for(model.cfg, seed=1)
    B, S = toks.shape
    lengths = np.array([63, 37], np.int32)
    ref_cache, want = ref_model.prefill(ref_params, ref_model.init_cache(B, S + 8),
                                        jnp.asarray(toks), jnp.asarray(lengths))
    cache = model.init_cache(B, S + 8)
    assert cache["periods"]["l2"]["k"].shape == (2, B, 16, 1, 16)   # the ring
    cache, got = model.prefill(params, cache, torch.from_numpy(toks),
                               torch.from_numpy(lengths))
    assert_close(got, want)

    def same_cache():
        np.testing.assert_array_equal(cache["lengths"].numpy(),
                                      np.asarray(ref_cache["lengths"]))
        np.testing.assert_array_equal(cache["periods"]["l2"]["slot_pos"].numpy(),
                                      np.asarray(ref_cache["periods"]["l2"]["slot_pos"]))
        for where in (cache["periods"]["l0"], cache["tail"]["t1"]):
            assert where["s"].dtype == torch.float32
        assert_close(cache["tail"]["t1"]["s"], ref_cache["tail"]["t1"]["s"])
        assert_close(cache["periods"]["l1"]["conv"], ref_cache["periods"]["l1"]["conv"])

    same_cache()
    nxt = np.array(jnp.argmax(want, -1), np.int32)
    for _ in range(3):
        ref_cache, want = ref_model.decode_step(ref_params, ref_cache, jnp.asarray(nxt))
        cache, got = model.decode_step(params, cache, torch.from_numpy(nxt))
        assert_close(got, want)
        nxt = np.array(jnp.argmax(want, -1), np.int32)
    same_cache()


def test_hybrid_prefill_decode_matches_forward():
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


def test_bf16_conversion_keeps_lam_fp32():
    bf16 = dict(dtype="bfloat16", param_dtype="bfloat16", serve_param_dtype="bfloat16")
    _, _, model, params, _ = pair(**bf16)
    leaves = {}

    def walk(node, path):
        for k, v in node.items():
            walk(v, path + (k,)) if isinstance(v, dict) else leaves.update({path + (k,): v})
    walk(params, ())
    for path, leaf in leaves.items():
        want = torch.float32 if path[-1] == "lam" else torch.bfloat16
        assert leaf.dtype == want, path
    assert sum(path[-1] == "lam" for path in leaves) == 4   # l0, l1, t0, t1
    # and the per-layer cast at bf16 activations keeps it
    for i in (0, 7):
        p = model._layer(params, i)
        assert p["rec"]["lam"].dtype == torch.float32
        assert p["rec"]["w_a"].dtype == torch.bfloat16
    # the port's own random init keeps it too
    own = model.init(torch.Generator().manual_seed(0))
    assert own["periods"]["l0"]["rec"]["lam"].dtype == torch.float32
    assert own["tail"]["t0"]["rec"]["conv"].dtype == torch.bfloat16


def test_convert_rejects_wrong_periods_layout():
    _, _, model, _, tree = pair()
    tree["periods"]["l3"] = tree["periods"].pop("l2")
    with pytest.raises(ValueError, match="periods"):
        params_from_reference(tree, model)


@pytest.mark.parametrize("overrides,item", [
    (dict(layer_pattern=(RWKV6,)), "M8"),
    (dict(num_experts=4, experts_per_token=2), "M9"),
    (dict(encoder_layers=2), "M10"),
])
def test_other_families_name_their_roadmap_item(overrides, item):
    cfg = dataclasses.replace(reduced(get_config("gemma2-2b")), **overrides)
    if item == "M8":
        # ROADMAP M8 (RWKV6) is ported: a pure RWKV6 stack builds, in the
        # reference's homogeneous layout
        shapes = DecoderLM(cfg, "cpu").param_shapes()
        assert "tm_cm" in shapes["layers"] and "ffn" not in shapes["layers"]
        return
    if item == "M9":
        # ROADMAP M9 (MoE) is ported: every layer's FFN is the experts' block,
        # router (D, E) and wi/wg (E, D, F), wo (E, F, D)
        ffn = DecoderLM(cfg, "cpu").param_shapes()["layers"]["ffn"]
        L, D, F = cfg.num_layers, cfg.d_model, cfg.d_ff
        assert ffn == {"router": (L, D, 4), "wi": (L, 4, D, F), "wg": (L, 4, D, F),
                       "wo": (L, 4, F, D)}
        return
    # ROADMAP M10 (encoder-decoder) is ported: such a config is EncDecLM's,
    # whose decoder layers carry cross-attention and whose cache the cross
    # k/v over the encoder's frames; DecoderLM refuses it
    with pytest.raises(ValueError, match="EncDecLM"):
        DecoderLM(cfg, "cpu")
    model = build_model(cfg, "cpu")
    assert isinstance(model, EncDecLM)
    shapes = model.param_shapes()
    L, D, H, K, hd = cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    assert set(shapes["dec_layers"]) == {"ln1", "attn", "lnx", "xattn", "ln2", "ffn"}
    assert set(shapes["enc_layers"]) == {"ln1", "attn", "ln2", "ffn"}
    assert shapes["enc_layers"]["attn"]["wq"] == (2, D, H, hd)
    assert shapes["dec_layers"]["xattn"] == {"wq": (L, D, H, hd), "wk": (L, D, K, hd),
                                             "wv": (L, D, K, hd), "wo": (L, H, hd, D)}
    cache = model.init_cache(3, 40, enc_len=24)
    assert cache["cross_k"].shape == cache["cross_v"].shape == (L, 3, 24, K, hd)
    assert cache["self"]["k"].shape == (L, 3, 40, K, hd)
    assert cache["self"]["slot_pos"].shape == (L, 3, 40)


@pytest.mark.parametrize("pattern", [(RWKV6, ATTN_LOCAL), (RGLRU, RWKV6)])
def test_rwkv6_mixed_with_other_kinds_is_refused(pattern):
    """The reference's hybrid path gives RWKV6 layers no state, so a pattern
    that mixes RWKV6 with other kinds has no working counterpart."""
    cfg = dataclasses.replace(reduced(get_config("gemma2-2b")), layer_pattern=pattern)
    with pytest.raises(ValueError, match="RWKV6"):
        DecoderLM(cfg, "cpu")
