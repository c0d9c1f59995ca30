"""The port's encoder-decoder (whisper-tiny) and VLM (llava-next-34b) against
the JAX models on the same weights.

Reduced configs on the CPU: weights come from the reference's
``init(jax.random.key(0))`` through ``convert.py``, token ids, frames and
patch embeddings from a numpy seed.  Logits of forward, prefill and
decode_step must agree within 1e-3 (``tests/test_models_smoke.py``'s
tolerance) and greedy tokens from the engines exactly, at the default cache
length, where the encoder-decoder's longest row decodes past the cache's
last slot and the reference drops that write, and at prompt + steps.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import ARCHS as REF_ARCHS  # noqa: E402
from repro.models import build_model as ref_build_model  # noqa: E402
from repro.models import reduced as ref_reduced  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.serving import engine as ref_engine  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.serve import run_server  # noqa: E402
from repro_torch.models import DecoderLM, EncDecLM, build_model, reduced  # noqa: E402
from repro_torch.models import registry as reg  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402
from repro_torch.serving.batching import make_policy  # noqa: E402
from repro_torch.serving.engine import make_generate_fn, make_prefill_fn  # noqa: E402
from repro_torch.serving.workload import WorkloadSpec  # noqa: E402

TOL = 1e-3
ARCHS = ("whisper-tiny", "llava-next-34b")
S_ENC = 16          # frames of the reduced encoder-decoder
B, S = 2, 32        # text prompts


def pair(name, **overrides):
    """(reference model, reference params, port model, port params)."""
    ref_cfg = ref_reduced(REF_ARCHS[name], **overrides)
    cfg = reduced(get_config(name), **overrides)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
    ref_model = ref_build_model(ref_cfg)
    ref_params = ref_model.init(jax.random.key(0))
    model = build_model(cfg, "cpu")
    return (ref_model, ref_params, model,
            params_from_reference(jax.tree.map(np.asarray, ref_params), model))


def inputs(cfg, seed=0, b=B, s=S):
    """(tokens, {"frames" or "prefix_embeds": array}, P): numpy inputs and
    the number of prefix positions in front of the text."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    if cfg.is_encdec:
        return toks, {"frames": rng.standard_normal((b, S_ENC, cfg.d_model),
                                                    dtype=np.float32)}, 0
    P = cfg.num_frontend_tokens
    return toks, {"prefix_embeds": rng.standard_normal((b, P, cfg.d_model),
                                                       dtype=np.float32)}, P


def jx(kw):
    return {k: jnp.asarray(v) for k, v in kw.items()}


def tx(kw):
    return {k: torch.from_numpy(v) for k, v in kw.items()}


def close(port, ref):
    got = port.detach().float().numpy()
    want = np.asarray(ref, np.float32)
    assert got.shape == want.shape
    err = float(np.max(np.abs(got - want)))
    assert err < TOL, f"max |port - reference| = {err}"


@pytest.mark.parametrize("name", ARCHS)
def test_forward_matches_reference(name):
    ref_model, ref_params, model, params = pair(name)
    toks, kw, P = inputs(model.cfg)
    want, _ = ref_model.forward(ref_params, jnp.asarray(toks), **jx(kw))
    got, aux = model.forward(params, torch.from_numpy(toks), **tx(kw))
    assert got.shape == (B, P + S, model.cfg.vocab_size)
    close(got, want)
    assert float(aux) == 0.0
    # with right-padded prompts (lengths count the prefix and the text)
    lengths = np.array([P + S, P + S - 11], np.int32)
    want, _ = ref_model.forward(ref_params, jnp.asarray(toks), **jx(kw),
                                lengths=jnp.asarray(lengths))
    got, _ = model.forward(params, torch.from_numpy(toks), **tx(kw),
                           lengths=torch.from_numpy(lengths))
    close(got, want)


def ref_cache(ref_model, cfg, W):
    return (ref_model.init_cache(B, W, enc_len=S_ENC) if cfg.is_encdec
            else ref_model.init_cache(B, W))


def port_cache(model, W):
    return (model.init_cache(B, W, enc_len=S_ENC) if model.cfg.is_encdec
            else model.init_cache(B, W))


@pytest.mark.parametrize("name", ARCHS)
def test_prefill_and_decode_match_reference(name):
    """Prefill of ragged prompts, then 3 greedy decode steps."""
    ref_model, ref_params, model, params = pair(name)
    toks, kw, P = inputs(model.cfg, seed=1)
    lengths = np.array([P + S - 1, P + S - 9], np.int32)
    W = P + S + 8
    rc, want = ref_model.prefill(ref_params, ref_cache(ref_model, model.cfg, W),
                                 jnp.asarray(toks), jnp.asarray(lengths), **jx(kw))
    cache, got = model.prefill(params, port_cache(model, W), torch.from_numpy(toks),
                               torch.from_numpy(lengths), **tx(kw))
    close(got, want)
    nxt = toks[np.arange(B), lengths - P]
    for _ in range(3):
        rc, want = ref_model.decode_step(ref_params, rc, jnp.asarray(nxt))
        cache, got = model.decode_step(params, cache, torch.from_numpy(nxt))
        close(got, want)
        nxt = np.array(jnp.argmax(want, -1), np.int32)
    np.testing.assert_array_equal(cache["lengths"].numpy(), np.asarray(rc["lengths"]))
    if model.cfg.is_encdec:
        np.testing.assert_array_equal(cache["self"]["slot_pos"].numpy(),
                                      np.asarray(rc["self"]["slot_pos"]))
        close(cache["cross_k"], rc["cross_k"])


@pytest.mark.parametrize("name", ARCHS)
def test_prefill_decode_matches_forward(name):
    """The serving invariant in the port alone, as the reference's own test
    (tests/test_models_smoke.py) runs it: lengths count patches + text."""
    _, _, model, params = pair(name)
    toks, kw, P = inputs(model.cfg, seed=2, s=64)
    toks, kw = torch.from_numpy(toks), tx(kw)
    lengths = torch.tensor([64 + P - 1, 64 + P - 9], dtype=torch.int32)
    full, _ = model.forward(params, toks, **kw)
    cache, pre = model.prefill(params, port_cache(model, 64 + P + 8), toks, lengths, **kw)
    b = torch.arange(B)
    assert float((pre - full[b, lengths.long() - 1]).abs().max()) < TOL
    cache, dec = model.decode_step(params, cache, toks[b, lengths.long() - P])
    assert float((dec - full[b, lengths.long()]).abs().max()) < TOL


def test_vlm_prefill_uses_prefix():
    """VLM decode position accounting includes the image-token prefix (the
    reference's test_vlm_prefill_uses_prefix)."""
    _, _, model, params = pair("llava-next-34b")
    toks, kw, P = inputs(model.cfg, seed=3)
    toks, kw = torch.from_numpy(toks), tx(kw)
    lengths = torch.full((B,), S + P, dtype=torch.int32)   # all positions valid
    cache, logits = model.prefill(params, model.init_cache(B, S + P + 4), toks, lengths, **kw)
    full, _ = model.forward(params, toks, **kw)
    assert float((logits - full[:, -1]).abs().max()) < TOL
    assert cache["lengths"].tolist() == [S + P] * B
    # the prefix goes in unscaled: scaled like the text, the logits move
    scaled = {"prefix_embeds": kw["prefix_embeds"] * model.cfg.d_model ** 0.5}
    other, _ = model.forward(params, toks, **scaled)
    assert float((other[:, -1] - full[:, -1]).abs().max()) > 100 * TOL


@pytest.mark.parametrize("name", ARCHS)
@pytest.mark.parametrize("cache_len", ["default", "prompt_plus_steps"])
def test_greedy_tokens_match_reference_engine(name, cache_len):
    """Greedy tokens of the port's engine equal the reference engine's.  At
    the default cache length (the padded prompt) the encoder-decoder's
    longest row decodes past the last slot from its first step on."""
    steps = 6
    ref_model, ref_params, model, params = pair(name)
    toks, kw, P = inputs(model.cfg, seed=4)
    lengths = np.array([P + S, P + 19], np.int32)
    if not model.cfg.is_encdec:
        kw = {"patches": kw.pop("prefix_embeds")}
    max_len = None if cache_len == "default" else P + S + steps
    ref_gen = (ref_engine.make_generate_fn(ref_model, steps) if max_len is None else
               _ref_generate_at(ref_model, steps, max_len))
    want = ref_gen(ref_params, jnp.asarray(toks), jnp.asarray(lengths), **jx(kw))
    got = make_generate_fn(model, steps, max_len=max_len)(
        params, torch.from_numpy(toks), torch.from_numpy(lengths), **tx(kw))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _ref_generate_at(ref_model, steps, max_len):
    """The reference engine's generate with its prefill's cache of
    ``max_len`` slots (its ``make_generate_fn`` sizes the cache to the
    prompt)."""
    prefill = ref_engine.make_prefill_fn(ref_model, max_len)
    decode = ref_engine.make_decode_fn(ref_model)

    def generate(params, tokens, lengths, **kw):
        cache, logits = prefill(params, tokens, lengths, **kw)
        out = [ref_engine.greedy_sample(logits)]
        for _ in range(steps):
            cache, logits = decode(params, cache, out[-1])
            out.append(ref_engine.greedy_sample(logits))
        return jnp.stack(out, axis=1)
    return generate


def test_decode_past_the_last_slot_drops_the_write():
    """A row whose position is past the cache's last slot attends to the
    slots it has and leaves the cache as it was, as the reference's
    out-of-range scatter does; the other row writes as usual."""
    ref_model, ref_params, model, params = pair("whisper-tiny")
    toks, kw, _ = inputs(model.cfg, seed=5)
    lengths = np.array([S, 20], np.int32)
    rc, _ = ref_model.prefill(ref_params, ref_model.init_cache(B, S, enc_len=S_ENC),
                              jnp.asarray(toks), jnp.asarray(lengths), **jx(kw))
    cache, _ = model.prefill(params, model.init_cache(B, S, enc_len=S_ENC),
                             torch.from_numpy(toks), torch.from_numpy(lengths), **tx(kw))
    before = cache["self"]["k"][:, 0].clone()
    nxt = np.array([7, 9], np.int32)
    for _ in range(3):
        rc, want = ref_model.decode_step(ref_params, rc, jnp.asarray(nxt))
        cache, got = model.decode_step(params, cache, torch.from_numpy(nxt))
        close(got, want)
    assert torch.equal(cache["self"]["k"][:, 0], before)
    np.testing.assert_array_equal(cache["self"]["slot_pos"].numpy(),
                                  np.asarray(rc["self"]["slot_pos"]))
    assert cache["self"]["slot_pos"][0, 1, 20:23].tolist() == [20, 21, 22]
    close(cache["self"]["k"], rc["self"]["k"])
    assert cache["lengths"].tolist() == [S + 3, 23]


@pytest.mark.parametrize("enc_len", [S_ENC // 2, 3 * S_ENC])
def test_prefill_replaces_a_cross_cache_of_another_length(enc_len):
    """The cache's cross k/v take the frames' length, whatever enc_len the
    cache was made with: the same logits as a cache of S_ENC, and no stale
    row is attended to."""
    _, _, model, params = pair("whisper-tiny")
    toks, kw, _ = inputs(model.cfg, seed=6)
    toks, kw = torch.from_numpy(toks), tx(kw)
    lengths = torch.tensor([S, 25], dtype=torch.int32)
    runs = []
    for n in (S_ENC, enc_len):
        cache = model.init_cache(B, S + 4, enc_len=n)
        cache["cross_k"].fill_(7.0)             # stale rows, if any were kept
        cache, pre = model.prefill(params, cache, toks, lengths, **kw)
        assert cache["cross_k"].shape[2] == S_ENC and cache["cross_v"].shape[2] == S_ENC
        cache, dec = model.decode_step(params, cache, torch.tensor([3, 4], dtype=torch.int32))
        runs.append((pre, dec))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_conversion_refuses_a_tree_without_cross_attention():
    ref_model, ref_params, model, _ = pair("whisper-tiny")
    tree = jax.tree.map(np.asarray, ref_params)
    del tree["dec_layers"]["xattn"]
    with pytest.raises(ValueError, match="dec_layers: keys"):
        params_from_reference(tree, model)
    tree = jax.tree.map(np.asarray, ref_params)
    tree["dec_layers"]["xattn"]["wk"] = tree["dec_layers"]["xattn"]["wk"][:, :, :1]
    with pytest.raises(ValueError, match="xattn/wk: shape"):
        params_from_reference(tree, model)
    # a decoder-only tree is no encoder-decoder's
    _, dec_params, _, _ = pair("granite-3-2b")
    with pytest.raises(ValueError, match="params: keys"):
        params_from_reference(jax.tree.map(np.asarray, dec_params), model)


def test_encdec_prefill_needs_frames_and_run_server_cannot_serve_it():
    """As in the reference, whose prefill step reads frames.shape[1] and
    whose run_server hands it none."""
    _, _, model, params = pair("whisper-tiny")
    toks = torch.ones((B, S), dtype=torch.int32)
    with pytest.raises(ValueError, match="needs frames"):
        make_prefill_fn(model)(params, toks, torch.full((B,), S, dtype=torch.int32))
    wl = WorkloadSpec(kind="poisson", seed=0, rate=4.0, duration_s=0.5, prompt_tokens=8)
    with pytest.raises(ValueError, match="needs frames"):
        run_server(model.cfg, make_policy("tris"), wl, max_len=16, decode_steps=2,
                   device="cpu")


@pytest.mark.parametrize("name", ARCHS)
def test_full_width_builds_where_asked(name):
    """On the card by default, refused without one; on the meta device with
    the reference's parameter count (whisper-tiny 4.1e7, llava-next-34b
    3.39e10) and FLOPs per token."""
    cfg = get_config(name)
    kind = EncDecLM if cfg.is_encdec else DecoderLM
    if torch.cuda.is_available():
        assert build_model(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_model(cfg)
    model = build_model(cfg, "meta")
    assert isinstance(model, kind)
    shapes = reg.param_shapes(model)
    ref_tree = jreg.param_shapes(jreg.build_model(REF_ARCHS[name]))
    n = reg.count_params(shapes)
    assert n == jreg.count_params(ref_tree)
    assert reg.model_flops_per_token(cfg) == jreg.model_flops_per_token(REF_ARCHS[name])
    assert round(n, -6 if cfg.is_encdec else -8) == \
        {"whisper-tiny": 4.1e7, "llava-next-34b": 3.39e10}[name]
    if cfg.is_encdec:
        # whisper-tiny's own random init, whole, on the CPU when asked: the
        # tree of param_shapes in bf16, with the reference's distributions
        model = build_model(dataclasses.replace(cfg, param_dtype="bfloat16"), "cpu")
        params = model.init(torch.Generator().manual_seed(0))
        got = jax.tree.map(lambda t: tuple(t.shape), params)
        assert got == jax.tree.map(tuple, shapes, is_leaf=lambda x: isinstance(x, tuple))
        assert all(t.dtype == torch.bfloat16 for t in jax.tree.leaves(params))
        dec = params["dec_layers"]
        assert torch.equal(dec["lnx"]["scale"], torch.ones_like(dec["lnx"]["scale"]))
        for w, fan_in in ((dec["xattn"]["wq"], 384), (dec["xattn"]["wo"], 6 * 64),
                          (dec["ffn"]["wo"], 1536), (params["embed"], 2500)):
            assert abs(float(w.float().std()) * fan_in ** 0.5 - 1.0) < 0.02
