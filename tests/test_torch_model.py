"""The port's DecoderLM against the JAX DecoderLM on the same weights.

Reduced configs (a few layers, narrow widths) on the CPU: weights come from
the reference's ``init(jax.random.key(0))`` through ``convert.py``, inputs
from a numpy seed, and logits of forward, prefill and decode_step must agree
within 1e-3 — the tolerance of ``tests/test_models_smoke.py``.
"""
import dataclasses
import importlib

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import ARCHS as REF_ARCHS  # noqa: E402
from repro.models import build_model as ref_build_model  # noqa: E402
from repro.models import reduced as ref_reduced  # noqa: E402
from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.models import build_model, reduced  # noqa: E402
from repro_torch.models.config import ATTN_LOCAL  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402

TOL = 1e-3
PORTED = ("gemma2-2b", "granite-3-2b", "rwkv6-7b", "granite-moe-3b-a800m", "dbrx-132b")


def pair(name, **overrides):
    """(reference model, reference params, port model, port params)."""
    ref_cfg = ref_reduced(REF_ARCHS[name], **overrides)
    cfg = reduced(get_config(name), **overrides)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
    ref_model = ref_build_model(ref_cfg)
    ref_params = ref_model.init(jax.random.key(0))
    model = build_model(cfg, "cpu")
    tree = jax.tree.map(np.asarray, ref_params)
    return ref_model, ref_params, model, params_from_reference(tree, model)


def tokens_for(cfg, B=2, S=64, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=(B, S)).astype(np.int32)


def close(port, ref):
    got = port.detach().float().numpy()
    want = np.asarray(ref, np.float32)
    assert got.shape == want.shape
    err = float(np.max(np.abs(got - want)))
    assert err < TOL, f"max |port - reference| = {err}"


def test_catalog_matches_reference():
    # all ten archs of the reference catalog, with the same values, each
    # also as its own configs/<arch>.py module
    assert sorted(ARCHS) == sorted(REF_ARCHS)
    for name, cfg in ARCHS.items():
        assert dataclasses.asdict(cfg) == dataclasses.asdict(REF_ARCHS[name])
        module = importlib.import_module(f"repro_torch.configs.{name.replace('-', '_')}")
        assert module.CONFIG is get_config(name)
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("gpt-5")


@pytest.mark.parametrize("name", PORTED)
def test_forward_matches_reference(name):
    ref_model, ref_params, model, params = pair(name)
    toks = tokens_for(model.cfg)
    want, _ = ref_model.forward(ref_params, jnp.asarray(toks))
    got, _ = model.forward(params, torch.from_numpy(toks))
    close(got, want)


@pytest.mark.parametrize("name", PORTED)
def test_prefill_and_decode_match_reference(name):
    ref_model, ref_params, model, params = pair(name)
    toks = tokens_for(model.cfg)
    B, S = toks.shape
    lengths = np.array([63, 55], np.int32)
    ref_cache = ref_model.init_cache(B, S + 8)
    ref_cache, want_pre = ref_model.prefill(ref_params, ref_cache,
                                            jnp.asarray(toks), jnp.asarray(lengths))
    cache = model.init_cache(B, S + 8)
    cache, got_pre = model.prefill(params, cache, torch.from_numpy(toks),
                                   torch.from_numpy(lengths))
    close(got_pre, want_pre)
    nxt = toks[np.arange(B), lengths]
    for _ in range(3):
        ref_cache, want = ref_model.decode_step(ref_params, ref_cache,
                                                jnp.asarray(nxt))
        cache, got = model.decode_step(params, cache, torch.from_numpy(nxt))
        close(got, want)
        nxt = np.array(jnp.argmax(want, -1), np.int32)
    np.testing.assert_array_equal(cache["lengths"].numpy(),
                                  np.asarray(ref_cache["lengths"]))


@pytest.mark.parametrize("name", PORTED)
def test_prefill_decode_matches_forward(name):
    """The serving invariant in the port alone: prefill + decode ≡ forward;
    for MoE at capacity factor 8.0, where no token is dropped, as the
    reference's own test of it does (tests/test_models_smoke.py)."""
    moe = get_config(name).is_moe
    _, _, model, params = pair(name, **({"moe_capacity_factor": 8.0} if moe else {}))
    toks = torch.from_numpy(tokens_for(model.cfg, seed=1))
    B, S = toks.shape
    lengths = torch.tensor([S - 1, S - 9], dtype=torch.int32)
    full, _ = model.forward(params, toks)
    cache, pre = model.prefill(params, model.init_cache(B, S + 8), toks, lengths)
    b = torch.arange(B)
    assert float((pre - full[b, lengths.long() - 1]).abs().max()) < TOL
    cache, dec = model.decode_step(params, cache, toks[b, lengths.long()])
    assert float((dec - full[b, lengths.long()]).abs().max()) < TOL


def test_all_local_ring_buffer_prefill_and_decode():
    """An all-local stack keeps a ring of the window (W=16 < S=64): the
    gather branch of prefill and decode past the wrap match the reference,
    cache contents included."""
    ref_model, ref_params, model, params = pair(
        "gemma2-2b", layer_pattern=(ATTN_LOCAL,))
    toks = tokens_for(model.cfg, seed=2)
    B, S = toks.shape
    lengths = np.array([64, 37], np.int32)
    ref_cache, want = ref_model.prefill(ref_params, ref_model.init_cache(B, S + 8),
                                        jnp.asarray(toks), jnp.asarray(lengths))
    cache, got = model.prefill(params, model.init_cache(B, S + 8),
                               torch.from_numpy(toks), torch.from_numpy(lengths))
    assert cache["layers"]["k"].shape[2] == 16
    close(got, want)
    np.testing.assert_array_equal(cache["layers"]["slot_pos"].numpy(),
                                  np.asarray(ref_cache["layers"]["slot_pos"]))
    close(cache["layers"]["k"], ref_cache["layers"]["k"])
    nxt = np.array(jnp.argmax(want, -1), np.int32)
    for _ in range(3):
        ref_cache, want = ref_model.decode_step(ref_params, ref_cache,
                                                jnp.asarray(nxt))
        cache, got = model.decode_step(params, cache, torch.from_numpy(nxt))
        close(got, want)
        nxt = np.array(jnp.argmax(want, -1), np.int32)


def test_convert_rejects_wrong_layout():
    _, ref_params, model, _ = pair("granite-3-2b")
    tree = jax.tree.map(np.asarray, ref_params)
    tree["layers"]["attn"]["wo"] = tree["layers"]["attn"]["wo"].transpose(0, 3, 1, 2)
    with pytest.raises(ValueError, match="wo"):
        params_from_reference(tree, model)
