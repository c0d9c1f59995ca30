"""The port's MoE block and MoE ``DecoderLM`` against the JAX ones.

The same inputs, made from a numpy seed, go through ``repro.models.moe`` and
``repro_torch.models.moe`` on the CPU: capacity equal; top-k indices,
dispatch positions and keep bitwise equal; the gates and top-k weights
within a few fp32 ulps (XLA's and PyTorch's CPU kernels round the router's
product and the softmax's exponentials differently, by up to 2-4 ulps on
identical inputs, so no two frameworks give these floats bit for bit);
``moe_apply`` within 1e-5 in fp32 and 2e-2 (plus two bf16 ulps of the
output) in bf16, after the tolerances of ``tests/test_kernels.py``; reduced granite-moe-3b-a800m and dbrx-132b
``DecoderLM`` within 1e-3 on logits (``tests/test_models_smoke.py``), aux
loss included, greedy tokens equal.  Their prefill + decode ≡ forward at
capacity factor 8.0 is ``tests/test_torch_model.py``'s, which holds every
ported arch to it.
"""
import dataclasses
import math

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import ARCHS as REF_ARCHS  # noqa: E402
from repro.models import build_model as ref_build_model  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import reduced as ref_reduced  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.serving import engine as ref_engine  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import DecoderLM, build_model, moe, reduced  # noqa: E402
from repro_torch.models import registry as reg  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402
from repro_torch.serving.engine import make_generate_fn  # noqa: E402

MOE_ARCHS = ("granite-moe-3b-a800m", "dbrx-132b")
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
LOGIT_TOL = 1e-3
# gates and top-k weights (all in [0, 1]): a few fp32 ulps apart at most
ROUTE_ATOL = 8 * 2.0 ** -24


def block(seed, E, k, d, f, B=2, S=64, dtype="float32"):
    """(jax params, jax x, torch params, torch x) of one MoE block with the
    reference's distributions, drawn by numpy and rounded to ``dtype``.  The
    tokens share one random offset (as tokens of one text share a topic), so
    the router favours some experts over others and capacity binds."""
    rng = np.random.default_rng(seed)
    shapes = moe.moe_shapes(d, f, E)
    arrs = {name: rng.standard_normal(shape, dtype=np.float32)
            / np.float32(math.sqrt(f if name == "wo" else d))
            for name, shape in shapes.items()}
    arrs["x"] = (rng.standard_normal((B, S, d), dtype=np.float32)
                 + rng.standard_normal((1, 1, d), dtype=np.float32))
    jx = {name: jnp.asarray(a).astype(dtype) for name, a in arrs.items()}
    tx = {name: torch.from_numpy(np.array(a, np.float32)).to(getattr(torch, dtype))
          for name, a in jx.items()}
    return ({n: jx[n] for n in shapes}, jx["x"], {n: tx[n] for n in shapes}, tx["x"])


def close(got, want, tol, rtol=0.0):
    """max |got − want| ≤ tol + rtol·|want|, entry by entry."""
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = np.abs(got - want)
    assert bool((err <= tol + rtol * np.abs(want)).all()), \
        f"max |port - reference| = {float(err.max())}"


@pytest.mark.parametrize("E,k", [(4, 2), (40, 8), (16, 4), (8, 1), (3, 3)])
def test_capacity_equals_reference(E, k):
    for tokens in (1, 2, 7, 64, 512, 4700):
        for factor in (1.0, 1.25, 2.0, 8.0):
            assert moe._capacity(tokens, E, k, factor) == \
                jmoe._capacity(tokens, E, k, factor)


@pytest.mark.parametrize("E,k,d", [(4, 2, 64), (40, 8, 32), (16, 4, 48)])
def test_route_and_dispatch_match_reference(E, k, d):
    jp, jx, tp, tx = block(0, E, k, d, 16, B=3, S=96)
    g, w, idx = jmoe._route(jp, jx, E, k)
    tg, tw, tidx = moe._route(tp, tx, E, k)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(idx))
    np.testing.assert_allclose(tg.numpy(), np.asarray(g), rtol=0, atol=ROUTE_ATOL)
    np.testing.assert_allclose(tw.numpy(), np.asarray(w), rtol=0, atol=ROUTE_ATOL)
    C = jmoe._capacity(96, E, k, 1.25)
    onehot, pos, keep = jmoe._dispatch_indices(idx, E, C)
    t_onehot, t_pos, t_keep = moe._dispatch_indices(tidx, E, C)
    for got, want in ((t_onehot, onehot), (t_pos, pos), (t_keep, keep)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert t_pos.dtype == torch.int32 and t_keep.dtype == torch.bool


def test_top_k_ties_go_to_the_lower_expert_index():
    """Equal gates: lax.top_k keeps the lower index first; so must the port."""
    E, k, d = 8, 3, 4
    router = np.zeros((d, E), np.float32)
    router[:, 5] = 1.0                     # expert 5 leads, the other 7 tie
    x = np.ones((1, 2, d), np.float32)
    _, _, want = jmoe._route({"router": jnp.asarray(router)}, jnp.asarray(x), E, k)
    _, _, got = moe._route({"router": torch.from_numpy(router)}, torch.from_numpy(x), E, k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got[0, 0].tolist() == [5, 0, 1]


def test_scatter_adds_and_dropped_rows_leave_slot_zero():
    """Dropped assignments point at slot 0 with zeroed rows: the buffer must
    add them (assigning would overwrite slot 0's token)."""
    xk = torch.tensor([[[1.0, 2.0], [0.0, 0.0], [3.0, 4.0]]])
    eidx = torch.tensor([[0, 0, 1]])
    pos = torch.tensor([[0, 0, 0]], dtype=torch.int32)
    buf = moe._scatter_local(xk, eidx, pos, E=2, C=2)
    want = jmoe._scatter_local(jnp.asarray(xk.numpy()), jnp.asarray(eidx.numpy()),
                               jnp.asarray(pos.numpy()), E=2, C=2)
    np.testing.assert_array_equal(buf.numpy(), np.asarray(want))
    assert buf[0, 0, 0].tolist() == [1.0, 2.0]
    np.testing.assert_array_equal(moe._gather_local(buf, eidx, pos).numpy(),
                                  np.asarray(jmoe._gather_local(want, jnp.asarray(eidx.numpy()),
                                                                jnp.asarray(pos.numpy()))))


@pytest.mark.parametrize("E,k,d,f", [(4, 2, 64, 128), (40, 8, 32, 16), (16, 4, 48, 32)])
@pytest.mark.parametrize("factor", [1.25, 8.0])
def test_moe_apply_fp32_matches_reference(E, k, d, f, factor):
    jp, jx, tp, tx = block(1, E, k, d, f, B=3, S=80)
    want, want_aux = jmoe.moe_apply(jp, jx, num_experts=E, k=k, capacity_factor=factor,
                                    return_aux=True)
    got, aux = moe.moe_apply(tp, tx, num_experts=E, k=k, capacity_factor=factor,
                             return_aux=True)
    close(got, want, TOL["float32"])
    close(aux, want_aux, TOL["float32"])
    # the capacity the case runs at: tokens dropped at 1.25, none at 8.0
    _, _, idx = moe._route(tp, tx, E, k)
    _, _, keep = moe._dispatch_indices(idx, E, moe._capacity(80, E, k, factor))
    assert (not bool(keep.all())) if factor == 1.25 else bool(keep.all())
    assert moe.moe_apply(tp, tx, num_experts=E, k=k, capacity_factor=factor).shape == tx.shape


@pytest.mark.parametrize("E,k", [(40, 8), (16, 4)])
def test_moe_apply_bf16_matches_reference(E, k):
    jp, jx, tp, tx = block(2, E, k, 64, 32, B=2, S=64, dtype="bfloat16")
    want = jmoe.moe_apply(jp, jx, num_experts=E, k=k)
    got = moe.moe_apply(tp, tx, num_experts=E, k=k)
    assert got.dtype == torch.bfloat16
    # the outputs reach 4-7 here: beside 2e-2, two bf16 ulps of |want| (each
    # framework rounds every product and the k-sum to bf16 once, after fp32
    # sums in its own order)
    close(got, want, TOL["bfloat16"], rtol=2.0 ** -6)


def pair(name, **overrides):
    """(reference model, reference params, port model, port params) of the
    reduced ``name``, weights from the reference's init."""
    ref_cfg = ref_reduced(REF_ARCHS[name], **overrides)
    cfg = reduced(get_config(name), **overrides)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
    ref_model = ref_build_model(ref_cfg)
    ref_params = ref_model.init(jax.random.key(0))
    model = build_model(cfg, "cpu")
    return (ref_model, ref_params, model,
            params_from_reference(jax.tree.map(np.asarray, ref_params), model))


def tokens_for(cfg, B=2, S=64, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


@pytest.mark.parametrize("name", MOE_ARCHS)
def test_decoder_forward_prefill_decode_match_reference(name):
    """Forward with its aux loss, then prefill of ragged prompts and 3 greedy
    decode steps: logits within 1e-3, greedy tokens equal."""
    ref_model, ref_params, model, params = pair(name)
    assert model.cfg.num_experts == 4 and model.cfg.experts_per_token == 2
    toks = tokens_for(model.cfg)
    want, want_aux = ref_model.forward(ref_params, jnp.asarray(toks))
    got, aux = model.forward(params, torch.from_numpy(toks))
    close(got, want, LOGIT_TOL)
    close(aux, want_aux, TOL["float32"])
    assert float(aux) > 0
    B, S = toks.shape
    lengths = np.array([64, 23], np.int32)
    ref_cache, want = ref_model.prefill(ref_params, ref_model.init_cache(B, S + 8),
                                        jnp.asarray(toks), jnp.asarray(lengths))
    cache, got = model.prefill(params, model.init_cache(B, S + 8), torch.from_numpy(toks),
                               torch.from_numpy(lengths))
    for _ in range(4):
        close(got, want, LOGIT_TOL)
        nxt = np.asarray(jnp.argmax(want, -1), np.int32)
        np.testing.assert_array_equal(torch.argmax(got, -1).numpy(), nxt)
        ref_cache, want = ref_model.decode_step(ref_params, ref_cache, jnp.asarray(nxt))
        cache, got = model.decode_step(params, cache, torch.from_numpy(nxt))
    close(got, want, LOGIT_TOL)


@pytest.mark.parametrize("name", MOE_ARCHS)
def test_capacity_follows_the_padded_length(name):
    """Capacity is set per row over the padded sequence: a 9-token prompt
    padded to 64 beside a long one runs at the capacity of 64 tokens, as in
    the reference, and alone at that of 9; both agree with the reference."""
    ref_model, ref_params, model, params = pair(name, moe_capacity_factor=1.0)
    toks = tokens_for(model.cfg, seed=5)
    for rows, S, lengths in (([0, 1], 64, [64, 9]), ([1], 9, [9])):
        t = toks[rows, :S]
        want = ref_model.prefill(ref_params, ref_model.init_cache(len(rows), S + 1),
                                 jnp.asarray(t), jnp.asarray(lengths, np.int32))[1]
        got = model.prefill(params, model.init_cache(len(rows), S + 1), torch.from_numpy(t),
                            torch.tensor(lengths, dtype=torch.int32))[1]
        close(got, want, LOGIT_TOL)
    E, k = model.cfg.num_experts, model.cfg.experts_per_token
    assert moe._capacity(64, E, k, 1.0) > moe._capacity(9, E, k, 1.0)


@pytest.mark.parametrize("name", MOE_ARCHS)
def test_greedy_tokens_match_reference_engine(name):
    ref_model, ref_params, model, params = pair(name)
    toks = tokens_for(model.cfg, seed=3)
    lengths = np.array([61, 40], np.int32)
    want = jax.jit(ref_engine.make_generate_fn(ref_model, 6))(ref_params, toks, lengths)
    got = make_generate_fn(model, 6)(params, torch.from_numpy(toks), torch.from_numpy(lengths))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_conversion_refuses_a_wrong_expert_count():
    ref_model, ref_params, model, _ = pair("granite-moe-3b-a800m")
    tree = jax.tree.map(np.asarray, ref_params)
    assert tree["layers"]["ffn"]["wi"].shape[:2] == (2, 4)
    tree["layers"]["ffn"]["wi"] = tree["layers"]["ffn"]["wi"][:, :3]
    with pytest.raises(ValueError, match="ffn/wi: shape"):
        params_from_reference(tree, model)
    other = build_model(reduced(get_config("granite-moe-3b-a800m"), num_experts=3), "cpu")
    with pytest.raises(ValueError, match="ffn/router: shape"):
        params_from_reference(jax.tree.map(np.asarray, ref_params), other)


def test_full_width_granite_moe_builds_where_asked():
    """On the card by default, refused without one; on the meta device with
    the reference's parameter count, and on the CPU when asked (at the full
    width, one layer deep: the full depth is 6.6 GB)."""
    cfg = get_config("granite-moe-3b-a800m")
    if torch.cuda.is_available():
        assert DecoderLM(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            DecoderLM(cfg)
    shapes = build_model(cfg, "meta").param_shapes()
    assert shapes["layers"]["ffn"] == {"router": (32, 1536, 40), "wi": (32, 40, 1536, 512),
                                       "wg": (32, 40, 1536, 512), "wo": (32, 40, 512, 1536)}
    ref_tree = jreg.param_shapes(jreg.build_model(REF_ARCHS[cfg.name]))
    assert reg.count_params(shapes) == jreg.count_params(ref_tree)
    one = build_model(dataclasses.replace(cfg, num_layers=1, param_dtype="bfloat16"), "cpu")
    params = one.init(torch.Generator().manual_seed(0))
    ffn = params["layers"]["ffn"]
    assert {n: tuple(t.shape) for n, t in ffn.items()} == \
        {n: (1,) + s for n, s in moe.moe_shapes(1536, 512, 40).items()}
    assert all(t.dtype == torch.bfloat16 for t in ffn.values())
    # the reference's distributions: N(0, 1/d) and, for wo, N(0, 1/d_ff)
    assert abs(float(ffn["wi"].float().std()) * math.sqrt(1536) - 1.0) < 0.01
    assert abs(float(ffn["wo"].float().std()) * math.sqrt(512) - 1.0) < 0.01
