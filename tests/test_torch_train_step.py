"""The port's train step against the reference's, on the CPU, for all ten
archs at the reduced size of ``tests/test_models_smoke.py`` (MoE at capacity
factor 8.0).

Weights go through ``params_from_reference`` and batches (numpy, from a
seed) are carried across.  The reference's gradient is
``jax.value_and_grad`` of its ``make_loss_fn``, compiled once per arch at
XLA's lowest backend optimisation level (LLVM's passes only; no fast math
either way, so the same arithmetic), which keeps the ten compiles within
this file's time; archs whose reduced configs are the same but for the
name (granite-3-2b, granite-8b and yi-9b; granite-moe-3b-a800m and
dbrx-132b) share one compile.  ``grad_accum`` 2 is held to the reference's scan: the
mean of the two microbatches' gradients, summed in fp32 from zero, with the
last microbatch's ce and aux.

Tolerances (fp32 throughout; XLA and PyTorch sum in other orders): ce
within 1e-5 relative, the grad norm within 2e-5 relative, aux within 1e-5 +
1e-4 relative, each leaf's gradient within GRAD_TOL of that leaf's largest
entry (measured worst: 2.9e-5 on whisper-tiny's leaves, 5.2e-6 on its grad
norm).
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import ARCHS as REF_ARCHS  # noqa: E402
from repro.models import build_model as ref_build_model  # noqa: E402
from repro.models import reduced as ref_reduced  # noqa: E402
from repro.training import optimizer as ref_optimizer  # noqa: E402
from repro.training.step import make_loss_fn as ref_make_loss_fn  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import build_model, reduced  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402
from repro_torch.training import losses  # noqa: E402
from repro_torch.training import step as port_step  # noqa: E402
from repro_torch.training.optimizer import global_norm  # noqa: E402
from repro_torch.training.tree import flatten  # noqa: E402

ALL_ARCHS = sorted(REF_ARCHS)
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}
B, S = 2, 32          # a microbatch; grad_accum 2 takes 2·B rows
GRAD_TOL = 1e-4


def _moe8(cfg):
    return dataclasses.replace(cfg, moe_capacity_factor=8.0) if cfg.is_moe else cfg


def _batch(cfg, rows: int, seed: int = 1):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (rows, S)).astype(np.int32)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1),
             "loss_mask": (rng.random((rows, S)) > 0.1).astype(np.float32)}
    if cfg.is_encdec:
        batch["frames"] = rng.standard_normal((rows, 16, cfg.d_model), dtype=np.float32)
    if cfg.frontend == "vision_patches":
        batch["patches"] = rng.standard_normal(
            (rows, cfg.num_frontend_tokens, cfg.d_model), dtype=np.float32)
    return batch


def _reference(name: str):
    """(reference params as numpy, the compiled value-and-grad of the
    reference's loss at a microbatch's shapes, a batch of 2·B rows)."""
    cfg = _moe8(ref_reduced(REF_ARCHS[name]))
    return _compiled(dataclasses.replace(cfg, name="reduced"))


@functools.cache
def _compiled(cfg):
    model = ref_build_model(cfg)
    params = jax.tree.map(np.asarray, model.init(jax.random.key(0)))
    batch = _batch(cfg, 2 * B)
    fn = jax.jit(jax.value_and_grad(ref_make_loss_fn(model, remat=False), has_aux=True))
    micro = {k: v[:B] for k, v in batch.items()}
    return params, fn.lower(params, micro).compile(FAST_COMPILE), batch


def _reference_grads(name: str, grad_accum: int, params=None):
    """The reference's (grads, ce, aux) over the first grad_accum·B rows."""
    ref_params, fn, batch = _reference(name)
    params = ref_params if params is None else params
    acc = None
    for i in range(grad_accum):
        (_, aux), grads = fn(params, {k: v[i * B:(i + 1) * B] for k, v in batch.items()})
        grads = jax.tree.map(np.asarray, grads)
        acc = grads if acc is None else jax.tree.map(np.add, acc, grads)
    if grad_accum > 1:
        acc = jax.tree.map(lambda g: g / np.float32(grad_accum), acc)
    return acc, float(aux["ce"]), float(aux["aux"])


def _port(name: str, params_np):
    model = build_model(_moe8(reduced(get_config(name))), "cpu")
    return model, params_from_reference(params_np, model)


def _leaf(tree, path):
    for key in path:
        tree = tree[key]
    return np.asarray(tree)


def _mismatches(port_grads, port_aux, ref_grads, ref_ce, ref_aux):
    """What in the port's (grads, aux) is off the reference's, by the
    tolerances above (empty when everything holds)."""
    bad = []
    ce, aux = float(port_aux["ce"]), float(port_aux["aux"])
    if abs(ce - ref_ce) > 1e-5 * abs(ref_ce):
        bad.append(f"ce {ce} vs {ref_ce}")
    if abs(aux - ref_aux) > 1e-5 + 1e-4 * abs(ref_aux):
        bad.append(f"aux {aux} vs {ref_aux}")
    gn, ref_gn = float(global_norm(port_grads)), float(ref_optimizer.global_norm(ref_grads))
    if abs(gn - ref_gn) > 2e-5 * ref_gn:
        bad.append(f"grad norm {gn} vs {ref_gn}")
    for path, g in flatten(port_grads):
        want = _leaf(ref_grads, path)
        err = np.abs(g.numpy() - want).max()
        if g.shape != want.shape or err > GRAD_TOL * np.abs(want).max():
            bad.append(f"{'/'.join(path)}: max|err| {err}, max|want| {np.abs(want).max()}")
    return bad


@pytest.mark.parametrize("grad_accum", [1, 2])
@pytest.mark.parametrize("name", ALL_ARCHS)
def test_train_step_grads_match_reference(name, grad_accum):
    """Loss, aux, grad norm and every leaf's gradient of the port's
    ``make_grad_fn`` against the reference's, and the full train step's
    metrics beside them."""
    ref_params, _, batch = _reference(name)
    model, params = _port(name, ref_params)
    rows = {k: v[:grad_accum * B] for k, v in batch.items()}
    grads, aux = port_step.make_grad_fn(model, grad_accum=grad_accum, remat=False)(
        params, rows)
    ref = _reference_grads(name, grad_accum)
    assert not _mismatches(grads, aux, *ref)
    assert set(p for p, _ in flatten(grads)) == set(p for p, _ in flatten(params))


@pytest.mark.parametrize("name", ALL_ARCHS)
def test_remat_is_bitwise_equal_on_the_cpu(name):
    """``remat=True`` recomputes each layer in the backward: on the CPU the
    gradients are bitwise those without it, and the train step's metrics
    too."""
    model, params = _port(name, _reference(name)[0])
    batch = {k: v[:B] for k, v in _reference(name)[2].items()}
    plain, aux0 = port_step.make_grad_fn(model, remat=False)(params, batch)
    remat, aux1 = port_step.make_grad_fn(model, remat=True)(params, batch)
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(flatten(plain), flatten(remat)))
    assert all(torch.equal(aux0[k], aux1[k]) for k in aux0)


def test_planted_fault_the_loss_without_its_softcap_fails():
    """gemma2-2b's final softcap (30) dropped from the loss: the check above
    must reject it.  The embedding is scaled up 40× in both frameworks so
    that the logits reach the cap (random reduced weights keep them ~0.2,
    where tanh is the identity to 1e-5)."""
    name = "gemma2-2b"
    ref_params, _, batch = _reference(name)
    ref_params = dict(ref_params, embed=ref_params["embed"] * np.float32(40.0))
    model, params = _port(name, ref_params)
    rows = {k: v[:B] for k, v in batch.items()}
    ref = _reference_grads(name, 1, ref_params)
    grad_fn = port_step.make_grad_fn(model, remat=False)
    assert not _mismatches(*grad_fn(params, rows), *ref)
    cap = losses.chunked_cross_entropy

    def uncapped(*args, **kw):
        return cap(*args, **dict(kw, logit_softcap=0.0))
    try:
        losses.chunked_cross_entropy = uncapped
        fault = grad_fn(params, rows)
    finally:
        losses.chunked_cross_entropy = cap
    bad = _mismatches(*fault, *ref)
    assert any(b.startswith("ce") for b in bad) and len(bad) > 3
