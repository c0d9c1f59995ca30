"""Train-step construction: loss, gradients, microbatch accumulation and
the update, ported from ``repro.training.step``.

Gradients come from ``torch.autograd.grad`` with respect to detached
aliases of the parameter leaves, so the caller's tensors never start
requiring a gradient.  On the card the gradients of attention, the RG-LRU
scan and the WKV recurrence are the backward kernels of K1, K3 and K4
(``kernels.ops``); a layer whose kernel has no backward kernel raises there.
Microbatches run one after another and their gradients sum
in fp32 (the reference's ``lax.scan``).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch.models.config import ModelConfig
from repro_torch.training import losses
from repro_torch.training.optimizer import OptimizerConfig, adamw_update, init_opt_state
from repro_torch.training.tree import flatten, unflatten

AUX_WEIGHT = 0.01  # MoE load-balance loss weight


def make_loss_fn(model, remat: bool = True) -> Callable:
    cfg: ModelConfig = model.cfg

    def loss_fn(params, batch):
        kwargs: Dict[str, Any] = {}
        if cfg.is_encdec:
            kwargs["frames"] = batch["frames"]
        if cfg.frontend == "vision_patches":
            kwargs["prefix_embeds"] = batch["patches"]
        hidden, aux = model.forward(params, batch["tokens"], remat=remat,
                                    return_hidden=True, **kwargs)
        if cfg.frontend == "vision_patches":
            hidden = hidden[:, batch["patches"].shape[1]:]
        ce = losses.chunked_cross_entropy(
            hidden, params["embed"], batch["labels"], batch["loss_mask"],
            logit_softcap=cfg.final_logit_softcap)
        return ce + AUX_WEIGHT * aux, {"ce": ce, "aux": aux}

    return loss_fn


def _placed_as(g, p):
    """A DTensor gradient laid out as its parameter (a partial sum over a
    mesh axis becomes a reduce-scatter or an all-reduce), as the
    reference's step returns gradients in the parameters' shardings."""
    if isinstance(g, DTensor) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def make_grad_fn(model, *, grad_accum: int = 1, remat: bool = True) -> Callable:
    """→ grad_fn(params, batch) = (grads, {"ce", "aux"}): the gradient of
    the loss, averaged over ``grad_accum`` microbatches (summed in fp32,
    then divided), and the last microbatch's ``ce`` and ``aux``, as the
    reference's scan carry leaves them."""
    loss_fn = make_loss_fn(model, remat=remat)

    def value_and_grad(params, batch):
        items = flatten(params)
        alias = [(path, p.detach().requires_grad_(p.is_floating_point())) for path, p in items]
        wrt = [p for _, p in alias if p.requires_grad]
        with torch.enable_grad():
            loss, aux = loss_fn(unflatten(alias), batch)
            got = iter(torch.autograd.grad(loss, wrt, allow_unused=True))
        grads = []
        for path, p in alias:
            g = next(got) if p.requires_grad else None
            grads.append((path, torch.zeros_like(p) if g is None else _placed_as(g, p)))
        return unflatten(grads), {k: v.detach() for k, v in aux.items()}

    def grad_fn(params, batch):
        batch = {k: torch.as_tensor(v).to(model.device) for k, v in batch.items()}
        if grad_accum == 1:
            return value_and_grad(params, batch)
        size = next(iter(batch.values())).shape[0] // grad_accum
        acc, aux = None, None
        for i in range(grad_accum):
            micro = {k: v[i * size:(i + 1) * size] for k, v in batch.items()}
            grads, aux = value_and_grad(params, micro)
            if acc is None:
                acc = {path: torch.zeros(g.shape, dtype=torch.float32, device=g.device)
                       for path, g in flatten(grads)}
            for path, g in flatten(grads):
                acc[path].add_(g)
        return unflatten((path, g.div_(grad_accum)) for path, g in acc.items()), aux

    return grad_fn


def make_train_step(model, opt_cfg: OptimizerConfig, *, grad_accum: int = 1,
                    remat: bool = True) -> Callable:
    """→ train_step(params, opt_state, batch) = (params, opt_state,
    metrics), the first two updated in place (see ``adamw_update``)."""
    grad_fn = make_grad_fn(model, grad_accum=grad_accum, remat=remat)

    def train_step(params, opt_state, batch) -> Tuple[Any, Dict, Dict]:
        grads, aux = grad_fn(params, batch)
        params, opt_state, metrics = adamw_update(opt_cfg, grads, opt_state, params)
        return params, opt_state, dict(metrics, loss=aux["ce"], moe_aux=aux["aux"])

    return train_step


def init_train_state(model, generator: torch.Generator):
    params = model.init(generator)
    return params, init_opt_state(params)
