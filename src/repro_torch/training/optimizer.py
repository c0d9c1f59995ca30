"""AdamW with warmup + cosine schedule and global-norm clipping, ported from
``repro.training.optimizer``.

The optimizer state has the parameters' tree structure: ``m`` and ``v`` in
fp32 per leaf and a 0-d int32 ``step``.  Every quantity is computed in fp32
in the reference's order.  :func:`adamw_update` updates the parameters,
``m`` and ``v`` in place under ``torch.no_grad()`` (the reference returns
new trees and donates the old ones): at full size a second copy of every
parameter and moment would not fit beside the first.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch

from repro_torch.training.tree import leaves, tree_map


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip_norm: float = 1.0


def schedule(cfg: OptimizerConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (a number or tensor), fp32 0-d."""
    step = torch.as_tensor(step).float()
    warm = cfg.learning_rate * step / max(cfg.warmup_steps, 1)
    decay_steps = max(cfg.total_steps - cfg.warmup_steps, 1)
    frac = torch.clamp((step - cfg.warmup_steps) / decay_steps, 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * frac))
    return torch.where(step < cfg.warmup_steps, warm, cfg.learning_rate * cos)


def init_opt_state(params: Any) -> Dict:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    device = leaves(params)[0].device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def opt_state_axes(param_axes: Any) -> Dict:
    """Logical axes of the optimizer state: the parameters' for ``m`` and
    ``v``, none for ``step``."""
    return {"m": param_axes, "v": param_axes, "step": ()}


def global_norm(tree: Any) -> torch.Tensor:
    return torch.sqrt(torch.stack([x.float().square().sum() for x in leaves(tree)]).sum())


@torch.no_grad()
def adamw_update(cfg: OptimizerConfig, grads: Any, opt_state: Dict,
                 params: Any) -> Tuple[Any, Dict, Dict]:
    """One AdamW step → (params, opt_state, metrics), the first two updated
    in place.  Decoupled weight decay goes on every leaf of two or more
    dimensions, decided on the stacked leaf: the stacked (L, d) norm scales
    decay, ``final_norm/scale`` (d,) does not, as in the reference."""
    step = opt_state["step"] + 1
    gnorm = global_norm(grads)
    clip = torch.clamp(cfg.grad_clip_norm / (gnorm + 1e-9), max=1.0)
    lr = schedule(cfg, step).to(gnorm.device)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - b1 ** step.float()
    bc2 = 1 - b2 ** step.float()

    def upd(g, m, v, p):
        g = g.float() * clip
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g.square_())
        delta = (m / bc1).div_((v / bc2).sqrt_().add_(cfg.eps))
        if p.dim() >= 2:  # decoupled weight decay on matrices only
            delta.add_(cfg.weight_decay * p.float())
        p.copy_(p.float() - lr * delta)

    tree_map(upd, grads, opt_state["m"], opt_state["v"], params)
    opt_state["step"] = step
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}
