"""Cell construction: (architecture × input shape) → step and operands on
meta tensors, ported from ``repro.launch.cells``.

A "cell" bundles the step function and its operands as meta tensors (shapes
and dtypes, never allocated): the parameters from the model's ``init`` on
the meta device (``param_shapes`` has their shapes but not their dtypes:
rwkv6's decay leaves stay fp32 in a bf16 model), the optimizer state from
``init_opt_state``, the batch from :func:`_batch_inputs` and the cache from
``model.init_cache``.  The dry-run
runs the step on them (``launch/dryrun.py``); so can a caller that first
places them on the card.

Without a mesh a cell is one device's (the port's card): ``mem_info`` holds
whole sizes.  With a ``mesh`` (``launch/mesh.py``: the reference's
production meshes over a fake group) and ``rules`` (default: the
reference's, ``TRAIN_RULES`` for training and ``SERVE_RULES`` for serving)
the operands are DTensors over meta blocks of their local shapes, laid out
by the models' logical axes (``repro_torch.dist.sharding``); the step runs
under the rules' activation sharding, and ``mem_info`` holds per-device
bytes, as the reference's ``_sharding_bytes``.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs import SHAPES, ShapeSpec, get_config
from repro_torch.configs.shapes import DECODE, PREFILL, TRAIN
from repro_torch.dist import sharding as shd
from repro_torch.launch.costing import storage_bytes
from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import build_model, model_flops_per_token
from repro_torch.serving.engine import make_decode_fn, make_prefill_fn, serving_config
from repro_torch.training.data import batch_axes
from repro_torch.training.optimizer import OptimizerConfig, opt_state_axes
from repro_torch.training.step import init_train_state, make_train_step

META = torch.device("meta")


@dataclasses.dataclass
class Cell:
    arch: str
    shape: ShapeSpec
    fn: Callable                     # the step
    args: Tuple[Any, ...]            # meta-tensor operands
    model_flops: float               # 6·N·D (train) / 2·N·D (serve)
    tokens: int
    cfg: ModelConfig
    mem_info: Dict[str, float] = dataclasses.field(default_factory=dict)
    mesh: Any = None                 # None: one device
    rules: Any = None                # the rules the step runs under (None: one device)


def _layout(mesh, rules, default):
    """The cell's rules: none without a mesh, else ``rules`` or ``default``."""
    if mesh is None:
        if rules is not None:
            raise ValueError("sharding rules need a device mesh: pass mesh= "
                             "(launch/mesh.py), or no rules for one device")
        return None
    return rules or default


def _vocab_shard_bytes(cfg: ModelConfig, rules=None, mesh=None) -> float:
    """f32 logits row per token, over the vocab's shards."""
    if mesh is None:
        return cfg.vocab_size * 4.0
    spec = shd.partition_spec((cfg.vocab_size, cfg.d_model), ("vocab", "embed"), rules, mesh)
    return cfg.vocab_size // shd.shard_factor(spec[:1], mesh) * 4.0


def _batch_dev(B: int, rules, mesh) -> int:
    if mesh is None:
        return B
    spec = shd.partition_spec((B,), ("batch",), rules, mesh)
    return max(B // shd.shard_factor(spec, mesh), 1)


def _placed(tree, axes, rules, mesh):
    """(``tree`` laid out on ``mesh``, its per-device bytes); without a
    mesh, (``tree``, its bytes)."""
    if mesh is None:
        return tree, storage_bytes(tree)
    specs = shd.tree_partition_specs(tree, axes, rules, mesh)
    return shd.shard_tree(tree, axes, rules, mesh), shd.bytes_per_device(tree, specs, mesh)


def _under(fn, mesh, rules):
    """``fn`` run under the rules' activation sharding (without a mesh,
    ``fn`` itself)."""
    if mesh is None:
        return fn

    @functools.wraps(fn)
    def step(*args):
        with shd.activation_sharding(mesh, rules):
            return fn(*args)

    return step


def _empty(shape, dtype, device=META) -> torch.Tensor:
    """An operand: shape and dtype only on meta, zeros on a device."""
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    return torch.zeros(shape, dtype=dtype, device=device)


def _batch_inputs(cfg: ModelConfig, shape: ShapeSpec, kind: str,
                  device=META) -> Dict[str, torch.Tensor]:
    """The data operands of a cell, as meta tensors (or zeros on
    ``device``)."""
    _e = functools.partial(_empty, device=device)
    B, S = shape.global_batch, shape.seq_len
    act_dt = cfg.activation_dtype
    n_front = cfg.num_frontend_tokens if cfg.frontend == "vision_patches" else 0
    if kind == DECODE:
        return {"tokens": _e((B,), torch.int32)}
    if kind == TRAIN:
        batch = {"tokens": _e((B, S - n_front), torch.int32),
                 "labels": _e((B, S - n_front), torch.int32),
                 "loss_mask": _e((B, S - n_front), torch.float32)}
    elif kind == PREFILL:
        batch = {"tokens": _e((B, S - n_front), torch.int32),
                 "lengths": _e((B,), torch.int32)}
    else:
        raise ValueError(kind)
    if cfg.is_encdec:
        batch["frames"] = _e((B, S, cfg.d_model), act_dt)
    if n_front:
        batch["patches"] = _e((B, n_front, cfg.d_model), act_dt)
    return batch


def _cell_flops(cfg: ModelConfig, shape: ShapeSpec, kind: str) -> Tuple[float, int]:
    per_tok = model_flops_per_token(cfg)          # 6·N_active
    if kind == TRAIN:
        tokens = shape.global_batch * shape.seq_len
        return per_tok * tokens, tokens
    if kind == PREFILL:
        tokens = shape.global_batch * shape.seq_len
        return per_tok / 3.0 * tokens, tokens     # fwd-only: 2·N·D
    tokens = shape.global_batch                    # one token per sequence
    return per_tok / 3.0 * tokens, tokens


def _params(model) -> Dict[str, Any]:
    return model.init(torch.Generator())          # meta: shapes and dtypes only


def build_train_cell(arch: str, shape: ShapeSpec, mesh=None, rules=None,
                     grad_accum: int = 1, remat: bool = True,
                     cfg: Optional[ModelConfig] = None, device=META) -> Cell:
    rules = _layout(mesh, rules, shd.TRAIN_RULES)
    cfg = cfg or get_config(arch)
    model = build_model(cfg, device)
    params, opt_state = init_train_state(model, torch.Generator())
    p_axes = model.logical_axes()
    params, params_bytes = _placed(params, p_axes, rules, mesh)
    opt_state, opt_bytes = _placed(opt_state, opt_state_axes(p_axes), rules, mesh)
    batch = _batch_inputs(cfg, shape, TRAIN, device)
    batch = _placed(batch, batch_axes(batch), rules, mesh)[0]
    fn = _under(make_train_step(model, OptimizerConfig(), grad_accum=grad_accum, remat=remat),
                mesh, rules)
    flops, tokens = _cell_flops(cfg, shape, TRAIN)
    mem_info = {
        "params_bytes": params_bytes,
        "opt_bytes": opt_bytes,
        "cache_bytes": 0.0,
        "batch_dev": _batch_dev(shape.global_batch, rules, mesh),
        "vocab_shard_bytes_per_token": _vocab_shard_bytes(cfg, rules, mesh),
    }
    return Cell(arch, shape, fn, (params, opt_state, batch), flops, tokens, cfg, mem_info,
                mesh, rules)


def build_prefill_cell(arch: str, shape: ShapeSpec, mesh=None, rules=None,
                       cfg: Optional[ModelConfig] = None, device=META) -> Cell:
    rules = _layout(mesh, rules, shd.SERVE_RULES)
    cfg = serving_config(cfg or get_config(arch))
    model = build_model(cfg, device)
    params, params_bytes = _placed(_params(model), model.logical_axes(), rules, mesh)
    batch = _batch_inputs(cfg, shape, PREFILL, device)
    batch = _placed(batch, batch_axes(batch), rules, mesh)[0]
    prefill = make_prefill_fn(model)

    def step(params, batch):
        return prefill(params, **batch)

    # the cache the step builds: the padded prompt's slots (patches included)
    B, S = shape.global_batch, shape.seq_len
    cache = (model.init_cache(B, S, enc_len=S) if cfg.is_encdec
             else model.init_cache(B, S))
    flops, tokens = _cell_flops(cfg, shape, PREFILL)
    mem_info = {
        "params_bytes": params_bytes,
        "cache_bytes": _placed(cache, model.cache_axes(), rules, mesh)[1],
        "batch_dev": _batch_dev(B, rules, mesh),
        "vocab_shard_bytes_per_token": _vocab_shard_bytes(cfg, rules, mesh),
    }
    return Cell(arch, shape, _under(step, mesh, rules), (params, batch), flops, tokens, cfg,
                mem_info, mesh, rules)


def build_decode_cell(arch: str, shape: ShapeSpec, mesh=None, rules=None,
                      cfg: Optional[ModelConfig] = None, device=META) -> Cell:
    rules = _layout(mesh, rules, shd.SERVE_RULES)
    cfg = serving_config(cfg or get_config(arch))
    model = build_model(cfg, device)
    B, S = shape.global_batch, shape.seq_len
    params, params_bytes = _placed(_params(model), model.logical_axes(), rules, mesh)
    cache = model.init_cache(B, S, enc_len=S) if cfg.is_encdec else model.init_cache(B, S)
    cache, cache_bytes = _placed(cache, model.cache_axes(), rules, mesh)
    tokens_in = _placed(_batch_inputs(cfg, shape, DECODE, device), {"tokens": ("batch",)},
                        rules, mesh)[0]["tokens"]
    flops, tokens = _cell_flops(cfg, shape, DECODE)
    mem_info = {
        "params_bytes": params_bytes,
        "cache_bytes": cache_bytes,
        "batch_dev": _batch_dev(B, rules, mesh),
        "vocab_shard_bytes_per_token": _vocab_shard_bytes(cfg, rules, mesh),
    }
    return Cell(arch, shape, _under(make_decode_fn(model), mesh, rules),
                (params, cache, tokens_in), flops, tokens, cfg, mem_info, mesh, rules)


def build_cell(arch: str, shape_name: str, mesh=None, rules=None,
               cfg: Optional[ModelConfig] = None, device=META, **kw) -> Cell:
    shape = SHAPES[shape_name]
    if shape.kind == TRAIN:
        return build_train_cell(arch, shape, mesh, rules, cfg=cfg, device=device, **kw)
    if shape.kind == PREFILL:
        return build_prefill_cell(arch, shape, mesh, rules, cfg=cfg, device=device)
    return build_decode_cell(arch, shape, mesh, rules, cfg=cfg, device=device)
