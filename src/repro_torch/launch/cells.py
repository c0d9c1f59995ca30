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

The port runs on one device: ``mem_info`` holds whole sizes, and the
reference's sharding ``rules`` other than the default raise until
distribution is ported (M12b).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs import SHAPES, ShapeSpec, get_config
from repro_torch.configs.shapes import DECODE, PREFILL, TRAIN
from repro_torch.launch.costing import storage_bytes
from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import build_model, model_flops_per_token
from repro_torch.serving.engine import make_decode_fn, make_prefill_fn, serving_config
from repro_torch.training.optimizer import OptimizerConfig
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


def _one_device(rules) -> None:
    if rules is not None:
        raise NotImplementedError(
            "sharding rules need a device mesh: distribution is M12b, not yet ported; "
            "the port's cells run on one device with the default rules")


def _vocab_shard_bytes(cfg: ModelConfig) -> float:
    return cfg.vocab_size * 4.0   # f32 logits row per token


def _empty(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def _batch_inputs(cfg: ModelConfig, shape: ShapeSpec, kind: str) -> Dict[str, torch.Tensor]:
    """The data operands of a cell, as meta tensors."""
    B, S = shape.global_batch, shape.seq_len
    act_dt = cfg.activation_dtype
    n_front = cfg.num_frontend_tokens if cfg.frontend == "vision_patches" else 0
    if kind == DECODE:
        return {"tokens": _empty((B,), torch.int32)}
    if kind == TRAIN:
        batch = {"tokens": _empty((B, S - n_front), torch.int32),
                 "labels": _empty((B, S - n_front), torch.int32),
                 "loss_mask": _empty((B, S - n_front), torch.float32)}
    elif kind == PREFILL:
        batch = {"tokens": _empty((B, S - n_front), torch.int32),
                 "lengths": _empty((B,), torch.int32)}
    else:
        raise ValueError(kind)
    if cfg.is_encdec:
        batch["frames"] = _empty((B, S, cfg.d_model), act_dt)
    if n_front:
        batch["patches"] = _empty((B, n_front, cfg.d_model), act_dt)
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


def build_train_cell(arch: str, shape: ShapeSpec, rules=None, grad_accum: int = 1,
                     remat: bool = True, cfg: Optional[ModelConfig] = None) -> Cell:
    _one_device(rules)
    cfg = cfg or get_config(arch)
    model = build_model(cfg, META)
    params, opt_state = init_train_state(model, torch.Generator())
    batch = _batch_inputs(cfg, shape, TRAIN)
    fn = make_train_step(model, OptimizerConfig(), grad_accum=grad_accum, remat=remat)
    flops, tokens = _cell_flops(cfg, shape, TRAIN)
    mem_info = {
        "params_bytes": storage_bytes(params),
        "opt_bytes": storage_bytes(opt_state),
        "cache_bytes": 0.0,
        "batch_dev": shape.global_batch,
        "vocab_shard_bytes_per_token": _vocab_shard_bytes(cfg),
    }
    return Cell(arch, shape, fn, (params, opt_state, batch), flops, tokens, cfg, mem_info)


def build_prefill_cell(arch: str, shape: ShapeSpec, rules=None,
                       cfg: Optional[ModelConfig] = None) -> Cell:
    _one_device(rules)
    cfg = serving_config(cfg or get_config(arch))
    model = build_model(cfg, META)
    params = _params(model)
    batch = _batch_inputs(cfg, shape, PREFILL)
    prefill = make_prefill_fn(model)

    def step(params, batch):
        return prefill(params, **batch)

    # the cache the step builds: the padded prompt's slots (patches included)
    B, S = shape.global_batch, shape.seq_len
    cache = (model.init_cache(B, S, enc_len=S) if cfg.is_encdec
             else model.init_cache(B, S))
    flops, tokens = _cell_flops(cfg, shape, PREFILL)
    mem_info = {
        "params_bytes": storage_bytes(params),
        "cache_bytes": storage_bytes(cache),
        "batch_dev": B,
        "vocab_shard_bytes_per_token": _vocab_shard_bytes(cfg),
    }
    return Cell(arch, shape, step, (params, batch), flops, tokens, cfg, mem_info)


def build_decode_cell(arch: str, shape: ShapeSpec, rules=None,
                      cfg: Optional[ModelConfig] = None) -> Cell:
    _one_device(rules)
    cfg = serving_config(cfg or get_config(arch))
    model = build_model(cfg, META)
    B, S = shape.global_batch, shape.seq_len
    params = _params(model)
    cache = model.init_cache(B, S, enc_len=S) if cfg.is_encdec else model.init_cache(B, S)
    tokens_in = _batch_inputs(cfg, shape, DECODE)["tokens"]
    flops, tokens = _cell_flops(cfg, shape, DECODE)
    mem_info = {
        "params_bytes": storage_bytes(params),
        "cache_bytes": storage_bytes(cache),
        "batch_dev": B,
        "vocab_shard_bytes_per_token": _vocab_shard_bytes(cfg),
    }
    return Cell(arch, shape, make_decode_fn(model), (params, cache, tokens_in),
                flops, tokens, cfg, mem_info)


def build_cell(arch: str, shape_name: str, rules=None,
               cfg: Optional[ModelConfig] = None, **kw) -> Cell:
    shape = SHAPES[shape_name]
    if shape.kind == TRAIN:
        return build_train_cell(arch, shape, rules, cfg=cfg, **kw)
    if shape.kind == PREFILL:
        return build_prefill_cell(arch, shape, rules, cfg=cfg)
    return build_decode_cell(arch, shape, rules, cfg=cfg)
