"""End-to-end trainer, ported from ``repro.launch.train``.

Trains an assigned architecture (optionally depth/width-reduced to a
~100M-param config) with the training stack: AdamW, remat, the data
pipeline, async checkpoints, restart recovery and straggler monitoring, on
a (world / mp, mp) ("data", "model") mesh over every rank
(``launch/mesh.py``) — the card and ``nccl`` unless ``--device cpu``
(``gloo``).  Parameters and optimizer state are laid out by
``TRAIN_RULES``, the global batch is built on every rank from the seed and
sharded over the batch axes, and the step runs under the rules'
activation sharding.  One device (one process, ``--model-parallel 1``)
joins no group and places nothing: the step runs on plain tensors, and the
printed mesh is the reference's 1 × 1.  On one card only that runs; more
ranks run on CPU groups:

  torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.train \\
      --smoke --steps 3 --device cpu --model-parallel 2

Same flags and printed lines as the reference, plus ``--device`` and
``--layers`` (a depth cut at full width, for archs whose whole state does
not fit one card: recurrentgemma-9b at 6 layers, rwkv6-7b at 8).

  PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b \\
      --reduce --steps 200 --batch 8 --seq 128
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import os
import tempfile
import time
from typing import Callable, Dict

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.dist import sharding as shd
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import build_model, reduced
from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import count_params, param_shapes
from repro_torch.training.data import DataConfig, batch_axes, host_batch
from repro_torch.training.ft import RunnerConfig, TrainingRunner
from repro_torch.training.optimizer import OptimizerConfig, opt_state_axes
from repro_torch.training.step import init_train_state, make_train_step


def train_100m_config(cfg: ModelConfig) -> ModelConfig:
    """~100M-param same-family config (CPU-trainable)."""
    return dataclasses.replace(
        reduced(cfg),
        num_layers=max(4, 2 * len(cfg.layer_pattern)),
        d_model=512, d_ff=1536,
        num_heads=8, num_kv_heads=min(cfg.num_kv_heads, 4), head_dim=64,
        vocab_size=32_768, rglru_d_rnn=512 if cfg.family == "hybrid" else 0,
        dtype="float32", param_dtype="float32")


def model_config(arch: str, *, reduce: bool = False, smoke: bool = False,
                 layers: int = 0) -> ModelConfig:
    """The config the flags ask for: ``--smoke`` the tiny one, ``--reduce``
    the ~100M one, else the published one; ``layers`` (``--layers``) above
    0 keeps its first that many layers at its width."""
    base = get_config(arch)
    cfg = reduced(base) if smoke else train_100m_config(base) if reduce else base
    return dataclasses.replace(cfg, num_layers=layers) if layers else cfg


def state_shardings(model, mesh, rules=shd.TRAIN_RULES) -> Dict:
    """The train state's placements on ``mesh`` (``{"params", "opt"}``)."""
    params, opt = init_train_state(build_model(model.cfg, "meta"), torch.Generator())
    p_axes = model.logical_axes()
    return {"params": shd.tree_shardings(params, p_axes, rules, mesh),
            "opt": shd.tree_shardings(opt, opt_state_axes(p_axes), rules, mesh)}


def make_init_state_fn(model, seed: int = 0, mesh=None, placements=None) -> Callable[[], Dict]:
    """→ the initial state from ``seed``; with ``mesh`` and ``placements``
    (``state_shardings``) laid out on the mesh, every rank keeping its
    block of the same numbers."""
    def init_state_fn():
        params, opt = init_train_state(model, torch.Generator(model.device).manual_seed(seed))
        state = {"params": params, "opt": opt}
        return state if mesh is None else shd.distribute_tree(state, placements, mesh)
    return init_state_fn


def _local(v):
    return v.full_tensor() if isinstance(v, DTensor) else v


def make_step_fn(model, opt_cfg: OptimizerConfig, data_cfg: DataConfig, *,
                 grad_accum: int = 1, remat: bool = True, mesh=None,
                 rules=shd.TRAIN_RULES) -> Callable:
    """→ step_fn(state, step) = (state, metrics as floats): step ``step``'s
    batch from the data pipeline through one train step; with ``mesh`` the
    batch sharded over the batch axes and the step under ``rules``."""
    train_step = make_train_step(model, opt_cfg, grad_accum=grad_accum, remat=remat)

    def step_fn(state, step):
        batch = host_batch(data_cfg, model.cfg, step)
        if mesh is None:
            params, opt, metrics = train_step(state["params"], state["opt"], batch)
        else:
            batch = {k: torch.as_tensor(v).to(model.device) for k, v in batch.items()}
            batch = shd.shard_tree(batch, batch_axes(batch), rules, mesh)
            with shd.activation_sharding(mesh, rules):
                params, opt, metrics = train_step(state["params"], state["opt"], batch)
        return {"params": params, "opt": opt}, {k: float(_local(v)) for k, v in metrics.items()}

    return step_fn



def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--reduce", action="store_true",
                    help="reduce to a ~100M-param config")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny smoke config (fastest)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_train_ckpt"))
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--layers", type=int, default=0,
                    help="keep the config's first N layers, at its width (0: all)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    world = (dist.get_world_size() if dist.is_initialized()
             else int(os.environ.get("WORLD_SIZE", 1)))
    if world == 1 and args.model_parallel == 1:
        _train(args, device, None)             # one device: no group, plain tensors
        return
    joined = dist.is_initialized()
    try:
        _train(args, device, make_host_mesh(args.model_parallel, device=args.device))
    finally:
        if not joined and dist.is_initialized():
            dist.destroy_process_group()


def _train(args, device, mesh) -> None:
    """Train on ``mesh`` (every rank), or with ``mesh`` None on one device."""
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    cfg = model_config(args.arch, reduce=args.reduce, smoke=args.smoke, layers=args.layers)
    model = build_model(cfg, device)
    opt_cfg = OptimizerConfig(learning_rate=args.lr,
                              warmup_steps=max(args.steps // 10, 1),
                              total_steps=args.steps)
    data_cfg = DataConfig(global_batch=args.batch, seq_len=args.seq)
    placements = state_shardings(model, mesh) if mesh is not None else None
    step_fn = make_step_fn(model, opt_cfg, data_cfg, grad_accum=args.grad_accum, mesh=mesh)
    rank0 = mesh is None or dist.get_rank() == 0

    n_params = count_params(param_shapes(model))
    if rank0:
        sizes = shd.mesh_sizes(mesh) if mesh is not None else {"data": 1, "model": 1}
        print(f"arch={cfg.name} params={n_params/1e6:.1f}M "
              f"devices={math.prod(sizes.values())} mesh={sizes}")

    runner = TrainingRunner(
        RunnerConfig(ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                     max_steps=args.steps),
        step_fn, make_init_state_fn(model, mesh=mesh, placements=placements),
        device=device, placements=placements, mesh=mesh)
    t0 = time.time()
    result = runner.run()
    dt = time.time() - t0
    if not rank0:
        return
    losses = [m["loss"] for m in result["metrics"] if "loss" in m]
    print(f"done: {result['final_step']} steps in {dt:.1f}s "
          f"({dt / max(len(losses), 1):.3f}s/step)")
    if losses:
        k = max(len(losses) // 10, 1)
        print(f"loss: first10={sum(losses[:k])/k:.4f} "
              f"last10={sum(losses[-k:])/k:.4f}")


if __name__ == "__main__":
    main()
