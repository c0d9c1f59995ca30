"""Fault tolerance for long training runs, ported from ``repro.training.ft``.

``TrainingRunner`` wraps the step loop with
  · periodic async checkpoints + retention GC,
  · crash/restart recovery (resume from the latest checkpoint),
  · a straggler monitor — per-host step-time EWMA; hosts slower than
    ``threshold ×`` the fleet median are flagged, and the runner's policy
    hook decides,
  · failure injection for tests (deterministic, per step).
Recovery restores the state from the checkpoint's own key paths onto
``device``, or with ``placements`` and ``mesh`` (where the reference takes
``shardings``) onto that mesh; the failed state is dropped first, so the
card never holds two.  Under a mesh every rank runs the loop, and they meet
at a barrier before a restart reads the checkpoint rank 0 wrote.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.training import checkpoint as ckpt_lib


class SimulatedFailure(RuntimeError):
    pass


@dataclasses.dataclass
class StragglerMonitor:
    """EWMA per-host step times; flags hosts above threshold × median."""
    n_hosts: int
    alpha: float = 0.2
    threshold: float = 1.5

    def __post_init__(self):
        self.ewma = np.zeros(self.n_hosts)

    def record(self, host_times: List[float]) -> List[int]:
        t = np.asarray(host_times, dtype=float)
        self.ewma = np.where(self.ewma == 0, t,
                             (1 - self.alpha) * self.ewma + self.alpha * t)
        med = float(np.median(self.ewma))
        if med <= 0:
            return []
        return [i for i, v in enumerate(self.ewma) if v > self.threshold * med]


@dataclasses.dataclass
class RunnerConfig:
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_ckpt")
    ckpt_every: int = 50
    keep: int = 3
    max_steps: int = 200
    n_hosts: int = 1
    fail_at_step: Optional[int] = None     # failure injection (once)
    async_ckpt: bool = True


class TrainingRunner:
    """Checkpoint/restart training loop.

    step_fn(state, step) -> (state, metrics); state is a nested dict of
    tensors, restored onto ``device`` (the card unless the caller passes
    ``device="cpu"``).
    """

    def __init__(self, cfg: RunnerConfig, step_fn: Callable,
                 init_state_fn: Callable[[], Any], device=None,
                 on_straggler: Optional[Callable[[List[int]], None]] = None,
                 placements: Optional[Any] = None, mesh=None):
        self.cfg = cfg
        self.placements, self.mesh = placements, mesh
        self.step_fn = step_fn
        self.init_state_fn = init_state_fn
        self.device = resolve_device(device)
        self.monitor = StragglerMonitor(cfg.n_hosts)
        self.on_straggler = on_straggler or (lambda hosts: None)
        self.ckpt = ckpt_lib.AsyncCheckpointer(cfg.ckpt_dir)
        self._failed_once = False
        self.metrics_log: List[Dict] = []

    # ---- recovery ---------------------------------------------------------
    def _load_or_init(self):
        last = ckpt_lib.latest_step(self.cfg.ckpt_dir)
        if last is None:
            return 0, self.init_state_fn()
        return ckpt_lib.restore(self.cfg.ckpt_dir, step=last, device=self.device,
                                placements=self.placements, mesh=self.mesh)

    # ---- main loop ----------------------------------------------------------
    def run(self) -> Dict[str, Any]:
        start_step, state = self._load_or_init()
        restarts = 0
        step = start_step
        while step < self.cfg.max_steps:
            try:
                if (self.cfg.fail_at_step is not None
                        and step == self.cfg.fail_at_step
                        and not self._failed_once):
                    self._failed_once = True
                    raise SimulatedFailure(f"injected failure at step {step}")
                t0 = time.perf_counter()
                state, metrics = self.step_fn(state, step)
                dt = time.perf_counter() - t0
                stragglers = self.monitor.record(
                    [dt] * self.cfg.n_hosts)  # single-host: uniform
                if stragglers:
                    self.on_straggler(stragglers)
                step += 1
                self.metrics_log.append(dict(metrics, step=step, dt=dt))
                if step % self.cfg.ckpt_every == 0:
                    if self.cfg.async_ckpt:
                        self.ckpt.save(step, state)
                    else:
                        ckpt_lib.save(self.cfg.ckpt_dir, step, state)
                    ckpt_lib.cleanup(self.cfg.ckpt_dir, keep=self.cfg.keep)
            except SimulatedFailure:
                # crash/restart path: reload the latest durable checkpoint
                self.ckpt.wait()
                if dist.is_initialized():
                    dist.barrier()
                restarts += 1
                state = None
                step, state = self._load_or_init()
        self.ckpt.wait()
        ckpt_lib.save(self.cfg.ckpt_dir, step, state)
        return {"final_step": step, "restarts": restarts,
                "metrics": self.metrics_log}
