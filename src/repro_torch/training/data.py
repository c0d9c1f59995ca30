"""Deterministic synthetic data pipeline, ported from ``repro.training.data``.

Every (seed, step, host) triple maps to a unique, reproducible batch shard,
so restarts resume mid-stream with no state files, a different host count
re-partitions the same stream, and no host reads another's shard.  The
reference draws through ``jax.random``'s threefry with folded keys; the port
does not reimplement threefry.  It draws from a ``torch.Generator`` on the
CPU seeded from a SHA-256 digest of (seed, step, host_id) (as the generated
models seed, ``core.generator.seed_of``): the same stream in law — the
affine bigram x_{t+1} = (31·x_t + 17) mod V with 10% uniform flips and a
uniform x_0, the same keys, shapes and dtypes — but not the same numbers.
Tests that compare steps with the reference carry its batches across.
A background prefetch thread keeps ``depth`` batches ready.
"""
from __future__ import annotations

import dataclasses
import hashlib
import queue
import threading
from typing import Dict, Iterator

import numpy as np
import torch

from repro_torch.models.config import ModelConfig

A, C = 31, 17       # the bigram's affine map
FLIP = 0.1          # share of uniform noise tokens


@dataclasses.dataclass(frozen=True)
class DataConfig:
    global_batch: int = 32
    seq_len: int = 256
    seed: int = 1234
    n_hosts: int = 1
    host_id: int = 0


def _generator(*key: int) -> torch.Generator:
    digest = hashlib.sha256(repr(key).encode()).digest()
    return torch.Generator().manual_seed(int.from_bytes(digest[:8], "little"))


def _synthetic_tokens(gen: torch.Generator, b: int, seq: int, vocab: int) -> np.ndarray:
    """Learnable stream: a model that learns the bigram drives the loss
    well below log V, so training curves are meaningful → (b, seq + 1)."""
    x0 = torch.randint(0, vocab, (b,), generator=gen, dtype=torch.int64).numpy()
    noise = torch.randint(0, vocab, (seq, b), generator=gen, dtype=torch.int64).numpy()
    flip = (torch.rand((seq, b), generator=gen) < FLIP).numpy()
    toks = np.empty((seq + 1, b), np.int64)
    toks[0] = x = x0
    for t in range(seq):
        x = np.where(flip[t], noise[t], (A * x + C) % vocab)
        toks[t + 1] = x
    return toks.T.astype(np.int32)


# the reference's logical axes of a batch's leaves (``dist.sharding``); a
# leaf of fewer dims takes the leading ones
BATCH_AXES = {"tokens": ("batch", "seq"), "labels": ("batch", "seq"),
              "loss_mask": ("batch", "seq"), "lengths": ("batch",),
              "frames": ("batch", "seq", "act_embed"),
              "patches": ("batch", "seq", "act_embed")}


def batch_axes(batch) -> Dict[str, tuple]:
    """``BATCH_AXES`` for the leaves of ``batch``."""
    return {k: BATCH_AXES[k][:v.ndim] for k, v in batch.items()}


def host_batch(cfg: DataConfig, model_cfg: ModelConfig, step: int) -> Dict[str, np.ndarray]:
    """This host's shard of the global batch for ``step`` (pure function)."""
    assert cfg.global_batch % cfg.n_hosts == 0
    b = cfg.global_batch // cfg.n_hosts
    gen = _generator(cfg.seed, step, cfg.host_id)
    toks = _synthetic_tokens(gen, b, cfg.seq_len, model_cfg.vocab_size)
    batch = {
        "tokens": toks[:, :-1],
        "labels": toks[:, 1:],
        "loss_mask": np.ones((b, cfg.seq_len), np.float32),
    }
    if model_cfg.is_encdec:
        batch["frames"] = torch.randn((b, cfg.seq_len, model_cfg.d_model),
                                      generator=gen).numpy()
    if model_cfg.frontend == "vision_patches":
        batch["patches"] = torch.randn((b, model_cfg.num_frontend_tokens, model_cfg.d_model),
                                       generator=gen).numpy()
    return batch


class PrefetchingLoader:
    """Iterator with a background thread keeping ``depth`` batches ready."""

    def __init__(self, cfg: DataConfig, model_cfg: ModelConfig,
                 start_step: int = 0, depth: int = 2):
        self.cfg = cfg
        self.model_cfg = model_cfg
        self.step = start_step
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        s = self.step
        while not self._stop.is_set():
            batch = host_batch(self.cfg, self.model_cfg, s)
            while not self._stop.is_set():
                try:
                    self._q.put((s, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            s += 1

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        return self._q.get()

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2)
