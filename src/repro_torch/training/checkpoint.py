"""Atomic, async-capable checkpoints, ported from
``repro.training.checkpoint``.

Layout (one directory per step), the reference's:
    step_00000100.tmp/ → rename → step_00000100/
        manifest.json            key paths, shapes, dtypes, step
        shard_<host>_<i>.npz     this host's leaves, ``leaf_%05d``

Leaves are flattened in the order ``jax.tree_util`` gives a nested dict
(keys sorted), so a checkpoint the reference wrote loads into the port's
tree, and the manifest stores each leaf's key path where the reference
stores its serialized treedef.  numpy has no bfloat16: a bf16 leaf is
stored as its uint16 bits with ``"bfloat16"`` in the manifest.  Restore
puts the leaves on a device (``device=``).

Under a device mesh the leaves are DTensors: ``save`` writes each whole
(``full_tensor()``, gathered on every rank, written by rank 0 alone), as
the reference writes whole numpy leaves, and ``restore(..., placements=,
mesh=)`` places them on a target mesh that may differ from the writer's
(the reference's elastic resharding).  Every rank calls ``save`` and
``restore``; the ranks share the checkpoint directory.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.training.tree import flatten, tree_map, unflatten


def _writer() -> bool:
    """This process writes checkpoints: rank 0, or the only process."""
    return not dist.is_initialized() or dist.get_rank() == 0


def _whole(leaf):
    """A DTensor leaf gathered whole (a collective: every rank calls it)."""
    return leaf.full_tensor() if isinstance(leaf, DTensor) else leaf


def _key_str(i: int) -> str:
    return f"leaf_{i:05d}"


def _to_numpy(leaf) -> Tuple[np.ndarray, str]:
    """A leaf on the host and its dtype's name; a bf16 tensor as its uint16
    bits, named ``"bfloat16"``."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        leaf = t.numpy()
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _to_tensor(arr: np.ndarray, dtype: str, device) -> torch.Tensor:
    arr = np.array(arr, order="C")      # writable, contiguous, 0-d kept
    if dtype == "bfloat16":  # uint16 bits, or the reference's ml_dtypes bytes
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device) if device is not None else t


def save(ckpt_dir: str, step: int, tree: Any, *, host_id: int = 0) -> Path:
    """Synchronous save with atomic rename."""
    items = [(path, _whole(leaf)) for path, leaf in flatten(tree)]
    final = Path(ckpt_dir) / f"step_{step:08d}"
    if not _writer():
        return final
    tmp = Path(str(final) + ".tmp")
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    arrays: Dict[str, np.ndarray] = {}
    dtypes = []
    for i, (_, leaf) in enumerate(items):
        arrays[_key_str(i)], dtype = _to_numpy(leaf)
        dtypes.append(dtype)
    np.savez(tmp / f"shard_{host_id:04d}_0.npz", **arrays)
    manifest = {
        "step": step,
        "n_leaves": len(items),
        "shapes": [list(a.shape) for a in arrays.values()],
        "dtypes": dtypes,
        "paths": [list(path) for path, _ in items],
    }
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    if final.exists():
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


class AsyncCheckpointer:
    """Snapshot on the main thread (a copy on the host), write in the
    background: the training loop overlaps the next step with the I/O, and
    may update its tensors in place meanwhile."""

    def __init__(self, ckpt_dir: str):
        self.ckpt_dir = ckpt_dir
        self._thread: Optional[threading.Thread] = None

    def save(self, step: int, tree: Any) -> None:
        self.wait()
        whole = tree_map(_whole, tree)
        if not _writer():
            return
        snapshot = tree_map(lambda x: x.detach().to("cpu", copy=True)
                            if isinstance(x, torch.Tensor) else np.array(x), whole)
        self._thread = threading.Thread(
            target=save, args=(self.ckpt_dir, step, snapshot), daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None


def latest_step(ckpt_dir: str) -> Optional[int]:
    root = Path(ckpt_dir)
    if not root.exists():
        return None
    steps = [int(p.name.split("_")[1]) for p in root.glob("step_*")
             if not p.name.endswith(".tmp")]
    return max(steps) if steps else None


def restore(ckpt_dir: str, *, step: Optional[int] = None, target: Optional[Any] = None,
            device=None, placements: Optional[Any] = None,
            mesh=None) -> Tuple[int, Any]:
    """Restore a checkpoint → (step, tree of tensors).

    ``target`` (a tree of the same structure) supplies the key paths; without
    it the manifest's are used (a checkpoint the reference wrote has none, so
    it needs ``target``).  Leaves go to ``device``, or else to the target's
    leaves' devices, or stay on the CPU.  With ``placements`` (a tree of the
    same structure, ``dist.sharding.tree_shardings``'s) and ``mesh`` each
    leaf becomes a DTensor on ``mesh``, each rank keeping its block."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    final = Path(ckpt_dir) / f"step_{step:08d}"
    manifest = json.loads((final / "manifest.json").read_text())
    data: Dict[str, np.ndarray] = {}
    for shard_file in sorted(final.glob("shard_*.npz")):
        with np.load(shard_file) as z:
            for k in z.files:
                data[k] = z[k]
    n = manifest["n_leaves"]
    if target is not None:
        slots = flatten(target)
        if len(slots) != n:
            raise ValueError(f"{final}: {n} leaves, the target has {len(slots)}")
        paths = [path for path, _ in slots]
        devices = [device if device is not None else
                   leaf.device if isinstance(leaf, torch.Tensor) else None
                   for _, leaf in slots]
    else:
        paths = [tuple(p) for p in manifest["paths"]]
        devices = [device] * n
    leaves = [_to_tensor(data[_key_str(i)], manifest["dtypes"][i], devices[i])
              for i in range(n)]
    if placements is not None:
        from repro_torch.dist.sharding import distribute
        places = [place for _, place in flatten(placements)]
        leaves = [distribute(t.to(mesh.device_type), mesh, place)
                  for t, place in zip(leaves, places)]
    return step, unflatten(zip(paths, leaves))


def cleanup(ckpt_dir: str, keep: int = 3) -> None:
    """Retain only the newest ``keep`` checkpoints (GC for long runs)."""
    root = Path(ckpt_dir)
    if not _writer() or not root.exists():
        return
    steps = sorted(p for p in root.glob("step_*") if not p.name.endswith(".tmp"))
    for p in steps[:-keep]:
        shutil.rmtree(p)
