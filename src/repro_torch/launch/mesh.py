"""Device meshes, ported from ``repro.launch.mesh``.

The reference's production meshes are 256 TPU v5e chips, 16 × 16 with axes
("data", "model"), and two such pods, 2 × 16 × 16 ("pod", "data",
"model"): the pod axis extends data parallelism across the slower links
between pods, model parallelism stays inside a pod.  Here they are
``DeviceMesh``es over a *fake* process group of 256 or 512 ranks in this
one process (``torch.testing``'s ``FakeStore``): collectives on it move
nothing, which is all the dry-run's accounting on meta tensors needs
(``launch/dryrun.py``).  Nothing there runs on a device.

``make_host_mesh`` spans the real ranks: (world / mp, mp) over ("data",
"model"), on the card with ``nccl`` unless the caller passes
``device="cpu"`` (then ``gloo``).  Under a launcher (``torchrun``) it joins
the launcher's group; without one it forms a group of one from a
``FileStore`` under the temporary directory.  It never falls back to the
CPU: without a card and without ``device="cpu"`` it raises.
"""
from __future__ import annotations

import os
import tempfile

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch import resolve_device


# the fake world the accounting meshes take their ranks from: both
# production meshes fit, so one group serves every cell of a process
FAKE_WORLD = 512
_MESHES: dict = {}


def _fake_group() -> None:
    """The default group: a fake one of ``FAKE_WORLD`` ranks (this process
    is rank 0)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_backend() != "fake" or dist.get_world_size() != FAKE_WORLD:
            raise RuntimeError("an accounting mesh needs a process of its own; this one "
                               f"is in a {dist.get_backend()} group of "
                               f"{dist.get_world_size()}")
        return
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=FAKE_WORLD)


def make_accounting_mesh(shape, axes) -> DeviceMesh:
    """A mesh of ``shape`` over the first ranks of a fake group, for
    accounting only (a 1 × 1 mesh reproduces the one-device counts)."""
    key = (tuple(shape), tuple(axes))
    if key not in _MESHES:
        _fake_group()
        n = int(torch.tensor(shape).prod())
        _MESHES[key] = DeviceMesh("cpu", torch.arange(n).reshape(shape),
                                  mesh_dim_names=tuple(axes))
    return _MESHES[key]


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """16 × 16 ("data", "model"), or 2 × 16 × 16 ("pod", "data", "model")
    with ``multi_pod``, over a fake group: for accounting only."""
    if multi_pod:
        return make_accounting_mesh((2, 16, 16), ("pod", "data", "model"))
    return make_accounting_mesh((16, 16), ("data", "model"))


def release_fake_group() -> None:
    """Destroy the fake group and forget its meshes (a process that goes on
    to join a real group)."""
    _MESHES.clear()
    if dist.is_initialized() and dist.get_backend() == "fake":
        dist.destroy_process_group()


def _join(backend: str) -> None:
    if dist.is_initialized():
        return
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend)                     # the launcher's env://
        return
    fd, path = tempfile.mkstemp(prefix="repro_torch_store_")
    os.close(fd)
    os.unlink(path)
    dist.init_process_group(backend, store=dist.FileStore(path, 1), rank=0, world_size=1)


def make_host_mesh(model_parallel: int = 1, device=None) -> DeviceMesh:
    """A (world / model_parallel, model_parallel) mesh over every rank,
    axes ("data", "model"): the card and ``nccl`` unless ``device="cpu"``
    (``gloo``)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    _join("nccl" if dev.type == "cuda" else "gloo")
    n = dist.get_world_size()
    if n % model_parallel:
        raise ValueError(f"{n} ranks do not divide into model parallel {model_parallel}")
    return init_device_mesh(dev.type, (n // model_parallel, model_parallel),
                            mesh_dim_names=("data", "model"))
