"""The dry-run's cost pass: count a step on meta tensors, and extrapolate
two depths to the full one, ported from ``repro.launch.costing``.

The reference compiles a step and reads XLA's ``cost_analysis()``; here
:func:`count_costs` runs the step once on meta tensors, which allocate and
compute nothing, and counts what it dispatches:
- ``flops``: ``torch.utils.flop_counter.FlopCounterMode`` (matmul-like
  ops, and each kernel by its formula, ``kernels/costs.py``);
- ``bytes``: every op's tensor inputs read and outputs written, unfused
  (the counterpart of CPU-XLA's "bytes accessed"); views move nothing, and
  a kernel moves its formula's bytes;
- ``transcendentals``: the elements of exp, log, tanh, sigmoid, rsqrt and
  kin, and each kernel's formula;
- ``collectives``: the five kinds of ``COLL_KINDS``.  Under a device mesh
  the step runs on DTensors, whose collectives reach the counter as
  ``_c10d_functional`` ops on the local blocks: each is counted at its
  local result by the reference's ring model (``repro.analysis.hlo``, whose
  formulas are copied in :func:`collective_cost`).  Zero on one device.

Under a mesh every count is per device, each op counted once: an op on
DTensors is passed on (``NotImplemented``) to DTensor, whose work on the
local blocks comes back to the counter and is counted there; the
FakeTensor ops DTensor's sharding propagation runs on global shapes are
not counted.

:func:`count` also tracks the live bytes of the run: the storages the
operands and every op's outputs hold, each released when its last tensor
dies, as the card's allocator releases them, and each kernel's scratch
beside its outputs during its call (``kernels/meta.py``'s ``SCRATCH``).

The port's layers are a Python loop, not a scan, so a count at full depth
is already whole; the two-depth extrapolation stays, and gives the same
numbers.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Any, Callable, Dict, Iterable, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode, _disable_current_modes
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.kernels import meta as kernel_meta

# the port's copy of repro.analysis.hlo.COLLECTIVE_KINDS
COLL_KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
              "collective-permute")

_aten = torch.ops.aten
# one transcendental an output element
_TRANSCENDENTAL = {getattr(_aten, name) for name in (
    "exp", "exp_", "exp2", "expm1", "log", "log_", "log2", "log10", "log1p", "tanh",
    "tanh_", "sigmoid", "sigmoid_", "rsqrt", "rsqrt_", "sqrt", "sqrt_", "erf", "sin",
    "cos", "pow", "pow_", "_softmax", "_log_softmax", "silu", "silu_", "gelu",
    "silu_backward", "gelu_backward", "softplus", "_log_softmax_backward_data")}
# one transcendental an input element
_TRANSCENDENTAL_IN = {_aten.logsumexp}
# ops that read and write nothing
_NO_TRAFFIC = {_aten.empty, _aten.empty_like, _aten.empty_strided, _aten.detach,
               _aten.alias, _aten.lift_fresh, torch.ops._c10d_functional.wait_tensor,
               torch.ops._c10d_functional._wrap_tensor_autograd}
# _c10d_functional op → (collective kind, the argument holding the group size)
_COLLECTIVES = {"all_gather_into_tensor": ("all-gather", 1),
                "all_gather_into_tensor_coalesced": ("all-gather", 1),
                "all_reduce": ("all-reduce", None),
                "all_reduce_coalesced": ("all-reduce", None),
                "reduce_scatter_tensor": ("reduce-scatter", 2),
                "reduce_scatter_tensor_coalesced": ("reduce-scatter", 2),
                "all_to_all_single": ("all-to-all", None),
                "broadcast": ("collective-permute", None)}


def collective_cost(kind: str, result_bytes: float, group: int) -> float:
    """Per-device interconnect bytes of one collective by the reference's
    ring model (``repro.analysis.hlo.parse_collectives``), n the group size:
    all-gather ≈ result bytes (each device receives n−1 shards), all-reduce
    ≈ 2 × result bytes (reduce-scatter + all-gather), reduce-scatter ≈
    result bytes × n (the full operand streams through), all-to-all and
    permute ≈ result bytes."""
    if kind == "all-reduce":
        return 2 * result_bytes
    if kind == "reduce-scatter":
        return result_bytes * group
    return result_bytes


def _collective(func, args):
    """(kind, group size) of a ``_c10d_functional`` collective, else None."""
    ns, _, name = func._schema.name.partition("::")
    if not ns.startswith("_c10d_functional") or name not in _COLLECTIVES:
        return None
    kind, at = _COLLECTIVES[name]
    return kind, (args[at] if at is not None else 1)


def depth_variants(cfg):
    """Two depth-reduced cost configs + (n1, n_full) period counts."""
    pl_ = len(cfg.layer_pattern)
    if cfg.is_encdec:
        assert cfg.encoder_layers == cfg.num_layers, \
            "depth extrapolation assumes enc depth == dec depth"
        mk = lambda n: dataclasses.replace(cfg, num_layers=n,
                                           encoder_layers=n, cost_unroll=True)
        return mk(1), mk(2), 1, cfg.num_layers
    tail = cfg.num_layers % pl_
    mk = lambda L: dataclasses.replace(cfg, num_layers=L, cost_unroll=True)
    return (mk(pl_ + tail), mk(2 * pl_ + tail), 1, cfg.num_layers // pl_)


def _tensors(tree) -> Iterable[torch.Tensor]:
    """The tensors of ``tree``, a DTensor's local block in its place (what
    one device holds)."""
    return (t._local_tensor if isinstance(t, DTensor) else t
            for t in tree_leaves(tree) if isinstance(t, torch.Tensor))


def _nbytes(tree) -> float:
    return float(sum(t.numel() * t.element_size() for t in _tensors(tree)))


def storage_bytes(tree) -> int:
    """Bytes of the distinct storages the tensors of ``tree`` hold."""
    seen = {}
    for t in _tensors(tree):
        st = t.untyped_storage()
        seen[id(st)] = st.nbytes()
    return sum(seen.values())


def shared_bytes(tree, other) -> int:
    """Bytes of the distinct storages of ``tree`` that ``other`` holds too
    (outputs updated in place in their operands)."""
    ids = {id(t.untyped_storage()) for t in _tensors(other)}
    return storage_bytes([t for t in _tensors(tree) if id(t.untyped_storage()) in ids])


class _Counter(TorchDispatchMode):
    """Bytes, transcendentals and live bytes of every op dispatched."""

    def __init__(self):
        super().__init__()
        self.bytes = 0.0
        self.transcendentals = 0.0
        self.collectives = {k: {"bytes": 0, "count": 0} for k in COLL_KINDS}
        self.live = 0
        self.peak = 0
        self._held = WeakIdKeyDictionary()

    def _release(self, nbytes: int) -> None:
        self.live -= nbytes

    def hold(self, tree) -> None:
        for t in _tensors(tree):
            st = t.untyped_storage()
            if st in self._held:
                continue
            n = st.nbytes()
            self._held[st] = n
            weakref.finalize(st, self._release, n)
            self.live += n
        self.peak = max(self.peak, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented          # counted on the local blocks
        if any(issubclass(t, FakeTensor) for t in types):
            with _disable_current_modes():  # sharding propagation: not counted
                return func(*args, **kwargs)
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        coll = _collective(func, args)
        if coll is not None:
            kind, group = coll
            self.collectives[kind]["count"] += 1
            self.collectives[kind]["bytes"] += collective_cost(kind, _nbytes(out), group)
        if packet in kernel_meta.COSTS:
            cost = kernel_meta.COSTS[packet](*args, **kwargs)
            self.bytes += cost.bytes
            self.transcendentals += cost.transcendentals
        elif not (func.is_view or packet in _NO_TRAFFIC):
            self.bytes += _nbytes((args, kwargs)) + _nbytes(out)
            if packet in _TRANSCENDENTAL:
                self.transcendentals += sum(t.numel() for t in _tensors(out))
            elif packet in _TRANSCENDENTAL_IN:
                self.transcendentals += args[0].numel()
        self.hold(out)
        if packet in kernel_meta.SCRATCH:     # held beside the outputs during the call
            self.peak = max(self.peak, self.live + kernel_meta.SCRATCH[packet](*args, **kwargs))
        return out


def count(step: Callable, *args) -> Tuple[Any, Dict, int]:
    """Run ``step(*args)`` on meta tensors → (its outputs, the cost dict,
    the peak live bytes, the operands included)."""
    counter = _Counter()
    counter.hold(args)
    with FlopCounterMode(display=False) as flops, counter:
        out = step(*args)
    costs = {"flops": float(flops.get_total_flops()), "bytes": counter.bytes,
             "transcendentals": counter.transcendentals,
             "collectives": counter.collectives}
    return out, costs, counter.peak


def count_costs(step: Callable, *args) -> dict:
    """The counterpart of the reference's ``extract_costs(compiled)``: the
    cost dict of one run of ``step(*args)`` on meta tensors."""
    return count(step, *args)[1]


def extrapolate(c1: dict, c2: dict, n1: int, n_full: int) -> dict:
    """cost(d1) + (n_full − n1) · (cost(d2) − cost(d1)), clamped ≥ cost(d1)."""
    mult = n_full - n1

    def ext(a, b):
        return a + mult * max(b - a, 0.0)

    colls = {}
    for kind in COLL_KINDS:
        a = c1["collectives"].get(kind, {"bytes": 0, "count": 0})
        b = c2["collectives"].get(kind, {"bytes": 0, "count": 0})
        colls[kind] = {"bytes": ext(a["bytes"], b["bytes"]),
                       "count": ext(a["count"], b["count"])}
    return {
        "flops": ext(c1["flops"], c2["flops"]),
        "bytes": ext(c1["bytes"], c2["bytes"]),
        "transcendentals": ext(c1["transcendentals"], c2["transcendentals"]),
        "collectives": colls,
    }
