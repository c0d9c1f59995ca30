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
- ``collectives``: the five kinds of ``COLL_KINDS``, zero on one device.

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
from torch.utils._python_dispatch import TorchDispatchMode
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
               _aten.alias, _aten.lift_fresh}


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
    return (t for t in tree_leaves(tree) if isinstance(t, torch.Tensor))


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
        out = func(*args, **kwargs)
        packet = func._overloadpacket
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
             "collectives": {k: {"bytes": 0, "count": 0} for k in COLL_KINDS}}
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
