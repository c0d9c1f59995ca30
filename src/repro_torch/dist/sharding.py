"""Logical-axis sharding rules → partition specs → DTensor placements,
ported from ``repro.dist.sharding``.

Model code names tensor dimensions with *logical* axes ("embed", "ffn",
"batch", ...); a rule set maps each logical axis to the mesh axes it may
shard over.  :func:`partition_spec` resolves the mapping against a mesh
with the reference's two safety nets:

  * divisibility fallback — a mesh axis that does not evenly divide the
    dimension is dropped (replicate rather than pad),
  * duplicate-axis avoidance — a mesh axis is consumed by the first
    dimension that claims it; later dimensions fall back to replication.

A spec has the reference's ``PartitionSpec`` entries as a tuple: per tensor
dimension ``None``, one mesh axis name or a tuple of names, trailing
``None``s dropped.  :func:`placements` turns it into one DTensor placement
per mesh dimension (``Shard(d)`` where tensor dim d takes that mesh axis,
else ``Replicate()``), which is how a ``torch.distributed`` mesh holds it.

A mesh here is a ``DeviceMesh`` with ``mesh_dim_names``, or an
:class:`AbstractMesh` (names and sizes only), on which the specs and
:func:`bytes_per_device` run without a process group, as the reference's
``AbstractMesh`` does.

Rule sets are plain dicts so callers can derive variants with ``dict(...)``;
boolean entries ("moe_seq", "moe_ep_local") act as mode flags read by the
MoE dispatch code (``models/moe.py``), not as tensor axes.

The activation context (:func:`set_activation_sharding`) is the
counterpart of the reference's ``with_sharding_constraint`` points: with a
mesh set, :func:`constrain_act` redistributes a DTensor activation to the
placements its logical axes resolve to; with none it returns ``x`` itself.
"""
from __future__ import annotations

import contextlib
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves, tree_map

Rules = Dict[str, Any]
Spec = Tuple[Any, ...]


class AbstractMesh:
    """Mesh axis names and sizes, with no devices: ``shape`` maps each
    name to its size, in order, as the reference's ``mesh.shape`` does."""

    def __init__(self, axis_sizes: Sequence[int], axis_names: Sequence[str]):
        if len(axis_sizes) != len(axis_names):
            raise ValueError(f"{tuple(axis_sizes)} sizes for axes {tuple(axis_names)}")
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in axis_sizes)))

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def __repr__(self) -> str:
        return f"AbstractMesh({self.shape})"


def abstract_mesh(axis_sizes: Sequence[int], axis_names: Sequence[str]) -> AbstractMesh:
    return AbstractMesh(axis_sizes, axis_names)


def mesh_sizes(mesh) -> Dict[str, int]:
    """{axis name: size}, in the mesh's order, of an :class:`AbstractMesh`
    or a named ``DeviceMesh``."""
    if isinstance(mesh, AbstractMesh):
        return dict(mesh.shape)
    names = mesh.mesh_dim_names
    if names is None:
        raise ValueError("a DeviceMesh used with sharding rules needs mesh_dim_names")
    return dict(zip(names, mesh.shape))


def _rules(**overrides) -> Rules:
    base: Dict[str, Any] = {
        "batch": ["pod", "data"],
        "seq": [],
        "kv": ["model"],
        "embed": ["data"],
        "act_embed": [],
        "vocab": ["model"],
        "ffn": ["model"],
        "heads": ["model"],
        "kv_heads": ["model"],
        "head_dim": [],
        "embed_out": ["model"],
        "rnn": ["model"],
        "rnn_in": [],
        "expert": ["model"],
    }
    base.update(overrides)
    return base


# FSDP-style training: params sharded over data, contracted dims over model.
TRAIN_RULES: Rules = _rules()

# Serving default: same layout, single-pod batch.
SERVE_RULES: Rules = _rules(batch=["data"])

# Pure tensor-parallel serving: weights replicated over data, TP over model,
# kv cache sharded by heads rather than sequence.
SERVE_TP_RULES: Rules = _rules(batch=["data"], embed=[], kv=[])

# MoE variants (consumed by launch.dryrun / moe.moe_apply mode selection):
# experts sharded over model (GSPMD dispatch).
MOE_EP_RULES: Rules = _rules(expert=["model"], ffn=["model"])
# experts over model with local dispatch — one all-reduce per layer.
MOE_EP_LOCAL_RULES: Rules = _rules(expert=["model"], moe_ep_local=True)
# whole MoE block local per batch shard; expert weights replicated.
MOE_LOCAL_RULES: Rules = _rules(ffn=[], expert=[], heads=[], kv_heads=[],
                                embed=[], embed_out=[], vocab=[], kv=[],
                                rnn=[])
# local MoE + sequence-partitioned dispatch over the model axis.
MOE_SP_RULES: Rules = dict(MOE_LOCAL_RULES, moe_seq=True)
# sequence-partitioned MoE dispatch + tensor-parallel dense layers.
MOE_SP_TP_RULES: Rules = dict(MOE_LOCAL_RULES, moe_seq=True,
                              heads=["model"], kv_heads=["model"],
                              embed_out=["model"], vocab=["model"],
                              rnn=["model"])

# the dry-run's names for the rule sets ("default": each cell kind's own)
RULE_SETS: Dict[str, Optional[Rules]] = {
    "default": None,
    "tp": SERVE_TP_RULES,
    "ep": MOE_EP_RULES,
    "moe_local": MOE_LOCAL_RULES,
    "moe_sp": MOE_SP_RULES,
    "moe_sp_tp": MOE_SP_TP_RULES,
    "ep_local": MOE_EP_LOCAL_RULES,
}


def partition_spec(shape: Sequence[int], axes: Sequence[Optional[str]],
                   rules: Rules, mesh) -> Spec:
    """Resolve logical ``axes`` for ``shape`` into a spec (see the module
    docstring)."""
    if len(shape) != len(axes):
        raise ValueError(f"rank mismatch: shape {tuple(shape)} "
                         f"vs logical axes {tuple(axes)}")
    sizes = mesh_sizes(mesh)
    used: set = set()
    entries: List[Any] = []
    for dim, ax in zip(shape, axes):
        chosen: List[str] = []
        factor = 1
        wanted = rules.get(ax, ()) if ax else ()
        for a in wanted:
            if a not in sizes or a in used or a in chosen:
                continue
            if dim % (factor * sizes[a]) == 0:
                chosen.append(a)
                factor *= sizes[a]
        used.update(chosen)
        entries.append(None if not chosen else
                       chosen[0] if len(chosen) == 1 else tuple(chosen))
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)


def _entry_axes(entry) -> Tuple[str, ...]:
    return () if entry is None else (entry,) if isinstance(entry, str) else tuple(entry)


def placements(spec: Spec, mesh) -> Tuple[Any, ...]:
    """One DTensor placement per mesh dimension: ``Shard(d)`` on each mesh
    axis that tensor dim d's entry names (a dim over two axes is sharded on
    both, outer axis first, which is the spec's order for every rule set
    here), ``Replicate()`` on the others and on axes of size 1 (the same
    layout)."""
    owner = {a: d for d, entry in enumerate(spec) for a in _entry_axes(entry)}
    names = list(mesh_sizes(mesh))
    for d, entry in enumerate(spec):
        order = [names.index(a) for a in _entry_axes(entry)]
        if order != sorted(order):
            raise ValueError(f"spec {spec}: dim {d} takes mesh axes out of the mesh's order")
    sizes = mesh_sizes(mesh)
    return tuple(Shard(owner[a]) if a in owner and sizes[a] > 1 else Replicate()
                 for a in names)


def shard_factor(spec: Spec, mesh) -> int:
    """The number of blocks ``spec`` cuts a tensor into on ``mesh``."""
    sizes = mesh_sizes(mesh)
    return math.prod(sizes[a] for entry in spec for a in _entry_axes(entry))


# ---- trees (nested dicts, as the port's parameter and cache trees) ---------
def _tree_map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def _axes_along(tree, axes_tree):
    """``axes_tree`` spread over ``tree``'s structure: an axes leaf (a tuple,
    or None for replicated) stands for every leaf beneath it."""
    if isinstance(tree, dict):
        if axes_tree is None:
            return {k: _axes_along(v, None) for k, v in tree.items()}
        if set(tree) != set(axes_tree):
            raise ValueError(f"tree keys {sorted(tree)} vs axes keys {sorted(axes_tree)}")
        return {k: _axes_along(v, axes_tree[k]) for k, v in tree.items()}
    return axes_tree


def tree_partition_specs(shape_tree, axes_tree, rules: Rules, mesh):
    """A tree of tensors (or anything with ``.shape``) and its logical axes
    → the tree of specs; a ``None`` axes leaf replicates."""
    def spec(s, a):
        shape = tuple(s.shape)
        return partition_spec(shape, a if a is not None else (None,) * len(shape),
                              rules, mesh)
    return _tree_map(spec, shape_tree, _axes_along(shape_tree, axes_tree))


def tree_shardings(shape_tree, axes_tree, rules: Rules, mesh):
    """The tree of placements (one per mesh dimension) for each leaf: the
    counterpart of the reference's tree of ``NamedSharding``s."""
    specs = tree_partition_specs(shape_tree, axes_tree, rules, mesh)
    return _tree_map(lambda s: placements(s, mesh), specs)


def distribute(t: torch.Tensor, mesh, place) -> torch.Tensor:
    """``t`` (the whole tensor, the same on every rank) as a DTensor with
    ``place``: each rank keeps its block, nothing is sent.  A meta tensor
    becomes a DTensor over a meta block of the local shape (nothing is
    allocated), so the fake production meshes take it too."""
    from torch.distributed.tensor import distribute_tensor
    if all(p == Replicate() for p in place):            # no copy
        return DTensor.from_local(t, mesh, place, run_check=False)
    if t.is_meta:
        shape = list(t.shape)
        for mesh_dim, p in enumerate(place):
            if isinstance(p, Shard):
                shape[p.dim] //= mesh.shape[mesh_dim]
        local = torch.empty(shape, dtype=t.dtype, device="meta")
        return DTensor.from_local(local, mesh, place, run_check=False,
                                  shape=t.shape, stride=t.stride())
    return distribute_tensor(t, mesh, place, src_data_rank=None)


def distribute_tree(tree, shardings, mesh):
    """Every leaf of ``tree`` placed by the same leaf of ``shardings``
    (``tree_shardings``'s tree)."""
    return _tree_map(lambda t, p: distribute(t, mesh, p), tree, shardings)


def shard_tree(tree, axes_tree, rules: Rules, mesh):
    """``tree`` placed on ``mesh`` by its logical axes under ``rules``."""
    return distribute_tree(tree, tree_shardings(tree, axes_tree, rules, mesh), mesh)


def bytes_per_device(shape_tree, spec_tree, mesh) -> int:
    """Total per-device bytes of a tree of tensors (or of objects with
    ``shape`` and ``dtype``) laid out by ``spec_tree``."""
    total = 0

    def add(s, spec):
        nonlocal total
        total += math.prod(int(d) for d in s.shape) * s.dtype.itemsize // shard_factor(spec, mesh)

    _tree_map(add, shape_tree, spec_tree)
    return total


# ---- local computation on the shards (the counterpart of shard_map) --------
def as_dtensor(t, mesh):
    """``t`` as a DTensor on ``mesh``: a plain tensor (the same on every
    rank) counts as replicated; None and DTensors pass."""
    if t is None or isinstance(t, DTensor):
        return t
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)


def local_call(fn, mesh, args, in_pl, out_pl, grad_pl=None):
    """``fn`` on the local blocks of ``args`` (tensors or None), each first
    redistributed to its placements in ``in_pl``; the outputs (one, or a
    tuple) come back as DTensors placed by ``out_pl`` (one placements tuple,
    or a tuple of them).  The inputs' gradients are placed by ``grad_pl``,
    by default as ``in_pl`` but a partial sum on each mesh dim where the
    input is replicated and another input is sharded: each rank then used
    it with other data, and the gradient is the sum of theirs.  This is
    ``local_map``, the counterpart of the reference's ``shard_map``."""
    from torch.distributed.tensor.experimental import local_map
    live = [i for i, a in enumerate(args) if a is not None]
    if grad_pl is None:
        cut = [any(isinstance(in_pl[j][i], Shard) for j in live) for i in range(mesh.ndim)]
        grad_pl = [tuple(Partial() if p == Replicate() and cut[i] else p
                         for i, p in enumerate(in_pl[j])) if j in live else None
                   for j in range(len(args))]

    def local(*xs):
        full = [None] * len(args)
        for i, x in zip(live, xs):
            full[i] = x
        return fn(*full)

    # local_map reads a tuple as one entry per output and a list as one
    # tensor's placements
    out_pl = (tuple(list(p) for p in out_pl) if isinstance(out_pl[0], tuple)
              else list(out_pl))
    return local_map(local, out_placements=out_pl,
                     in_placements=tuple(list(in_pl[i]) for i in live),
                     in_grad_placements=tuple(list(grad_pl[i]) for i in live),
                     device_mesh=mesh, redistribute_inputs=True)(
        *(as_dtensor(args[i], mesh) for i in live))


def pointwise(fn, x):
    """``fn`` (elementwise) on a DTensor's local block, placements kept
    (for ops DTensor has no sharding rule for); ``fn(x)`` otherwise."""
    if not isinstance(x, DTensor):
        return fn(x)
    pl = tuple(Replicate() if isinstance(p, Partial) else p for p in x.placements)
    return local_call(fn, x.device_mesh, (x,), (pl,), pl)


def split_last(y, sizes: Tuple[int, int]):
    """``y.view(*y.shape[:-1], *sizes)``.  A DTensor is viewed block by
    block: its last dim stays sharded where the mesh axes divide
    ``sizes[0]`` (heads), and is gathered first where they do not (8 heads
    of a projection on 16 ranks), which DTensor's view rule does not do by
    itself; the local view's backward then reshapes the local gradient,
    whatever its strides."""
    if not isinstance(y, DTensor):
        return y.view(*y.shape[:-1], *sizes)
    mesh, last = y.device_mesh, Shard(y.ndim - 1)
    cut = [i for i, p in enumerate(y.placements) if p == last]
    keep = not cut or sizes[0] % math.prod(mesh.size(i) for i in cut) == 0
    pl = tuple(Replicate() if isinstance(p, Partial) or (p == last and not keep) else p
               for p in y.placements)
    return local_call(lambda t: t.view(*t.shape[:-1], -1, sizes[1]), mesh, (y,), (pl,), pl)


def merge_dims(t, d: int):
    """``t`` with dims d and d + 1 merged (a reshape).  A DTensor is
    reshaped block by block: dim d stays sharded, dim d + 1 is gathered
    first if sharded, later dims shift down one."""
    shape = (*t.shape[:d], -1, *t.shape[d + 2:])
    if not isinstance(t, DTensor):
        return t.reshape(shape)
    pl_in = tuple(Replicate() if p == Shard(d + 1) else p for p in t.placements)
    pl_out = tuple(Shard(p.dim - 1) if isinstance(p, Shard) and p.dim > d + 1 else p
                   for p in pl_in)
    return local_call(lambda x: x.reshape(*x.shape[:d], -1, *x.shape[d + 2:]),
                      t.device_mesh, (t,), (pl_in,), pl_out)


def embed_lookup(table, tokens):
    """``table[tokens]``: rows of a (V, D) table.  On DTensors it runs on
    the local blocks: the table gathered but for its vocab shards, the
    tokens kept in their batch shards; with the vocab sharded each rank
    looks up the tokens in its slice and the rows are summed over the
    slices (a partial sum), as XLA partitions the reference's gather."""
    if not isinstance(table, DTensor):
        return table[tokens]
    mesh = table.device_mesh
    tokens = as_dtensor(tokens, mesh)
    tok = tuple(p if p == Shard(0) else Replicate() for p in tokens.placements)
    vocab = [i for i, p in enumerate(table.placements) if p == Shard(0) and tok[i] != Shard(0)]
    tab = tuple(Shard(0) if i in vocab else Replicate() for i in range(mesh.ndim))
    out = tuple(Partial() if i in vocab else tok[i] for i in range(mesh.ndim))

    def local(t, ids):
        if not vocab:
            return t[ids]
        n = t.shape[0]
        idx = ids - coordinate(mesh, vocab) * n
        mine = (idx >= 0) & (idx < n)
        return torch.where(mine[..., None], t[idx.clamp(0, n - 1)], 0)

    return local_call(local, mesh, (table, tokens), (tab, tok), out)


def take_rows(x, idx):
    """``x[arange(B), idx]``: row b's entry ``idx[b]`` along dim 1.  A
    DTensor is indexed block by block, its batch shards kept and dim 1
    gathered."""
    if not isinstance(x, DTensor):
        return x[torch.arange(x.shape[0], device=x.device), idx]
    rows = tuple(p if p == Shard(0) else Replicate() for p in x.placements)
    return local_call(lambda t, i: t[torch.arange(t.shape[0], device=t.device), i],
                      x.device_mesh, (x, idx), (rows, rows), rows)


def coordinate(mesh, dims) -> int:
    """This rank's index among the blocks that mesh dims ``dims`` cut, the
    first dim outermost (DTensor's order for a dim sharded on several)."""
    r = 0
    for i in dims:
        r = r * mesh.size(i) + mesh.get_local_rank(i)
    return r


# ---- cache writes, in place; under a mesh into each rank's own block -------
# A DTensor cache is written through its local block: DTensor takes no
# in-place write into a slice of a sharded dim, and a cache sharded on its
# slots (the "kv" axis) has each rank hold W/m of them.  The written values
# come gathered over the slot axis and each rank keeps what falls in its
# slots.
def _local_src(src, dst, dims: Dict[int, int]):
    """``src`` laid out as ``dst`` is, through ``dims`` (dst dim → src dim;
    a dst dim not in it, or dst's slot dim 1, is gathered), as its local
    block."""
    mesh = dst.device_mesh
    src = as_dtensor(src, mesh)
    want = [Shard(dims[p.dim]) if isinstance(p, Shard) and p.dim != 1 and p.dim in dims
            else Replicate() for p in dst.placements]
    return src.redistribute(mesh, want).to_local()


def _first_slot(dst) -> int:
    """The first slot (dim 1) of this rank's block of ``dst``."""
    dims = [i for i, p in enumerate(dst.placements) if p == Shard(1)]
    return coordinate(dst.device_mesh, dims) * dst.to_local().shape[1]


def copy_into(dst, src) -> None:
    """``dst.copy_(src)``."""
    if not isinstance(dst, DTensor):
        dst.copy_(src.full_tensor() if isinstance(src, DTensor) else src)
        return
    mesh = dst.device_mesh
    dst.to_local().copy_(as_dtensor(src, mesh).redistribute(mesh, dst.placements).to_local())


def set_prefix(dst, src) -> None:
    """``dst[:, :S] = src`` with S = src.shape[1]."""
    S = src.shape[1]
    if not isinstance(dst, DTensor):
        dst[:, :S] = src
        return
    loc, s0 = dst.to_local(), _first_slot(dst)
    src = _local_src(src, dst, {d: d for d in range(dst.ndim)})
    if loc.shape[1] == dst.shape[1]:              # the slots are not sharded
        loc[:, :S] = src
        return
    hi = min(S, s0 + loc.shape[1])
    if hi > s0:
        loc[:, :hi - s0] = src[:, s0:hi]


def set_rows(dst, b, slot, val, keep=None) -> None:
    """``dst[b, slot[b]] = val[b]`` for every row b (``b`` = arange(B);
    where ``keep[b]``, if given; elsewhere the slot keeps its value)."""
    if not isinstance(dst, DTensor):
        dst[b, slot] = val if keep is None else torch.where(
            keep.view(-1, *[1] * (val.dim() - 1)), val, dst[b, slot])
        return
    loc, s0 = dst.to_local(), _first_slot(dst)
    rows = {0: 0, **{d: d - 1 for d in range(2, dst.ndim)}}
    val = _local_src(val, dst, rows)
    slot = _local_src(slot, dst, {0: 0})
    keep = None if keep is None else _local_src(keep, dst, {0: 0})
    if loc.shape[0] != b.shape[0]:
        b = torch.arange(loc.shape[0], device=loc.device)
    if loc.shape[1] == dst.shape[1]:              # the slots are not sharded
        set_rows(loc, b, slot, val, keep)
        return
    mine = (slot >= s0) & (slot < s0 + loc.shape[1])
    if keep is not None:
        mine &= keep
    idx = (slot - s0).clamp(0, loc.shape[1] - 1)
    loc[b, idx] = torch.where(mine.view(-1, *[1] * (val.dim() - 1)), val, loc[b, idx])


# ---- partial sums meeting shards -------------------------------------------
class _SettlePartials(TorchDispatchMode):
    """Before an op on DTensors, an operand that is a partial sum on a mesh
    dim where another operand is sharded is reduced on that dim first
    (all-reduce).  DTensor would otherwise turn the shard into a partial
    sum, which not every torch version can (a backward adds such
    gradients)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        dts = ([t for t in tree_leaves((args, kwargs)) if isinstance(t, DTensor)]
               if any(issubclass(t, DTensor) for t in types) else [])
        dims = [i for i in range(dts[0].device_mesh.ndim)
                if any(t.placements[i].is_partial() for t in dts)
                and any(t.placements[i].is_shard() for t in dts)] if len(dts) > 1 else []
        if dims:
            mutated = args[0] if func._schema.is_mutable and args else None

            def settle(t):
                if (not isinstance(t, DTensor) or t is mutated
                        or not any(t.placements[i].is_partial() for i in dims)):
                    return t
                with torch.no_grad():   # below autograd: no graph to record
                    return t.detach().redistribute(t.device_mesh, [
                        Replicate() if i in dims and p.is_partial() else p
                        for i, p in enumerate(t.placements)])

            args, kwargs = tree_map(settle, (args, kwargs))
        return func(*args, **kwargs)


# ---- activation sharding context -------------------------------------------
# One-element cell read at call time; (mesh, rules) or None.
_ACT_CTX: List[Optional[Tuple[Any, Rules]]] = [None]


def set_activation_sharding(mesh, rules: Optional[Rules]) -> None:
    _ACT_CTX[0] = None if mesh is None else (mesh, rules)


@contextlib.contextmanager
def activation_sharding(mesh, rules: Optional[Rules]):
    """``set_activation_sharding`` for the duration of a block, in which a
    plain tensor meeting a DTensor (positions, masks, constants) counts as
    replicated on the mesh."""
    from torch.distributed.tensor.experimental import implicit_replication
    prev = _ACT_CTX[0]
    set_activation_sharding(mesh, rules)
    try:
        with implicit_replication(), _SettlePartials():
            yield
    finally:
        _ACT_CTX[0] = prev


def constrain_act(x, *axes: Optional[str]):
    """With a context active and ``x`` a DTensor on its mesh, ``x``
    redistributed to the placements of its logical ``axes`` (the
    counterpart of ``with_sharding_constraint``); else ``x`` itself."""
    ctx = _ACT_CTX[0]
    if ctx is None:
        return x
    if not isinstance(x, DTensor):
        return x
    mesh, rules = ctx
    want = placements(partition_spec(tuple(x.shape), axes, rules, mesh), mesh)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(mesh, want)


def constrain_attn_q(q):
    """q: (B, S, H, hd)."""
    return constrain_act(q, "batch", "seq", "heads", "head_dim")
