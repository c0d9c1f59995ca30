"""The port's sharding rules against the JAX package's (one process, no
process group for the specs; a fake one for the cells).

``repro_torch.dist.sharding.partition_spec`` must give the reference's
``PartitionSpec`` entries for every case of ``tests/test_sharding.py`` and
for hypothesis draws (as ``tests/test_property.py``); the models' logical
axes trees, the optimizer state's, and the per-device bytes of every
catalog arch's full-size parameter, optimizer and cache trees must equal
the reference's on both production meshes under every rule set (the MoE
rule sets on the two MoE archs).  A cell built on a fake 16 × 16 mesh must
hold the reference's per-device bytes, and one built on a fake 1 × 1 mesh
must count what the one-device cell counts, digit for digit.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.dist import sharding as ref_shd  # noqa: E402
from repro.models import build_model as ref_build_model  # noqa: E402
from repro.training.optimizer import opt_state_axes as ref_opt_state_axes  # noqa: E402
from repro.training.step import init_train_state as ref_init_train_state  # noqa: E402
from repro_torch.configs import ARCHS, ShapeSpec, get_config  # noqa: E402
from repro_torch.dist import sharding as shd  # noqa: E402
from repro_torch.launch import cells, costing  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.config import reduced  # noqa: E402
from repro_torch.training.optimizer import opt_state_axes  # noqa: E402
from repro_torch.training.step import init_train_state  # noqa: E402

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
RULES = {"train": "TRAIN_RULES", "serve": "SERVE_RULES", "tp": "SERVE_TP_RULES",
         "ep": "MOE_EP_RULES", "ep_local": "MOE_EP_LOCAL_RULES",
         "moe_local": "MOE_LOCAL_RULES", "moe_sp": "MOE_SP_RULES",
         "moe_sp_tp": "MOE_SP_TP_RULES"}
MOE_ONLY = ("ep", "ep_local", "moe_local", "moe_sp", "moe_sp_tp")
MOE_ARCHS = ("granite-moe-3b-a800m", "dbrx-132b")
CACHE_BS = (128, 32768)        # decode_32k's batch and cache slots


def _meshes(name):
    sizes, axes = MESHES[name]
    return shd.abstract_mesh(sizes, axes), ref_shd.abstract_mesh(sizes, axes)


def _both(shape, axes, rules="train", mesh="16x16"):
    ours, theirs = _meshes(mesh)
    got = shd.partition_spec(shape, axes, getattr(shd, RULES[rules]), ours)
    want = ref_shd.partition_spec(shape, axes, getattr(ref_shd, RULES[rules]), theirs)
    return got, tuple(want)


# every case of tests/test_sharding.py: (shape, axes, rules, mesh)
CASES = [((4096, 14336), ("embed", "ffn"), "train", "16x16"),
         ((2048, 4, 128), ("embed", "kv_heads", "head_dim"), "train", "16x16"),
         ((51865, 384), ("vocab", "embed"), "train", "16x16"),
         ((1024, 1024), ("ffn", "embed_out"), "train", "16x16"),
         ((256, 4096), ("batch", "seq"), "train", "2x16x16"),
         ((256, 4096), ("batch", "seq"), "train", "16x16"),
         ((1,), ("batch",), "train", "16x16"),
         ((26, 128, 32768, 4, 256), ("layers", "batch", "kv", "kv_heads", "head_dim"),
          "train", "16x16"),
         ((4096, 14336), ("embed", "ffn"), "train", "16x16"),
         ((14336,), ("ffn",), "train", "16x16"),
         ((16, 6144, 10752), ("expert", "embed", "ffn"), "ep", "16x16")]


@pytest.mark.parametrize("shape,axes,rules,mesh", CASES)
def test_partition_spec_matches_the_reference(shape, axes, rules, mesh):
    got, want = _both(shape, axes, rules, mesh)
    assert got == want


def test_rule_sets_are_the_reference_ones():
    for name in RULES.values():
        assert getattr(shd, name) == getattr(ref_shd, name)
    assert set(shd.RULE_SETS) == {"default", "tp", "ep", "moe_local", "moe_sp",
                                  "moe_sp_tp", "ep_local"}


def test_rank_mismatch_raises():
    with pytest.raises(ValueError):
        _both((4, 4), ("embed",))


def test_placements_shard_each_mesh_axis_on_its_dim():
    from torch.distributed.tensor import Replicate, Shard
    mesh = shd.abstract_mesh((2, 16, 16), ("pod", "data", "model"))
    assert shd.placements((("pod", "data"), None, "model"), mesh) == (
        Shard(0), Shard(0), Shard(2))
    assert shd.placements((), mesh) == (Replicate(),) * 3
    with pytest.raises(ValueError):
        shd.placements((("data", "pod"),), mesh)


try:
    from hypothesis import given, settings, strategies as st
except ImportError:          # gated as tests/conftest.py gates test_property.py
    given = None


def _property(fn):
    if given is None:
        return pytest.mark.skip(reason="hypothesis is not installed")(fn)
    return settings(max_examples=50, deadline=None)(given(
        st.lists(st.integers(1, 64), min_size=1, max_size=5),
        st.sampled_from(["embed", "ffn", "heads", "kv", "batch", "vocab"]))(fn))


@_property
def test_partition_spec_property_matches_the_reference(dims, ax):
    """tests/test_property.py's draws: the port's spec is the reference's,
    and divides every dim."""
    axes = tuple([ax] + [None] * (len(dims) - 1))
    ours, theirs = shd.abstract_mesh((4, 8), ("data", "model")), \
        ref_shd.abstract_mesh((4, 8), ("data", "model"))
    spec = shd.partition_spec(tuple(dims), axes, shd.TRAIN_RULES, ours)
    assert spec == tuple(ref_shd.partition_spec(tuple(dims), axes, ref_shd.TRAIN_RULES,
                                                theirs))
    for d, dim in enumerate(dims[:len(spec)]):
        assert dim % shd.shard_factor(spec[d:d + 1], ours) == 0


# ---- the models' axes trees and per-device bytes ----------------------------
def _ref_trees(arch):
    model = ref_build_model(ref_get_config(arch))
    params, opt = jax.eval_shape(lambda: ref_init_train_state(model, jax.random.key(0)))
    cache = jax.eval_shape(lambda: model.init_cache(*CACHE_BS, **(
        {"enc_len": CACHE_BS[1]} if model.cfg.is_encdec else {})))
    return model, params, opt, cache


def _trees(arch):
    model = build_model(get_config(arch), "meta")
    params, opt = init_train_state(model, torch.Generator())
    cache = model.init_cache(*CACHE_BS, **({"enc_len": CACHE_BS[1]}
                                           if model.cfg.is_encdec else {}))
    return model, params, opt, cache


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_axes_trees_and_bytes_per_device_match_the_reference(arch):
    model, params, opt, cache = _trees(arch)
    ref_model, ref_params, ref_opt, ref_cache = _ref_trees(arch)
    p_axes = model.logical_axes()
    assert p_axes == ref_model.logical_axes()
    assert model.cache_axes() == ref_model.cache_axes()
    assert opt_state_axes(p_axes) == ref_opt_state_axes(ref_model.logical_axes())
    trees = ((params, ref_params, p_axes), (opt, ref_opt, opt_state_axes(p_axes)),
             (cache, ref_cache, model.cache_axes()))
    rules = [r for r in RULES if arch in MOE_ARCHS or r not in MOE_ONLY]
    for mesh_name in MESHES:
        ours, theirs = _meshes(mesh_name)
        for r in rules:
            for tree, ref_tree, axes in trees:
                specs = shd.tree_partition_specs(tree, axes, getattr(shd, RULES[r]), ours)
                ref_specs = ref_shd.tree_partition_specs(
                    ref_tree, axes, getattr(ref_shd, RULES[r]), theirs)
                got = shd.bytes_per_device(tree, specs, ours)
                want = ref_shd.bytes_per_device(ref_tree, ref_specs, theirs)
                assert got == want, (mesh_name, r)


# ---- cells on fake meshes ----------------------------------------------------
@pytest.fixture(scope="module")
def fake_meshes():
    from repro_torch.launch.mesh import (make_accounting_mesh, make_production_mesh,
                                         release_fake_group)
    yield make_production_mesh, make_accounting_mesh
    release_fake_group()


@pytest.mark.parametrize("arch,shape", [("dbrx-132b", "train_4k"),
                                        ("gemma2-2b", "decode_32k"),
                                        ("whisper-tiny", "prefill_32k"),
                                        ("rwkv6-7b", "decode_32k")])
def test_cell_on_a_fake_mesh_holds_the_reference_bytes(arch, shape, fake_meshes):
    mesh = fake_meshes[0](multi_pod=False)
    cell = cells.build_cell(arch, shape, mesh)
    ref_model, ref_params, ref_opt, _ = _ref_trees(arch)
    abstract = ref_shd.abstract_mesh((16, 16), ("data", "model"))
    kind = cell.shape.kind
    rules = ref_shd.TRAIN_RULES if kind == "train" else ref_shd.SERVE_RULES
    if kind != "train":       # the serving cells' params are in the serve dtype
        from repro.serving.engine import serving_config
        ref_model = ref_build_model(serving_config(ref_get_config(arch)))
        ref_params = jax.eval_shape(lambda: ref_model.init(jax.random.key(0)))
    p_axes = ref_model.logical_axes()

    def per_device(tree, axes):
        return ref_shd.bytes_per_device(
            tree, ref_shd.tree_partition_specs(tree, axes, rules, abstract), abstract)

    assert cell.mem_info["params_bytes"] == per_device(ref_params, p_axes)
    if kind == "train":
        assert cell.mem_info["opt_bytes"] == per_device(ref_opt, ref_opt_state_axes(p_axes))
    else:
        B, S = cell.shape.global_batch, cell.shape.seq_len
        kw = {"enc_len": S} if ref_model.cfg.is_encdec else {}
        ref_cache = jax.eval_shape(lambda: ref_model.init_cache(B, S, **kw))
        assert cell.mem_info["cache_bytes"] == per_device(ref_cache, ref_model.cache_axes())
    # the operands the step gets are each device's blocks of those trees
    assert costing.storage_bytes(cell.args[0]) == cell.mem_info["params_bytes"]


ONE = {"gemma2-2b": {"num_layers": 2}, "granite-moe-3b-a800m": {"num_layers": 2},
       "recurrentgemma-9b": {"num_layers": 3}, "rwkv6-7b": {"num_layers": 2},
       "whisper-tiny": {"num_layers": 1, "encoder_layers": 1}}


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", sorted(ONE))
def test_one_by_one_fake_mesh_counts_what_one_device_counts(arch, kind, fake_meshes):
    """Every op is counted once, on the local blocks, and a 1 × 1 mesh
    issues no collective: the counts (FLOPs, bytes, transcendentals,
    collectives) and ``mem_info`` are the one-device cell's, digit for
    digit.  The live peak is not held here: DTensor's wrappers and
    ``local_map`` keep some local blocks alive for other spans than the
    plain tensors do."""
    mesh = fake_meshes[1]((1, 1), ("data", "model"))
    cfg = reduced(get_config(arch), **ONE[arch])
    shape = ShapeSpec("cell", 64, 4, kind)
    build = {"train": cells.build_train_cell, "prefill": cells.build_prefill_cell,
             "decode": cells.build_decode_cell}[kind]
    one = build(arch, shape, cfg=cfg)
    meshed = build(arch, shape, mesh, cfg=cfg)
    want = costing.count_costs(one.fn, *one.args)
    got = costing.count_costs(meshed.fn, *meshed.args)
    assert got == want
    assert meshed.mem_info == one.mem_info
    assert all(c == {"bytes": 0, "count": 0} for c in got["collectives"].values())

