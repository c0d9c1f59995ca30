"""The port's distribution on CPU process groups: 4 ``gloo`` ranks against
the JAX package and against one rank.

The ranks are spawned once for the module (this file run as a script, one
process a rank, meeting through a ``FileStore`` under the test's temporary
directory); each runs every check and rank 0 writes the results, so each
test below is one assertion on them.  Beside them run ``torchrun`` (the
trainer at 2 × 2) and one process with the reference on 4 XLA host devices
(``jax.sharding.Mesh`` with ``Auto`` axes: ``jax.make_mesh``'s ``Explicit``
ones make the reference's ``constrain_act`` refuse).

Limits:
- ``compressed_psum``: bitwise the reference's (integer sums of the same
  int8 payloads, the same max scale, one fp32 product).
- MoE modes at 2 × 2 (gspmd, local, ep_local) on a reduced
  granite-moe-3b-a800m block with the same weights: top-k indices bitwise,
  outputs within ``tests/test_torch_moe.py``'s fp32 limit, 1e-5.
- Train step at world 4 (2 × 2) against world 1, reduced granite-3-2b and
  recurrentgemma-9b (4 query heads on 2 model ranks, its one kv head
  replicated): only the order of fp32 sums differs (a contraction split
  over two ranks and added by an all-reduce, the loss's and the gradient
  norm's sums over shards).  A reordered sum of n fp32 terms moves by at
  most (n − 1)·2^-24 of the sum of their magnitudes.  The longest chain
  of sums a gradient here sits on is the forward contraction (d = 64), the
  recurrence forward and back (2·S = 64) and the sum over B·S = 128
  tokens: 256 roundings; the magnitudes' sum is taken as twice the leaf's
  largest entry (the gates' gradients cancel), so each leaf, the loss and
  the gradient norm are held to 512·2^-24 ≈ 3.1e-5 of their largest
  magnitude (measured worst: 1.05e-5, recurrentgemma-9b's w_a; 3.6e-6 on
  granite-3-2b).
- Train step of a reduced granite-moe-3b-a800m (4 experts, top 2, d 64,
  d_ff 128) at world 4 under each MoE mode's rules (gspmd, local,
  ep_local) against world 1: again only the order of fp32 sums differs,
  now also the aux loss's per-shard means and ep_local's sum of the
  ranks' experts.  The longest chain: the experts' down-projection
  (d_ff = 128) and their weights' gradients summed over B·C = 4·40 slots:
  288 roundings, so 576·2^-24 ≈ 3.4e-5 of each leaf's largest magnitude
  (measured worst: 4.9e-6, ep_local's wg).
- GQA at model 4 (8 query heads, 2 kv heads): K1 and its gradients on the
  shards against the plain version on the whole, within 1e-5 of the
  largest magnitude (dK and dV add two ranks' partial sums).
- A checkpoint written on a (4, 1) mesh and restored on (2, 2): bitwise.
- Collectives counted in a real 4-rank train step of a small cell equal, kind
  by kind in count and bytes, those counted on a fake 2 × 2 mesh over meta
  tensors.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
MOE = dict(E=4, k=2, d=64, f=128, B=4, S=16, capacity_factor=1.25)
MOE_MODES = {"gspmd": "MOE_EP_RULES", "local": "MOE_LOCAL_RULES",
             "ep_local": "MOE_EP_LOCAL_RULES"}
TRAIN_ARCHS = ("granite-3-2b", "recurrentgemma-9b")
MOE_ARCH = "granite-moe-3b-a800m"     # reduced: 4 experts, top 2, d 64, d_ff 128
TRAIN_BS = (4, 32)
SUM_TOL = 512 * 2.0 ** -24
MOE_SUM_TOL = 576 * 2.0 ** -24
CELL = ("gemma2-2b", 32, 4)          # arch, seq, batch of the counted train cell


# ---- data shared by the ranks, the reference and the tests ------------------
def moe_data():
    """Weights and input of one MoE block, drawn by numpy as
    ``tests/test_torch_moe.py`` draws them."""
    rng = np.random.default_rng(7)
    E, d, f = MOE["E"], MOE["d"], MOE["f"]
    shapes = {"router": (d, E), "wi": (E, d, f), "wg": (E, d, f), "wo": (E, f, d)}
    arrs = {n: rng.standard_normal(s, dtype=np.float32) / np.float32(
        np.sqrt(f if n == "wo" else d)) for n, s in shapes.items()}
    x = (rng.standard_normal((MOE["B"], MOE["S"], d), dtype=np.float32)
         + rng.standard_normal((1, 1, d), dtype=np.float32))
    return arrs, x


def grad_of(rank: int) -> np.ndarray:
    """Rank ``rank``'s gradient leaf for compressed_psum."""
    return np.random.default_rng(100 + rank).standard_normal((3, 257)).astype(np.float32)


def train_batch(vocab: int):
    B, S = TRAIN_BS
    rng = np.random.default_rng(11)
    toks = rng.integers(0, vocab, (B, S)).astype(np.int32)
    return {"tokens": toks, "labels": np.roll(toks, -1, axis=1),
            "loss_mask": (rng.random((B, S)) > 0.1).astype(np.float32)}


def train_setup(arch):
    from repro_torch.configs import get_config
    from repro_torch.models import build_model, reduced
    from repro_torch.training.optimizer import init_opt_state
    model = build_model(reduced(get_config(arch)), "cpu")
    params = model.init(torch.Generator().manual_seed(3))
    batch = {k: torch.from_numpy(v) for k, v in train_batch(model.cfg.vocab_size).items()}
    return model, params, init_opt_state(params), batch


def train_step(arch, mesh=None, rules_name="TRAIN_RULES"):
    """(loss, grad norm, {path: gradient}, {path: updated param}) of one
    step; with ``mesh`` the state and batch laid out by ``rules_name``."""
    from repro_torch.dist import sharding as shd
    from repro_torch.training.optimizer import OptimizerConfig, adamw_update, opt_state_axes
    from repro_torch.training.step import make_grad_fn
    from repro_torch.training.tree import flatten
    model, params, opt, batch = train_setup(arch)
    grad_fn = make_grad_fn(model)
    cfg = OptimizerConfig(warmup_steps=1)
    if mesh is None:
        grads, aux = grad_fn(params, batch)
        params, _, metrics = adamw_update(cfg, grads, opt, params)
    else:
        rules, axes = getattr(shd, rules_name), model.logical_axes()
        params = shd.shard_tree(params, axes, rules, mesh)
        opt = shd.shard_tree(opt, opt_state_axes(axes), rules, mesh)
        batch = shd.shard_tree(batch, {k: ("batch", "seq") for k in batch}, rules, mesh)
        with shd.activation_sharding(mesh, rules):
            grads, aux = grad_fn(params, batch)
            params, _, metrics = adamw_update(cfg, grads, opt, params)

    def whole(t):
        return (t.full_tensor() if hasattr(t, "full_tensor") else t).detach().clone()

    return (whole(aux["ce"]), whole(metrics["grad_norm"]),
            {p: whole(g) for p, g in flatten(grads)}, {p: whole(v) for p, v in flatten(params)})


def counted_cell(mesh, device):
    """The collectives of one train step of a small cell on ``mesh``."""
    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.launch import cells, costing
    from repro_torch.models import reduced
    arch, S, B = CELL
    cell = cells.build_train_cell(arch, ShapeSpec("cell", S, B, "train"), mesh,
                                  cfg=reduced(get_config(arch)), device=device)
    return costing.count_costs(cell.fn, *cell.args)["collectives"]


# ---- one rank ------------------------------------------------------------------
def _rank_main(rank: int, store: str, out: str) -> None:
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    sys.path.insert(0, str(ROOT / "src"))
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, WORLD), rank=rank,
                            world_size=WORLD)
    from repro_torch.dist import sharding as shd
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import plain as flash_plain
    from repro_torch.models import moe
    from repro_torch.training import checkpoint as ckpt
    from repro_torch.training.compress import compressed_psum
    from repro_torch.training.optimizer import opt_state_axes
    from repro_torch.training.tree import flatten

    def mesh_of(shape):
        return DeviceMesh("cpu", torch.arange(WORLD).reshape(shape),
                          mesh_dim_names=("data", "model"))

    mesh = mesh_of((2, 2))
    res = {"psum": compressed_psum(torch.from_numpy(grad_of(rank)))}

    arrs, x = moe_data()
    res["moe"] = {}
    for mode, rules_name in MOE_MODES.items():
        rules = getattr(shd, rules_name)
        params = shd.shard_tree({n: torch.from_numpy(a) for n, a in arrs.items()},
                                moe.moe_axes(), rules, mesh)
        xs = shd.shard_tree({"x": torch.from_numpy(x)}, {"x": ("batch", "seq", "act_embed")},
                            rules, mesh)["x"]
        with shd.activation_sharding(mesh, rules):
            y = moe.moe_apply(params, xs, num_experts=MOE["E"], k=MOE["k"],
                              capacity_factor=MOE["capacity_factor"])
        res["moe"][mode] = y.full_tensor()

    res["train"] = {arch: train_step(arch, mesh) for arch in TRAIN_ARCHS}
    res["moe_train"] = {mode: train_step(MOE_ARCH, mesh, rules_name)
                        for mode, rules_name in MOE_MODES.items()}
    res["moe_train_modes"] = {mode: moe.mode_name(mesh, getattr(shd, rules_name),
                                                  TRAIN_BS[0], TRAIN_BS[1], MOE["E"])
                              for mode, rules_name in MOE_MODES.items()}

    # GQA with the kv heads on fewer ranks than the query heads
    gen = torch.Generator().manual_seed(5)
    q, k, v, dout = (torch.randn(shape, generator=gen) for shape in
                     ((2, 8, 16, 16), (2, 2, 16, 16), (2, 2, 16, 16), (2, 8, 16, 16)))
    m14 = mesh_of((1, 4))
    place = shd.distribute
    qs = place(q, m14, shd.placements((None, "model"), m14)).requires_grad_()
    ks = place(k, m14, shd.placements((), m14)).requires_grad_()
    vs = place(v, m14, shd.placements((), m14)).requires_grad_()
    o = ops.flash_attention(qs, ks, vs, causal=True)
    o.backward(place(dout, m14, o.placements))
    res["gqa"] = [t.full_tensor().detach() for t in (o, qs.grad, ks.grad, vs.grad)]
    if rank == 0:
        ql, kl, vl = (t.clone().requires_grad_() for t in (q, k, v))
        ow = flash_plain(ql, kl, vl, causal=True)
        ow.backward(dout)
        res["gqa_want"] = [t.detach() for t in (ow, ql.grad, kl.grad, vl.grad)]

    # a checkpoint written on (4, 1), restored on (2, 2)
    model, params, opt, _ = train_setup("granite-3-2b")
    state = {"params": params, "opt": opt}
    axes = {"params": model.logical_axes(), "opt": opt_state_axes(model.logical_axes())}
    m41 = mesh_of((4, 1))
    written = shd.shard_tree(state, axes, shd.TRAIN_RULES, m41)
    ckpt.save(os.path.join(os.path.dirname(out), "ckpt"), 1, written)
    dist.barrier()
    _, back = ckpt.restore(os.path.join(os.path.dirname(out), "ckpt"), mesh=mesh,
                           placements=shd.tree_shardings(state, axes, shd.TRAIN_RULES, mesh))
    pairs = list(zip(flatten(state), flatten(back)))
    res["ckpt"] = {"leaves": len(pairs),
                   "bitwise": all(pa == pb and torch.equal(a, b.full_tensor())
                                  for (pa, a), (pb, b) in pairs),
                   "placed": all(tuple(b.placements) == tuple(shd.placements(
                       shd.partition_spec(a.shape, _axes_at(axes, pa), shd.TRAIN_RULES, mesh),
                       mesh)) for (pa, a), (_, b) in pairs),
                   "moved": sum(tuple(w.placements) != tuple(b.placements) for (_, w), (_, b)
                                in zip(flatten(written), flatten(back)))}

    res["colls"] = counted_cell(mesh, "cpu")
    if rank == 0:
        res["train_world1"] = {arch: train_step(arch) for arch in TRAIN_ARCHS + (MOE_ARCH,)}
        torch.save(res, out)
    dist.barrier()
    dist.destroy_process_group()


def _axes_at(axes, path):
    for key in path:
        axes = axes[key]
    return axes


# ---- the reference on 4 XLA host devices ------------------------------------
def _reference_main(out: str) -> None:
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    os.environ["JAX_PLATFORMS"] = "cpu"
    sys.path.insert(0, str(ROOT / "src"))
    import jax
    from jax.experimental.shard_map import shard_map
    from jax.sharding import Mesh, PartitionSpec as P
    from repro.dist import sharding as rshd
    from repro.models import moe as jmoe
    from repro.training.compress import compressed_psum
    arrs, x = moe_data()
    res = {}
    mesh = Mesh(np.array(jax.devices()).reshape(2, 2), ("data", "model"))
    for mode, rules_name in MOE_MODES.items():
        rshd.set_activation_sharding(mesh, getattr(rshd, rules_name))
        with mesh:
            y = jmoe.moe_apply(arrs, x, num_experts=MOE["E"], k=MOE["k"],
                               capacity_factor=MOE["capacity_factor"])
        res[mode] = np.asarray(y)
    rshd.set_activation_sharding(None, None)
    res["topk_idx"] = np.asarray(jmoe._route(arrs, x, MOE["E"], MOE["k"])[2])
    line = Mesh(np.array(jax.devices()), ("i",))
    grads = np.stack([grad_of(r) for r in range(WORLD)])
    psum = shard_map(lambda g: compressed_psum(g[0], "i")[None], mesh=line,
                     in_specs=P("i"), out_specs=P("i"))
    res["psum"] = np.asarray(psum(grads))
    np.savez(out, **res)


# ---- the module's runs -------------------------------------------------------
@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    me = str(Path(__file__).resolve())
    ranks = [subprocess.Popen([sys.executable, me, "rank", str(r), str(tmp / "store"),
                               str(tmp / "ranks.pt")], env=env, cwd=tmp,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]
    ref = subprocess.Popen([sys.executable, me, "reference", str(tmp / "ref.npz")], env=env,
                           cwd=tmp, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                           text=True)
    trainer = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         f"--nproc-per-node={WORLD}", "-m", "repro_torch.launch.train", "--smoke",
         "--steps", "3", "--device", "cpu", "--model-parallel", "2",
         "--ckpt-dir", str(tmp / "train_ckpt")],
        env=env, cwd=tmp, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    logs = {}
    for name, proc in [(f"rank{r}", p) for r, p in enumerate(ranks)] + [
            ("reference", ref), ("torchrun", trainer)]:
        logs[name] = proc.communicate(timeout=600)[0]
        assert proc.returncode == 0, f"{name} failed:\n{logs[name][-4000:]}"
    from repro_torch.launch.mesh import make_accounting_mesh, release_fake_group
    try:
        fake = counted_cell(make_accounting_mesh((2, 2), ("data", "model")), "meta")
    finally:
        release_fake_group()
    yield {"ranks": torch.load(tmp / "ranks.pt", weights_only=False),
           "ref": dict(np.load(tmp / "ref.npz")), "torchrun": logs["torchrun"],
           "fake_colls": fake}


def _close(got, want, rel):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"max err {err} > {rel} · {scale}"


def test_compressed_psum_is_bitwise_the_reference(runs):
    got = runs["ranks"]["psum"].numpy()
    assert np.array_equal(got, runs["ref"]["psum"][0])


@pytest.mark.parametrize("mode", sorted(MOE_MODES))
def test_moe_mode_matches_the_reference(mode, runs):
    got, want = runs["ranks"]["moe"][mode].numpy(), runs["ref"][mode]
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= 1e-5


def test_moe_routing_indices_match(runs):
    from repro_torch.models import moe
    arrs, x = moe_data()
    idx = moe._route({"router": torch.from_numpy(arrs["router"])}, torch.from_numpy(x),
                     MOE["E"], MOE["k"])[2]
    assert np.array_equal(idx.numpy(), runs["ref"]["topk_idx"])


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_train_step_at_world_4_is_world_1s(arch, runs):
    loss, gnorm, grads, params = runs["ranks"]["train"][arch]
    loss1, gnorm1, grads1, params1 = runs["ranks"]["train_world1"][arch]
    _close(loss, loss1, SUM_TOL)
    _close(gnorm, gnorm1, SUM_TOL)
    assert grads.keys() == grads1.keys()
    for path in grads:
        _close(grads[path], grads1[path], SUM_TOL)


@pytest.mark.parametrize("mode", sorted(MOE_MODES))
def test_moe_train_step_at_world_4_is_world_1s(mode, runs):
    assert runs["ranks"]["moe_train_modes"][mode] == mode
    loss, gnorm, grads, params = runs["ranks"]["moe_train"][mode]
    loss1, gnorm1, grads1, params1 = runs["ranks"]["train_world1"][MOE_ARCH]
    _close(loss, loss1, MOE_SUM_TOL)
    _close(gnorm, gnorm1, MOE_SUM_TOL)
    assert grads.keys() == grads1.keys()
    for path in grads:
        _close(grads[path], grads1[path], MOE_SUM_TOL)


def test_gqa_with_kv_heads_replicated_matches_the_whole(runs):
    for got, want in zip(runs["ranks"]["gqa"], runs["ranks"]["gqa_want"]):
        _close(got, want, 1e-5)


def test_checkpoint_restores_bitwise_onto_another_mesh(runs):
    c = runs["ranks"]["ckpt"]
    assert c["bitwise"] and c["placed"] and c["leaves"] > 0 and c["moved"] > 0


def test_real_and_fake_mesh_count_the_same_collectives(runs):
    real, fake = runs["ranks"]["colls"], runs["fake_colls"]
    assert real == fake
    assert real["all-gather"]["count"] > 0 and real["all-reduce"]["count"] > 0


def test_torchrun_trains_on_a_two_by_two_mesh(runs):
    assert "devices=4 mesh={'data': 2, 'model': 2}" in runs["torchrun"]
    assert "done: 3 steps" in runs["torchrun"]


def test_host_mesh_needs_a_card_unless_cpu_is_asked(monkeypatch):
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_host_mesh(1)
    assert not dist.is_initialized()


if __name__ == "__main__":
    if sys.argv[1] == "rank":
        _rank_main(int(sys.argv[2]), sys.argv[3], sys.argv[4])
    else:
        _reference_main(sys.argv[2])
