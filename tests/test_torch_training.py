"""The port's training stack against the reference's, on the CPU: the
chunked loss, the optimizer, checkpoints, the fault-tolerant runner, the data
pipeline, gradient compression and ``python -m repro_torch.launch.train``
(ports of ``tests/test_losses_opt.py`` and ``tests/test_checkpoint_ft.py``
beside the parity checks).

Inputs come from numpy with a seed and go to both frameworks.  Tolerances:
the loss and its gradients within 1e-5 relative (fp32; XLA and PyTorch sum
in other orders), the schedule and the optimizer's params, m and v within
1e-6 relative (cos and pow differ by an ulp between the two), quantization
exact.
"""
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as REF_ARCHS  # noqa: E402
from repro.models import build_model as ref_build_model  # noqa: E402
from repro.models import count_params as ref_count_params  # noqa: E402
from repro.models import reduced as ref_reduced  # noqa: E402
from repro.training import checkpoint as ref_ckpt  # noqa: E402
from repro.training import compress as ref_compress  # noqa: E402
from repro.training import losses as ref_losses  # noqa: E402
from repro.training import optimizer as ref_opt  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import reduced  # noqa: E402
from repro_torch.training import checkpoint as ckpt  # noqa: E402
from repro_torch.training.compress import (compress_grads_with_feedback,  # noqa: E402
                                           dequantize, quantize)
from repro_torch.training.data import DataConfig, PrefetchingLoader, host_batch  # noqa: E402
from repro_torch.training.ft import RunnerConfig, StragglerMonitor, TrainingRunner  # noqa: E402
from repro_torch.training.losses import chunked_cross_entropy  # noqa: E402
from repro_torch.training.optimizer import (OptimizerConfig, adamw_update,  # noqa: E402
                                            global_norm, init_opt_state, schedule)
from repro_torch.training.tree import flatten  # noqa: E402

REPO = Path(__file__).resolve().parents[1]


def _np(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _t(tree):
    return {k: _t(v) if isinstance(v, dict) else torch.from_numpy(np.array(v))
            for k, v in tree.items()}


# ------------------------------------------------------------------ losses
@pytest.mark.parametrize("S,chunk,softcap", [(64, 16, 30.0), (64, 16, 0.0), (50, 16, 30.0)],
                         ids=["chunked-softcap", "chunked", "ragged-softcap"])
def test_chunked_cross_entropy_and_grads_match_reference(S, chunk, softcap):
    """Value and gradients with respect to hidden and embed; S = 50 is no
    multiple of the chunk, so both run it as one chunk."""
    B, D, V = 2, 16, 50
    hidden, embed = _np(0, B, S, D), _np(1, V, D)
    rng = np.random.default_rng(2)
    labels = rng.integers(0, V, (B, S)).astype(np.int32)
    mask = (rng.random((B, S)) > 0.2).astype(np.float32)
    ref_val, (ref_dh, ref_de) = jax.value_and_grad(
        lambda h, e: ref_losses.chunked_cross_entropy(h, e, labels, mask,
                                                      logit_softcap=softcap, chunk=chunk),
        argnums=(0, 1))(hidden, embed)
    h, e = (torch.from_numpy(x).requires_grad_() for x in (hidden, embed))
    val = chunked_cross_entropy(h, e, torch.from_numpy(labels), torch.from_numpy(mask),
                                logit_softcap=softcap, chunk=chunk)
    dh, de = torch.autograd.grad(val, (h, e))
    np.testing.assert_allclose(float(val.detach()), float(ref_val), rtol=1e-5)
    for got, want in ((dh, ref_dh), (de, ref_de)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5 * float(np.abs(want).max()))


def test_chunked_ce_matches_full():
    B, S, D, V = 2, 64, 16, 50
    hidden, embed = torch.from_numpy(_np(0, B, S, D)), torch.from_numpy(_np(1, V, D))
    rng = np.random.default_rng(3)
    labels = torch.from_numpy(rng.integers(0, V, (B, S)))
    mask = torch.from_numpy((rng.random((B, S)) > 0.2).astype(np.float32))
    full = chunked_cross_entropy(hidden, embed, labels, mask, chunk=S)
    chunked = chunked_cross_entropy(hidden, embed, labels, mask, chunk=16)
    np.testing.assert_allclose(float(full), float(chunked), rtol=1e-6)


# --------------------------------------------------------------- optimizer
def test_schedule_matches_reference():
    cfg = OptimizerConfig(learning_rate=3e-3, warmup_steps=20, total_steps=200)
    ref_cfg = ref_opt.OptimizerConfig(learning_rate=3e-3, warmup_steps=20, total_steps=200)
    for step in range(0, 230, 7):
        np.testing.assert_allclose(float(schedule(cfg, step)),
                                   float(ref_opt.schedule(ref_cfg, jnp.asarray(step))), rtol=1e-6)


def _tree(seed):
    """A parameter tree in the models' stacked layout: a stacked (L, d)
    norm scale (which decays), an unstacked (d,) one (which does not), the
    embedding and a stacked matrix."""
    return {"embed": _np(seed, 50, 16, scale=0.02),
            "final_norm": {"scale": _np(seed + 1, 16)},
            "layers": {"ln1": {"scale": _np(seed + 2, 3, 16)},
                       "ffn": {"wi": _np(seed + 3, 3, 16, 32, scale=0.25)}}}


def _adamw_runs(fault: bool = False):
    """Three AdamW steps of the port and the reference on the same gradient
    trees → (port params, m, v, metrics; the reference's).  With ``fault``
    the port decays every leaf: its (d,) leaf goes in as a (1, d) view."""
    cfg = OptimizerConfig(learning_rate=1e-2, warmup_steps=2, total_steps=10)
    ref_cfg = ref_opt.OptimizerConfig(learning_rate=1e-2, warmup_steps=2, total_steps=10)
    params, ref_params = _t(_tree(0)), jax.tree.map(jnp.asarray, _tree(0))
    opt, ref_state = init_opt_state(params), ref_opt.init_opt_state(ref_params)
    for step in range(3):
        grads = _tree(10 * step + 10)
        view = params
        if fault:
            view = dict(params, final_norm={"scale": params["final_norm"]["scale"][None]})
            opt["m"]["final_norm"]["scale"] = opt["m"]["final_norm"]["scale"][None]
            opt["v"]["final_norm"]["scale"] = opt["v"]["final_norm"]["scale"][None]
            g = _t(grads)
            g["final_norm"]["scale"] = g["final_norm"]["scale"][None]
        else:
            g = _t(grads)
        _, opt, metrics = adamw_update(cfg, g, opt, view)
        if fault:
            for t in ("m", "v"):
                opt[t]["final_norm"]["scale"] = opt[t]["final_norm"]["scale"][0]
        ref_params, ref_state, ref_metrics = ref_opt.adamw_update(
            ref_cfg, jax.tree.map(jnp.asarray, grads), ref_state, ref_params)
    return (params, opt, metrics), (ref_params, ref_state, ref_metrics)


def _close(got, want):
    return np.allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                       atol=1e-6 * float(np.abs(np.asarray(want)).max()))


def test_adamw_update_matches_reference():
    """schedule, global_norm and adamw_update fed the same gradient trees:
    params, m and v within 1e-6 relative after three steps, the step, the
    learning rate and the (pre-clip) grad norm alike.  Weight decay goes on
    the stacked (L, d) scale and not on the (d,) one, as in the reference."""
    (params, opt, metrics), (ref_params, ref_state, ref_metrics) = _adamw_runs()
    for got, want in ((params, ref_params), (opt["m"], ref_state["m"]),
                      (opt["v"], ref_state["v"])):
        for path, leaf in flatten(got):
            ref_leaf = want
            for key in path:
                ref_leaf = ref_leaf[key]
            assert _close(leaf, ref_leaf), path
    assert int(opt["step"]) == int(ref_state["step"]) == 3
    np.testing.assert_allclose(float(metrics["lr"]), float(ref_metrics["lr"]), rtol=1e-7)
    np.testing.assert_allclose(float(metrics["grad_norm"]), float(ref_metrics["grad_norm"]),
                               rtol=1e-6)
    np.testing.assert_allclose(float(global_norm(_t(_tree(5)))),
                               float(ref_opt.global_norm(_tree(5))), rtol=1e-6)


def test_planted_fault_weight_decay_on_every_leaf_fails():
    (params, _, _), (ref_params, _, _) = _adamw_runs(fault=True)
    assert not _close(params["final_norm"]["scale"], ref_params["final_norm"]["scale"])
    assert _close(params["embed"], ref_params["embed"])


def test_adamw_converges_quadratic():
    params = {"w": torch.tensor([5.0, -3.0])}
    opt = init_opt_state(params)
    cfg = OptimizerConfig(learning_rate=0.3, warmup_steps=1, total_steps=200,
                          weight_decay=0.0)
    for _ in range(150):
        params, opt, m = adamw_update(cfg, {"w": 2 * params["w"]}, opt, params)
    assert float(params["w"].abs().max()) < 0.1
    assert m["grad_norm"] >= 0


def test_grad_clip():
    params = {"w": torch.zeros(4)}
    opt = init_opt_state(params)
    cfg = OptimizerConfig(grad_clip_norm=1.0, warmup_steps=1, total_steps=10)
    _, _, m = adamw_update(cfg, {"w": torch.full((4,), 100.0)}, opt, params)
    assert float(m["grad_norm"]) > 1.0  # raw norm reported pre-clip


def test_schedule_shape():
    cfg = OptimizerConfig(learning_rate=1.0, warmup_steps=10, total_steps=100,
                          min_lr_ratio=0.1)
    lrs = [float(schedule(cfg, s)) for s in range(0, 101, 10)]
    assert lrs[1] == 1.0                      # end of warmup
    assert lrs[-1] <= 0.11                    # cosine floor
    assert all(a >= b - 1e-6 for a, b in zip(lrs[1:], lrs[2:]))


# ------------------------------------------------------------- checkpoints
def _state():
    rng = np.random.default_rng(0)
    return {"a": torch.from_numpy(rng.standard_normal((16, 8), dtype=np.float32)),
            "b": {"c": torch.arange(10, dtype=torch.int32),
                  "d": torch.from_numpy(rng.standard_normal(3, dtype=np.float32)),
                  "e": torch.from_numpy(rng.standard_normal((4, 5), dtype=np.float32))
                  .to(torch.bfloat16)},
            "step": torch.zeros((), dtype=torch.int32)}


def _equal(a, b):
    return all(pa == pb and x.dtype == y.dtype and torch.equal(x, y)
               for (pa, x), (pb, y) in zip(flatten(a), flatten(b)))


class TestCheckpoint:
    def test_roundtrip_with_and_without_target(self, tmp_path):
        """Every leaf back bitwise with its dtype, bf16 included, from the
        manifest's key paths or a target's."""
        t = _state()
        ckpt.save(str(tmp_path), 7, t)
        manifest = json.loads((tmp_path / "step_00000007" / "manifest.json").read_text())
        assert manifest["paths"] == [["a"], ["b", "c"], ["b", "d"], ["b", "e"], ["step"]]
        assert manifest["dtypes"] == ["float32", "int32", "float32", "bfloat16", "int32"]
        for kw in ({}, {"target": t}):
            step, back = ckpt.restore(str(tmp_path), **kw)
            assert step == 7 and _equal(t, back)

    def test_leaf_order_and_layout_are_the_reference_s(self, tmp_path):
        """The same tree saved by both: the same npz keys, shapes and dtypes
        in the same order (a checkpoint of either lists leaves alike)."""
        t = {k: v for k, v in _state().items() if k != "b"}
        t["b"] = {"d": _state()["b"]["d"], "c": _state()["b"]["c"]}
        ckpt.save(str(tmp_path / "port"), 1, t)
        ref_ckpt.save(str(tmp_path / "ref"), 1, jax.tree.map(lambda x: jnp.asarray(x.numpy()), t))
        zs = [np.load(tmp_path / w / "step_00000001" / "shard_0000_0.npz") for w in ("port", "ref")]
        assert zs[0].files == zs[1].files
        for k in zs[0].files:
            np.testing.assert_array_equal(zs[0][k], zs[1][k])
            assert zs[0][k].dtype == zs[1][k].dtype

    def test_restores_a_checkpoint_the_reference_wrote(self, tmp_path):
        """The reference's save (a JAX tree with a bf16 leaf), restored into
        the port's tree by target: every leaf bitwise."""
        t = _state()
        ref_tree = jax.tree.map(
            lambda x: jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
            if x.dtype == torch.bfloat16 else jnp.asarray(x.numpy()), t)
        ref_ckpt.save(str(tmp_path), 3, ref_tree)
        step, back = ckpt.restore(str(tmp_path), target=t)
        assert step == 3 and _equal(t, back)

    def test_latest_and_cleanup(self, tmp_path):
        t = _state()
        for s in (1, 2, 3, 4):
            ckpt.save(str(tmp_path), s, t)
        assert ckpt.latest_step(str(tmp_path)) == 4
        ckpt.cleanup(str(tmp_path), keep=2)
        assert ckpt.latest_step(str(tmp_path)) == 4
        assert sorted(p.name for p in tmp_path.iterdir()) == ["step_00000003", "step_00000004"]
        step, _ = ckpt.restore(str(tmp_path), target=t)
        assert step == 4

    def test_async_snapshot_is_taken_at_save(self, tmp_path):
        """The background write holds the values at ``save``, though the
        tensors are updated in place right after (as ``adamw_update`` does)."""
        t = _state()
        before = t["a"].clone()
        ac = ckpt.AsyncCheckpointer(str(tmp_path))
        ac.save(5, t)
        t["a"].add_(1.0)
        ac.wait()
        step, back = ckpt.restore(str(tmp_path))
        assert step == 5 and torch.equal(back["a"], before)

    def test_restore_needs_the_target_s_leaf_count(self, tmp_path):
        ckpt.save(str(tmp_path), 1, _state())
        with pytest.raises(ValueError, match="leaves"):
            ckpt.restore(str(tmp_path), target={"a": torch.zeros(1)})


# ------------------------------------------------------------------ runner
class TestRunner:
    def test_restart_recovers(self, tmp_path):
        calls = []

        def step_fn(state, step):
            calls.append(step)
            return {"x": state["x"] + 1}, {"loss": float(state["x"])}

        runner = TrainingRunner(
            RunnerConfig(ckpt_dir=str(tmp_path), ckpt_every=5, max_steps=20,
                         fail_at_step=12, async_ckpt=False),
            step_fn, lambda: {"x": torch.zeros(())}, device="cpu")
        out = runner.run()
        assert out["restarts"] == 1
        assert out["final_step"] == 20
        # state is consistent: x == number of *effective* steps
        step, state = ckpt.restore(str(tmp_path), target={"x": torch.zeros(())})
        assert int(state["x"]) == 20
        # steps 10..12 re-executed after recovery from step-10 checkpoint
        assert 10 in calls and calls.count(11) >= 2


class TestStraggler:
    def test_flags_slow_host(self):
        mon = StragglerMonitor(n_hosts=4, threshold=1.5)
        flagged = []
        for _ in range(10):
            flagged = mon.record([1.0, 1.0, 1.0, 3.0])
        assert flagged == [3]

    def test_uniform_no_flags(self):
        mon = StragglerMonitor(n_hosts=4)
        for _ in range(5):
            assert mon.record([1.0, 1.0, 1.0, 1.0]) == []


# -------------------------------------------------------------------- data
class TestData:
    def test_deterministic_and_learnable_shapes(self):
        cfg = DataConfig(global_batch=4, seq_len=32)
        mc = reduced(get_config("granite-3-2b"))
        b1 = host_batch(cfg, mc, step=3)
        b2 = host_batch(cfg, mc, step=3)
        np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
        assert not np.array_equal(b1["tokens"], host_batch(cfg, mc, step=4)["tokens"])
        assert b1["tokens"].shape == (4, 32)
        assert (b1["labels"][:, :-1] == b1["tokens"][:, 1:]).all()
        assert (b1["tokens"] < mc.vocab_size).all()

    @pytest.mark.parametrize("arch", ["granite-3-2b", "whisper-tiny", "llava-next-34b"])
    def test_keys_shapes_and_dtypes_are_the_reference_s(self, arch):
        cfg = DataConfig(global_batch=4, seq_len=16)
        got = host_batch(cfg, reduced(get_config(arch)), 0)
        from repro.training.data import DataConfig as RefDataConfig
        from repro.training.data import host_batch as ref_host_batch
        want = ref_host_batch(RefDataConfig(global_batch=4, seq_len=16),
                              ref_reduced(REF_ARCHS[arch]), 0)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype, k

    def test_bigram_share(self):
        """The share of transitions that follow x → (31x + 17) mod V: 90%
        kept plus the flips that land on it by chance."""
        mc = reduced(get_config("granite-3-2b"))
        b = host_batch(DataConfig(global_batch=8, seq_len=256), mc, 0)
        share = ((31 * b["tokens"].astype(np.int64) + 17) % mc.vocab_size
                 == b["labels"]).mean()
        assert 0.87 <= share <= 0.93

    def test_host_sharding_disjoint_sizes(self):
        mc = reduced(get_config("granite-3-2b"))
        h0 = host_batch(DataConfig(global_batch=8, seq_len=16, n_hosts=2, host_id=0), mc, 0)
        h1 = host_batch(DataConfig(global_batch=8, seq_len=16, n_hosts=2, host_id=1), mc, 0)
        assert h0["tokens"].shape == (4, 16) == h1["tokens"].shape
        assert not (h0["tokens"] == h1["tokens"]).all()

    def test_prefetch_loader(self):
        mc = reduced(get_config("granite-3-2b"))
        loader = PrefetchingLoader(DataConfig(global_batch=2, seq_len=16), mc, start_step=5)
        step, batch = next(loader)
        assert step == 5 and batch["tokens"].shape == (2, 16)
        np.testing.assert_array_equal(
            batch["tokens"], host_batch(DataConfig(global_batch=2, seq_len=16), mc, 5)["tokens"])
        step2, _ = next(loader)
        assert step2 == 6
        loader.close()


# ------------------------------------------------------------- compression
class TestCompression:
    def test_quantize_matches_reference(self):
        """Bitwise, ties included: both round half to even."""
        g = np.concatenate([_np(0, 256), np.float32([1.5, 2.5, -0.5, 127.0, -127.0])])
        q, s = quantize(torch.from_numpy(g))
        rq, rs = ref_compress.quantize(jnp.asarray(g))
        np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
        assert float(s) == float(rs)
        np.testing.assert_array_equal(dequantize(q, s).numpy(),
                                      np.asarray(ref_compress.dequantize(rq, rs)))
        z, zs = quantize(torch.zeros(8))
        assert float(zs) == 1.0 and not z.any()

    def test_quantize_bound(self):
        g = torch.from_numpy(_np(0, 256))
        q, s = quantize(g)
        assert float((q.float() * s - g).abs().max()) <= float(s) / 2 + 1e-6

    def test_error_feedback_unbiased_over_time(self):
        g = torch.from_numpy(_np(1, 128)) * 1e-3
        grads, err, acc = {"w": g}, None, torch.zeros_like(g)
        for _ in range(50):
            deq, err = compress_grads_with_feedback(grads, err)
            acc = acc + deq["w"]
        rel = (acc - 50 * g).norm() / (50 * g).norm()
        assert float(rel) < 0.05

    def test_feedback_step_matches_reference(self):
        grads = {"w": _np(2, 64), "b": {"c": _np(3, 8, 4)}}
        err = {"w": _np(4, 64, scale=1e-2), "b": {"c": _np(5, 8, 4, scale=1e-2)}}
        deq, new = compress_grads_with_feedback(_t(grads), _t(err))
        rdeq, rnew = ref_compress.compress_grads_with_feedback(grads, err)
        for got, want in ((deq, rdeq), (new, rnew)):
            for path, leaf in flatten(got):
                ref_leaf = want
                for key in path:
                    ref_leaf = ref_leaf[key]
                np.testing.assert_array_equal(leaf.numpy(), np.asarray(ref_leaf))


# ------------------------------------------------------------- the trainer
def test_train_smoke_prints_the_reference_s_lines(tmp_path):
    """``python -m repro_torch.launch.train --smoke --steps 3 --device cpu``
    prints the reference's three lines: the first with the reference's
    parameter count, then the step time and the loss means."""
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--smoke", "--steps", "3",
         "--device", "cpu", "--ckpt-dir", str(tmp_path)],
        capture_output=True, text=True, check=True, cwd=REPO,
        env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin"}).stdout.splitlines()
    ref_model = ref_build_model(ref_reduced(REF_ARCHS["granite-3-2b"]))
    n = ref_count_params(jax.eval_shape(lambda: ref_model.init(jax.random.key(0))))
    assert out[0] == (f"arch=granite-3-2b-smoke params={n / 1e6:.1f}M devices=1 "
                      "mesh={'data': 1, 'model': 1}")
    assert re.fullmatch(r"done: 3 steps in \d+\.\ds \(\d+\.\d{3}s/step\)", out[1])
    first, last = map(float, re.fullmatch(r"loss: first10=(\d+\.\d{4}) last10=(\d+\.\d{4})",
                                          out[2]).groups())
    assert abs(first - np.log(256)) < 0.5 and abs(last - first) < 0.5
    assert ckpt.latest_step(str(tmp_path)) == 3


def test_model_parallel_waits_for_m12():
    """Model parallelism now runs on a mesh of every rank (M12b,
    tests/test_torch_dist.py runs it on 4); one process cannot split into
    2 model-parallel ranks, and says so, leaving no group behind."""
    import torch.distributed as dist
    from repro_torch.launch import train
    with pytest.raises(ValueError, match="model parallel 2"):
        train.main(["--smoke", "--model-parallel", "2", "--device", "cpu"])
    assert not dist.is_initialized()


def test_training_entry_points_need_a_card_unless_cpu_is_asked(monkeypatch):
    from repro_torch.launch import train
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--smoke", "--steps", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TrainingRunner(RunnerConfig(), lambda s, i: (s, {}), dict)
    assert TrainingRunner(RunnerConfig(), lambda s, i: (s, {}), dict,
                          device="cpu").device.type == "cpu"
