"""The port's cost pass against the JAX package's, and against itself.

``launch/costing.py``'s ``depth_variants`` and ``extrapolate`` and
``analysis/roofline.py``'s ``analyze`` must give the reference's outputs on
the same inputs (exactly: the same arithmetic).  Each kernel's call on meta
tensors must count exactly its formula of ``kernels/costs.py`` (operations,
bytes, transcendentals), under autograd its backward's too, and never run
its plain version.  The formulas must give the bounds ``chip_smoke.py``'s
kernel table printed before they moved into one module (the values of
``PERF.md``'s table, to 1e-9).  The count extrapolated from two depths must
equal the count at full depth for every family and kind of step.
"""
import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import hw as ref_hw  # noqa: E402
from repro.analysis import roofline as ref_roofline  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.launch import costing as ref_costing  # noqa: E402
from repro_torch import hw  # noqa: E402
from repro_torch.analysis import roofline  # noqa: E402
from repro_torch.configs import ARCHS, ShapeSpec, get_config  # noqa: E402
from repro_torch.kernels import costs, ops  # noqa: E402
from repro_torch.kernels import decode_attention as dec  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import rglru_scan as rg  # noqa: E402
from repro_torch.kernels import wkv6 as wk  # noqa: E402
from repro_torch.launch import cells, costing  # noqa: E402
from repro_torch.models.config import reduced  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
META = "meta"


def _cost_dict(rng):
    return {"flops": float(rng.integers(1, 10 ** 12)), "bytes": float(rng.integers(1, 10 ** 12)),
            "transcendentals": float(rng.integers(0, 10 ** 9)),
            "collectives": {k: {"bytes": float(rng.integers(0, 10 ** 9)),
                                "count": int(rng.integers(0, 50))}
                            for k in costing.COLL_KINDS}}


@pytest.mark.parametrize("arch", ARCHS)
def test_depth_variants_match_reference(arch):
    got, want = costing.depth_variants(get_config(arch)), \
        ref_costing.depth_variants(ref_get_config(arch))
    assert got[2:] == want[2:]
    for g, w in zip(got[:2], want[:2]):
        assert dataclasses.asdict(g) == dataclasses.asdict(w)


def test_collective_kinds_match_reference():
    assert costing.COLL_KINDS == ref_costing.COLL_KINDS


@pytest.mark.parametrize("seed", range(4))
def test_extrapolate_matches_reference(seed):
    rng = np.random.default_rng(seed)
    c1, c2 = _cost_dict(rng), _cost_dict(rng)
    if seed % 2:                       # a term that shrinks with depth is clamped
        c2["bytes"] = c1["bytes"] / 2
    n1, n_full = 1, int(rng.integers(2, 60))
    assert costing.extrapolate(c1, c2, n1, n_full) == \
        ref_costing.extrapolate(c1, c2, n1, n_full)


@pytest.mark.parametrize("which", ["tpu-v5e", "h100"])
@pytest.mark.parametrize("seed", range(3))
def test_analyze_matches_reference(which, seed):
    rng = np.random.default_rng(seed)
    ours = hw.HARDWARE[which]
    theirs = (ref_hw.TPU_V5E if which == "tpu-v5e"
              else ref_hw.HardwareModel(**dataclasses.asdict(hw.GPU_H100)))
    kw = dict(flops_per_device=float(rng.integers(1, 10 ** 16)),
              bytes_per_device=float(rng.integers(1, 10 ** 13)),
              bytes_model_per_device=float(rng.integers(1, 10 ** 12)),
              chips=int(rng.integers(1, 9)), model_flops=float(rng.integers(1, 10 ** 16)),
              collectives=_cost_dict(rng)["collectives"])
    got = roofline.analyze(hw=ours, **kw).to_dict()
    assert got == ref_roofline.analyze(hw=theirs, **kw).to_dict()
    if which == "h100":
        assert roofline.analyze(**kw).to_dict() == got      # the port's default card


# ---- the formulas against the bounds chip_smoke.py printed before ----------
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402

PROMPTS, LLAVA = chip_smoke.PROMPTS, chip_smoke.LLAVA_LENGTHS


def _fwd(H, K, d, window, prompts=PROMPTS):
    S = max(prompts)
    pairs = costs.attention_pairs(S, S, window=window, lengths=prompts, padded_rows=False)
    return costs.flash_attention(len(prompts), H, K, S, S, d, 2, window=window, pairs=pairs)


def _bwd(B, H, K, Sq, Skv, d, itemsize=2, causal=True, window=0, lengths=None):
    pairs = costs.attention_pairs(Sq, Skv, causal=causal, window=window,
                                  lengths=lengths or [Skv] * B)
    return costs.flash_attention_bwd(B, H, K, Sq, Skv, d, itemsize, causal=causal,
                                     window=window, pairs=pairs)


# (the kernel row of PERF.md's table, its cost calls, its bound_ms as printed
# by chip_smoke.py's phases 3, 18 and 19 in PRs 15-25); K2's model rows
# count slots of a random mask and are left out
RECORDED_BOUNDS = {
    "K1 gemma2-2b": ([_fwd(8, 4, 256, 4096), _fwd(8, 4, 256, 0)], 0.10044972418200201),
    "K1 recurrentgemma-9b": ([_fwd(16, 1, 256, 2048)], 0.14413488533872598),
    "K1 granite-moe-3b-a800m": ([_fwd(24, 8, 64, 0)], 0.07590482106370071),
    "K1 dbrx-132b": ([_fwd(48, 8, 128, 0)], 0.30361928425480283),
    "K1 llava-next-34b": ([_fwd(56, 8, 128, 0, LLAVA)], 0.5639240560080889),
    "K1 granite-3-2b train": ([_fwd(32, 8, 64, 0, (2048,) * 4)], 0.06951772615571283),
    "K1 whisper-tiny encoder": ([costs.flash_attention(4, 6, 6, 1500, 1500, 64, 2,
                                                       causal=False)], 0.013977755308392315),
    "K1 whisper-tiny cross": ([costs.flash_attention(4, 6, 6, 432, 1500, 64, 2,
                                                     causal=False)], 0.004025593528816987),
    "K2 whisper-tiny cross": ([costs.decode_attention(8, 6, 6, 1500, 64, 2)],
                              0.005505757611940299),
    "K3 recurrentgemma-9b": ([costs.rglru_scan(4, 4700, 4096, 4)], 0.2758772155223881),
    "K3 bf16": ([costs.rglru_scan(4, 4700, 4096, 2)], 0.13795817074626868),
    "K4 rwkv6-7b": ([costs.wkv6(4, 4700, 64, 64, 2)], 0.3723814208955224),
    "K4 N 32": ([costs.wkv6(4, 256, 2, 32, 2)], 0.00025439522388059704),
    "K5 down-projection": ([costs.int8_matmul(4096, 9216, 2304)], 0.08789599569883778),
    "K5 largest point": ([costs.int8_matmul(1024, 512, 512)], 0.0008626053731343284),
    "K1' granite-3-2b": ([_bwd(4, 32, 8, 2048, 2048, 64)], 0.1737943153892821),
    "K1' gemma2-2b local": ([_bwd(2, 8, 4, 4700, 4700, 256, window=4096)],
                            0.44996527239635997),
    "K1' gemma2-2b global": ([_bwd(2, 8, 4, 4700, 4700, 256)], 0.4575323114256825),
    "K1' recurrentgemma-9b": ([_bwd(2, 16, 1, 4096, 4096, 256, window=2048)],
                              0.5212133079878665),
    "K1' whisper-tiny encoder": ([_bwd(4, 6, 6, 1500, 1500, 64, causal=False)],
                                 0.034944388270980786),
    "K1' whisper-tiny cross": ([_bwd(4, 6, 6, 432, 1500, 64, causal=False)],
                               0.010063983822042467),
    "K1' llava-next-34b": ([_bwd(4, 56, 8, 3392, 3392, 128, lengths=list(LLAVA))],
                           1.651589534155713),
    "K1' ~100M fp32": ([_bwd(8, 8, 4, 256, 256, 64, itemsize=4)], 0.02011074865671642),
    "K3' recurrentgemma-9b": ([costs.rglru_scan_bwd(4, 2048, 4096, 4)], 0.20038365611940298),
    "K3' bf16": ([costs.rglru_scan_bwd(4, 2048, 4096, 2)], 0.10022117253731343),
    "K4' rwkv6-7b": ([costs.wkv6_bwd(4, 2048, 64, 64, 2)], 0.4567409251343284),
    "K4' N 32": ([costs.wkv6_bwd(4, 2048, 128, 32, 2)], 0.23237696191044777),
    "K4' ~100M": ([costs.wkv6_bwd(8, 256, 32, 16, 4)], 0.011504257910447761),
}


@pytest.mark.parametrize("row", RECORDED_BOUNDS)
def test_formulas_give_the_recorded_bounds(row):
    cases, want = RECORDED_BOUNDS[row]
    got = float(np.mean([chip_smoke.bound_of(c)[0] for c in cases]))
    assert got == pytest.approx(want, rel=1e-9, abs=0)


def test_attention_pairs_is_the_mask_count():
    """attention_pairs against the dense mask of the plain version."""
    for Sq, Skv, causal, window, lengths, padded in [(64, 64, True, 0, None, True),
                                                     (64, 64, True, 16, [64, 40, 3], False),
                                                     (64, 64, True, 16, [64, 40, 3], True),
                                                     (24, 80, False, 0, [80, 50], True)]:
        i, j = np.arange(Sq)[:, None], np.arange(Skv)[None, :]
        want = 0
        for n in lengths or [Skv]:
            m = np.broadcast_to(j < n, (Sq, Skv)).copy()
            if causal:
                m &= j <= i
            if window:
                m &= j > i - window
            if not padded:
                m &= i < n
            want += int(m.sum())
        assert costs.attention_pairs(Sq, Skv, causal=causal, window=window,
                                     lengths=lengths, padded_rows=padded) == want


# ---- each kernel's meta call counts its formula -------------------------------
def _meta(*shape, dtype=torch.float32, grad=False):
    return torch.empty(shape, dtype=dtype, device=META, requires_grad=grad)


def _kernel_calls(grad: bool):
    """(name, inputs, call, [formula costs]) of each kernel on meta tensors:
    the forward alone, or forward and backward (``grad``)."""
    bf = torch.bfloat16
    B, H, K, S, d, N, R = 2, 4, 2, 64, 64, 16, 32
    q, k, v = _meta(B, H, S, d, dtype=bf, grad=grad), _meta(B, K, S, d, dtype=bf, grad=grad), \
        _meta(B, K, S, d, dtype=bf, grad=grad)
    a, b, s0 = _meta(B, S, R, grad=grad), _meta(B, S, R, grad=grad), _meta(B, R, grad=grad)
    r, kk, vv = (_meta(B, S, H, N, dtype=bf, grad=grad) for _ in range(3))
    logw, u, st = _meta(B, S, H, N, grad=grad), _meta(H, N, grad=grad), _meta(B, H, N, N, grad=grad)
    out = [("flash_attention", (q, k, v),
            lambda q, k, v: ops.flash_attention(q, k, v, window=16, softcap=50.0),
            [costs.flash_attention(B, H, K, S, S, d, 2, window=16, softcap=50.0)]
            + ([costs.flash_attention_bwd(B, H, K, S, S, d, 2, window=16, softcap=50.0),
                # the state K1 writes for K1′: the fp32 output and each row's lse
                costs.Cost(0.0, 4.0 * B * H * (S * d + fa.stats_pitch(S)), 0.0, "bf16")]
               if grad else [])),
           ("rglru_scan", (a, b, s0), ops.rglru_scan,
            [costs.rglru_scan(B, S, R, 4)] + ([costs.rglru_scan_bwd(B, S, R, 4)] if grad else [])),
           ("wkv6", (r, kk, vv, logw, u, st), ops.wkv6,
            [costs.wkv6(B, S, H, N, 2)] + ([costs.wkv6_bwd(B, S, H, N, 2)] if grad else []))]
    if not grad:
        T = 128
        lengths, qpos, slot = (_meta(B, dtype=torch.int32), _meta(B, dtype=torch.int32),
                               _meta(B, T, dtype=torch.int32))
        out.append(("decode_attention", (_meta(B, H, d, dtype=bf), _meta(B, K, T, d, dtype=bf),
                                         _meta(B, K, T, d, dtype=bf)),
                    lambda q, k, v: ops.decode_attention(q, k, v, lengths, window=32,
                                                         q_pos=qpos, slot_pos=slot),
                    [costs.decode_attention(B, H, K, T, d, 2, window=32)]))
        out.append(("cross-attention", (_meta(B, H, 24, d, dtype=bf), k, v),
                    lambda q, k, v: ops.flash_attention(q, k, v, causal=False),
                    [costs.flash_attention(B, H, K, 24, S, d, 2, causal=False)]))
    return out


def _forward_and_backward(call):
    def step(*inputs):
        outs = call(*inputs)
        outs = outs if isinstance(outs, tuple) else (outs,)
        return torch.autograd.grad(outs, inputs, [torch.empty_like(o) for o in outs])
    return step


@pytest.mark.parametrize("grad", [False, True], ids=["forward", "backward"])
def test_kernel_meta_call_counts_its_formula(grad):
    for name, inputs, call, want in _kernel_calls(grad):
        step = _forward_and_backward(call) if grad else call
        got = costing.count_costs(step, *inputs)
        assert got["flops"] == sum(c.flops for c in want), name
        assert got["transcendentals"] == sum(c.transcendentals for c in want), name
        assert got["bytes"] == sum(c.bytes for c in want), name


def test_meta_calls_allocate_the_kernels_outputs_and_scratch():
    """The meta op's live bytes peak at its outputs and scratch: K2's split
    partials at a cache long enough to split."""
    B, H, K, T, d = 2, 8, 4, 4096, 256
    q, k, v = _meta(B, H, d, dtype=torch.bfloat16), _meta(B, K, T, d, dtype=torch.bfloat16), \
        _meta(B, K, T, d, dtype=torch.bfloat16)
    lengths = _meta(B, dtype=torch.int32)
    nsplit, _ = dec.plan_splits(B, K, T, d, 2)
    assert nsplit > 1
    _, _, peak = costing.count(lambda *a: ops.decode_attention(*a), q, k, v, lengths)
    args = sum(t.numel() * t.element_size() for t in (q, k, v, lengths))
    assert peak == args + 4 * B * K * nsplit * (H // K) * (d + 2) + 2 * B * H * d


# ---- the cells of every family -------------------------------------------------
FAMILIES = {"gemma2-2b": {"num_layers": 7}, "granite-moe-3b-a800m": {"num_layers": 3},
            "recurrentgemma-9b": {"num_layers": 10}, "rwkv6-7b": {"num_layers": 3},
            "whisper-tiny": {"num_layers": 3, "encoder_layers": 3},
            "llava-next-34b": {"num_layers": 3}}
KINDS = {"train": ShapeSpec("t", 32, 2, "train"), "prefill": ShapeSpec("p", 32, 2, "prefill"),
         "decode": ShapeSpec("d", 32, 2, "decode")}


def _cell(arch, kind, **cfg_kw):
    cfg = reduced(get_config(arch), **{**FAMILIES[arch], **cfg_kw})
    build = {"train": cells.build_train_cell, "prefill": cells.build_prefill_cell,
             "decode": cells.build_decode_cell}[kind]
    return build(arch, KINDS[kind], cfg=cfg)


@pytest.fixture
def no_plain_versions(monkeypatch):
    """Every kernel's plain version raises: the meta route must not run them."""
    def refuse(*a, **k):
        raise AssertionError("a plain version ran on meta tensors")
    for mod in (fa, dec, rg, wk):
        monkeypatch.setattr(mod, "plain", refuse)


# ---- the two-depth count is the full-depth count ------------------------------
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", FAMILIES)
def test_two_depths_extrapolate_to_the_full_count(arch, kind, no_plain_versions):
    full = _cell(arch, kind)
    d1, d2, n1, n_full = costing.depth_variants(full.cfg)
    assert n_full - n1 >= 2, "at least two periods past the first, so the test extrapolates"
    counted = [costing.count_costs(c.fn, *c.args) for c in
               (full, *(_cell(arch, kind, num_layers=d.num_layers,
                              **({"encoder_layers": d.encoder_layers} if d.is_encdec else {})
                              ) for d in (d1, d2)))]
    assert costing.extrapolate(counted[1], counted[2], n1, n_full) == counted[0]
