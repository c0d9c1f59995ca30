#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one H100.

    python3 chip_smoke.py

Phases, each printed on its own lines; any failure exits non-zero:
  1. device   — nvidia-smi name and power limit, torch's device name and
                capability (must be 9.0);
  2. build    — both CUDA kernels from ``src/repro_torch/kernels/csrc`` with
                nvcc for sm_90a, in parallel, with ptxas's resource report;
  3. kernels  — each kernel against its plain PyTorch version at gemma2-2b's
                shapes (bf16, H=8, K=4, d=256, softcap 50, window 4096 and
                global), element by element within one bf16 ulp
                (|err| ≤ 1e-5 + 2^-7·|want|), and planted faults (a kv tile
                skipped, the window one tile wide) that this check must
                reject; kernel, plain and library times (CUDA events) and
                the least time the card could take;
  4. model    — full-width gemma2-2b (random bf16 weights from a seed)
                generating 16 tokens for a ragged batch through the kernels
                (launch counts checked), then the same prefill and first
                decode step with every kernel call held against its plain
                version, and with the plain versions swapped in;
  5. serving  — ``run_server`` with the tris policy on a Poisson workload,
                launch counts checked against the batches served;
then a ``kernels`` JSON line, and last the ``ok`` JSON line.
Needs one card; imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 tensor-core rate
PEAK_BYTES = 3.35e12       # H100 SXM HBM3 bandwidth
# Kernel against plain, element by element.  Both compute in fp32 and round
# once to bf16, so where both are right their outputs differ by at most one
# bf16 ulp (≤ 2^-7·|want|) plus the fp32 summation-order difference (≤ ATOL).
# An absolute limit alone cannot fail a wrong kernel here: most outputs
# average thousands of unit-normal rows and are ~0.02, the size of the 2e-2
# bf16 tolerance of tests/test_kernels.py, while a kernel that drops one
# 32-key tile moves them by ~1e-3.  Planted faults show the limit rejects
# such errors.
RTOL = 2.0 ** -7
ATOL = 1e-5
TILE = 32                  # keys per kv tile in both kernels
# Full-width model, kernel path against plain path on the same weights.
# With fp32 activations the two differ only in fp32 summation order inside
# attention, so logits must agree to the reference's logit tolerance, 1e-3
# (tests/test_models_smoke.py), and the first greedy token must agree.  With
# bf16 activations each layer's output is rounded to bf16, and one-ulp flips
# where the two orders round differently are amplified over 26 random-weight
# layers (0.86 in logits), so the bf16 path is held per attention call (each
# kernel call against its plain version on the model's own activations, to
# RTOL/ATOL above), and its logits may lie at most 1.1x as far from the fp32
# path as the bf16 plain path's do (measured 1.02).
LOGIT_TOL_FP32 = 1e-3
BF16_DRIFT_RATIO = 1.1
PROMPTS = (4700, 1500, 300, 17)   # ragged prefill, one prompt past the window
DECODE_STEPS = 16
SERVE = dict(rate=8.0, duration_s=10.0, prompt_tokens=512)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def held(got, want, rows=None):
    """(max |got − want|, max of |got − want| / (ATOL + RTOL·|want|)) over
    the valid rows: ``rows`` gives, per sequence b, how many of the rows of
    got[b, :, :rows[b]] to compare (all of got when None).  A ratio above 1
    fails."""
    pairs = ([(got, want)] if rows is None else
             [(got[b, :, :n], want[b, :, :n]) for b, n in enumerate(rows)])
    err = ratio = 0.0
    for g, w in pairs:
        g, w = g.float(), w.float()
        e = (g - w).abs()
        err = max(err, float(e.max()))
        ratio = max(ratio, float((e / (ATOL + RTOL * w.abs())).max()))
    return err, ratio


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call on the card, after one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(flops: float, nbytes: float):
    """(least milliseconds, what bounds it) on an H100 SXM."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def phase_device():
    import torch
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device={name} capability={cap} count={torch.cuda.device_count()}")
    require(cap == (9, 0), f"capability {cap} is not Hopper (9, 0)")
    return name


def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    secs = _build.build(["flash_attention", "decode_attention"])
    print(f"[build] {json.dumps({k: round(v, 1) for k, v in secs.items()})} "
          f"wall_s={time.perf_counter() - t0:.1f}")
    for name in ("flash_attention", "decode_attention"):
        fn = spill = ""
        for line in (_build.BUILD_DIR / f"lib{name}.log").read_text().splitlines():
            if "Compiling entry function" in line:
                fn = line.split("'")[1]
            elif "stack frame" in line:
                spill = line.strip()
            elif "Used" in line:
                print(f"[ptxas] {fn}: {line.split(':', 1)[1].strip()}; {spill}")


def flash_case(window: int):
    """K1 at the prefill shapes of gemma2-2b: B=4 ragged prompts padded to
    the longest, H=8 on K=4, d=256, softcap 50."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    B, H, K, d, S = len(PROMPTS), 8, 4, 256, max(PROMPTS)
    g = torch.Generator(device="cuda").manual_seed(1)
    # the model's layout: (B, S, heads, d), handed over as transposed views
    q, k, v = (torch.randn((B, S, h, d), generator=g, device="cuda").to(torch.bfloat16)
               .transpose(1, 2) for h in (H, K, K))
    lengths = torch.tensor(PROMPTS, dtype=torch.int32, device="cuda")
    kw = dict(causal=True, window=window, softcap=50.0, lengths=lengths)
    got = fa.flash_attention(q, k, v, **kw)
    want = fa.plain(q, k, v, **kw)
    # rows past a prompt's length are padding the model discards (a row
    # with no key in its window is 0 from the kernel, the mean of v from
    # the plain version); compare the valid rows
    err, ratio = held(got, want, PROMPTS)
    require(bool(torch.isfinite(got).all()), "flash_attention output finite")
    require(ratio <= 1.0, f"flash_attention window={window} max|err| {err}, "
            f"{ratio}x the limit")
    # planted faults, each the kernel's own output where a wrong kernel would
    # give it: the longest prompt's last kv tile skipped, and (local layers)
    # the window edge one tile late; the check above must reject each
    short = lengths - torch.tensor([TILE, 0, 0, 0], dtype=torch.int32, device="cuda")
    faults = {"last_tile_skipped": fa.flash_attention(q, k, v, **{**kw, "lengths": short})}
    if window:
        faults["window_one_tile_wide"] = fa.flash_attention(
            q, k, v, **{**kw, "window": window + TILE})
    fault_ratio = {name: held(out, want, PROMPTS)[1] for name, out in faults.items()}
    require(all(r > 1.0 for r in fault_ratio.values()),
            f"flash_attention check rejects planted faults {fault_ratio}")
    pos = torch.arange(S, device="cuda")
    mask = (pos[None, :] <= pos[:, None])
    if window:
        mask &= pos[None, :] > pos[:, None] - window
    mask = (mask[None] & (pos[None, None, :] < lengths[:, None, None]))[:, None]
    # work these inputs need: valid query rows × keys in their mask
    pairs = sum(sum(min(i + 1, window or i + 1) for i in range(n)) for n in PROMPTS)
    flops = 4.0 * d * H * pairs
    nbytes = 2.0 * d * B * S * (2 * H + 2 * K)       # q, out, k, v once
    ms_bound, by = bound(flops, nbytes)
    res = dict(max_abs_err=err, limit_ratio=ratio, fault_ratio=fault_ratio,
               ms=cuda_ms(lambda: fa.flash_attention(q, k, v, **kw), 10),
               plain_ms=cuda_ms(lambda: fa.plain(q, k, v, **kw), 3),
               library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                   q, k, v, attn_mask=mask, enable_gqa=True), 10),
               bound_ms=ms_bound, bound_by=by)
    print(f"[kernel flash_attention] window={window} " + json.dumps(res))
    return res


def decode_case(window: int):
    """K2 at the decode shapes of gemma2-2b: B=8, a cache of T=4736 slots in
    the model's (B, T, K, d) layout, H=8 on K=4, d=256, softcap 50."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as da
    B, H, K, d, T = 8, 8, 4, 256, 4736
    g = torch.Generator(device="cuda").manual_seed(2)
    q = torch.randn((B, H, d), generator=g, device="cuda").to(torch.bfloat16)
    k, v = (torch.randn((B, T, K, d), generator=g, device="cuda").to(torch.bfloat16)
            .transpose(1, 2) for _ in range(2))
    q_pos = torch.tensor([4735, 4700, 4500, 4100, 3000, 1500, 300, 17],
                         dtype=torch.int32, device="cuda")
    t = torch.arange(T, device="cuda")[None, :]
    holes = torch.rand((B, T), generator=g, device="cuda") < 0.05  # padded slots
    slot_pos = torch.where((t <= q_pos[:, None]) & ~holes, t, -1).to(torch.int32)
    lengths = torch.clamp(q_pos + 1, max=T).to(torch.int32)
    kw = dict(softcap=50.0, window=window, q_pos=q_pos, slot_pos=slot_pos)
    got = da.decode_attention(q, k, v, lengths, **kw)
    want = da.plain(q, k, v, lengths, **kw)
    err, ratio = held(got, want)
    require(bool(torch.isfinite(got).all()), "decode_attention output finite")
    require(ratio <= 1.0, f"decode_attention window={window} max|err| {err}, "
            f"{ratio}x the limit")
    # planted faults, as in flash_case: one kv tile of slots (positions
    # 1024..1055, live for the six longest rows) skipped, and (local layers)
    # the window edge one tile late; the check above must reject each
    gap = slot_pos.clone()
    gap[:, 1024:1024 + TILE] = -1
    faults = {"one_tile_skipped": da.decode_attention(
        q, k, v, lengths, **{**kw, "slot_pos": gap})}
    if window:
        faults["window_one_tile_wide"] = da.decode_attention(
            q, k, v, lengths, **{**kw, "window": window + TILE})
    fault_ratio = {name: held(out, want)[1] for name, out in faults.items()}
    require(all(r > 1.0 for r in fault_ratio.values()),
            f"decode_attention check rejects planted faults {fault_ratio}")
    from repro_torch.kernels.ref import decode_mask
    mask = decode_mask(lengths, T, window=window, q_pos=q_pos, slot_pos=slot_pos)
    live = int(mask.sum())
    nbytes = 2.0 * (2 * live * K * d + 2 * B * H * d)   # live K/V rows, q, out
    ms_bound, by = bound(4.0 * d * H * live, nbytes)
    res = dict(max_abs_err=err, limit_ratio=ratio, fault_ratio=fault_ratio,
               ms=cuda_ms(lambda: da.decode_attention(q, k, v, lengths, **kw), 50),
               plain_ms=cuda_ms(lambda: da.plain(q, k, v, lengths, **kw), 10),
               library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                   q[:, :, None], k, v, attn_mask=mask[:, None, None],
                   enable_gqa=True), 50),
               bound_ms=ms_bound, bound_by=by)
    print(f"[kernel decode_attention] window={window} " + json.dumps(res))
    return res


def merge(cases):
    """One kernel's record over gemma2-2b's two layer kinds: the mean of
    each time over the local (4096) and global cases, the worst error."""
    out = {key: float(np.mean([c[key] for c in cases]))
           for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
    out["max_abs_err"] = max(c["max_abs_err"] for c in cases)
    out["bound_by"] = cases[0]["bound_by"]
    return out


def phase_model():
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.serving.engine import (greedy_sample, make_decode_fn,
                                            make_generate_fn, make_prefill_fn,
                                            serving_config)
    cfg = serving_config(get_config("gemma2-2b"))
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    B, S = len(PROMPTS), max(PROMPTS)
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S))
                              .astype(np.int32)).cuda()
    lengths = torch.tensor(PROMPTS, dtype=torch.int32, device="cuda")
    max_len = S + DECODE_STEPS

    # the main path: counts at 0 just before, read just after
    fa.launches = da.launches = 0
    t0 = time.perf_counter()
    out = make_generate_fn(model, DECODE_STEPS, max_len=max_len)(params, tokens, lengths)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    launches = {"flash_attention": fa.launches, "decode_attention": da.launches}
    print(f"[model] gemma2-2b generate B={B} prompts={list(PROMPTS)} "
          f"steps={DECODE_STEPS} s={gen_s:.3f} launches={json.dumps(launches)}")
    require(launches["flash_attention"] == cfg.num_layers,
            f"flash launches {launches['flash_attention']} != {cfg.num_layers}")
    require(launches["decode_attention"] == cfg.num_layers * DECODE_STEPS,
            f"decode launches {launches['decode_attention']} != "
            f"{cfg.num_layers * DECODE_STEPS}")
    require(tuple(out.shape) == (B, DECODE_STEPS + 1), f"tokens shape {out.shape}")
    require(bool(((out >= 0) & (out < cfg.vocab_size)).all()), "token ids in range")

    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    # The same prefill and first decode step through the kernels and through
    # the plain versions (swapped in here; the package has no switch), all
    # decoding the same token, with bf16 activations (as served) and with
    # fp32 activations on the same bf16 weights.  The bf16 kernel run also
    # holds every kernel call against the plain version on the same inputs.
    tok = None
    worst = {"flash_attention": 0.0, "decode_attention": 0.0}

    def checked_flash(q, k, v, **kw):
        got = fa.flash_attention(q, k, v, **kw)
        rows = kw["lengths"].tolist()
        worst["flash_attention"] = max(worst["flash_attention"],
                                       held(got, fa.plain(q, k, v, **kw), rows)[1])
        return got

    def checked_decode(q, k, v, lengths, **kw):
        got = da.decode_attention(q, k, v, lengths, **kw)
        worst["decode_attention"] = max(worst["decode_attention"],
                                        held(got, da.plain(q, k, v, lengths, **kw))[1])
        return got

    swaps = {"kernel": None, "plain": (fa.plain, da.plain),
             "checked": (checked_flash, checked_decode)}

    def prefill_and_step(m, path: str):
        nonlocal tok
        kernels = (ops.flash_attention, ops.decode_attention)
        if swaps[path]:
            ops.flash_attention, ops.decode_attention = swaps[path]
        try:
            cache, pre = make_prefill_fn(m, max_len)(params, tokens, lengths)
            tok = greedy_sample(pre) if tok is None else tok
            _, dec = make_decode_fn(m)(params, cache, tok)
        finally:
            ops.flash_attention, ops.decode_attention = kernels
        for what, t in (("prefill", pre), ("decode", dec)):
            require(tuple(t.shape) == (B, cfg.vocab_size), f"{what} logits shape")
            require(bool(torch.isfinite(t).all()), f"{what} logits finite")
        return pre, dec

    # fp32 activations and an fp32 cache; the weights stay the bf16 ones
    model32 = build_model(dataclasses.replace(cfg, dtype="float32",
                                              serve_param_dtype="float32"))
    runs = {("bf16", "kernel"): prefill_and_step(model, "checked"),
            ("bf16", "plain"): prefill_and_step(model, "plain"),
            ("fp32", "kernel"): prefill_and_step(model32, "kernel"),
            ("fp32", "plain"): prefill_and_step(model32, "plain")}

    def diff(a, b, i):
        return float((runs[a][i] - runs[b][i]).abs().max())

    def first(dt, path):
        return greedy_sample(runs[(dt, path)][0])

    def gaps(dt):
        top2 = runs[(dt, "plain")][0].topk(2, dim=-1).values
        return (top2[:, 0] - top2[:, 1]).tolist()

    d32 = max(diff(("fp32", "kernel"), ("fp32", "plain"), i) for i in (0, 1))
    d16 = max(diff(("bf16", "kernel"), ("bf16", "plain"), i) for i in (0, 1))
    far_k = max(diff(("bf16", "kernel"), ("fp32", "plain"), i) for i in (0, 1))
    far_p = max(diff(("bf16", "plain"), ("fp32", "plain"), i) for i in (0, 1))
    same32 = first("fp32", "kernel") == first("fp32", "plain")
    # reported, not held: random weights leave top-two gaps of ~0.2 logits,
    # below the ~0.9 that any two bf16 summation orders drift apart
    same16 = first("bf16", "kernel") == first("bf16", "plain")
    print(f"[model] per-call limit ratio, bf16 on the model's activations: "
          f"{json.dumps(worst)} (fail above 1)")
    print(f"[model] max|Δlogit| fp32 kernel-vs-plain={d32} (tol {LOGIT_TOL_FP32}) "
          f"bf16 kernel-vs-plain={d16}; to the fp32 path: bf16 kernel={far_k} "
          f"bf16 plain={far_p} ratio={far_k / far_p} (tol {BF16_DRIFT_RATIO})")
    print(f"[model] first token agrees fp32={same32.tolist()} top2_gap={gaps('fp32')}; "
          f"bf16={same16.tolist()} top2_gap={gaps('bf16')} (not held); "
          f"generate_max_memory_allocated_gb={peak_gb:.2f}")
    require(all(r <= 1.0 for r in worst.values()),
            "every bf16 kernel call on the model's activations within the limit")
    require(d32 <= LOGIT_TOL_FP32, "fp32 kernel vs plain logits")
    require(bool(same32.all()), "fp32 first greedy token agrees")
    require(far_k <= BF16_DRIFT_RATIO * far_p, "bf16 kernel path drift")
    return launches


def phase_serving():
    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.serve import run_server
    from repro_torch.serving.batching import make_policy
    from repro_torch.serving.engine import serving_config
    from repro_torch.serving.workload import WorkloadSpec, generate
    cfg = serving_config(get_config("gemma2-2b"))
    policy = make_policy("tris")
    wl = WorkloadSpec(kind="poisson", seed=0, **SERVE)
    # the main path again: counts at 0 just before, read just after
    fa.launches = da.launches = 0
    res = run_server(cfg, policy, wl, max_len=SERVE["prompt_tokens"] + DECODE_STEPS,
                     decode_steps=DECODE_STEPS)
    launches = {"flash_attention": fa.launches, "decode_attention": da.launches}
    print(f"[serving] gemma2-2b tris poisson {json.dumps(SERVE)} "
          f"decode_steps={DECODE_STEPS} {json.dumps(res)} launches={json.dumps(launches)}")
    require(res["requests"] == len(generate(wl)), "every request served")
    require(all(np.isfinite(v) for v in res.values()), "finite serving metrics")
    # run_server warms up with one prefill and one decode step at each batch
    # size the policy emits, then runs a prefill and decode_steps − 1 steps
    # per batch
    warm = len({1, getattr(policy, "max_batch", 1), *getattr(policy, "preferred", (1,))})
    batches = round(res["requests"] / res["mean_batch"])
    want = {"flash_attention": cfg.num_layers * (batches + warm),
            "decode_attention": cfg.num_layers * ((DECODE_STEPS - 1) * batches + warm)}
    require(launches == want, f"serving launches {launches} != {want}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    # fp32 products on the card stay IEEE in every comparison below
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = phase_device()
    phase_build()
    flash = merge([flash_case(4096), flash_case(0)])
    decode = merge([decode_case(4096), decode_case(0)])
    torch.cuda.empty_cache()
    launches = phase_model()
    torch.cuda.empty_cache()
    phase_serving()
    src = "src/repro_torch/kernels/csrc/"
    print(json.dumps({"kernels": [
        dict(name="flash_attention", route="cuda", source=src + "flash_attention.cu",
             replaces="src/repro/kernels/flash_attention.py:94",
             launches=launches["flash_attention"], **flash),
        dict(name="decode_attention", route="cuda", source=src + "decode_attention.cu",
             replaces="src/repro/kernels/decode_attention.py:73",
             launches=launches["decode_attention"], **decode),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
