#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one H100.

    python3 chip_smoke.py

Phases, each printed on its own lines; any failure exits non-zero:
  1. device   — nvidia-smi name and power limit, torch's device name and
                capability (must be 9.0);
  2. build    — the five CUDA kernels from ``src/repro_torch/kernels/csrc``
                with nvcc for sm_90a, in parallel, with ptxas's resource
                report (no instantiation may spill, K3's bf16 and K4's
                N = 32 ones included);
  3. kernels  — each kernel against its plain PyTorch version, element by
                element, with planted faults that the check must reject, and
                kernel, plain and library times (CUDA events) beside the
                least time the card could take:
                K1 and K2 at gemma2-2b's shapes (bf16, H=8, K=4, d=256,
                softcap 50, window 4096 and global) and at recurrentgemma-9b's
                (H=16, K=1, window 2048, no softcap; K2 over a 2048-slot
                ring), within one bf16 ulp (|err| ≤ 1e-5 + 2^-7·|want|) of
                their plain versions computed in float64, K2's faults
                including one split of its plan dropped;
                K3 at recurrentgemma-9b's prefill shapes bitwise equal to
                its plain version (ring or register variant, as its plan
                chooses; the plan is printed), its faults including the
                state carried across one stage boundary dropped; K4 at
                rwkv6-7b's prefill
                shapes (H=64 heads of 64, bf16 r/k/v), held to its plain
                version computed in float64, its output within one bf16 ulp
                plus a bound on its chunked arithmetic and its final fp32
                state within that bound (see wkv_atol), planted faults
                including a segment started from a zero state; K3 again
                with bf16 a/b/seq (bitwise, its B = 1 time beside) and K4
                again at the calibration's shape (B=4, S=256, H=2 heads of
                N=32), each with the same limits;
                K5 at gemma2-2b's MLP down-projection for a prefill of 8 ×
                512 tokens (x (4096, 9216) and w (9216, 2304) int8), bitwise
                equal to its exact plain version with w row-major and
                column-major and at K − 4 (zero-padded; handed operands
                whose padding is not zero, it must fail), within
                VERIFY_TOL["int8"]·max|want| of the dequantizing reference,
                timed with both layouts of w (the transposing pass's share),
                its library time that of ``torch._int_mm`` (the int32
                product only, unscaled);
  4. model    — full-width gemma2-2b (random bf16 weights from a seed)
                generating 16 tokens for a ragged batch through the kernels
                (launch counts checked), then the same prefill and first
                decode step with every kernel call held against its plain
                version (K1, K2 and K4's computed in float64; K3 bitwise,
                on the ring variant), and with the plain versions swapped
                in;
  5. serving  — gemma2-2b behind ``run_server`` with the tris policy on a
                Poisson workload, launch counts checked against the batches
                served;
  6. model    — phase 4 for full-width recurrentgemma-9b (38 layers, 26
                RG-LRU through K3 and 12 local attention through K1/K2);
  7. serving  — phase 5 for recurrentgemma-9b;
  8. model    — phase 4 for full-width rwkv6-7b (32 RWKV6 layers, the WKV
                recurrence through K4 on prefill, no attention);
  9. serving  — phase 5 for rwkv6-7b;
 10. calibration — the kernel-calibration backend on the card:
                ``kernel_records()`` with its defaults (all five kernels,
                batches (1, 2, 4) × seqs (64, 128, 256), fp32 and bf16, int8
                for K5: 81 records, each kernel verified against its
                reference first; K3's fp32 record exactly), the nine
                per-(kernel, dtype) fits, the int8 ``compute_scale`` from
                ``derive_speed_modes``, and the ``launch.bench_kernels``
                smoke sweep; launch counts checked; then every kernel held
                to its plain version at every point of the grid
                (``held_on_grid``: K3 and K5 bitwise, K4 within
                ``wkv_atol``, all within ``VERIFY_TOL``; plans printed);
 11. session  — the benchmark-job system (``repro_torch.core``) on the card:
                the four generated families at the Fig. 9 point (L = 8,
                W = 512, batch 4, seq 32), the sequence families also at
                the jobs' seq 64, held to the same modules in float64 on
                the CPU (|err| ≤ 1e-5 + 1e-4·|want|, in float64 and in fp32
                on the card, fp32 also within GEN_DRIFT times the CPU fp32
                run's distance; a TF32 run of each family must fail the
                check); then a ``BenchmarkSession`` with the InlineExecutor
                and a PerfDB file runs the four generated jobs, a measured
                fc calibration (L = 4, W = 256, batches 16–256) with all
                five kernels on its hook (launch counts exact; after the
                run every kernel held at every point the hook timed, as in
                phase 10), an oracle calibration of gemma2-2b on h100,
                gemma2-2b serving jobs on h100 on the roofline oracle and
                on the measured profile, and quickstart.json, whose records
                must equal those of a second session with concurrent
                followers; the PerfDB file must hold every record and read
                back equal;
 12. plan     — measure → model → plan through the job-config launcher
                (``repro_torch.launch.run_jobs``), from a temporary working
                directory holding a copy of configs/: an oracle calibration
                of gemma2-2b on h100 on calibrate_plan.json's grid (batches
                1–16 × seqs 32–256) with all five kernels on its hook (180
                verified records, launch counts exact; after the phase every
                kernel held at every point, as in phase 10); then, in a
                second run, a plan on the h100 profile it fitted
                (calibrate_plan.json's workload and SLO, replicas 1/2/4 ×
                tfs/continuous × fp16/int8/speculative, objective p99_s: 18
                candidates, the best re-simulated exactly); then all seven
                configs/jobs/*.json inline and with concurrent followers
                (records equal), each session's HTML report, and a span
                timeline on the fitted profile (engine spans; the summary
                equal to the run without observability);
then a ``kernels`` JSON line (``hook_launches``: phase 11's,
``plan_hook_launches``: phase 12's), and last the ``ok`` JSON line.
Needs one card; imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import dataclasses
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 tensor-core rate
PEAK_FP32_FLOPS = 67e12    # H100 SXM fp32 rate outside the tensor cores
PEAK_INT8_OPS = 1979e12    # H100 SXM dense int8 tensor-core rate
PEAK_BYTES = 3.35e12       # H100 SXM HBM3 bandwidth
# Kernel against plain, element by element.  The attention kernels compute
# in fp32 and are held to their plain versions computed in float64 (``acc``;
# their fp32 default is the CPU path and plain_ms), and both round once to
# bf16, so where both are right their outputs differ by at most one bf16 ulp
# (≤ 2^-7·|want|) plus the kernel's fp32 summation error (≤ ATOL).  (Held
# to the fp32 plain version, a right kernel failed on a cancelling output of
# gemma2-2b's activations, 17 bf16 ulps from the fp32 sum and one from the
# float64 one.)
# An absolute limit alone cannot fail a wrong kernel here: most outputs
# average thousands of unit-normal rows and are ~0.02, the size of the 2e-2
# bf16 tolerance of tests/test_kernels.py, while a kernel that drops one
# 32-key tile moves them by ~1e-3.  Planted faults show the limit rejects
# such errors.
RTOL = 2.0 ** -7
ATOL = 1e-5
# K3 against plain: both are the same sequential fp32 recurrence, each step
# rounded twice (a product, then a sum) and each stored state once, so K3 is
# held bitwise (torch.equal), in both variants and both types.
#
# K4 is the chunked form on the tensor cores, which sums in another order
# than the plain recurrence, so it is held to the plain version computed in
# float64 (``acc``), entry by entry, with limits from its own arithmetic
# (u = 2^-24, the unit roundoff of fp32; T = 32 steps a chunk, N the head
# size, C = ceil(S / T) chunks):
# - A decay factor: the decays of r, of k and A's pairwise ones are running
#   products of at most T - 1 factors e^{w} (expf ≤ 2 ulp = 4u, each
#   product rounded u), ≤ 5Tu; each product with r or k adds u.
# - A product in 3 tf32 passes: ≤ 12u (the dropped small·small term and
#   what the small part's own tf32 rounding leaves, 4u each side).
# - Sums: each k8 step is 24 products summed in the tensor core, whose
#   fp32 adds truncate (≤ 2u each): 48u; the steps are then added in IEEE
#   fp32, (N + T) / 8 of them for an output, T / 8 for the state's
#   increment; A[t, s] sums N terms (≤ Nu).
# - The state carried into the next chunk: the chunk's decay (≤ (|x| + 4)u
#   with x = Σ_j w_j, the double sum rounded to fp32 once, expf's 2 ulp
#   after it) and the fused update (u): ≤ (|x| + 5)u of the carried term.
#   The segment chain's step into segment p + 1 likewise: ≤ (|X_p| + 5)u of
#   d_p·|S_p|, X_p the segment's Σ w.
# So with A_c the state of the plain recurrence run on |r|, |k|, |v|, |u|
# and |s0| (it bounds every term's absolute value, entry by entry, as
# e^w > 0) at the start of chunk c, D_c = e^{x_c} and I_c = |k ⊙ decay|^T|V|
# the chunk's increment, the error E_c of the state at the start of chunk c
# is at most
#   E_0 = 0,  E_{c+1} = D_c·E_c + (|x_c| + 5)u·D_c·A_c + γ_i·I_c
#         (+ (|X_p| + 5)u·d_p·A at segment p's start, where c + 1 starts p + 1),
#   γ_i = (5T + 12 + 48 + T/8)u,
# which contracts with the decays: a chunk's rounding fades as the state it
# sits in does.  An output of chunk c is then within γ_o·M + |r ⊙ decay|·E_c,
# γ_o = (5T + N + 12 + 48 + (N + T)/8)u, M the output of the absolute-value
# recurrence.  Kernel and float64 plain version may differ by
# ATOL + 2(γ_o·M + |r ⊙ decay|·E_c) + RTOL·|want| on an output (RTOL: one ulp
# of a bf16 output; the factor 2 as before) and by ATOL + 2·E_C on the final
# state (wkv_atol runs both recurrences in float64 on the card).  These
# limits replace the earlier ones, whose argument (an elementwise state
# update, bitwise the plain version's) no longer holds.  The contraction
# matters: 12u a chunk on the whole carried state, 2γ = 4568u of M at
# rwkv6-7b's prompts (C = 147), lets a kernel with a single tf32 pass
# through the output check.  Planted faults show the limits still reject a
# wrong kernel.
UNIT = 2.0 ** -24   # u, the unit roundoff of fp32, in K4's limits above
# Full-width model, kernel path against plain path on the same weights.
# With fp32 activations the two differ only in fp32 summation order inside
# the kernels (attention; the WKV kernel's chunked tf32 products, within a
# few u of float64), so logits must agree to the reference's logit
# tolerance, 1e-3 (tests/test_models_smoke.py), and the first greedy token
# must agree.  With
# bf16 activations each layer's output is rounded to bf16, and one-ulp flips
# where the two orders round differently are amplified over 26 random-weight
# layers (0.86 in logits), so the bf16 path is held per kernel call (each
# kernel call against its plain version on the model's own activations, to
# the limits above), and its logits may lie at most 1.1x as far from the fp32
# path as the bf16 plain path's do (measured 1.02 on gemma2-2b).
LOGIT_TOL_FP32 = 1e-3
BF16_DRIFT_RATIO = 1.1
PROMPTS = (4700, 1500, 300, 17)   # ragged prefill, one prompt past the window
DECODE_STEPS = 16
SERVE = {"gemma2-2b": dict(rate=8.0, duration_s=10.0, prompt_tokens=512),
         "recurrentgemma-9b": dict(rate=4.0, duration_s=5.0, prompt_tokens=512),
         "rwkv6-7b": dict(rate=4.0, duration_s=5.0, prompt_tokens=512)}
MODEL_KERNELS = ("flash_attention", "decode_attention", "rglru_scan", "wkv6")
KERNELS = MODEL_KERNELS + ("int8_matmul",)   # K5 runs on the calibration path only


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def held(got, want, rows=None, atol=ATOL, rtol=RTOL):
    """(max |got − want|, max of |got − want| / (atol + rtol·|want|)) over
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
        ratio = max(ratio, float((e / (atol + rtol * w.abs())).max()))
    return err, ratio


def flash_want(q, k, v, **kw):
    """K1's plain version in float64, the check of the kernel: one sequence
    at a time, as its float64 logits over 4700 keys take 2.8 GB a sequence
    at recurrentgemma-9b's 16 heads."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    lengths = kw.pop("lengths")
    return torch.cat([fa.plain(q[b:b + 1], k[b:b + 1], v[b:b + 1], lengths=lengths[b:b + 1],
                               acc=torch.float64, **kw) for b in range(q.shape[0])])


def decode_want(q, k, v, lengths, **kw):
    """K2's plain version in float64, the check of the kernel."""
    import torch
    from repro_torch.kernels import decode_attention as da
    return da.plain(q, k, v, lengths, acc=torch.float64, **kw)


def exact_scan(got, want):
    """(K3's (seq, last) pair bitwise equal to the plain version's, max
    |got − want| over both)."""
    import torch
    equal = all(torch.equal(g, w) for g, w in zip(got, want))
    err = max((float((g.float() - w.float()).abs().max())
               for g, w in zip(got, want) if g.numel()), default=0.0)
    return equal, err


def wkv_atol(r, k, v, logw, u, s0):
    """K4's absolute limits on its output and final state, entry by entry:
    ATOL + 2(γ_o·M + |r ⊙ decay|·E_c) and ATOL + 2·E_C, from the float64
    plain recurrence on absolute values and the chunk by chunk recurrence of
    the state's error bound E (see the comment above UNIT)."""
    import torch
    from repro_torch.kernels import wkv6 as wk
    B, S, H, N = r.shape
    T, unit = wk.CHUNK, UNIT
    mag, _ = wk.plain(r.double().abs(), k.double().abs(), v.double().abs(), logw, u.abs(),
                      s0.abs(), acc=torch.float64)
    C, (_, Lc) = -(-S // T), wk.plan_segments(B, H, S)

    def chunked(x):  # (B, C, T, H, N) in float64, zeros past S
        x = torch.nn.functional.pad(x.double(), (0, 0, 0, 0, 0, C * T - S))
        return x.view(B, C, T, H, N)
    ra, ka, va, w = (chunked(x) for x in (r.abs(), k.abs(), v.abs(), logw))
    g_i = (5 * T + 12 + 48 + T / 8) * unit
    g_o = (5 * T + N + 12 + 48 + (N + T) / 8) * unit
    a = s0.double().abs()                 # A_c, (B, H, N, N)
    e = torch.zeros_like(a)               # E_c
    seg_a, seg_x = a, torch.zeros_like(a[..., 0])
    carried = torch.empty((B, C, T, H, N), dtype=torch.float32, device=r.device)
    for c in range(C):
        lc = w[:, c].cumsum(1)            # Σ_{j<=t} w_j, (B, T, H, N)
        x = lc[:, -1]
        carried[:, c] = torch.einsum("bthd,bhde->bthe", ra[:, c] * torch.exp(lc - w[:, c]), e)
        inc = torch.einsum("bthd,bthe->bhde", ka[:, c] * torch.exp(x[:, None] - lc), va[:, c])
        dt = torch.exp(x)[..., None]
        e = dt * e + (x.abs()[..., None] + 5) * unit * dt * a + g_i * inc
        a = dt * a + inc
        seg_x = seg_x + x
        if (c + 1) % Lc == 0 and c + 1 < C:   # the chain's step into the next segment
            e = e + (seg_x.abs()[..., None] + 5) * unit * torch.exp(seg_x)[..., None] * seg_a
            seg_a, seg_x = a, torch.zeros_like(seg_x)
    carried = carried.view(B, C * T, H, N)[:, :S]
    return ATOL + 2.0 * (g_o * mag.float() + carried), ATOL + 2.0 * e.float()


def wkv_want(*args):
    """K4's plain version in float64, the check of the kernel."""
    import torch
    from repro_torch.kernels import wkv6 as wk
    return wk.plain(*args, acc=torch.float64)


def held_wkv(got, want, atols):
    """``held`` over K4's (out, final state) pair: out within ``atols[0]``
    (``wkv_atol``) and one ulp of its dtype (RTOL), the state within
    ``atols[1]``.  → (max |err|, worst ratio, (the output's ratio, the
    state's))."""
    (e_o, r_o), (e_s, r_s) = (held(got[0], want[0], atol=atols[0]),
                              held(got[1], want[1], atol=atols[1], rtol=0.0))
    return max(e_o, e_s), max(r_o, r_s), (r_o, r_s)


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


def bound(flops: float, nbytes: float, peak_flops: float = PEAK_BF16_FLOPS):
    """(least milliseconds, what bounds it) on an H100 SXM."""
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def counters():
    from repro_torch.kernels import (decode_attention, flash_attention, int8_matmul,
                                     rglru_scan, wkv6)
    return {"flash_attention": flash_attention, "decode_attention": decode_attention,
            "rglru_scan": rglru_scan, "wkv6": wkv6, "int8_matmul": int8_matmul}


def reset_launches():
    for mod in counters().values():
        mod.launches = 0


def read_launches():
    return {name: mod.launches for name, mod in counters().items()}


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
    secs = _build.build(KERNELS)
    print(f"[build] {json.dumps({k: round(v, 1) for k, v in secs.items()})} "
          f"wall_s={time.perf_counter() - t0:.1f}")
    spilled = []
    for name in KERNELS:
        fn = spill = ""
        for line in (_build.BUILD_DIR / f"lib{name}.log").read_text().splitlines():
            if "Compiling entry function" in line:
                fn = line.split("'")[1]
            elif "stack frame" in line:
                spill = line.strip()
                if int(re.search(r"(\d+) bytes spill stores", spill).group(1)):
                    spilled.append(fn)
            elif "Used" in line:
                print(f"[ptxas] {fn}: {line.split(':', 1)[1].strip()}; {spill}")
    print("[ptxas] decode_attention: decode_kernel<T, D, NG> takes H/K up to 16 "
          "in one block (NG = 2 tiles of 8 heads above 8); combine_kernel merges "
          "the splits")
    require(not spilled, f"no kernel instantiation spills: {spilled}")


def flash_case(arch: str, H: int, K: int, window: int, softcap: float):
    """K1 at the prefill shapes of ``arch``: B=4 ragged prompts padded to the
    longest, H query heads on K kv heads, d=256."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    B, d, S = len(PROMPTS), 256, max(PROMPTS)
    g = torch.Generator(device="cuda").manual_seed(1)
    # the model's layout: (B, S, heads, d), handed over as transposed views
    q, k, v = (torch.randn((B, S, h, d), generator=g, device="cuda").to(torch.bfloat16)
               .transpose(1, 2) for h in (H, K, K))
    lengths = torch.tensor(PROMPTS, dtype=torch.int32, device="cuda")
    kw = dict(causal=True, window=window, softcap=softcap, lengths=lengths)
    got = fa.flash_attention(q, k, v, **kw)
    want = flash_want(q, k, v, **kw)
    # rows past a prompt's length are padding the model discards (a row
    # with no key in its window is 0 from the kernel, the mean of v from
    # the plain version); compare the valid rows
    err, ratio = held(got, want, PROMPTS)
    require(bool(torch.isfinite(got).all()), "flash_attention output finite")
    require(ratio <= 1.0, f"flash_attention {arch} window={window} max|err| {err}, "
            f"{ratio}x the limit")
    # planted faults, each the kernel's own output where a wrong kernel would
    # give it: the longest prompt's last kv tile skipped, and (local layers)
    # the window edge one tile late; the check above must reject each
    tile = fa.KV_TILE[q.dtype, d]
    short = lengths - torch.tensor([tile, 0, 0, 0], dtype=torch.int32, device="cuda")
    faults = {"last_tile_skipped": fa.flash_attention(q, k, v, **{**kw, "lengths": short})}
    if window:
        faults["window_one_tile_wide"] = fa.flash_attention(
            q, k, v, **{**kw, "window": window + tile})
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
    print(f"[kernel flash_attention] {arch} H={H} K={K} window={window} "
          f"softcap={softcap} " + json.dumps(res))
    return res


def decode_case(arch: str, H: int, K: int, T: int, window: int, softcap: float,
                ring: bool):
    """K2 at the decode shapes of ``arch``: B=8, a cache of T slots in the
    model's (B, T, K, d) layout, H query heads on K kv heads, d=256.  Without
    ``ring`` slot t holds position t (a full-length cache); with it slot t
    holds the latest position ≡ t (mod T), as in a local layer's ring."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels.ref import decode_mask
    B, d = 8, 256
    g = torch.Generator(device="cuda").manual_seed(2)
    q = torch.randn((B, H, d), generator=g, device="cuda").to(torch.bfloat16)
    k, v = (torch.randn((B, T, K, d), generator=g, device="cuda").to(torch.bfloat16)
            .transpose(1, 2) for _ in range(2))
    q_pos = torch.tensor([4735, 4700, 4500, 4100, 3000, 1500, 300, 17],
                         dtype=torch.int32, device="cuda")
    t = torch.arange(T, device="cuda")[None, :]
    holes = torch.rand((B, T), generator=g, device="cuda") < 0.05  # padded slots
    qp = q_pos[:, None]
    pos = qp - ((qp - t) % T) if ring else t
    slot_pos = torch.where((pos >= 0) & (pos <= qp) & ~holes, pos, -1).to(torch.int32)
    lengths = torch.clamp(q_pos + 1, max=T).to(torch.int32)
    kw = dict(softcap=softcap, window=window, q_pos=q_pos, slot_pos=slot_pos)
    got = da.decode_attention(q, k, v, lengths, **kw)
    want = decode_want(q, k, v, lengths, **kw)
    err, ratio = held(got, want)
    require(bool(torch.isfinite(got).all()), "decode_attention output finite")
    require(ratio <= 1.0, f"decode_attention {arch} window={window} max|err| {err}, "
            f"{ratio}x the limit")
    # planted faults, as in flash_case: one tile of slots (1024..1055, live
    # for the six longest rows) skipped; one split of the kernel's plan
    # (the second, live for six or seven of the eight rows) dropped; on a
    # full-length cache the window edge one tile late (a ring of the window
    # holds no position outside it, so there a wider window changes
    # nothing); with more than 8 query heads per kv head, heads 8-15 given
    # heads 0-7's queries.  The check above must reject each.
    tile = da.TILE[q.dtype, d]
    gap = slot_pos.clone()
    gap[:, 1024:1024 + tile] = -1
    nsplit, chunk = da.plan_splits(B, K, T, d, q.element_size())
    require(nsplit > 2, f"decode_attention {arch} splits the cache ({nsplit} splits)")
    dropped = slot_pos.clone()
    dropped[:, chunk:2 * chunk] = -1
    faults = {"one_tile_skipped": da.decode_attention(
        q, k, v, lengths, **{**kw, "slot_pos": gap}),
        "one_split_dropped": da.decode_attention(
        q, k, v, lengths, **{**kw, "slot_pos": dropped})}
    if window and not ring:
        faults["window_one_tile_wide"] = da.decode_attention(
            q, k, v, lengths, **{**kw, "window": window + tile})
    if H // K > 8:
        q_dup = q.clone()
        q_dup[:, 8:16] = q[:, 0:8]
        faults["head_block_swapped"] = da.decode_attention(q_dup, k, v, lengths, **kw)
    fault_ratio = {name: held(out, want)[1] for name, out in faults.items()}
    require(all(r > 1.0 for r in fault_ratio.values()),
            f"decode_attention check rejects planted faults {fault_ratio}")
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
    print(f"[kernel decode_attention] {arch} H={H} K={K} T={T} ring={ring} "
          f"window={window} softcap={softcap} splits={nsplit}x{chunk} " + json.dumps(res))
    return res


def rglru_case(dtype: str = "float32"):
    """K3 at recurrentgemma-9b's prefill shapes: the B=4 ragged prompts padded
    to the longest, R=4096, pad steps a=1, b=0 as the model gives them; a and
    b in ``dtype`` (the model sends fp32; the calibration also bf16).  Held
    bitwise; the register variant and a batch of one are timed beside."""
    import torch
    from repro_torch.kernels import rglru_scan as rg
    B, S, R = len(PROMPTS), max(PROMPTS), 4096
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(3)
    lengths = torch.tensor(PROMPTS, device="cuda")
    valid = (torch.arange(S, device="cuda")[None, :] < lengths[:, None])[..., None]
    a = torch.where(valid, 0.5 + 0.499 * torch.rand((B, S, R), generator=g,
                                                    device="cuda"), 1.0).to(dt)
    b = torch.where(valid, 0.1 * torch.randn((B, S, R), generator=g, device="cuda"),
                    0.0).to(dt)
    s0 = torch.randn((B, R), generator=g, device="cuda")
    got = rg.rglru_scan(a, b, s0)
    plan = rg.last_plan
    want = rg.plain(a, b, s0)
    require(got[0].dtype == dt and got[1].dtype == torch.float32, "rglru_scan dtypes")
    equal, err = exact_scan(got, want)
    require(all(bool(torch.isfinite(x).all()) for x in got), "rglru_scan output finite")
    require(equal, f"rglru_scan {dtype} {plan} bitwise equal to plain (max|err| {err})")
    require(plan.variant == "ring", f"rglru_scan {dtype} at the model's shape runs the ring")
    # planted faults, each the kernel's own output where a wrong kernel would
    # give it: one valid step of the longest prompt skipped (a=1, b=0); the
    # state carried into the ring's second stage dropped (a=0 at its first
    # step, so the state restarts from b there)
    faults = {}
    for name, t, fill in (("one_step_skipped", 1000, (1.0, 0.0)),
                          ("state_dropped_at_stage_boundary", plan.steps, (0.0, None))):
        a_f, b_f = a.clone(), b.clone()
        a_f[:, t] = fill[0]
        if fill[1] is not None:
            b_f[:, t] = fill[1]
        faults[name] = exact_scan(rg.rglru_scan(a_f, b_f, s0), want)
    require(not any(eq for eq, _ in faults.values()),
            f"rglru_scan check rejects planted faults {faults}")
    # a and b read once, s0 read once, seq and last written once; two
    # fp32 operations a step
    size = a.element_size()
    ms_bound, by = bound(2.0 * B * S * R, size * 3.0 * B * S * R + 4.0 * 2 * B * R,
                         PEAK_FP32_FLOPS)
    one = [x[:1] for x in (a, b, s0)]   # a batch of one, the card covered by C = 32
    require(exact_scan(rg.rglru_scan(*one), rg.plain(*one))[0],
            f"rglru_scan {dtype} {rg.last_plan} at B=1 bitwise equal to plain")
    one_plan = rg.last_plan
    res = dict(max_abs_err=err,
               fault_max_abs_err={k: e for k, (_, e) in faults.items()},
               plan=plan._asdict(),
               ms=cuda_ms(lambda: rg.rglru_scan(a, b, s0), 20),
               register_ms=cuda_ms(lambda: rg.rglru_scan(a, b, s0, use=rg.REGISTER), 20),
               batch1_plan=one_plan._asdict(),
               batch1_ms=cuda_ms(lambda: rg.rglru_scan(*one), 20),
               batch1_register_ms=cuda_ms(lambda: rg.rglru_scan(*one, use=rg.REGISTER), 20),
               plain_ms=cuda_ms(lambda: rg.plain(a, b, s0), 2),
               library_ms=None,   # no single PyTorch call computes the recurrence
               bound_ms=ms_bound, bound_by=by)
    print(f"[kernel rglru_scan] recurrentgemma-9b {dtype} B={B} S={S} R={R} "
          + json.dumps(res))
    return res


def wkv6_case(label: str, B: int, S: int, H: int, N: int, prompts, fault_step: int):
    """K4 at B ragged prompts of lengths ``prompts`` padded to S, H heads of
    N, bf16 r/k/v with k=0 and logw=0 on pad steps as the model gives them,
    logw = −exp(·), u and s0 in fp32: rwkv6-7b's prefill (H=64, N=64) and
    the calibration's shape (H=2, N=32)."""
    import torch
    from repro_torch.kernels import wkv6 as wk
    g = torch.Generator(device="cuda").manual_seed(4)

    def normal(shape, scale=1.0):
        return scale * torch.randn(shape, generator=g, device="cuda")
    shape = (B, S, H, N)
    valid = (torch.arange(S, device="cuda")[None, :]
             < torch.tensor(prompts, device="cuda")[:, None])[..., None, None]
    r = normal(shape, 0.5).to(torch.bfloat16)
    k = torch.where(valid, normal(shape, 0.5), 0.0).to(torch.bfloat16)
    v = normal(shape).to(torch.bfloat16)
    logw = torch.where(valid, -torch.exp(normal(shape)), 0.0)
    u, s0 = normal((H, N), 0.1), normal((B, H, N, N), 0.1)
    args = (r, k, v, logw, u, s0)
    got = wk.wkv6(*args)
    want = wkv_want(*args)
    atols = wkv_atol(*args)
    err, ratio, (out_ratio, state_ratio) = held_wkv(got, want, atols)
    require(all(bool(torch.isfinite(x.float()).all()) for x in got), "wkv6 output finite")
    require(ratio <= 1.0, f"wkv6 {label} max|err| {err}, output {out_ratio}x and state "
            f"{state_ratio}x the limit")
    # planted faults: one valid step of the longest prompt skipped (k=0 and
    # logw=0 there, so S_t = S_{t-1}); the bonus-u term dropped; and the
    # longest prompt's second segment started from a zero state (k=0 and
    # e^{logw} = 0 on the first segment's last step: e^{-200} is 0 in fp32)
    P, Lc = wk.plan_segments(B, H, S)
    require(P > 1, f"wkv6 {label} splits the sequence ({P} segments)")
    k_f, w_f = k.clone(), logw.clone()
    k_f[0, fault_step], w_f[0, fault_step] = 0.0, 0.0
    k_z, w_z = k.clone(), logw.clone()
    k_z[0, Lc * 32 - 1], w_z[0, Lc * 32 - 1] = 0.0, -200.0
    fault_ratio = {"one_step_skipped": held_wkv(wk.wkv6(r, k_f, v, w_f, u, s0), want,
                                                atols)[1],
                   "bonus_u_dropped": held_wkv(
                       wk.wkv6(r, k, v, logw, torch.zeros_like(u), s0), want, atols)[1],
                   "segment_state_dropped": held_wkv(
                       wk.wkv6(r, k_z, v, w_z, u, s0), want, atols)[1]}
    require(all(r_ > 1.0 for r_ in fault_ratio.values()),
            f"wkv6 {label} check rejects planted faults {fault_ratio}")
    # every (b, s, h) step: 5N² + 4N fp32 operations; r, k, v and out read or
    # written once in bf16, logw once in fp32, u once, the state in and out
    flops = (5.0 * N * N + 4.0 * N) * B * S * H
    nbytes = 2.0 * 4 * B * S * H * N + 4.0 * (B * S * H * N + H * N + 2 * B * H * N * N)
    ms_bound, by = bound(flops, nbytes, PEAK_FP32_FLOPS)
    res = dict(max_abs_err=err, limit_ratio=ratio, out_ratio=out_ratio,
               state_ratio=state_ratio, fault_ratio=fault_ratio,
               state_max_abs_err=float((got[1] - want[1]).abs().max()),
               # reported, not held: the output against ATOL + RTOL alone
               ulp_only_ratio=held(got[0], want[0])[1], segments=[P, Lc],
               # beside the bound: the time its bytes alone take
               bytes_ms=nbytes / PEAK_BYTES * 1e3,
               ms=cuda_ms(lambda: wk.wkv6(*args), 20),
               plain_ms=cuda_ms(lambda: wk.plain(*args), 2),
               library_ms=None,   # no single PyTorch call computes the recurrence
               bound_ms=ms_bound, bound_by=by)
    print(f"[kernel wkv6] {label} B={B} S={S} H={H} N={N} " + json.dumps(res))
    return res


def int8_case(label: str, x_q, w_q, sx, sw):
    """K5 on int8 x (M, K) and w (K, N) with their fp32 scales: bitwise equal
    to its exact plain version with w row-major (transposed into scratch)
    and column-major (read in place), and with K cut by 4 (x and the scratch
    zero-padded); within the calibration's tolerance of the dequantizing
    reference; planted faults rejected."""
    import torch
    from repro_torch.calibrate.kernel_bench import VERIFY_TOL, ieee_fp32
    from repro_torch.kernels import int8_matmul as i8
    from repro_torch.kernels.ref import int8_matmul_reference
    (M, K), N = x_q.shape, w_q.shape[1]
    w_cm = w_q.T.contiguous().T                      # (K, N), column-major
    got = i8.int8_matmul(x_q, w_q, sx, sw)
    want = i8.plain(x_q, w_q, sx, sw)
    err = float((got - want).abs().max())
    require(bool(torch.isfinite(got).all()), f"int8_matmul {label} output finite")
    require(torch.equal(got, want), f"int8_matmul {label} bitwise equal to "
            f"int8_matmul_exact (max|err| {err})")
    require(torch.equal(i8.int8_matmul(x_q, w_cm, sx, sw), want),
            f"int8_matmul {label} bitwise equal with w column-major")
    # K − 4 is no multiple of 16: x and the transposed w are zero-padded
    x_t, w_t = x_q[:, :K - 4], w_q[:K - 4]
    want_t = i8.plain(x_t, w_t, sx, sw)
    require(torch.equal(i8.int8_matmul(x_t, w_t, sx, sw), want_t),
            f"int8_matmul {label} bitwise equal at K = {K - 4} (padded)")
    with ieee_fp32():
        deq = int8_matmul_reference(x_q, w_q, sx, sw)
    ref_err = float((got - deq).abs().max())
    ref_tol = VERIFY_TOL["int8"] * max(1.0, float(deq.abs().max()))
    require(ref_err <= ref_tol, f"int8_matmul {label} against the dequantizing "
            f"reference max|err| {ref_err} > {ref_tol}")
    # planted faults, each the kernel's own output where a wrong kernel would
    # give it: one 64-byte K tile skipped (its columns of x zeroed); sw
    # dropped; and, at K − 4, the kernel handed x and a K-major w whose
    # padding past K is not zero (what a wrapper or transposing pass that
    # left it unzeroed would hand over; with zeros there the same call is
    # exact); the bitwise check must reject each
    Kt, Kp = K - 4, i8.padded_k(K - 4)

    def padded(a, fill):     # a (rows, Kt) → (rows, Kp), `fill` past Kt
        return torch.cat([a, torch.full((a.shape[0], Kp - Kt), fill, dtype=torch.int8,
                                        device=a.device)], 1)
    require(torch.equal(i8._launch(padded(x_t, 0), padded(w_t.T, 0), sx, sw, Kt, True),
                        want_t), f"int8_matmul {label} exact on operands padded with zeros")
    x_f = x_q.clone()
    x_f[:, K // 2:K // 2 + 64] = 0
    faults = {"k_tile_skipped": (i8.int8_matmul(x_f, w_q, sx, sw), want),
              "sw_dropped": (i8.int8_matmul(x_q, w_q, sx, torch.ones_like(sw)), want),
              "nonzero_padding": (i8._launch(padded(x_t, 3), padded(w_t.T, 5), sx, sw, Kt,
                                             True), want_t)}
    fault_err = {name: float((out - w).abs().max()) for name, (out, w) in faults.items()}
    require(not any(torch.equal(out, w) for out, w in faults.values()),
            f"int8_matmul {label} check rejects planted faults {fault_err}")
    # x and w read once (int8), the scales once, out written once (fp32)
    ms_bound, by = bound(2.0 * M * N * K, M * K + K * N + 4.0 * (M + N + M * N),
                         PEAK_INT8_OPS)
    ms = cuda_ms(lambda: i8.int8_matmul(x_q, w_q, sx, sw), 20)
    ms_cm = cuda_ms(lambda: i8.int8_matmul(x_q, w_cm, sx, sw), 20)
    res = dict(max_abs_err=err, ref_max_abs_err=ref_err, ref_tol=ref_tol,
               fault_max_abs_err=fault_err, ms=ms,
               # reported beside it: w column-major (no transposing pass), and
               # the pass's share of ms, (ms − ms_colmajor) / ms
               ms_colmajor=ms_cm, transpose_share=(ms - ms_cm) / ms,
               plain_ms=cuda_ms(lambda: i8.plain(x_q, w_q, sx, sw), 3),
               library_ms=cuda_ms(lambda: torch._int_mm(x_q, w_q), 20),
               # reported beside it: the same call with w stored column-major
               library_colmajor_ms=cuda_ms(lambda: torch._int_mm(x_q, w_cm), 20),
               bound_ms=ms_bound, bound_by=by)
    print(f"[kernel int8_matmul] {label} M={M} K={K} N={N} "
          f"(library_ms: torch._int_mm, the int32 product only, unscaled) "
          + json.dumps(res))
    return res


def int8_down_projection():
    """K5 at gemma2-2b's MLP down-projection (d_ff 9216 → d_model 2304) for a
    prefill of batch 8 × 512 tokens: x (4096, 9216) and w (9216, 2304) int8,
    quantized row by row (w column by column) from normals made from a seed."""
    import torch
    from repro_torch.kernels import ops
    M, K, N = 8 * 512, 9216, 2304
    g = torch.Generator(device="cuda").manual_seed(5)
    x_q, sx = ops.quantize_rowwise(torch.randn((M, K), generator=g, device="cuda"))
    w_q_t, sw = ops.quantize_rowwise(torch.randn((N, K), generator=g, device="cuda"))
    w_q = w_q_t.T.contiguous()                       # w drawn as its transpose
    return int8_case("gemma2-2b MLP down-projection", x_q, w_q, sx, sw)


def int8_calibration_largest():
    """K5 on the calibration sweep's own inputs at its largest point,
    batch 4 × seq 256: (1024, 512) × (512, 512)."""
    from repro_torch.calibrate.kernel_bench import (DEFAULT_BATCHES, DEFAULT_SEQS,
                                                    kernel_registry)
    args, _ = kernel_registry()["int8_matmul"].make(
        max(DEFAULT_BATCHES), max(DEFAULT_SEQS), "int8", 0, "cuda")
    return int8_case("calibration's largest point", *args)


RGLRU_EXTRA = ("plan", "register_ms", "batch1_plan", "batch1_ms", "batch1_register_ms")


def merge(cases):
    """One kernel's record over a model's layer kinds: the mean of each time
    over the cases (gemma2-2b: window 4096 and global), the worst error."""
    out = {key: None if any(c[key] is None for c in cases)
           else float(np.mean([c[key] for c in cases]))
           for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
    out["max_abs_err"] = max(c["max_abs_err"] for c in cases)
    out["bound_by"] = cases[0]["bound_by"]
    # K3's plan and its times beside (one case a record)
    out.update({k: v for k, v in cases[0].items() if k in RGLRU_EXTRA})
    return out


def layer_counts(cfg):
    """(attention layers, RG-LRU layers, RWKV6 layers) of a config."""
    from repro_torch.models.config import ATTN_GLOBAL, ATTN_LOCAL, RGLRU, RWKV6
    kinds = cfg.layer_kinds()
    return (kinds.count(ATTN_GLOBAL) + kinds.count(ATTN_LOCAL), kinds.count(RGLRU),
            kinds.count(RWKV6))


def model_setup(arch: str):
    """Full-width ``arch`` with random bf16 weights from a seed, and the
    ragged prompt batch: (cfg, model, params, tokens, lengths, max_len)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serving.engine import serving_config
    cfg = serving_config(get_config(arch))
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    B, S = len(PROMPTS), max(PROMPTS)
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S))
                              .astype(np.int32)).cuda()
    lengths = torch.tensor(PROMPTS, dtype=torch.int32, device="cuda")
    return cfg, model, params, tokens, lengths, S + DECODE_STEPS


def checked_kernels(worst: dict, reported: dict) -> dict:
    """Stand-ins for the model kernels in ``ops`` that run each kernel and
    hold the call against its plain version on the same inputs (K1 and K2
    against float64; K3 bitwise, raising at once), keeping each kernel's
    worst limit ratio in ``worst`` and, in ``reported``, K4's worst output
    and state ratios apart and its output against ATOL + RTOL alone (not
    held), and the plans K3 ran."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rglru_scan as rg
    from repro_torch.kernels import wkv6 as wk

    def keep(name, ratio):
        worst[name] = max(worst.get(name, 0.0), ratio)

    def checked_flash(q, k, v, **kw):
        got = fa.flash_attention(q, k, v, **kw)
        keep("flash_attention", held(got, flash_want(q, k, v, **kw), kw["lengths"].tolist())[1])
        return got

    def checked_decode(q, k, v, lengths, **kw):
        got = da.decode_attention(q, k, v, lengths, **kw)
        keep("decode_attention", held(got, decode_want(q, k, v, lengths, **kw))[1])
        return got

    def checked_rglru(a, b, s0):
        got = rg.rglru_scan(a, b, s0)
        equal, err = exact_scan(got, rg.plain(a, b, s0))
        require(equal, f"rglru_scan {rg.last_plan} on the model's activations bitwise "
                       f"equal to plain (max|err| {err})")
        keep("rglru_scan", 0.0)
        plans = reported.setdefault("rglru_scan_plans", [])
        if rg.last_plan._asdict() not in plans:
            plans.append(rg.last_plan._asdict())
        return got

    def checked_wkv6(*args):
        got, want = wk.wkv6(*args), wkv_want(*args)
        _, ratio, parts = held_wkv(got, want, wkv_atol(*args))
        keep("wkv6", ratio)
        for key, value in zip(("wkv6_output", "wkv6_state"), parts):
            reported[key] = max(reported.get(key, 0.0), value)
        reported["wkv6_ulp_only"] = max(reported.get("wkv6_ulp_only", 0.0),
                                        held(got[0], want[0])[1])
        return got

    return {"flash_attention": checked_flash, "decode_attention": checked_decode,
            "rglru_scan": checked_rglru, "wkv6": checked_wkv6}


def plain_kernels() -> dict:
    """The model kernels' plain versions, as stand-ins in ``ops``."""
    return {name: mod.plain for name, mod in counters().items() if name in MODEL_KERNELS}


def prefill_and_step(m, params, tokens, lengths, max_len, swap: dict, tok=None):
    """A prefill of ``m`` and one decode step of ``tok`` (the prefill's greedy
    token when None), with ``swap``'s functions in place of those kernels in
    ``ops`` (the package has no switch; restored after).  Returns (prefill
    logits, decode logits, token, {"prefill": launches, "decode_step":
    launches})."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.serving.engine import greedy_sample, make_decode_fn, make_prefill_fn
    kernels = {name: getattr(ops, name) for name in swap}
    for name, fn in swap.items():
        setattr(ops, name, fn)
    launches = {}
    try:
        reset_launches()
        cache, pre = make_prefill_fn(m, max_len)(params, tokens, lengths)
        launches["prefill"] = read_launches()
        tok = greedy_sample(pre) if tok is None else tok
        reset_launches()
        _, dec = make_decode_fn(m)(params, cache, tok)
        launches["decode_step"] = read_launches()
    finally:
        for name, fn in kernels.items():
            setattr(ops, name, fn)
    for what, t in (("prefill", pre), ("decode", dec)):
        require(tuple(t.shape) == (len(tokens), m.cfg.vocab_size), f"{what} logits shape")
        require(bool(torch.isfinite(t).all()), f"{what} logits finite")
    return pre, dec, tok, launches


def fp32_activations(cfg):
    """The model of ``cfg`` with fp32 activations and an fp32 cache; it runs
    on the same bf16 weights."""
    from repro_torch.models import build_model
    return build_model(dataclasses.replace(cfg, dtype="float32", serve_param_dtype="float32"))


def max_diff(a, b) -> float:
    """max |a − b| over the prefill and decode logits of two runs."""
    return max(float((a[i] - b[i]).abs().max()) for i in (0, 1))


def phase_model(arch: str):
    import torch
    from repro_torch.serving.engine import greedy_sample, make_generate_fn
    torch.cuda.reset_peak_memory_stats()
    cfg, model, params, tokens, lengths, max_len = model_setup(arch)
    n_attn, n_rec, n_rwkv = layer_counts(cfg)
    B = len(PROMPTS)

    # the main path: counts at 0 just before, read just after
    reset_launches()
    t0 = time.perf_counter()
    out = make_generate_fn(model, DECODE_STEPS, max_len=max_len)(params, tokens, lengths)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    launches = read_launches()
    print(f"[model] {arch} layers={cfg.num_layers} d_model={cfg.d_model} "
          f"generate B={B} prompts={list(PROMPTS)} "
          f"steps={DECODE_STEPS} s={gen_s:.3f} launches={json.dumps(launches)}")
    want = {"flash_attention": n_attn, "decode_attention": n_attn * DECODE_STEPS,
            "rglru_scan": n_rec, "wkv6": n_rwkv, "int8_matmul": 0}
    require(launches == want, f"generate launches {launches} != {want}")
    require(tuple(out.shape) == (B, DECODE_STEPS + 1), f"tokens shape {out.shape}")
    require(bool(((out >= 0) & (out < cfg.vocab_size)).all()), "token ids in range")

    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    # The same prefill and first decode step through the kernels and through
    # the plain versions, all decoding the same token, with bf16 activations
    # (as served) and with fp32 activations on the same bf16 weights.  The
    # bf16 kernel run also holds every kernel call against the plain version
    # on the same inputs.
    worst = {name: 0.0 for name in MODEL_KERNELS}
    reported = {"wkv6_output": 0.0, "wkv6_state": 0.0, "wkv6_ulp_only": 0.0}
    model32 = fp32_activations(cfg)
    args = (params, tokens, lengths, max_len)
    runs, step_launches = {}, {}
    tok = None
    for key, m, swap in ((("bf16", "kernel"), model, checked_kernels(worst, reported)),
                         (("bf16", "plain"), model, plain_kernels()),
                         (("fp32", "kernel"), model32, {}),
                         (("fp32", "plain"), model32, plain_kernels())):
        pre, dec, tok, step_launches[key] = prefill_and_step(m, *args, swap, tok)
        runs[key] = (pre, dec)
    per_step = {"prefill": {"flash_attention": n_attn, "decode_attention": 0,
                            "rglru_scan": n_rec, "wkv6": n_rwkv, "int8_matmul": 0},
                "decode_step": {"flash_attention": 0, "decode_attention": n_attn,
                                "rglru_scan": 0, "wkv6": 0, "int8_matmul": 0}}
    for what, want in per_step.items():
        got = step_launches["fp32", "kernel"][what]
        require(got == want, f"{what} launches {got} != {want}")
    print(f"[model] {arch} launches per prefill {json.dumps(per_step['prefill'])}, "
          f"per decode step {json.dumps(per_step['decode_step'])}")

    def first(dt, path):
        return greedy_sample(runs[(dt, path)][0])

    def gaps(dt):
        top2 = runs[(dt, "plain")][0].topk(2, dim=-1).values
        return (top2[:, 0] - top2[:, 1]).tolist()

    d32 = max_diff(runs["fp32", "kernel"], runs["fp32", "plain"])
    d16 = max_diff(runs["bf16", "kernel"], runs["bf16", "plain"])
    far_k = max_diff(runs["bf16", "kernel"], runs["fp32", "plain"])
    far_p = max_diff(runs["bf16", "plain"], runs["fp32", "plain"])
    same32 = first("fp32", "kernel") == first("fp32", "plain")
    # reported, not held: random weights leave top-two gaps of ~0.2 logits,
    # below the ~0.9 that any two bf16 summation orders drift apart
    same16 = first("bf16", "kernel") == first("bf16", "plain")
    print(f"[model] {arch} per-call limit ratio, bf16 on the model's activations: "
          f"{json.dumps(worst)} (fail above 1)"
          + (f"; wkv6 output {reported['wkv6_output']}, state {reported['wkv6_state']}, "
             f"output against ATOL + RTOL alone {reported['wkv6_ulp_only']} (not held)"
             if n_rwkv else "")
          + (f"; rglru_scan bitwise on every call, plans "
             f"{json.dumps(reported['rglru_scan_plans'])}" if n_rec else ""))
    if n_rec:
        require(all(p["variant"] == "ring" for p in reported["rglru_scan_plans"]),
                "every rglru_scan call of the model runs the ring variant")
    print(f"[model] {arch} max|Δlogit| fp32 kernel-vs-plain={d32} "
          f"(tol {LOGIT_TOL_FP32}) bf16 kernel-vs-plain={d16}; to the fp32 path: "
          f"bf16 kernel={far_k} bf16 plain={far_p} ratio={far_k / far_p} "
          f"(tol {BF16_DRIFT_RATIO})")
    print(f"[model] {arch} first token agrees fp32={same32.tolist()} "
          f"top2_gap={gaps('fp32')}; bf16={same16.tolist()} top2_gap={gaps('bf16')} "
          f"(not held); generate_max_memory_allocated_gb={peak_gb:.2f}")
    require(all(r <= 1.0 for r in worst.values()),
            "every bf16 kernel call on the model's activations within the limit")
    require(d32 <= LOGIT_TOL_FP32, "fp32 kernel vs plain logits")
    require(bool(same32.all()), "fp32 first greedy token agrees")
    require(far_k <= BF16_DRIFT_RATIO * far_p, "bf16 kernel path drift")
    return launches


def phase_serving(arch: str):
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import run_server
    from repro_torch.serving.batching import make_policy
    from repro_torch.serving.engine import serving_config
    from repro_torch.serving.workload import WorkloadSpec, generate
    cfg = serving_config(get_config(arch))
    n_attn, n_rec, n_rwkv = layer_counts(cfg)
    spec = SERVE[arch]
    policy = make_policy("tris")
    wl = WorkloadSpec(kind="poisson", seed=0, **spec)
    # the main path again: counts at 0 just before, read just after
    reset_launches()
    res = run_server(cfg, policy, wl, max_len=spec["prompt_tokens"] + DECODE_STEPS,
                     decode_steps=DECODE_STEPS)
    launches = read_launches()
    print(f"[serving] {arch} tris poisson {json.dumps(spec)} "
          f"decode_steps={DECODE_STEPS} {json.dumps(res)} launches={json.dumps(launches)}")
    require(res["requests"] == len(generate(wl)), "every request served")
    require(all(np.isfinite(v) for v in res.values()), "finite serving metrics")
    # run_server warms up with one prefill and one decode step at each batch
    # size the policy emits, then runs a prefill and decode_steps − 1 steps
    # per batch
    warm = len({1, getattr(policy, "max_batch", 1), *getattr(policy, "preferred", (1,))})
    batches = round(res["requests"] / res["mean_batch"])
    want = {"flash_attention": n_attn * (batches + warm),
            "decode_attention": n_attn * ((DECODE_STEPS - 1) * batches + warm),
            "rglru_scan": n_rec * (batches + warm), "wkv6": n_rwkv * (batches + warm),
            "int8_matmul": 0}
    require(launches == want, f"serving launches {launches} != {want}")


def held_on_grid(tag: str, batches, seqs) -> dict:
    """Every (kernel, dtype, batch, seq) of a calibration grid, on the inputs
    the sweep times there (``make`` with seed 0): the wrapper on the card
    against its plain version.  Every kernel's output within
    ``kernel_bench.VERIFY_TOL`` of the reference the sweep verifies against
    (what ``kernel_records`` checks at the grid's smallest point only); K3
    bitwise equal to its plain version, K5 bitwise to its exact plain
    version, K4's output and state within ``wkv_atol`` of float64.  Prints
    the plans of K2, K3 and K4 with the points that chose them.  These
    launches come after the counts are read and are not counted."""
    import torch
    from repro_torch.calibrate.kernel_bench import VERIFY_TOL, ieee_fp32, kernel_registry
    from repro_torch.kernels import _build
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import int8_matmul as i8
    from repro_torch.kernels import rglru_scan as rg
    from repro_torch.kernels import wkv6 as wk

    def first(x):
        return x[0] if isinstance(x, tuple) else x
    worst, plans, n = {}, {}, 0
    for name, case in sorted(kernel_registry().items()):
        for dt in case.dtypes:
            for b in batches:
                for s in seqs:
                    where = f"{name} {dt} B={b} S={s}"
                    args, kw = case.make(b, s, dt, 0, "cuda")
                    got = case.kernel_fn(*args, **kw)
                    plan = None
                    if name == "rglru_scan":
                        plan = tuple(rg.last_plan)
                        equal, err = exact_scan(got, rg.plain(*args))
                        require(equal, f"[{tag}] {where} {plan} bitwise equal to plain "
                                       f"(max|err| {err})")
                    elif name == "int8_matmul":
                        require(torch.equal(got, i8.plain(*args)),
                                f"[{tag}] {where} bitwise equal to int8_matmul_exact")
                    elif name == "wkv6":
                        B, S, H, _ = args[0].shape
                        plan = wk.plan_segments(B, H, S)
                        err, ratio, parts = held_wkv(got, wkv_want(*args), wkv_atol(*args))
                        require(ratio <= 1.0, f"[{tag}] {where} segments {plan} output and "
                                              f"state {parts}x wkv_atol (max|err| {err})")
                    elif name == "decode_attention":
                        k = args[1]
                        plan = da.plan_splits(b, k.shape[1], k.shape[2], k.shape[3],
                                              k.element_size(), _build.sm_count(k.device.index))
                    with ieee_fp32():
                        want = first(case.ref_fn(*args, **kw)).double()
                    err = float((first(got).double() - want).abs().max())
                    tol = VERIFY_TOL[dt] * max(1.0, float(want.abs().max()))
                    require(err <= tol, f"[{tag}] {where} {plan or ''} max|err| {err} > {tol}")
                    worst[f"{name}/{dt}"] = max(worst.get(f"{name}/{dt}", 0.0), err / tol)
                    if plan is not None:
                        plans.setdefault(f"{name}/{dt}", {}).setdefault(
                            str(tuple(plan)), []).append(f"B={b} S={s}")
                    n += 1
    print(f"[{tag}] {n} grid points, each kernel held to its plain version; worst "
          f"max|err| / VERIFY_TOL {json.dumps(worst)}")
    print(f"[{tag}] plans (K2: splits, slots; K3: variant, C, T, P; K4: segments, "
          f"chunks) and their points {json.dumps(plans)}")
    return {"points": n, "worst_tol_ratio": worst}


def phase_calibration():
    """The kernel-calibration backend on the card, with its defaults, then
    the compute scale and the bench_kernels smoke sweep; counts at 0 just
    before, read just after.  Nothing is caught: a kernel that fails to build,
    launch or verify ends the run."""
    from repro_torch.calibrate import derive_speed_modes, fit_kernel_records, kernel_records
    from repro_torch.calibrate.kernel_bench import (DEFAULT_BATCHES, DEFAULT_SEQS,
                                                    kernel_registry)
    from repro_torch.launch.bench_kernels import run_smoke
    reg = kernel_registry()
    reset_launches()
    t0 = time.perf_counter()
    records = kernel_records()
    fits = fit_kernel_records(records)
    modes = derive_speed_modes(fits, measure_compute_scale=True)
    smoke = run_smoke()
    launches = read_launches()
    print(f"[calibration] records={len(records)} fits={len(fits)} "
          f"s={time.perf_counter() - t0:.1f} launches={json.dumps(launches)}")
    for key, fit in fits.items():
        print(f"[calibration] {key} phase={fit['phase']} coef={list(fit['coef'])} "
              f"n_points={fit['n_points']} mean_rel_err={fit['mean_rel_err']} "
              f"r2={fit['r2']} max_err_vs_ref={fit['max_err_vs_ref']}")
    scale = modes["int8"]["compute_scale"]
    print(f"[calibration] int8 compute_scale={scale} (K5 against an fp32 "
          f"torch.matmul of the dequantized operands, clamped to [1.0, 1.5])")
    print(f"[calibration] bench_kernels smoke {json.dumps(smoke)}")
    grid = len(DEFAULT_BATCHES) * len(DEFAULT_SEQS)
    pairs = sum(len(case.dtypes) for case in reg.values())
    require(len(records) == grid * pairs == 81, f"{len(records)} calibration records")
    require(all(r["kind"] == "calibration" and r["backend"] == "hopper-kernel"
                and r["result"]["mode"] == "kernel-cuda"
                and r["result"]["max_err_vs_ref"] >= 0.0 for r in records),
            "every record verified on the card")
    require(len(fits) == pairs == 9 and all(f["n_points"] == grid for f in fits.values()),
            f"nine fits of {grid} points")
    require(1.0 <= scale <= 1.5, f"int8 compute_scale {scale}")
    require((smoke["n_records"], smoke["n_fits"], smoke["verified_pairs"]) == (20, 5, 5),
            f"bench_kernels smoke {smoke}")
    # each (kernel, dtype): one verification, then per grid point a warm-up
    # and 3 timed calls; the compute scale: 1 + 3 int8 calls; the smoke
    # sweep: per kernel one verification and 4 points × (1 + 2) calls
    want = {name: len(case.dtypes) * (1 + grid * 4) + 1 + 4 * 3
            for name, case in reg.items()}
    want["int8_matmul"] += 1 + 3
    require(launches == want, f"calibration launches {launches} != {want}")
    # K3's fp32 records verified exactly against the sequential reference;
    # then every grid point of every kernel held (these calls are not counted)
    require(all(r["result"]["max_err_vs_ref"] == 0.0 for r in records
                if r["kernel"] == "rglru_scan" and r["dtype"] == "float32"),
            "rglru_scan fp32 calibration records verified exactly")
    held_on_grid("calibration", DEFAULT_BATCHES, DEFAULT_SEQS)
    return launches


# Phase 11: the generated models at the largest point of the reference's
# Fig. 9 sweep (benchmarks/bench_sensitivity.py), and the measured fc
# calibration of benchmarks/bench_calibrate.py.
FIG9 = dict(layers=8, width=512, batch=4, seq=32)
# A generated model on the card against the same module (same weights) in
# float64 on the CPU: |err| ≤ 1e-5 + 1e-4·|want|, for its float64 run on the
# card (the module's arithmetic on the card) and for its fp32 run (TF32 off).
# The reference's transformer has no normalisation: its residual stream and
# attention logits grow with depth (logits ~6400 by layer 8 at the Fig. 9
# point), so its softmax amplifies fp32 rounding far past that limit — the
# CPU's own fp32 run misses it by a ratio of ~760.  Where the CPU's fp32 run
# misses the limit, the card's fp32 run is held instead to at most
# GEN_DRIFT times the CPU fp32 run's distance from float64: the two differ
# only in summation order, so their errors are of one size, while TF32
# (2^13 times fp32's unit roundoff) or a wrong result lies far outside.
# Every family is held to GEN_DRIFT as well: the lstm's outputs (~4e-3) sit
# below the limit's atol, which a TF32 run meets (ratio 0.37–0.42), while
# it lies 1358–1506x the CPU fp32 run's distance (fc 1087x, cnn 1857x,
# transformer 525–869x; the card's fp32 runs 0.31–2.40x; chip_smoke.py on
# "NVIDIA H100 80GB HBM3, 700.00 W").  A TF32 run of each family is the
# control: the check must reject it.
GEN_ATOL, GEN_RTOL = 1e-5, 1e-4
GEN_DRIFT = 8.0
FC_CALIBRATION = dict(layers=4, width=256, batches=(16, 32, 64, 96, 128, 192, 256))
WALL_CLOCKED = ("benchmark_wall_s", "ts")


def sim_record(result) -> dict:
    """A simulated job's PerfDB record without its wall-clocked fields (as
    the reference's Fig. 15 executor check compares them)."""
    rec = {k: v for k, v in result.to_record().items() if k not in WALL_CLOCKED}
    rec["result"] = {k: v for k, v in rec["result"].items() if k != "sim_events_per_sec"}
    return json.loads(json.dumps(rec))


def generated_against_float64(spec):
    """A generated model on the card against the same module (same weights)
    in float64 on the CPU: its float64 run on the card within the limit, its
    fp32 run (TF32 off) within GEN_DRIFT times the CPU fp32 run's distance
    and within the limit unless the CPU's own fp32 run misses it.  A TF32
    run is the control: the same check must reject it."""
    import copy

    import torch
    from repro_torch.core import generator as gen
    model, (x,) = gen.build(spec)
    xs = torch.from_numpy(np.random.default_rng(0).standard_normal(
        tuple(x.shape), dtype=np.float32))
    with torch.inference_mode():
        got = model(xs.cuda()).double().cpu()
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        try:
            tf32 = model(xs.cuda()).double().cpu()
        finally:
            torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        got64 = copy.deepcopy(model).double()(xs.double().cuda()).cpu()
        cpu = copy.deepcopy(model).cpu()
        cpu32 = cpu(xs).double()
        want = cpu.double()(xs.double())
    d64 = (got64 - want).abs()    # in float64: held() rounds to fp32 first
    e64 = float(d64.max())
    r64 = float((d64 / (GEN_ATOL + GEN_RTOL * want.abs())).max())
    err, ratio = held(got, want, atol=GEN_ATOL, rtol=GEN_RTOL)
    cpu_err, cpu_ratio = held(cpu32, want, atol=GEN_ATOL, rtol=GEN_RTOL)
    tf32_err, tf32_ratio = held(tf32, want, atol=GEN_ATOL, rtol=GEN_RTOL)
    drift = cpu_ratio > 1.0

    def accepted(e, r):
        return (r <= 1.0 or drift) and e <= GEN_DRIFT * cpu_err
    print(f"[session] generated {spec.name} B={spec.batch} S={spec.seq} against float64 on "
          f"the CPU: the card in float64 max|err|={e64} ratio={r64}; in fp32 "
          f"max|err|={err} ratio={ratio} (x{err / max(cpu_err, 1e-300)} the CPU's fp32 distance; "
          f"the CPU in fp32: max|err|={cpu_err} ratio={cpu_ratio}); control in TF32: "
          f"max|err|={tf32_err} ratio={tf32_ratio} (x{tf32_err / max(cpu_err, 1e-300)} the CPU's fp32 "
          f"distance, GEN_DRIFT={GEN_DRIFT}); max|want|={float(want.abs().max())}")
    require(got.shape == (spec.batch, spec.num_classes) and bool(torch.isfinite(got).all())
            and r64 <= 1.0, f"generated {spec.name} in float64 on the card (ratio {r64})")
    require(accepted(err, ratio), f"generated {spec.name} in fp32 on the card (ratio "
            f"{ratio}, max|err| {err}; the CPU's fp32: ratio {cpu_ratio}, max|err| {cpu_err})")
    require(not accepted(tf32_err, tf32_ratio),
            f"generated {spec.name}: the check rejects a TF32 run (max|err| {tf32_err}, "
            f"x{tf32_err / max(cpu_err, 1e-300)} the CPU's fp32 distance)")


def phase_session():
    """The benchmark-job system on the card: a BenchmarkSession with the
    InlineExecutor and a PerfDB file runs the four generated families, a
    measured fc calibration with all five kernels on its hook, an oracle
    calibration of gemma2-2b on h100, gemma2-2b serving jobs on the roofline
    oracle and on the measured profile, and quickstart.json (again through
    concurrent followers, which must agree).  Counts at 0 just before the
    first run, read just after it: only the hook launches the port's
    kernels.  Nothing is caught."""
    import tempfile

    import torch
    from repro_torch.calibrate.kernel_bench import DEFAULT_SEQS, kernel_registry
    from repro_torch.calibrate.microbench import SEQ_FAMILIES
    from repro_torch.calibrate.profile import load_profile
    from repro_torch.core import (BenchmarkSession, CalibrationSpec,
                                  ConcurrentFollowerExecutor, InlineExecutor, ModelRef,
                                  PerfDB)
    from repro_torch.core import generator as gen
    from repro_torch.serving.latency_model import FittedLatencyModel
    reg = kernel_registry()
    # the generated models on the card against the same modules (same
    # weights) in float64 on the CPU, at the Fig. 9 point and, for the
    # families with a sequence axis, at the seq the session's jobs time
    timed_seq = gen.GeneratedSpec("transformer").seq
    for family in gen.FAMILIES:
        for seq in sorted({FIG9["seq"], timed_seq} if family in SEQ_FAMILIES
                          else {FIG9["seq"]}):
            generated_against_float64(gen.GeneratedSpec(family, **dict(FIG9, seq=seq)))
    with tempfile.TemporaryDirectory() as tmp:
        db_path = Path(tmp) / "perfdb.jsonl"
        session = BenchmarkSession(db=PerfDB(str(db_path)), executor=InlineExecutor())
        generated = {family: session.submit({
            "job_id": f"gen-{family}", "hardware": "h100", "chips": 1,
            "model": {"kind": "generated", "family": family, "layers": FIG9["layers"],
                      "width": FIG9["width"], "batch_hint": FIG9["batch"]}})
            for family in gen.FAMILIES}
        fc = FC_CALIBRATION
        measured = session.submit(CalibrationSpec(
            job_id="cal-fc", model=ModelRef(kind="generated", family="fc",
                                            layers=fc["layers"], width=fc["width"]),
            hardware="h100", batches=fc["batches"], seqs=DEFAULT_SEQS, holdout_fraction=0.25,
            kernels=tuple(sorted(reg)), profile_dir=tmp))
        oracle = session.submit(CalibrationSpec(
            job_id="cal-gemma2", model=ModelRef(name="gemma2-2b"), hardware="h100", chips=1,
            batches=(1, 2, 4, 8, 16), seqs=(32, 64, 128, 256), holdout_fraction=0.25,
            profile_dir=tmp))
        reset_launches()
        t0 = time.perf_counter()
        session.run()
        launches = read_launches()
        print(f"[session] generated + calibration jobs s={time.perf_counter() - t0:.1f} "
              f"launches={json.dumps(launches)}")
        for family, handle in generated.items():
            m = handle.result().metrics
            print(f"[session] {handle.job_id} {json.dumps(handle.result().generated)} "
                  f"latency_s={m['latency_s']} flops={m['flops']} "
                  f"attained_flops={m['attained_flops']} mode={m['mode']}")
            require(m["mode"] == "measured-cuda" and m["latency_s"] > 0
                    and np.isfinite(m["attained_flops"]), f"generated job {family}")
        # the measured fc calibration and its kernel hook
        spec, cal = measured.spec, measured.result()
        m = cal.metrics
        kernel_recs = [r for r in cal.extra_records if r.get("backend") == "hopper-kernel"]
        points = len(spec.batches) * len(spec.seqs)
        pairs = sum(len(case.dtypes) for case in reg.values())
        print(f"[session] cal-fc mode={m['mode']} n_records={m['n_records']} "
              f"n_kernel_records={m['n_kernel_records']} prefill_r2={m['prefill_r2']} "
              f"prefill_mean_rel_err={m['prefill_mean_rel_err']} decode_r2={m['decode_r2']} "
              f"decode_mean_rel_err={m['decode_mean_rel_err']} "
              f"holdout={json.dumps(m.get('holdout'))} "
              f"prefill_coef={m['profile']['prefill']['coef']} "
              f"decode_coef={m['profile']['decode']['coef']}")
        require(m["mode"] == "measured-cuda" and all(
            r["result"]["mode"] == "measured-cuda" for r in cal.extra_records
            if "backend" not in r), "the fc sweep measured on the card")
        require(len(kernel_recs) == m["n_kernel_records"] == points * pairs
                and all(r["result"]["mode"] == "kernel-cuda"
                        and r["result"]["max_err_vs_ref"] >= 0.0 for r in kernel_recs),
                f"{len(kernel_recs)} verified kernel records, want {points * pairs}")
        # per (kernel, dtype): one verification, then per point a warm-up
        # and ``repeats`` timed calls
        want = {name: len(case.dtypes) * (1 + points * (1 + spec.repeats))
                for name, case in reg.items()}
        require(launches == want, f"hook launches {launches} != {want}")
        # the records are verified at the grid's smallest point only: hold
        # every kernel at every point the hook timed
        held_on_grid("session", spec.batches, spec.seqs)
        saved = load_profile(m["profile_path"])
        require(dict(json.loads(json.dumps(saved.to_dict())), created_ts=None)
                == dict(json.loads(json.dumps(m["profile"])), created_ts=None)
                and sorted(saved.kernels) == sorted(
                    f"{n}/{dt}" for n, case in reg.items() for dt in case.dtypes),
                "the measured profile reads back")
        fitted = FittedLatencyModel.from_profile(m["profile_path"])
        require(fitted.hw.name == "h100" and fitted.prefill_latency(32, 1) > 0,
                "the measured profile builds a fitted oracle")
        om = oracle.result().metrics
        print(f"[session] cal-gemma2 mode={om['mode']} n_records={om['n_records']} "
              f"prefill_coef={om['profile']['prefill']['coef']} "
              f"decode_coef={om['profile']['decode']['coef']} "
              f"prefill_r2={om['prefill_r2']} decode_r2={om['decode_r2']} "
              f"prefill_mean_rel_err={om['prefill_mean_rel_err']} "
              f"decode_mean_rel_err={om['decode_mean_rel_err']} "
              f"cold_start_s={om['profile']['cold_start_s']}")
        require(om["mode"] == "oracle" and om["n_records"] == 5 * 4 * 2
                and FittedLatencyModel.from_profile(om["profile_path"]).hw.name == "h100",
                "the oracle profile reads back")
        # gemma2-2b on h100, quickstart's base workload at chips 1: on the
        # roofline oracle and on the measured profile
        base = json.loads((ROOT / "configs" / "jobs" / "quickstart.json").read_text())["base"]
        serving = {name: session.submit(dict(base, job_id=f"gemma2-h100-{name}",
                                             hardware="h100", chips=1, **extra))
                   for name, extra in (("roofline", {}),
                                       ("profile", {"profile": m["profile_path"]}))}
        session.run()
        for name, handle in serving.items():
            r = handle.result().metrics
            print(f"[session] {handle.job_id} mode={r['mode']} throughput_rps="
                  f"{r['throughput_rps']} p50_s={r['p50_s']} p99_s={r['p99_s']} "
                  f"slo_attainment={r['slo_attainment']} cost_usd={r['cost_usd']}")
            require(r["mode"] == ("roofline-model" if name == "roofline" else "fitted-profile")
                    and r["requests"] > 0 and all(np.isfinite(r[k]) for k in (
                        "throughput_rps", "p50_s", "p99_s")), f"serving job {name}")
        # quickstart.json inline in this session, and through concurrent
        # followers in another: the same records
        quick = session.submit_file(ROOT / "configs" / "jobs" / "quickstart.json")
        session.run()
        other = BenchmarkSession(executor=ConcurrentFollowerExecutor())
        other.submit_file(ROOT / "configs" / "jobs" / "quickstart.json")
        concurrent = {r.job_id: sim_record(r) for r in other.run()}
        inline = {h.job_id: sim_record(h.result()) for h in quick}
        require(len(inline) == 18 and inline == concurrent,
                "quickstart.json: inline and concurrent records equal")
        print(f"[session] quickstart.json {len(inline)} jobs, inline == concurrent; "
              f"best throughput_rps={max(r['result']['throughput_rps'] for r in inline.values())}")
        results = session.results()
        want_rows = sum(1 + len(r.extra_records or ()) for r in results)
        rows = PerfDB(str(db_path)).all()
        require(len(rows) == want_rows == len(session.db)
                and rows == json.loads(json.dumps(session.db.all())),
                f"PerfDB file holds {len(rows)} rows, want {want_rows}, read back equal")
        print(f"[session] PerfDB {len(results)} jobs, {len(rows)} rows, read back equal")
    return launches


# Phase 12: calibrate_plan.json's calibration grid and plan workload on the
# card's own profile.  The calibration and the plan are two runs of the
# launcher, in that order: the two-tier scheduler runs the shortest job
# first, so a plan submitted beside the calibration that writes its profile
# could start before it.  h100 has no price (cost_usd 0.0), so the plan names
# an objective a run can tell apart: p99_s.
PLAN_GRID = dict(batches=(1, 2, 4, 8, 16), seqs=(32, 64, 128, 256))
PLAN_MODES = ("fp16", "int8", "speculative")


def launch_file(path: str, executor: str = "inline", db: str = ""):
    """``repro_torch.launch.run_jobs`` on a job file, from the working
    directory, on the card; returns the session."""
    from repro_torch.launch.run_jobs import parse_args, run_config
    return run_config(parse_args(["--config", path, "--executor", executor]
                                 + (["--db", db] if db else [])))


def launch_jobs(jobs, name: str):
    """``launch_file`` on ``jobs`` written to ``name`` in the working
    directory."""
    Path(name).write_text(json.dumps({"jobs": jobs}))
    return launch_file(name)


def records_by_job(db: str) -> dict:
    """A PerfDB file's records per job, without their wall-clocked fields."""
    from repro_torch.core import PerfDB
    out = {}
    for rec in PerfDB(db).all():
        rec = {k: v for k, v in rec.items() if k not in WALL_CLOCKED}
        rec["result"] = {k: v for k, v in rec["result"].items()
                         if k != "sim_events_per_sec"}
        out.setdefault(rec["job_id"], []).append(rec)
    return out


def phase_plan():
    """measure → model → plan on the card: an oracle calibration of gemma2-2b
    on h100 with all five kernels on its hook, then a plan on the profile it
    fitted, then every committed job config inline and with concurrent
    followers, each config's report, and a span timeline on the fitted
    profile.  All through the launcher, from a temporary working directory
    that holds a copy of configs/ (the configs' relative paths resolve
    there).  Counts at 0 just before the calibration, read after the
    configs: only the hook launches the port's kernels.  Nothing is caught."""
    import dataclasses as dc
    import os
    import shutil
    import tempfile

    from repro_torch.calibrate.kernel_bench import kernel_registry
    from repro_torch.calibrate.planner import PlanCandidate, simulate_candidate
    from repro_torch.calibrate.profile import load_profile
    from repro_torch.core import resolve_policy
    from repro_torch.core.spec import SoftwareSpec
    from repro_torch.obs import ObsSpec, write_trace
    from repro_torch.serving.cluster import ClusterSpec, simulate_cluster
    from repro_torch.serving.latency_model import NETWORKS
    t_phase = time.perf_counter()
    reg = kernel_registry()
    plan_cfg = json.loads((ROOT / "configs" / "jobs" / "calibrate_plan.json").read_text())
    (plan_job,) = [j for j in plan_cfg["jobs"] if j.get("kind") == "plan"]
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            shutil.copytree(ROOT / "configs", "configs")
            reset_launches()
            t0 = time.perf_counter()
            cal = launch_jobs([{
                "kind": "calibration", "job_id": "cal-h100", "model": {"name": "gemma2-2b"},
                "hardware": "h100", "chips": 1, **PLAN_GRID, "holdout_fraction": 0.25,
                "kernels": sorted(reg), "profile_dir": tmp}], "calibrate.json")
            t_cal = time.perf_counter() - t0
            plan = launch_jobs([{
                "kind": "plan", "job_id": "plan-h100", "profile": "gemma2-2b@h100",
                "profile_dir": tmp, "workload": plan_job["workload"],
                "slo_latency_s": 0.25, "slo_target": 0.99, "replicas": [1, 2, 4],
                "policies": ["tfs", "continuous"], "routers": ["least-loaded"],
                "speed_modes": list(PLAN_MODES), "objective": "p99_s"}], "plan.json")
            t_plan = time.perf_counter() - t0 - t_cal
            configs = {}
            for path in sorted(Path("configs/jobs").glob("*.json")):
                runs = {ex: launch_file(str(path), ex, db=f"{path.stem}-{ex}.jsonl")
                        for ex in ("inline", "concurrent")}
                configs[path.name] = (runs["inline"], {
                    ex: records_by_job(f"{path.stem}-{ex}.jsonl") for ex in runs})
            launches = read_launches()
            print(f"[plan] calibration s={t_cal:.1f} plan s={t_plan:.1f} configs "
                  f"s={time.perf_counter() - t0 - t_cal - t_plan:.1f} "
                  f"launches={json.dumps(launches)}")
            # the calibration and its hook
            (cal_res,) = cal.results()
            spec, m = cal_res.spec, cal_res.metrics
            kernel_recs = [r for r in cal_res.extra_records
                           if r.get("backend") == "hopper-kernel"]
            points = len(spec.batches) * len(spec.seqs)
            pairs = sum(len(case.dtypes) for case in reg.values())
            print(f"[plan] cal-h100 mode={m['mode']} n_records={m['n_records']} "
                  f"n_kernel_records={m['n_kernel_records']} "
                  f"prefill_coef={m['profile']['prefill']['coef']} "
                  f"decode_coef={m['profile']['decode']['coef']} "
                  f"prefill_r2={m['prefill_r2']} decode_r2={m['decode_r2']} "
                  f"holdout={json.dumps(m.get('holdout'))}")
            require(m["mode"] == "oracle" and points * pairs == 180
                    and len(kernel_recs) == m["n_kernel_records"] == 180
                    and all(r["result"]["mode"] == "kernel-cuda"
                            and r["result"]["max_err_vs_ref"] >= 0.0 for r in kernel_recs),
                    f"{len(kernel_recs)} verified kernel records, want 180")
            # per (kernel, dtype): one verification, then per point a warm-up
            # and ``repeats`` timed calls; the plan and the configs launch none
            want = {name: len(case.dtypes) * (1 + points * (1 + spec.repeats))
                    for name, case in reg.items()}
            require(launches == want, f"phase 12 launches {launches} != {want}")
            profile = load_profile("gemma2-2b@h100", tmp)
            require(profile.hardware == "h100" and sorted(profile.kernels) == sorted(
                f"{n}/{dt}" for n, case in reg.items() for dt in case.dtypes)
                and sorted(profile.speed_modes) == sorted(PLAN_MODES),
                "the h100 profile reads back with its nine kernel fits and speed modes")
            # the plan on that profile
            (plan_res,) = plan.results()
            pm = plan_res.metrics
            cands = pm["plan"]["candidates"]
            for c in cands:
                print(f"[plan] candidate replicas={c['replicas']} policy={c['policy']} "
                      f"speed_mode={c['speed_mode']} p99_s={c['metrics']['p99_s']} "
                      f"slo_attainment={c['metrics']['slo_attainment']} "
                      f"meets_slo={c['meets_slo']}")
            feasible = [c["objective"] for c in cands if c["meets_slo"]]
            shown = pm["best"] and {k: pm["best"][k] for k in (
                "replicas", "policy", "speed_mode", "objective")}
            print(f"[plan] plan-h100 {len(cands)} candidates, {pm['feasible']} meet the "
                  f"SLO (p99 <= 0.25 s at 0.99); best {json.dumps(shown)}")
            require(len(cands) == pm["candidates"] == 18 and feasible == sorted(feasible)
                    and {c["speed_mode"] for c in cands} == set(PLAN_MODES),
                    "18 candidates, the feasible ones by p99")
            workload = plan_res.spec.workload
            if pm["best"] is not None:
                best = PlanCandidate(**pm["best"])
                res = simulate_candidate(profile, workload, best)
                require(res.summary() == {k: best.metrics[k] for k in res.summary()},
                        "the best candidate re-simulated gives its metrics exactly")
            # every committed config: inline == concurrent, and its report
            for name, (session, recs) in configs.items():
                html_path = session.report(str(Path(tmp) / f"{name}.html"))
                html = Path(html_path).read_text()
                ids = sorted(recs["inline"])
                require(recs["inline"] == recs["concurrent"] and ids
                        and len(ids) == len(session.results()),
                        f"{name}: inline and concurrent records equal")
                require(len(html) > 0 and all(i in html for i in ids),
                        f"{name}: the report names every job")
                print(f"[plan] {name} {len(ids)} jobs, inline == concurrent, report "
                      f"{len(html)} bytes")
            require(len(configs) == 7, f"{len(configs)} committed configs")
            (mp,) = configs["calibrate_plan.json"][1]["inline"]["plan-gemma2"]
            shown = mp["result"]["best"] and {k: mp["result"]["best"][k] for k in (
                "replicas", "policy", "objective")}
            print(f"[plan] calibrate_plan.json plan-gemma2 best {json.dumps(shown)}")
            # a span timeline on the fitted profile, observability on and off
            policy = resolve_policy(SoftwareSpec(policy="continuous", max_batch=16))
            cluster = ClusterSpec(replicas=2, router="least-loaded")
            oracle = profile.to_latency_model()
            off = simulate_cluster(workload, policy, oracle, cluster=cluster,
                                   network=NETWORKS["lan"])
            on = simulate_cluster(workload, policy, oracle, network=NETWORKS["lan"],
                                  cluster=dc.replace(cluster, obs=ObsSpec()))
            trace = json.loads(Path(write_trace(on, str(Path(tmp) / "trace.json"))).read_text())
            engine = [e for e in trace["traceEvents"] if e["ph"] == "X" and e["tid"] == 0]
            require(on.summary() == off.summary() and engine
                    and trace["metadata"]["requests_recorded"] == len(on.traces) > 0,
                    "the timeline holds engine spans and moves no simulated number")
            print(f"[plan] timeline on gemma2-2b@h100: {len(trace['traceEvents'])} events, "
                  f"{len(engine)} engine spans, {len(on.traces)} requests")
        finally:
            os.chdir(cwd)
        # every kernel at every point the hook timed (not counted)
        held_on_grid("plan", spec.batches, spec.seqs)
    print(f"[plan] phase 12 s={time.perf_counter() - t_phase:.1f}")
    return launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    # fp32 products on the card stay IEEE in every comparison below
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    name = phase_device()
    phase_build()
    # (kernel, model, variant): record; the launches of a "calibration"
    # record are counted on the calibration sweep (all its dtypes together),
    # the others' on the model's generate run
    records = {
        ("flash_attention", "gemma2-2b", ""): merge([
            flash_case("gemma2-2b", 8, 4, 4096, 50.0),
            flash_case("gemma2-2b", 8, 4, 0, 50.0)]),
        ("decode_attention", "gemma2-2b", ""): merge([
            decode_case("gemma2-2b", 8, 4, 4736, 4096, 50.0, ring=False),
            decode_case("gemma2-2b", 8, 4, 4736, 0, 50.0, ring=False)]),
        ("flash_attention", "recurrentgemma-9b", ""): merge([
            flash_case("recurrentgemma-9b", 16, 1, 2048, 0.0)]),
        ("decode_attention", "recurrentgemma-9b", ""): merge([
            decode_case("recurrentgemma-9b", 16, 1, 2048, 2048, 0.0, ring=True)]),
        ("rglru_scan", "recurrentgemma-9b", ""): merge([rglru_case()]),
        ("rglru_scan", "calibration",
         f"bf16 a/b/seq, timed at recurrentgemma-9b's prefill shape B={len(PROMPTS)} "
         f"S={max(PROMPTS)} R=4096"):
            merge([rglru_case("bfloat16")]),
        ("wkv6", "rwkv6-7b", ""): merge([
            wkv6_case("rwkv6-7b", len(PROMPTS), max(PROMPTS), 64, 64, PROMPTS, 1000)]),
        ("wkv6", "calibration", "N=32, timed at B=4 S=256 H=2"): merge([
            wkv6_case("calibration", 4, 256, 2, 32, (256,) * 4, 100)]),
        ("int8_matmul", "calibration",
         "timed at gemma2-2b's MLP down-projection 4096 x 9216 x 2304"): merge([
            int8_down_projection()]),
        ("int8_matmul", "calibration", "timed at the sweep's largest point 1024 x 512 x 512"):
            merge([int8_calibration_largest()]),
    }
    launches = {}
    for arch in ("gemma2-2b", "recurrentgemma-9b", "rwkv6-7b"):
        torch.cuda.empty_cache()
        launches[arch] = phase_model(arch)
        torch.cuda.empty_cache()
        phase_serving(arch)
    calibration = phase_calibration()
    torch.cuda.empty_cache()
    hook = phase_session()
    torch.cuda.empty_cache()
    plan_hook = phase_plan()
    src = "src/repro_torch/kernels/csrc/"
    replaces = {"flash_attention": "src/repro/kernels/flash_attention.py:94",
                "decode_attention": "src/repro/kernels/decode_attention.py:73",
                "rglru_scan": "src/repro/kernels/rglru_scan.py:53",
                "wkv6": "src/repro/kernels/wkv6.py:66",
                "int8_matmul": "src/repro/kernels/int8_matmul.py:45"}
    print(f"[done] wall_s={time.perf_counter() - t0:.1f}")
    print(json.dumps({"kernels": [
        dict(name=kernel, model=arch, **({"variant": variant} if variant else {}),
             route="cuda", source=f"{src}{kernel}.cu", replaces=replaces[kernel],
             launches=(calibration if arch == "calibration" else launches[arch])[kernel],
             launches_on=("calibration sweep, all its dtypes together"
                          if arch == "calibration" else "generate"),
             hook_launches=hook[kernel], plan_hook_launches=plan_hook[kernel], **rec)
        for (kernel, arch, variant), rec in records.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
