#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one H100.

    python3 chip_smoke.py

Phases, each printed on its own lines; any failure exits non-zero:
  1. device   — nvidia-smi name and power limit, torch's device name and
                capability (must be 9.0);
  2. build    — the five CUDA kernels from ``src/repro_torch/kernels/csrc``
                and the backward kernels of K1, K3 and K4 with nvcc for
                sm_90a, in parallel, with ptxas's resource report (no
                instantiation may spill, K3's bf16 and K4's N = 32 ones
                included);
  3. kernels  — each kernel against its plain PyTorch version, element by
                element, with planted faults that the check must reject, and
                kernel, plain and library times (CUDA events) beside the
                least time the card could take:
                K1 and K2 at gemma2-2b's shapes (bf16, H=8, K=4, d=256,
                softcap 50, window 4096 and global) and at recurrentgemma-9b's
                (H=16, K=1, window 2048, no softcap; K2 over a 2048-slot
                ring), granite-moe-3b-a800m's (H=24, K=8, d=64: 3 query heads
                per kv head) and dbrx-132b's (H=48, K=8, d=128: 6), both
                global without softcap, whisper-tiny's (K1 on the encoder,
                1500 x 1500, and on the cross-attention, 432 x 1500, both
                not causal, no lengths; K2 on the cross-attention, T = 1500,
                no slot positions) and llava-next-34b's (H=56, K=8, d=128,
                causal, at its prefill lengths), within one bf16 ulp (|err| ≤ 1e-5 +
                2^-7·|want|) of their plain versions computed in float64,
                their faults including the last head of each group dropped
                and, for K2, one split of its plan dropped;
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
 13. model    — phase 4 for full-width granite-moe-3b-a800m (32 layers, 40
                experts top-8 of d_ff 512 behind K1/K2 attention, 24 query
                heads on 8), with the routing apart: the fp32 plain run fixes
                each layer's top-k choices; the fp32 kernel run's own choices
                are reported (decisions that differ, with their margins), and
                the comparison runs are pinned to the plain run's routing by a
                stand-in for the router; every decision the kernel run would
                take otherwise must sit at a near tie; the fp32 logits with
                routing pinned held to max(1e-3, MOE_DRIFT × those of a
                control, the plain path with attention summed in float64),
                which attention rounded through bf16 must fail;
 14. serving  — phase 5 for granite-moe-3b-a800m;
 15. model    — phase 13 for dbrx-132b at full width (16 experts top-4 of
                d_ff 10752, 48 query heads of 128 on 8) and 4 of its 40
                layers (MODEL_RUNS: all 40 do not fit one card), on shorter
                prompts;
 16. model    — phase 4 for whisper-tiny, whole (4 encoder + 4 decoder
                layers, d_model 384, 6 heads of 64), on 1500 frames from a
                seed (its encoder context) and text prompts (432, 300, 100,
                17): K1 on the encoder (not causal, 1500 x 1500), the
                decoder's self-attention and its cross-attention (not
                causal, text x 1500), K2 on both in decode (the
                cross-attention with no slot positions); then generate
                again at the default cache length (the padded prompt),
                where the longest row decodes past the last slot and drops
                its write, as the reference does: the fp32 kernel path's
                tokens equal to the fp32 plain path's run the same way;
 17. model    — phase 4 for llava-next-34b at full width and 8 of its 60
                layers (MODEL_RUNS), 2880 patch embeddings from a seed in
                front of text prompts (512, 300, 100, 17): K1 causal with 7
                query heads per kv head, d 128, K2 likewise;
 18. train    — K1's backward (``flash_attention_bwd.cu``) at each model's
                training shapes (granite-3-2b, gemma2-2b local and global
                with softcap 50, recurrentgemma-9b local at 16 query heads
                per kv head, whisper-tiny's encoder and cross-attention,
                llava-next-34b with lengths, the ~100M config in fp32)
                against the plain version's gradient in float64 (see
                BWD_ATOL_SHARE), the fp32 plain version against the same
                limit, planted faults (dK without the group sum, the
                softcap's derivative dropped, the causal mask shifted), two
                calls bitwise equal, and times against SDPA's backward with
                the first version's (FLASH_BWD_FIRST_MS) beside; K1 forward at granite's
                training shape; one train step of granite-3-2b at 4 layers
                and gemma2-2b at 2 through the kernels against the plain
                path and a float64-attention control (TRAIN_DRIFT), launch
                counts exact; granite-3-2b at full width and depth (fp32
                masters, 4 x 2048, remat) for 3 steps, step times and peaks;
                ``launch/train.py`` with examples_torch/train_100m.py's
                flags (the loss's last tenth a nat below its first), then 50
                steps killed at step 30 and restored: the final state
                bitwise that of a run without the failure;
 19. train    — the hybrid and RWKV6 families: K3's backward
                (``rglru_scan_bwd.cu``) at recurrentgemma-9b's training shape
                (B 4 × 2048, R 4096) in fp32 and bf16, on the ring of bulk
                copies its plan chooses there and bitwise equal to its
                register kernel, and K4's (``wkv6_bwd.cu``, tf32 mma.sync
                in the forward's segments) at rwkv6-7b's (B 4 × 2048, 64
                heads of 64, bf16), at N 32 and at S 300 (a partial last
                chunk), with a nonzero state0 and a gradient on the final
                state, two calls bitwise equal, against
                float64 autograd through the plain forwards (K4's through
                its float64 formulas, held to autograd on a slice) within
                limits derived from their arithmetic (see BWD_CASE), the
                fp32 plain versions against the same limits, planted faults
                failing by ≥ 10x (K3′: g_last dropped, s_{t-1} shifted by
                one; K4′: the gradient not carried across a chunk boundary,
                u dropped from dk, dlogw without its state term; also at
                the ~100M config's heads of 16, run padded to 32); one train
                step of recurrentgemma-9b (3 layers) and rwkv6-7b (2 layers)
                through the kernels, every kernel call of it, forward and
                backward, held to float64 on its own operands, launch counts
                exact, no plain call (its leaves against the plain path and
                a float64 control reported, not held: see train_check);
                recurrentgemma-9b at full width and 6
                layers and rwkv6-7b at full width and 8 (fp32 masters,
                4 × 2048, remat) for 3 steps each, step times and peaks;
                both families' ~100M configs through ``launch/train.py``
                for 200 steps (a nat down at least), and rwkv6-7b's killed
                at step 30 and restored bitwise;
 20. cost     — cost accounting (``launch/dryrun.py``): (a) the dry-run
                over all 10 archs × 4 shapes on meta tensors on this host,
                32 OK and 8 SKIP, none FAIL, its roofline table (accounting
                on ``hw.GPU_H100``'s data-sheet rates) and seconds; (b)
                gemma2-2b's prefill (4 × 2048) and decode (8 at 4096) cells
                counted on meta, then run on the card through K1 and K2:
                ``argument_bytes`` exactly the bytes the operands requested
                of the allocator, the card's peak within COST_PEAK_RATIO of
                the meta peak, launches exact, logits finite, the counted
                FLOPs beside the step's time; (c) the paper's Fig. 9 and
                Fig. 10 (``launch/figures.py``) measured on the card, their
                JSON of the reference's keys;
 21. dist     — distribution (``repro_torch.dist``, ``launch/mesh.py``) at
                world size 1, the only size one card has (the collectives
                between ranks are held on CPU ``gloo`` groups,
                tests/test_torch_dist.py): (a) an ``nccl`` group of one and
                ``make_host_mesh(1)``; granite-3-2b whole (4 × 2048, remat,
                fp32 masters) takes one gradient with its state placed by
                ``TRAIN_RULES`` on the 1 × 1 mesh: loss and every gradient
                leaf bitwise the same gradient without a mesh, K1 and K1′
                launched exactly 80 and 40 times, both step times and peaks
                printed, then the update on the mesh; (b)
                granite-moe-3b-a800m at full width, phase 13's ragged
                prefill and one decode step under ``MOE_EP_RULES`` (gspmd),
                ``MOE_LOCAL_RULES`` (local) and ``MOE_EP_LOCAL_RULES``
                (ep_local) on the 1 × 1 mesh, routing pinned as phase 13
                pins it: logits bitwise the run without a mesh, K1 and K2
                launches the same; a planted fault (ep_local's expert
                offset shifted by one) must change them; (c)
                ``compressed_psum`` over the group on one of (a)'s gradient
                leaves bitwise ``dequantize(*quantize(g))``; (d) the
                dry-run of gemma2-2b, granite-moe-3b-a800m and dbrx-132b ×
                train_4k, prefill_32k, decode_32k on both production meshes
                (fake groups on this host, meta tensors), granite-moe-3b-a800m
                and dbrx-132b under ``--rules ep_local`` and
                granite-moe-3b-a800m under ``moe_local``: all OK, their
                collectives by kind, the roofline's collective term (at
                ``hw.GPU_H100.link_bw``) and the MoE blocks' mode (ep_local
                runs only where the experts divide over "model": dbrx-132b's
                16, not granite-moe-3b-a800m's 40, which run gspmd), and the
                same 9 cells on a 1 × 1 fake mesh counting what phase 20 (a)
                counted, digit for digit; seconds printed; (e)
                granite-moe-3b-a800m's train step at full width (4 layers,
                2 × 2048, fp32 masters) on the 1 × 1 mesh under each MoE
                mode's rules: x's gradient in each MoE block adds its aux
                loss's router term in another order than without a mesh, so
                the step is held to TRAIN_DRIFT × the distance from the
                control of the step without a mesh, launches exact;
 22. examples — the port's example flows (``examples_torch/``): (a)
                ``serve_benchmark``'s main at full width, gemma2-2b's 26
                layers behind the none, tfs and tris policies of its sweep:
                every request of the workload served under each policy, the
                metrics finite, none's mean batch 1, K1 and K2 launched
                exactly as the batches served ask (phase 5's count, with its
                4 decode steps), K3, K4, K5 and the backward kernels not at
                all; its table printed under the card's name and power
                limit; then, outside the timed run, the flow's own shapes (a
                prefill of each batch size its policies emit, 1 to 8, of its
                32-token prompts and one decode step into its 64-slot cache)
                with every K1 and K2 call held to the plain version in
                float64, each limit ratio at most 1; (b) the ten flows that run on the host (the
                simulator, the planner, the session on the roofline model,
                the scheduler, the roofline report over the dry-run records
                of tests/golden_torch_examples/dryrun), each from a temporary
                working directory, their stdout equal to the reference's
                golden text in tests/golden_torch_examples/ byte for byte
                (in quickstart's tables, a run of rows that tie on the sort
                key as a multiset, UNORDERED_ROWS), and observe_flash_crowd's
                two files equal to the reference's by SHA-256; (c) phase 18 (d) and 19 (d)
                take their flags from examples_torch/train_100m.py; seconds
                printed;
then a ``kernels`` JSON line (``hook_launches``: phase 11's,
``plan_hook_launches``: phase 12's, ``examples_launches``: phase 22's on
gemma2-2b's K1 and K2; phase 18's and 19's records name the run
their ``launches`` were counted on), and last the ``ok`` JSON line.
Needs one card; imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import costs  # noqa: E402  (the kernels' formulas)

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
# MoE models route each token to its top k of E experts, a discrete choice:
# where two gates nearly tie, the fp32 rounding in which the kernel path and
# the plain path differ can swap them, and a swap moves that token's FFN
# output by O(1), and later tokens' capacity positions with it.  So the MoE
# phases compare the paths with routing pinned to the fp32 plain run's
# choices (a stand-in for models/moe.py's _route in this script; the package
# has no switch), and hold the routing apart, by this argument: if expert i
# is in the plain run's top k and j is not, but another run ranks j above i,
# then z_i − z_j ≥ z_(k) − z_(k+1) in the plain run's router logits z, while
# z'_j ≥ z'_i in the other's z', so the plain run's margin z_(k) − z_(k+1)
# ≤ |δz_i| + |δz_j| ≤ 2·max|δz|, δz = z' − z (on log-gates, log g = z −
# logsumexp z, the same differences).  With routing pinned, the router's
# logits are held like the model's: within the fp32 logit limit below, so
# every decision the kernel run would take otherwise must sit at a
# plain-run margin z_(k) − z_(k+1) ≤ 2·(that limit): a near tie.
#
# The fp32 logit limit of an MoE model.  Even pinned, a random-weight MoE
# stack amplifies fp32 rounding with depth: on granite-moe-3b-a800m (32
# layers) the fp32 plain path with its attention summed in float64 instead
# — a more exact evaluation of the same function — lies 0.0099 from the fp32
# plain path in logits and 0.0186 in router log-gates (the kernel path
# 0.0089 and 0.0176; chip_smoke.py on "NVIDIA H100 80GB HBM3, 700.00 W"),
# ten times LOGIT_TOL_FP32.  So each MoE phase runs that control, pinned
# alike, and holds the fp32 kernel path to max(LOGIT_TOL_FP32, MOE_DRIFT ×
# the control's distance), in logits and in router log-gates; at 4 layers
# (dbrx-132b) LOGIT_TOL_FP32 binds.  A kernel path that rounds attention
# through bf16 (what a kernel computing in the wrong precision gives) is run
# as the fault the limit must reject.
MOE_DRIFT = 2.0
PROMPTS = (4700, 1500, 300, 17)   # ragged prefill, one prompt past the window
# dbrx-132b at full width and 4 of its 40 layers (27.3 GB of bf16 weights;
# all 40 take 263 GB, more than one card holds): its fp32 comparison runs
# hold a layer's weights in fp32 (13 GB) and the plain attention's fp32
# logits, 48 heads wide, so its prompts are shorter than PROMPTS
#
# whisper-tiny runs whole on text prompts within its 448-token decoder
# context (432 + 16 generated) and 1500 frames, its encoder's 30 s of audio.
#
# llava-next-34b at full width and 8 of its 60 layers: a layer is 5.578e8
# parameters (1.116 GB of bf16), 8 layers and the 64000 x 7168 embedding
# 9.84 GB; all 60 take 67.9 GB, and init draws each stacked leaf in fp32
# first (wi alone 35 GB at 60 layers), so full depth does not fit beside
# the checks.  Its 2880 patch embeddings (the config's num_frontend_tokens)
# go in front of text prompts (512, 300, 100, 17), so the sequences are
# 3392, 3180, 2980 and 2897 long.  Memory of the attention checks at 56
# heads and S = 3392: the plain path's fp32 logits over the batch are
# 4·56·3392²·4 B = 10.3 GB a tensor, two alive at its peak; K1's float64
# check, one sequence at a time (flash_want), 5.2 GB a tensor.
MODEL_RUNS = {"dbrx-132b": dict(layers=4, prompts=(1024, 700, 300, 17)),
              "whisper-tiny": dict(prompts=(432, 300, 100, 17), frames=1500),
              "llava-next-34b": dict(layers=8, prompts=(512, 300, 100, 17))}
LLAVA_LENGTHS = tuple(2880 + n for n in MODEL_RUNS["llava-next-34b"]["prompts"])
DECODE_STEPS = 16
SERVE = {"gemma2-2b": dict(rate=8.0, duration_s=10.0, prompt_tokens=512),
         "recurrentgemma-9b": dict(rate=4.0, duration_s=5.0, prompt_tokens=512),
         "rwkv6-7b": dict(rate=4.0, duration_s=5.0, prompt_tokens=512),
         "granite-moe-3b-a800m": dict(rate=8.0, duration_s=10.0, prompt_tokens=512)}
MODEL_KERNELS = ("flash_attention", "decode_attention", "rglru_scan", "wkv6")
KERNELS = MODEL_KERNELS + ("int8_matmul",)   # K5 runs on the calibration path only
# the backward kernels: K1's (training, phase 18), K3's and K4's (phase 19)
BACKWARD = {"flash_attention_bwd": "flash_attention", "rglru_scan_bwd": "rglru_scan",
            "wkv6_bwd": "wkv6"}
BUILT = KERNELS + tuple(BACKWARD)


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
    lengths = kw.pop("lengths", None)
    return torch.cat([fa.plain(q[b:b + 1], k[b:b + 1], v[b:b + 1],
                               lengths=None if lengths is None else lengths[b:b + 1],
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


def bound_of(cost):
    """``bound`` of a kernel call's ``kernels.costs.Cost``, its operations
    at the peak rate of their type."""
    peak = {"bf16": PEAK_BF16_FLOPS, "fp32": PEAK_FP32_FLOPS, "int8": PEAK_INT8_OPS}
    return bound(cost.flops, cost.bytes, peak[cost.peak])


def counters():
    from repro_torch.kernels import (decode_attention, flash_attention, int8_matmul,
                                     rglru_scan, wkv6)
    return {"flash_attention": flash_attention, "decode_attention": decode_attention,
            "rglru_scan": rglru_scan, "wkv6": wkv6, "int8_matmul": int8_matmul}


def reset_launches():
    for mod in counters().values():
        mod.launches = 0
    for kernel in BACKWARD.values():
        counters()[kernel].launches_bwd = 0


def train_launches_read(kernels) -> dict:
    """(forward, backward) launches of each of ``kernels`` (those with a
    backward kernel)."""
    return {k: (counters()[k].launches, counters()[k].launches_bwd) for k in kernels}


def train_kernels(cfg) -> dict:
    """The kernels a train step of ``cfg`` runs, each with its layers."""
    n_attn, n_rec, n_rwkv = layer_counts(cfg)
    return {k: n for k, n in (("flash_attention", n_attn), ("rglru_scan", n_rec),
                              ("wkv6", n_rwkv)) if n}


def read_launches():
    return {name: mod.launches for name, mod in counters().items()}


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]


def phase_device():
    import torch
    print(card())
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device={name} capability={cap} count={torch.cuda.device_count()}")
    require(cap == (9, 0), f"capability {cap} is not Hopper (9, 0)")
    return name


def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    secs = _build.build(BUILT)
    print(f"[build] {json.dumps({k: round(v, 1) for k, v in secs.items()})} "
          f"wall_s={time.perf_counter() - t0:.1f}")
    spilled = []
    for name in BUILT:
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
    print("[ptxas] decode_attention: decode_kernel<T, D, NG> takes any H/K from 1 "
          "to 16 in one block (NG = 2 tiles of 8 heads above 8); combine_kernel "
          "merges the splits")
    require(not spilled, f"no kernel instantiation spills: {spilled}")


def last_head_dropped(out, G: int):
    """A planted fault: ``out`` (B, H, ...) with the last of each group of G
    query heads zeroed, the output of a kernel that drops that head (one
    that rounds G down to a power of two or to its head tiles' width)."""
    f = out.clone()
    f[:, G - 1::G] = 0
    return f


def flash_case(arch: str, H: int, K: int, window: int, softcap: float, d: int = 256,
               prompts=PROMPTS):
    """K1 at the prefill shapes of ``arch``: B=4 ragged ``prompts`` padded to
    the longest, H query heads on K kv heads of d."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    B, S = len(prompts), max(prompts)
    g = torch.Generator(device="cuda").manual_seed(1)
    # the model's layout: (B, S, heads, d), handed over as transposed views
    q, k, v = (torch.randn((B, S, h, d), generator=g, device="cuda").to(torch.bfloat16)
               .transpose(1, 2) for h in (H, K, K))
    lengths = torch.tensor(prompts, dtype=torch.int32, device="cuda")
    kw = dict(causal=True, window=window, softcap=softcap, lengths=lengths)
    got = fa.flash_attention(q, k, v, **kw)
    want = flash_want(q, k, v, **kw)
    # rows past a prompt's length are padding the model discards (a row
    # with no key in its window is 0 from the kernel, the mean of v from
    # the plain version); compare the valid rows
    err, ratio = held(got, want, prompts)
    require(bool(torch.isfinite(got).all()), "flash_attention output finite")
    require(ratio <= 1.0, f"flash_attention {arch} window={window} max|err| {err}, "
            f"{ratio}x the limit")
    # planted faults, each the kernel's own output where a wrong kernel would
    # give it: the longest prompt's last kv tile skipped, the last head of
    # each group dropped, and (local layers) the window edge one tile late;
    # the check above must reject each
    tile = fa.KV_TILE[q.dtype, d]
    short = lengths - torch.tensor([tile, 0, 0, 0], dtype=torch.int32, device="cuda")
    faults = {"last_tile_skipped": fa.flash_attention(q, k, v, **{**kw, "lengths": short}),
              "last_head_dropped": last_head_dropped(got, H // K)}
    if window:
        faults["window_one_tile_wide"] = fa.flash_attention(
            q, k, v, **{**kw, "window": window + tile})
    fault_ratio = {name: held(out, want, prompts)[1] for name, out in faults.items()}
    require(all(r > 1.0 for r in fault_ratio.values()),
            f"flash_attention check rejects planted faults {fault_ratio}")
    pos = torch.arange(S, device="cuda")
    mask = (pos[None, :] <= pos[:, None])
    if window:
        mask &= pos[None, :] > pos[:, None] - window
    mask = (mask[None] & (pos[None, None, :] < lengths[:, None, None]))[:, None]
    # work these inputs need: valid query rows × keys in their mask
    pairs = costs.attention_pairs(S, S, window=window, lengths=prompts, padded_rows=False)
    ms_bound, by = bound_of(costs.flash_attention(
        B, H, K, S, S, d, q.element_size(), window=window, softcap=softcap, pairs=pairs))
    res = dict(max_abs_err=err, limit_ratio=ratio, fault_ratio=fault_ratio,
               ms=cuda_ms(lambda: fa.flash_attention(q, k, v, **kw), 10),
               plain_ms=cuda_ms(lambda: fa.plain(q, k, v, **kw), 3),
               library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                   q, k, v, attn_mask=mask, enable_gqa=True), 10),
               bound_ms=ms_bound, bound_by=by)
    print(f"[kernel flash_attention] {arch} H={H} K={K} d={d} window={window} "
          f"softcap={softcap} " + json.dumps(res))
    return res


def decode_case(arch: str, H: int, K: int, T: int, window: int, softcap: float,
                ring: bool, d: int = 256):
    """K2 at the decode shapes of ``arch``: B=8, a cache of T slots in the
    model's (B, T, K, d) layout, H query heads on K kv heads of d.  Without
    ``ring`` slot t holds position t (a full-length cache); with it slot t
    holds the latest position ≡ t (mod T), as in a local layer's ring."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels.ref import decode_mask
    B = 8
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
    # (the second, live for six or seven of the eight rows) dropped; the
    # last head of each group dropped; on a full-length cache the window
    # edge one tile late (a ring of the window holds no position outside
    # it, so there a wider window changes nothing); with more than 8 query
    # heads per kv head, heads 8-15 given heads 0-7's queries.  The check
    # above must reject each.
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
        q, k, v, lengths, **{**kw, "slot_pos": dropped}),
        "last_head_dropped": last_head_dropped(got, H // K)}
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
    ms_bound, by = bound_of(costs.decode_attention(
        B, H, K, T, d, q.element_size(), window=window, softcap=softcap,
        live=int(mask.sum())))
    res = dict(max_abs_err=err, limit_ratio=ratio, fault_ratio=fault_ratio,
               ms=cuda_ms(lambda: da.decode_attention(q, k, v, lengths, **kw), 50),
               plain_ms=cuda_ms(lambda: da.plain(q, k, v, lengths, **kw), 10),
               library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                   q[:, :, None], k, v, attn_mask=mask[:, None, None],
                   enable_gqa=True), 50),
               bound_ms=ms_bound, bound_by=by)
    print(f"[kernel decode_attention] {arch} H={H} K={K} d={d} T={T} ring={ring} "
          f"window={window} softcap={softcap} splits={nsplit}x{chunk} " + json.dumps(res))
    return res


def flash_cross_case(label: str, B: int, H: int, Sq: int, Skv: int, d: int):
    """K1 not causal and without lengths, queries of Sq rows against Skv keys
    (H query heads, as many kv heads): whisper-tiny's encoder (Sq = Skv) and
    its cross-attention (text against frames), at the model's batch."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    g = torch.Generator(device="cuda").manual_seed(3)
    q, k, v = (torch.randn((B, n, H, d), generator=g, device="cuda").to(torch.bfloat16)
               .transpose(1, 2) for n in (Sq, Skv, Skv))
    got = fa.flash_attention(q, k, v, causal=False)
    want = flash_want(q, k, v, causal=False)
    err, ratio = held(got, want)
    require(bool(torch.isfinite(got).all()), "flash_attention output finite")
    require(ratio <= 1.0, f"flash_attention {label} max|err| {err}, {ratio}x the limit")
    # planted faults: the last kv tile skipped; keys read only up to Sq (a
    # kernel that takes Skv = Sq); the causal mask applied; the head dropped
    tile = fa.KV_TILE[q.dtype, d]
    full = torch.full((B,), Skv, dtype=torch.int32, device="cuda")
    faults = {"last_tile_skipped": fa.flash_attention(q, k, v, causal=False,
                                                      lengths=full - tile),
              "causal_mask_applied": fa.flash_attention(q, k, v, causal=True),
              "last_head_dropped": last_head_dropped(got, 1)}
    if Sq < Skv:
        faults["keys_cut_at_sq"] = fa.flash_attention(q, k, v, causal=False,
                                                      lengths=full.clamp(max=Sq))
    fault_ratio = {name: held(out, want)[1] for name, out in faults.items()}
    require(all(r > 1.0 for r in fault_ratio.values()),
            f"flash_attention check rejects planted faults {fault_ratio}")
    ms_bound, by = bound_of(costs.flash_attention(B, H, H, Sq, Skv, d, q.element_size(),
                                                  causal=False))
    res = dict(max_abs_err=err, limit_ratio=ratio, fault_ratio=fault_ratio,
               ms=cuda_ms(lambda: fa.flash_attention(q, k, v, causal=False), 20),
               plain_ms=cuda_ms(lambda: fa.plain(q, k, v, causal=False), 5),
               library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v), 20),
               bound_ms=ms_bound, bound_by=by)
    print(f"[kernel flash_attention] {label} B={B} H={H} K={H} d={d} Sq={Sq} Skv={Skv} "
          f"causal=False " + json.dumps(res))
    return res


def decode_cross_case(label: str, B: int, H: int, T: int, d: int):
    """K2 with no slot positions (q_pos and slot_pos None): one query token
    against all T encoder slots, whisper-tiny's cross-attention in decode."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as da
    g = torch.Generator(device="cuda").manual_seed(4)
    q = torch.randn((B, H, d), generator=g, device="cuda").to(torch.bfloat16)
    k, v = (torch.randn((B, T, H, d), generator=g, device="cuda").to(torch.bfloat16)
            .transpose(1, 2) for _ in range(2))
    lengths = torch.full((B,), T, dtype=torch.int32, device="cuda")
    got = da.decode_attention(q, k, v, lengths)
    want = decode_want(q, k, v, lengths)
    err, ratio = held(got, want)
    require(bool(torch.isfinite(got).all()), "decode_attention output finite")
    require(ratio <= 1.0, f"decode_attention {label} max|err| {err}, {ratio}x the limit")
    # planted faults: the last tile of slots skipped; one split of the plan
    # (the second) dropped, through slot positions that mask it and match
    # the unmasked ones elsewhere; the head dropped
    tile = da.TILE[q.dtype, d]
    nsplit, chunk = da.plan_splits(B, H, T, d, q.element_size())
    require(nsplit > 1, f"decode_attention {label} splits the cache ({nsplit} splits)")
    slot_pos = torch.arange(T, dtype=torch.int32, device="cuda").repeat(B, 1)
    slot_pos[:, chunk:2 * chunk] = -1
    faults = {"last_tile_skipped": da.decode_attention(q, k, v, lengths - tile),
              "one_split_dropped": da.decode_attention(
                  q, k, v, lengths, q_pos=lengths - 1, slot_pos=slot_pos),
              "last_head_dropped": last_head_dropped(got, 1)}
    fault_ratio = {name: held(out, want)[1] for name, out in faults.items()}
    require(all(r > 1.0 for r in fault_ratio.values()),
            f"decode_attention check rejects planted faults {fault_ratio}")
    ms_bound, by = bound_of(costs.decode_attention(B, H, H, T, d, q.element_size()))
    res = dict(max_abs_err=err, limit_ratio=ratio, fault_ratio=fault_ratio,
               ms=cuda_ms(lambda: da.decode_attention(q, k, v, lengths), 50),
               plain_ms=cuda_ms(lambda: da.plain(q, k, v, lengths), 10),
               library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                   q[:, :, None], k, v), 50),
               bound_ms=ms_bound, bound_by=by)
    print(f"[kernel decode_attention] {label} B={B} H={H} K={H} d={d} T={T} q_pos=None "
          f"slot_pos=None splits={nsplit}x{chunk} " + json.dumps(res))
    return res


def rglru_inputs(dtype: str = "float32"):
    """K3's operands (a, b, s0) at recurrentgemma-9b's prefill shapes from a
    seed: the B=4 ragged prompts padded to the longest, R=4096, pad steps
    a=1, b=0; a and b in ``dtype``."""
    import torch
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
    return a, b, s0


def rglru_case(dtype: str = "float32"):
    """K3 at recurrentgemma-9b's prefill shapes: the B=4 ragged prompts padded
    to the longest, R=4096, pad steps a=1, b=0 as the model gives them; a and
    b in ``dtype`` (the model sends fp32; the calibration also bf16).  Held
    bitwise; the register variant and a batch of one are timed beside."""
    import torch
    from repro_torch.kernels import rglru_scan as rg
    B, S, R = len(PROMPTS), max(PROMPTS), 4096
    dt = getattr(torch, dtype)
    a, b, s0 = rglru_inputs(dtype)
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
    ms_bound, by = bound_of(costs.rglru_scan(B, S, R, a.element_size()))
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


def wkv6_inputs(B: int, S: int, H: int, N: int, prompts):
    """K4's operands (r, k, v, logw, u, s0) from a seed: B ragged prompts
    of lengths ``prompts`` padded to S, H heads of N, bf16 r/k/v with k=0
    and logw=0 on pad steps as the model gives them, logw = −exp(·), u and
    s0 in fp32."""
    import torch
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
    return r, k, v, logw, u, s0


def wkv6_case(label: str, B: int, S: int, H: int, N: int, prompts, fault_step: int):
    """K4 at B ragged prompts of lengths ``prompts`` padded to S, H heads of
    N, bf16 r/k/v with k=0 and logw=0 on pad steps as the model gives them,
    logw = −exp(·), u and s0 in fp32: rwkv6-7b's prefill (H=64, N=64) and
    the calibration's shape (H=2, N=32)."""
    import torch
    from repro_torch.kernels import wkv6 as wk
    args = wkv6_inputs(B, S, H, N, prompts)
    r, k, v, logw, u, s0 = args
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
    cost = costs.wkv6(B, S, H, N, r.element_size())
    ms_bound, by = bound_of(cost)
    res = dict(max_abs_err=err, limit_ratio=ratio, out_ratio=out_ratio,
               state_ratio=state_ratio, fault_ratio=fault_ratio,
               state_max_abs_err=float((got[1] - want[1]).abs().max()),
               # reported, not held: the output against ATOL + RTOL alone
               ulp_only_ratio=held(got[0], want[0])[1], segments=[P, Lc],
               # beside the bound: the time its bytes alone take
               bytes_ms=cost.bytes / PEAK_BYTES * 1e3,
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
    ms_bound, by = bound_of(costs.int8_matmul(M, K, N))
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
    out.update({k: v for k, v in cases[0].items() if k in RGLRU_EXTRA + ("library",)})
    return out


def layer_counts(cfg):
    """(attention layers, RG-LRU layers, RWKV6 layers) of a config."""
    from repro_torch.models.config import ATTN_GLOBAL, ATTN_LOCAL, RGLRU, RWKV6
    kinds = cfg.layer_kinds()
    return (kinds.count(ATTN_GLOBAL) + kinds.count(ATTN_LOCAL), kinds.count(RGLRU),
            kinds.count(RWKV6))


def kernel_calls(cfg):
    """(launches of each kernel per prefill, per decode step) of a model."""
    zero = {name: 0 for name in KERNELS}
    if cfg.is_encdec:
        # K1: each encoder layer, and each decoder layer's self- and
        # cross-attention; K2: each decoder layer's two in decode
        return ({**zero, "flash_attention": cfg.encoder_layers + 2 * cfg.num_layers},
                {**zero, "decode_attention": 2 * cfg.num_layers})
    n_attn, n_rec, n_rwkv = layer_counts(cfg)
    return ({**zero, "flash_attention": n_attn, "rglru_scan": n_rec, "wkv6": n_rwkv},
            {**zero, "decode_attention": n_attn})


def model_setup(arch: str, run: dict):
    """Full-width ``arch`` (its first ``run["layers"]`` layers when given)
    with random bf16 weights from a seed, and the ragged batch of
    ``run["prompts"]`` (PROMPTS by default): (cfg, model, params, tokens,
    lengths, max_len, extra).  ``extra`` holds the stub frontend's inputs
    from a seed, fp32: an encoder-decoder's ``frames`` (B, run["frames"],
    d_model), a VLM's ``patches`` (B, num_frontend_tokens, d_model), which
    go in front of the text, so ``lengths`` and ``max_len`` count them."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serving.engine import serving_config
    cfg = serving_config(get_config(arch))
    if run.get("layers"):
        cfg = dataclasses.replace(cfg, num_layers=run["layers"])
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    prompts = run.get("prompts", PROMPTS)
    B, S = len(prompts), max(prompts)
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S))
                              .astype(np.int32)).cuda()
    g = torch.Generator(device="cuda").manual_seed(1)
    extra, P = {}, 0
    if cfg.is_encdec:
        extra["frames"] = torch.randn((B, run["frames"], cfg.d_model), generator=g,
                                      device="cuda")
    elif cfg.frontend == "vision_patches":
        P = cfg.num_frontend_tokens
        extra["patches"] = torch.randn((B, P, cfg.d_model), generator=g, device="cuda")
    lengths = torch.tensor(prompts, dtype=torch.int32, device="cuda") + P
    return cfg, model, params, tokens, lengths, P + S + DECODE_STEPS, extra


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
        rows = None if kw.get("lengths") is None else kw["lengths"].tolist()
        keep("flash_attention", held(got, flash_want(q, k, v, **kw), rows)[1])
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


def bf16_rounded_attention() -> dict:
    """K1 and K2 with their outputs rounded through bf16, as stand-ins in
    ``ops``: what a kernel computing in the wrong precision gives."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    return {"flash_attention": lambda *a, **kw: fa.flash_attention(*a, **kw).bfloat16().float(),
            "decode_attention": lambda *a, **kw: da.decode_attention(*a, **kw).bfloat16().float()}


class Routing:
    """A stand-in for ``models/moe.py``'s ``_route`` (the package has no
    switch): it runs the real router and keeps, per call (one a layer, the
    prefill's then the decode step's), the gates and the top-k indices it
    chose.  Given ``pin``, another run's Routing, it hands the block that
    run's indices of the same call instead, with this run's gates at them,
    renormalised as ``_route`` does: the routing of both runs is then the
    same, and ``calls`` still holds what this run would have chosen."""

    def __init__(self, pin: "Routing" = None):
        from repro_torch.models import moe
        self.route, self.pin, self.calls = moe._route, pin, []

    def __call__(self, params, x, E, k):
        gates, w, idx = self.route(params, x, E, k)
        self.calls.append((gates, idx))
        if self.pin is None:
            return gates, w, idx
        idx = self.pin.calls[len(self.calls) - 1][1]
        w = gates.gather(-1, idx)
        return gates, w / w.sum(-1, keepdim=True).clamp(min=1e-9), idx


def routing_flips(ref: Routing, run: Routing) -> list:
    """Per call: (decisions, decisions whose top-k set differs from the
    reference run's, each one's margin in the reference run as (logit
    margin log g_(k) − log g_(k+1), gate margin g_(k) − g_(k+1)), max over
    the call of |δ log g| = |δz − δ logsumexp z| between the runs)."""
    import torch
    out = []
    for (g0, i0), (g1, i1) in zip(ref.calls, run.calls):
        k = i0.shape[-1]
        differ = (i0.sort(-1).values != i1.sort(-1).values).any(-1)
        top = g0.topk(k + 1, dim=-1).values[differ]
        margins = [(float(torch.log(a) - torch.log(b)), float(a - b))
                   for a, b in zip(top[:, k - 1], top[:, k])]
        drift = float((torch.log(g1) - torch.log(g0)).abs().max())
        out.append((differ.numel(), int(differ.sum()), margins, drift))
    return out


@contextlib.contextmanager
def swapped(swap: dict):
    """``swap``'s functions in place of those kernels in ``ops`` (the package
    has no switch), restored after."""
    from repro_torch.kernels import ops
    kernels = {name: getattr(ops, name) for name in swap}
    for name, fn in swap.items():
        setattr(ops, name, fn)
    try:
        yield
    finally:
        for name, fn in kernels.items():
            setattr(ops, name, fn)


def prefill_and_step(m, params, tokens, lengths, max_len, extra: dict, swap: dict,
                     tok=None, route: Routing = None):
    """A prefill of ``m`` (with the frontend's inputs ``extra``) and one
    decode step of ``tok`` (the prefill's greedy token when None), with
    ``swap``'s functions in place of those kernels in ``ops`` and ``route``
    in place of the MoE router (the package has no switch; restored after).
    Returns (prefill logits, decode logits, token, {"prefill": launches,
    "decode_step": launches})."""
    import torch
    from repro_torch.models import moe
    from repro_torch.serving.engine import greedy_sample, make_decode_fn, make_prefill_fn
    router = moe._route
    if route is not None:
        moe._route = route
    launches = {}
    try:
        with swapped(swap):
            reset_launches()
            cache, pre = make_prefill_fn(m, max_len)(params, tokens, lengths, **extra)
            launches["prefill"] = read_launches()
            tok = greedy_sample(pre) if tok is None else tok
            reset_launches()
            _, dec = make_decode_fn(m)(params, cache, tok)
            launches["decode_step"] = read_launches()
    finally:
        moe._route = router
    for what, t in (("prefill", pre), ("decode", dec)):
        require(tuple(t.shape) == (len(tokens), m.cfg.vocab_size), f"{what} logits shape")
        require(bool(torch.isfinite(t).all()), f"{what} logits finite")
    return pre, dec, tok, launches


def step_times(m, params, tokens, lengths, max_len, extra: dict) -> dict:
    """The generate run's steps timed apart, after it: a prefill, then the
    mean of DECODE_STEPS decode steps, each ended by a synchronise."""
    import torch
    from repro_torch.serving.engine import greedy_sample, make_decode_fn, make_prefill_fn
    t0 = time.perf_counter()
    cache, logits = make_prefill_fn(m, max_len)(params, tokens, lengths, **extra)
    tok = greedy_sample(logits)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    decode = make_decode_fn(m)
    for _ in range(DECODE_STEPS):
        cache, logits = decode(params, cache, tok)
        tok = greedy_sample(logits)
    torch.cuda.synchronize()
    return {"prefill_s": t1 - t0, "decode_step_s": (time.perf_counter() - t1) / DECODE_STEPS}


def fp32_activations(cfg):
    """The model of ``cfg`` with fp32 activations and an fp32 cache; it runs
    on the same bf16 weights."""
    from repro_torch.models import build_model
    return build_model(dataclasses.replace(cfg, dtype="float32", serve_param_dtype="float32"))


def max_diff(a, b) -> float:
    """max |a − b| over the prefill and decode logits of two runs."""
    return max(float((a[i] - b[i]).abs().max()) for i in (0, 1))


def report_routing(arch: str, ref: Routing, unpinned: Routing, pinned: Routing,
                   control: Routing) -> None:
    """The routing of the fp32 kernel run against the fp32 plain run's
    (``ref``): run unpinned, the decisions that differ per layer call; run
    pinned to ``ref``, the decisions it would have taken otherwise.  Held
    (see MOE_DRIFT): with routing pinned, the router's log-gates within
    max(LOGIT_TOL_FP32, MOE_DRIFT × the control's) of the plain run's, and
    every such decision at a plain-run logit margin ≤ 2·that limit; unpinned,
    the same for every decision of the first call that differs (the layers
    before it routed alike, so its inputs are the pinned run's).  Later calls
    of the unpinned run inherit the first flip's O(1) change: reported, not
    held."""
    free, held_ = routing_flips(ref, unpinned), routing_flips(ref, pinned)
    ctl = max(d for _, _, _, d in routing_flips(ref, control))
    limit = max(LOGIT_TOL_FP32, MOE_DRIFT * ctl)
    decisions = sum(n for n, _, _, _ in free)
    first = next((i for i, (_, f, _, _) in enumerate(free) if f), None)
    print(f"[routing] {arch} fp32 kernel run unpinned: {sum(f for _, f, _, _ in free)} of "
          f"{decisions} top-k decisions differ from the fp32 plain run's; per layer call "
          f"(the prefill's, then the decode step's) {[f for _, f, _, _ in free]}; first "
          f"differing call {first}, its flips' plain-run margins (logit, gate) "
          f"{free[first][2] if first is not None else []}")
    flips = [m for _, _, margins, _ in held_ for m in margins]
    drift = max(d for _, _, _, d in held_)
    print(f"[routing] {arch} fp32 kernel run pinned to the plain run's routing: max "
          f"|δ log gate| {drift} per layer call {[d for _, _, _, d in held_]}; the control's "
          f"{ctl}; limit {limit}; {len(flips)} decisions it would take otherwise, max "
          f"plain-run logit margin {max((m for m, _ in flips), default=0.0)} (limit "
          f"{2 * limit}), each (logit, gate) {flips}")
    require(drift <= limit, "router log-gates with routing pinned within the limit")
    near = flips + (free[first][2] if first is not None else [])
    require(all(m <= 2 * limit for m, _ in near),
            f"every routing flip at a near tie (logit margin <= {2 * limit})")


def phase_model(arch: str):
    import torch
    from repro_torch.serving.engine import greedy_sample, make_generate_fn
    torch.cuda.reset_peak_memory_stats()
    run = MODEL_RUNS.get(arch, {})
    prompts = run.get("prompts", PROMPTS)
    cfg, model, params, tokens, lengths, max_len, extra = model_setup(arch, run)
    n_attn, n_rec, n_rwkv = layer_counts(cfg)
    per_step = dict(zip(("prefill", "decode_step"), kernel_calls(cfg)))
    B = len(prompts)
    # the weights' init draws each stacked leaf in fp32 first: its peak apart
    init_gb = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()

    # the main path: counts at 0 just before, read just after
    reset_launches()
    t0 = time.perf_counter()
    out = make_generate_fn(model, DECODE_STEPS, max_len=max_len)(params, tokens, lengths,
                                                                 **extra)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    launches = read_launches()
    print(f"[model] {arch} layers={cfg.num_layers}"
          + (f" encoder_layers={cfg.encoder_layers}" if cfg.is_encdec else "")
          + f" d_model={cfg.d_model} generate B={B} prompts={list(prompts)} "
          f"{ {k: tuple(v.shape) for k, v in extra.items()} } lengths={lengths.tolist()} "
          f"max_len={max_len} steps={DECODE_STEPS} s={gen_s:.3f} "
          f"launches={json.dumps(launches)}")
    want = {k: per_step["prefill"][k] + DECODE_STEPS * per_step["decode_step"][k]
            for k in KERNELS}
    require(launches == want, f"generate launches {launches} != {want}")
    require(tuple(out.shape) == (B, DECODE_STEPS + 1), f"tokens shape {out.shape}")
    require(bool(((out >= 0) & (out < cfg.vocab_size)).all()), "token ids in range")

    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"[model] {arch} step times (host clock, synchronised): "
          f"{json.dumps(step_times(model, params, tokens, lengths, max_len, extra))}")

    # The same prefill and first decode step through the kernels and through
    # the plain versions, all decoding the same token, with bf16 activations
    # (as served) and with fp32 activations on the same bf16 weights.  The
    # bf16 kernel run also holds every kernel call against the plain version
    # on the same inputs.  An MoE model first runs the fp32 plain path alone
    # to fix the routing, and the fp32 kernel path unpinned; the other runs
    # are pinned to that routing, among them the control (the fp32 plain
    # path with its attention summed in float64) and the fault (the fp32
    # kernel path with attention rounded through bf16): see MOE_DRIFT.
    worst = {name: 0.0 for name in MODEL_KERNELS}
    reported = {"wkv6_output": 0.0, "wkv6_state": 0.0, "wkv6_ulp_only": 0.0}
    model32 = fp32_activations(cfg)
    args = (params, tokens, lengths, max_len, extra)
    runs, step_launches, routes = {}, {}, {}
    tok = ref = None
    cases = [(("bf16", "kernel"), model, checked_kernels(worst, reported)),
             (("bf16", "plain"), model, plain_kernels()),
             (("fp32", "kernel"), model32, {}),
             (("fp32", "plain"), model32, plain_kernels())]
    if cfg.is_moe:
        ref, unpinned = Routing(), Routing()
        tok = prefill_and_step(model32, *args, plain_kernels(), route=ref)[2]
        prefill_and_step(model32, *args, {}, tok, route=unpinned)
        cases += [(("fp32", "control"), model32, {"flash_attention": flash_want,
                                                  "decode_attention": decode_want}),
                  (("fp32", "fault"), model32, bf16_rounded_attention())]
    for key, m, swap in cases:
        routes[key] = None if ref is None else Routing(pin=ref)
        pre, dec, tok, step_launches[key] = prefill_and_step(m, *args, swap, tok,
                                                             route=routes[key])
        runs[key] = (pre, dec)
    logit_tol = LOGIT_TOL_FP32
    if ref is not None:
        control = max_diff(runs["fp32", "control"], runs["fp32", "plain"])
        logit_tol = max(LOGIT_TOL_FP32, MOE_DRIFT * control)
        fault = max_diff(runs["fp32", "fault"], runs["fp32", "plain"])
        print(f"[model] {arch} fp32 logits with routing pinned: the control (attention "
              f"summed in float64) {control} from the plain path; limit {logit_tol}; the "
              f"fault (attention rounded through bf16) {fault}")
        require(fault > logit_tol, "the fp32 logit limit rejects attention rounded "
                                   "through bf16")
        report_routing(arch, ref, unpinned, routes["fp32", "kernel"],
                       routes["fp32", "control"])
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
          f"(tol {logit_tol}) bf16 kernel-vs-plain={d16}; to the fp32 path: "
          f"bf16 kernel={far_k} bf16 plain={far_p} ratio={far_k / far_p} "
          f"(tol {BF16_DRIFT_RATIO})")
    print(f"[model] {arch} first token agrees fp32={same32.tolist()} "
          f"top2_gap={gaps('fp32')}; bf16={same16.tolist()} top2_gap={gaps('bf16')} "
          f"(not held); init_max_memory_allocated_gb={init_gb:.2f} "
          f"generate_max_memory_allocated_gb={peak_gb:.2f} "
          f"checks_max_memory_allocated_gb={torch.cuda.max_memory_allocated() / 1e9:.2f}")
    require(all(r <= 1.0 for r in worst.values()),
            "every bf16 kernel call on the model's activations within the limit")
    require(d32 <= logit_tol, "fp32 kernel vs plain logits")
    require(bool(same32.all()), "fp32 first greedy token agrees")
    require(far_k <= BF16_DRIFT_RATIO * far_p, "bf16 kernel path drift")
    if cfg.is_encdec:
        past_the_last_slot(arch, model, model32, params, tokens, lengths, extra,
                           per_step)
    return launches


def past_the_last_slot(arch, model, model32, params, tokens, lengths, extra, per_step):
    """An encoder-decoder generating at the default cache length, the padded
    prompt: its longest row decodes past the last slot from the first step
    on, and each such step drops its own k/v, as the reference's scatter
    drops an out-of-range index.  Through the kernels and through the plain
    versions, in fp32 (tokens held equal) and in bf16 (reported: there two
    summation orders may flip a near tie); kernel launch counts exact."""
    import torch
    from repro_torch.serving.engine import make_generate_fn
    require(int(lengths.max()) == tokens.shape[1], "the longest prompt fills the cache")
    want = {k: per_step["prefill"][k] + DECODE_STEPS * per_step["decode_step"][k]
            for k in KERNELS}
    toks = {}
    for dt, m in (("bf16", model), ("fp32", model32)):
        for path, swap in (("kernel", {}), ("plain", plain_kernels())):
            reset_launches()
            with swapped(swap):
                toks[dt, path] = make_generate_fn(m, DECODE_STEPS)(params, tokens, lengths,
                                                                   **extra)
            if path == "kernel":
                got = read_launches()
                require(got == want, f"default-length generate launches {got} != {want}")
    same = {dt: (toks[dt, "kernel"] == toks[dt, "plain"]).all(1).tolist()
            for dt in ("bf16", "fp32")}
    print(f"[model] {arch} generate at the default cache length {tokens.shape[1]} "
          f"(row 0 past the last slot for all {DECODE_STEPS} steps): tokens of the kernel "
          f"path equal the plain path's, per row, fp32={same['fp32']} bf16={same['bf16']} "
          f"(bf16 not held); fp32 kernel-path tokens {toks['fp32', 'kernel'].tolist()}")
    require(bool(torch.equal(toks["fp32", "kernel"], toks["fp32", "plain"])),
            "default-length generate: fp32 kernel-path tokens equal the plain path's")


def phase_serving(arch: str):
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import run_server
    from repro_torch.serving.batching import make_policy
    from repro_torch.serving.engine import serving_config
    from repro_torch.serving.workload import WorkloadSpec, generate
    cfg = serving_config(get_config(arch))
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
    want = served_launches(cfg, policy, res, DECODE_STEPS)
    require(launches == want, f"serving launches {launches} != {want}")


def served_launches(cfg, policy, res: dict, decode_steps: int) -> dict:
    """The launches of each kernel in one ``run_server`` call: it warms up
    with one prefill and one decode step at each batch size the policy
    emits, then runs a prefill and decode_steps − 1 steps per batch."""
    n_attn, n_rec, n_rwkv = layer_counts(cfg)
    warm = len({1, getattr(policy, "max_batch", 1), *getattr(policy, "preferred", (1,))})
    batches = round(res["requests"] / res["mean_batch"])
    return {"flash_attention": n_attn * (batches + warm),
            "decode_attention": n_attn * ((decode_steps - 1) * batches + warm),
            "rglru_scan": n_rec * (batches + warm), "wkv6": n_rwkv * (batches + warm),
            "int8_matmul": 0}


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


# ---- phase 18: training ---------------------------------------------------
# K1's backward against the plain version's gradient (autograd through
# ``mha_reference``) computed in float64, per element of dQ, dK and dV:
# |err| ≤ atol + 2^-7·|want|, the forward's form.  2^-7·|want| is one ulp of
# a bf16 output (the kernel rounds its fp32 sums once to the input type).
# atol = BWD_ATOL_SHARE·max|want| of that tensor is the fp32 sums' error
# where an entry cancels: each gradient sums up to G·Sq ≈ 2^15 terms whose
# fp32 rounding, on these random inputs, leaves ~2^-18 of the tensor's
# largest entry (the fp32 plain version, a right fp32 evaluation of the same
# function, is printed against the same limit as a control and must pass
# it: 2^-17.4 at worst on the CPU); 2^-14 keeps a 10x margin, and the planted
# faults move entries by whole ulps.  The softcap shapes draw q at 16x so
# that the scores reach the cap (s/cap ~ 0.3, where the cap's derivative is
# 0.9): at unit scale it is 1 − 4e-4, below one ulp, and dropping it would
# not show.
BWD_ATOL_SHARE = 2.0 ** -14
# The train-step check of phase 18 (b): kernel path against the control
# (the plain path with its attention summed in float64), in the loss, the
# grad norm and each leaf's gradient relative to that leaf's largest entry:
# at most max(TRAIN_FLOOR, TRAIN_DRIFT × the plain fp32 path's distance from
# the control), as MOE_DRIFT sets the MoE limit: bf16 activations round each
# layer, and the kernel's and the plain version's fp32 sums flip different
# roundings, so their distances from the control are of one size.
TRAIN_FLOOR = 2.0 ** -20
TRAIN_DRIFT = 2.0
TRAIN_CHECKS = {"granite-3-2b": dict(layers=4, batch=2, seq=2048),
                "gemma2-2b": dict(layers=2, batch=2, seq=4608)}
TRAIN_SLICE = dict(arch="granite-3-2b", batch=4, seq=2048, steps=3)


def per_head_group(fn, q, k, v, dout, lengths=None, **kw):
    """``fn(q, k, v, dout, **kw)`` → (dq, dk, dv) run one sequence and one
    kv head (its G query heads) at a time, the results put together: the
    float64 plain version's memory at llava-next-34b's 56 heads."""
    import torch
    B, H = q.shape[:2]
    K = k.shape[1]
    G = H // K
    out = [torch.empty(t.shape, dtype=torch.float64, device=t.device) for t in (q, k, v)]
    for b in range(B):
        for h in range(K):
            hs = slice(h * G, (h + 1) * G)
            lens = None if lengths is None else lengths[b:b + 1]
            dq, dk, dv = fn(q[b:b + 1, hs], k[b:b + 1, h:h + 1], v[b:b + 1, h:h + 1],
                            dout[b:b + 1, hs], lengths=lens, **kw)
            out[0][b, hs], out[1][b, h], out[2][b, h] = dq[0], dk[0, 0], dv[0, 0]
    return out


def flash_bwd_want(q, k, v, dout, **kw):
    """K1's backward's plain version in float64, the check of the kernel."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    return per_head_group(lambda *a, **k_: fa.plain_grad(*a, acc=torch.float64, **k_),
                          q, k, v, dout, **kw)


def faulty_grad(fault: str):
    """A planted fault as the gradient of the plain version in float64 with
    that fault in it: ``softcap_derivative_dropped`` (the capped scores in
    the forward, the cap's derivative taken as 1) or
    ``causal_mask_shifted`` (keys up to q + 1 seen)."""
    import torch

    def grad(q, k, v, dout, *, causal, window, softcap, lengths):
        with torch.enable_grad():
            q, k, v = (t.detach().double().requires_grad_() for t in (q, k, v))
            B, H, Sq, d = q.shape
            K, Skv = k.shape[1], k.shape[2]
            s = torch.einsum("bkgsd,bktd->bkgst", q.reshape(B, K, H // K, Sq, d), k) / d ** 0.5
            if softcap > 0:
                capped = softcap * torch.tanh(s / softcap)
                s = s + (capped - s).detach() if fault == "softcap_derivative_dropped" \
                    else capped
            qp, kp = torch.arange(Sq, device=q.device), torch.arange(Skv, device=q.device)
            shift = 1 if fault == "causal_mask_shifted" else 0
            mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
            if causal:
                mask &= kp[None, :] <= qp[:, None] + shift
            if window > 0:
                mask &= kp[None, :] > qp[:, None] - window
            mask = mask.expand(B, Sq, Skv)
            if lengths is not None:
                mask = mask & (kp[None, None, :] < lengths[:, None, None])
            p = torch.softmax(torch.where(mask[:, None, None], s, -1e30), -1)
            out = torch.einsum("bkgst,bktd->bkgsd", p, v).reshape(B, H, Sq, d)
            return torch.autograd.grad(out, (q, k, v), dout.double())
    return grad


def held_grads(got, want):
    """(max |got − want|, worst ratio to BWD_ATOL_SHARE·max|want| +
    RTOL·|want|, the ratio of dq, dk and dv apart)."""
    errs, ratios = [], []
    for g, w in zip(got, want):
        e = (g.double() - w).abs()
        errs.append(float(e.max()))
        ratios.append(float((e / (BWD_ATOL_SHARE * w.abs().max() + RTOL * w.abs())).max()))
    return max(errs), max(ratios), ratios


def sdpa_backward_ms(q, k, v, dout, mask, is_causal):
    """SDPA's backward alone (``torch.autograd.grad`` of its output, graph
    kept), with k and v expanded to the query heads beforehand, on the first
    backend of flash, memory-efficient, cuDNN and math that takes the call
    → (ms, backend)."""
    import warnings
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    G = q.shape[1] // k.shape[1]
    qx, kx, vx = (t.detach().requires_grad_() for t in
                  (q, k.repeat_interleave(G, 1), v.repeat_interleave(G, 1)))
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        try:
            with sdpa_kernel([backend]), warnings.catch_warnings():
                warnings.simplefilter("ignore")   # the backends that refuse say why
                out = F.scaled_dot_product_attention(qx, kx, vx, attn_mask=mask,
                                                     is_causal=is_causal)
                ms = cuda_ms(lambda: torch.autograd.grad(out, (qx, kx, vx), dout,
                                                         retain_graph=True), 5)
            return ms, backend.name
        except RuntimeError:
            continue
    raise RuntimeError("no SDPA backend takes the call")


def flash_bwd_inputs(B: int, H: int, K: int, Sq: int, Skv: int, d: int, *,
                     dtype: str = "bfloat16", causal: bool = True, window: int = 0,
                     softcap: float = 0.0, lengths=None, q_scale: float = 1.0):
    """q, k, v and dout of a K1′ case, from a seed (q scaled by
    ``q_scale``; dout zero on the padding rows past ``lengths``, which carry
    no loss), and the kernel's options."""
    import torch
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(5)
    # the model's layout: (B, S, heads, d), handed over as transposed views
    q, k, v, dout = (torch.randn((B, n, h, d), generator=g, device="cuda")
                     .mul(q_scale if i == 0 else 1.0).to(dt).transpose(1, 2)
                     for i, (n, h) in enumerate(((Sq, H), (Skv, K), (Skv, K), (Sq, H))))
    lens = None
    if lengths is not None:
        lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
        for b, n in enumerate(lengths):
            dout[b, :, n:] = 0
    return q, k, v, dout, dict(causal=causal, window=window, softcap=softcap, lengths=lens)


# Phase 18's K1′ cases: (model, record variant) → [(label, the case's
# shape and options)], one record a model, merged over its cases.
FLASH_BWD_CASES = {
    ("granite-3-2b", "B 4, 32/8 heads of 64, S 2048, causal"): [
        ("granite-3-2b", dict(B=4, H=32, K=8, Sq=2048, Skv=2048, d=64))],
    ("gemma2-2b", "B 2, 8/4 heads of 256, S 4700, softcap 50, q at 16x; window 4096 and "
     "global"): [
        ("gemma2-2b local", dict(B=2, H=8, K=4, Sq=4700, Skv=4700, d=256, window=4096,
                                 softcap=50.0, q_scale=16.0)),
        ("gemma2-2b global", dict(B=2, H=8, K=4, Sq=4700, Skv=4700, d=256, softcap=50.0,
                                  q_scale=16.0))],
    ("recurrentgemma-9b", "B 2, 16/1 heads of 256, S 4096, window 2048"): [
        ("recurrentgemma-9b local", dict(B=2, H=16, K=1, Sq=4096, Skv=4096, d=256,
                                         window=2048))],
    ("whisper-tiny", "encoder, B 4, 6/6 heads of 64, 1500 x 1500, not causal"): [
        ("whisper-tiny encoder", dict(B=4, H=6, K=6, Sq=1500, Skv=1500, d=64, causal=False))],
    ("whisper-tiny", "cross-attention, 432 x 1500"): [
        ("whisper-tiny cross-attention", dict(B=4, H=6, K=6, Sq=432, Skv=1500, d=64,
                                              causal=False))],
    ("llava-next-34b", f"56/8 heads of 128, lengths {LLAVA_LENGTHS}"): [
        ("llava-next-34b", dict(B=4, H=56, K=8, Sq=max(LLAVA_LENGTHS), Skv=max(LLAVA_LENGTHS),
                                d=128, lengths=LLAVA_LENGTHS))],
    ("granite-3-2b 100M", "fp32, B 8, 8/4 heads of 64, S 256"): [
        ("granite-3-2b 100M (fp32)", dict(B=8, H=8, K=4, Sq=256, Skv=256, d=64,
                                          dtype="float32"))],
}
# K1′'s times as first written, three passes of fp32 FMA in both types
# (PERF.md's kernel table, "NVIDIA H100 80GB HBM3, 700.00 W"), printed beside
# this run's
FLASH_BWD_FIRST_MS = {"granite-3-2b": 14.724533081054688, "gemma2-2b local": 64.32095845540364,
                     "gemma2-2b global": 67.88464864095052,
                     "recurrentgemma-9b local": 81.30113220214844,
                     "whisper-tiny encoder": 3.122015953063965,
                     "whisper-tiny cross-attention": 1.1615359783172607,
                     "llava-next-34b": 137.73812866210938,
                     "granite-3-2b 100M (fp32)": 0.27717334032058716}


def flash_bwd_case(label: str, B: int, H: int, K: int, Sq: int, Skv: int, d: int, *,
                   dtype: str = "bfloat16", causal: bool = True, window: int = 0,
                   softcap: float = 0.0, lengths=None, q_scale: float = 1.0):
    """K1's backward at a model's training shapes: dQ, dK and dV against the
    float64 plain version, the fp32 plain version against the same limit
    (the control), the planted faults that apply, and the times, the first
    version's beside."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    dt = getattr(torch, dtype)
    q, k, v, dout, kw = flash_bwd_inputs(B, H, K, Sq, Skv, d, dtype=dtype, causal=causal,
                                         window=window, softcap=softcap, lengths=lengths,
                                         q_scale=q_scale)
    lens = kw["lengths"]
    got = fa.flash_attention_bwd(q, k, v, dout, **kw)
    torch.cuda.synchronize()
    want = flash_bwd_want(q, k, v, dout, **kw)
    err, ratio, parts = held_grads(got, want)
    require(all(bool(torch.isfinite(t).all()) and t.dtype == dt for t in got),
            "flash_attention_bwd outputs finite, in the input dtype")
    require(ratio <= 1.0, f"flash_attention_bwd {label} max|err| {err}, {ratio}x the limit "
            f"(dq, dk, dv {parts})")
    plain32 = per_head_group(fa.plain_grad, q, k, v, dout, **kw)
    control = held_grads(plain32, want)[1]
    require(control <= 1.0, f"the fp32 plain version within the limit at {label} ({control})")
    faults = {}
    G = H // K
    if G > 1:   # dK of the first head of each group only
        one = fa.flash_attention_bwd(q[:, ::G], k, v, dout[:, ::G], **kw)[1]
        faults["dk_without_the_group_sum"] = (got[0], one, got[2])
    if softcap:
        faults["softcap_derivative_dropped"] = per_head_group(
            faulty_grad("softcap_derivative_dropped"), q, k, v, dout, **kw)
    if causal:
        faults["causal_mask_shifted"] = per_head_group(
            faulty_grad("causal_mask_shifted"), q, k, v, dout, **kw)
    fault_ratio = {name: held_grads(out, want)[1] for name, out in faults.items()}
    require(all(r > 4.0 for r in fault_ratio.values()),
            f"flash_attention_bwd check rejects planted faults by far {fault_ratio}")
    del want, plain32, faults
    # work these inputs need: 5 products over the live (query, key) pairs
    qp, kp = torch.arange(Sq, device="cuda"), torch.arange(Skv, device="cuda")
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device="cuda")
    if causal:
        mask &= kp[None, :] <= qp[:, None]
    if window:
        mask &= kp[None, :] > qp[:, None] - window
    mask = mask.expand(B, Sq, Skv)
    if lens is not None:
        mask = mask & (kp[None, None, :] < lens[:, None, None])
    ms_bound, by = bound_of(costs.flash_attention_bwd(
        B, H, K, Sq, Skv, d, dt.itemsize, pairs=int(mask.sum())))
    plain_ms = 0.0
    for b in range(B):   # the fp32 plain version one sequence at a time (memory)
        sl = slice(b, b + 1)
        plain_ms += cuda_ms(lambda: fa.plain_grad(
            q[sl], k[sl], v[sl], dout[sl],
            **dict(kw, lengths=None if lens is None else lens[sl])), 2)
    plain_mask = None if (not window and lens is None) else mask[:, None]
    library_ms, backend = sdpa_backward_ms(q, k, v, dout, plain_mask,
                                           causal and plain_mask is None)
    again = fa.flash_attention_bwd(q, k, v, dout, **kw)
    require(all(torch.equal(a, b) for a, b in zip(got, again)),
            f"flash_attention_bwd {label}: two calls give the same bits")
    del again
    res = dict(max_abs_err=err, limit_ratio=ratio, limit_ratio_dq_dk_dv=parts,
               plain_fp32_limit_ratio=control, fault_ratio=fault_ratio, bitwise_twice=True,
               ms=cuda_ms(lambda: fa.flash_attention_bwd(q, k, v, dout, **kw), 3),
               ms_first_version=FLASH_BWD_FIRST_MS[label],
               plain_ms=plain_ms, library_ms=library_ms,
               library=f"SDPA backward ({backend}{', no softcap' if softcap else ''}"
                       f"{', masked' if plain_mask is not None else ''})",
               bound_ms=ms_bound, bound_by=by)
    print(f"[kernel flash_attention_bwd] {label} B={B} H={H} K={K} d={d} Sq={Sq} "
          f"Skv={Skv} {dtype} causal={causal} window={window} softcap={softcap} "
          f"lengths={lengths} q_scale={q_scale} " + json.dumps(res))
    return res


def train_setup(arch: str, layers: int = 0):
    """Full-width ``arch`` (its first ``layers`` when given) for training:
    fp32 masters, the reference's train config, random weights from seed 0
    through ``launch/train.py``'s init."""
    from repro_torch.launch import train
    from repro_torch.models import build_model
    cfg = train.model_config(arch, layers=layers)
    model = build_model(cfg)
    return cfg, model, train.make_init_state_fn(model)()


def rel(a, b) -> float:
    """max |a − b| / max |b| (|a − b| for scalars, relative)."""
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


def rglru_plain64(a, b, s0):
    """K3's plain version with the recurrence in float64, rounded back to
    the kernel's dtypes: the control's RG-LRU."""
    from repro_torch.kernels.ref import rglru_reference
    seq, last = rglru_reference(a.double(), b.double(), s0.double())
    return seq.to(a.dtype), last.float()


def controls() -> dict:
    """The train-step control's stand-ins in ``ops``: each kernel's plain
    version with its sums in float64."""
    import functools
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import wkv6 as wk
    return {"flash_attention": functools.partial(fa.plain, acc=torch.float64),
            "rglru_scan": rglru_plain64, "wkv6": functools.partial(wk.plain, acc=torch.float64)}


def step_run(grad_fn, params, batch, swap: dict):
    """One gradient step with ``swap``'s functions in ``ops`` → (loss, grad
    norm, {leaf path: gradient})."""
    import torch
    from repro_torch.training.optimizer import global_norm
    from repro_torch.training.tree import flatten
    with swapped(swap):
        grads, aux = grad_fn(params, batch)
        torch.cuda.synchronize()
    run = (aux["ce"], global_norm(grads), dict(flatten(grads)))
    del grads
    return run


def step_distances(run, ctl) -> dict:
    """A step's distance from the control in the loss, the grad norm and each
    leaf (``rel``: relative to the control's largest entry)."""
    out = {"loss": rel(run[0], ctl[0]), "grad_norm": rel(run[1], ctl[1])}
    out.update({"/".join(p): rel(run[2][p], ctl[2][p]) for p in ctl[2]})
    return out


def kernel_step(arch: str, grad_fn, params, batch, used: dict, swap=None):
    """One step through the kernels: each of ``used`` launched forward and
    backward once a layer, and no plain version called (that would be a
    fallback)."""
    mods = {k: counters()[k] for k in used}
    plains = {k: mod.plain for k, mod in mods.items()}
    plain_calls = []

    def counting(fn):
        def call(*args, **kw):
            plain_calls.append(fn)
            return fn(*args, **kw)
        return call
    reset_launches()
    for k, mod in mods.items():
        mod.plain = counting(plains[k])
    try:
        run = step_run(grad_fn, params, batch, swap or {})
    finally:
        for k, mod in mods.items():
            mod.plain = plains[k]
    launched, want = train_launches_read(used), {k: (n, n) for k, n in used.items()}
    require(launched == want and not plain_calls,
            f"{arch} train step: launches (forward, backward) {launched}, want "
            f"{want}, and no plain call ({len(plain_calls)})")
    return run


def plain_step(arch: str, name: str, grad_fn, params, batch, used: dict, swap: dict):
    """One step with every kernel of ``used`` swapped out: it launches none."""
    reset_launches()
    run = step_run(grad_fn, params, batch, swap)
    launched = train_launches_read(used)
    require(all(n == (0, 0) for n in launched.values()),
            f"{arch} {name} train step launched no kernel ({launched})")
    return run


def held_step(arch: str, kernel: dict, plain: dict, what: str) -> float:
    """Each of ``kernel``'s distances within max(TRAIN_FLOOR, TRAIN_DRIFT x
    ``plain``'s) → the worst ratio; prints the comparison."""
    report = {k: dict(kernel=kernel[k], plain=plain[k],
                      ratio=kernel[k] / max(TRAIN_FLOOR, TRAIN_DRIFT * plain[k]))
              for k in plain}
    worst = max(r["ratio"] for r in report.values())
    print(f"[train] {arch}: {what}: worst ratio to max({TRAIN_FLOOR}, {TRAIN_DRIFT} x "
          f"plain) {worst}; " + json.dumps(report))
    over = {k: r for k, r in report.items() if r["ratio"] > 1.0}
    require(not over, f"{arch} train step, {what}: the kernel path beyond max("
            f"{TRAIN_FLOOR}, {TRAIN_DRIFT} x the plain path's distance from the control) "
            f"in {over}")
    return worst


def train_check(arch: str, run: dict):
    """Phases 18 (b) and 19 (b): one train step's loss, grad norm and
    gradients through the kernels, through the plain path and through the
    control (the plain path with attention and the recurrences in float64),
    on the same weights and batch: the kernel path within max(TRAIN_FLOOR,
    TRAIN_DRIFT × the plain path's distance from the control), launches
    exact, no plain call."""
    import torch
    from repro_torch.training.data import DataConfig, host_batch
    from repro_torch.training.step import make_grad_fn
    cfg, model, state = train_setup(arch, run["layers"])
    params = state["params"]
    del state
    batch = host_batch(DataConfig(global_batch=run["batch"], seq_len=run["seq"]), cfg, 0)
    grad_fn = make_grad_fn(model, remat=False)
    used = train_kernels(cfg)
    kern = kernel_step(arch, grad_fn, params, batch, used)
    plain = plain_step(arch, "plain", grad_fn, params, batch, used,
                       {k: counters()[k].plain for k in used})
    ctl = plain_step(arch, "control", grad_fn, params, batch, used,
                     {k: controls()[k] for k in used})
    require(all(bool(torch.isfinite(t).all()) for t in kern[:2]),
            f"{arch} loss and grad norm finite")
    print(f"[train] {arch} {run['layers']} layers, batch {run['batch']} x {run['seq']}: loss "
          f"{float(kern[0])} (plain {float(plain[0])}, control {float(ctl[0])}), grad norm "
          f"{float(kern[1])}; launches (forward, backward) "
          f"{ {k: (n, n) for k, n in used.items()} }, no plain call")
    return held_step(arch, step_distances(kern, ctl), step_distances(plain, ctl),
                     "one step")


# Phase 19 (b) for rwkv6-7b.  Its step's gradient is ill-conditioned at the
# first token: with a zero state the WKV output there is (r·u·k) v, a head's
# variance across its channels can be ~1e-4 (the group norm's eps is 1e-5),
# and one bf16 ulp of one WKV output value at t = 0 of layer 0 moves bonus_u's
# gradient by tens of percent through layer 1's group norm (printed below).
# So one step's distance from the control is a draw from a heavy-tailed
# distribution: which of its 4096 values at t = 0 a path's fp32 sums round
# the other way decides it.  A single-step check (TRAIN_DRIFT x the
# plain path's distance) then fails for plain fp32 PyTorch as well (PERF.md
# §6).  The check is therefore held over RWKV_BATCHES batches, each
# step's distance against three plain fp32 versions of the WKV: the port's
# sequential one (``wk.plain``), K4's chunked decomposition
# (``ref.wkv6_chunked_reference``) and the reference's training algorithm
# (``reference_wkv``).  For the loss, the grad norm and each leaf the
# median over the batches of the kernel path's distance must be within
# max(TRAIN_FLOOR, TRAIN_DRIFT × the median of the largest plain distance);
# each batch's single-step ratio is printed, not held.  A K4 whose outputs
# carry a relative error of RWKV_FAULT before their bf16 rounding (far
# inside the per-call limit of one bf16 ulp) must fail it.
RWKV_BATCHES = 8
RWKV_FAULT = 2.0 ** -12


def reference_wkv(r, k, v, logw, u, state0, chunk: int = 32):
    """The reference's training WKV (``repro.models.rwkv6.wkv_chunked``) in
    plain PyTorch, fp32: within a chunk every decay an exponential of a
    difference of cumulative sums, the chunk states chained in order (the
    reference combines the same pairs in an associative scan).  S a
    multiple of ``chunk``; out in r's dtype, the final state fp32."""
    import torch
    B, S, H, N = r.shape
    C = S // chunk

    def chunks(x):
        return x.float().reshape(B, C, chunk, H, N).permute(0, 1, 3, 2, 4)
    rc, kc, vc, wc = chunks(r), chunks(k), chunks(v), chunks(logw)
    lc = torch.cumsum(wc, dim=3)                          # inclusive Σ logw
    lc_excl = lc - wc
    decay = torch.exp(lc[:, :, :, -1])                    # the chunks' decays
    inject = torch.einsum("bchsd,bchse->bchde", kc * torch.exp(lc[:, :, :, -1:] - lc), vc)
    state, before = state0.float(), []
    for c in range(C):
        before.append(state)
        state = decay[:, c][..., None] * state + inject[:, c]
    o_inter = torch.einsum("bchtd,bchde->bchte", rc * torch.exp(lc_excl),
                           torch.stack(before, dim=1))
    a = torch.einsum("bchtd,bchsd,bchtsd->bchts", rc, kc,
                     torch.exp(lc_excl[:, :, :, :, None] - lc[:, :, :, None]))
    below = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool, device=r.device), -1)
    a = torch.where(below, a, torch.zeros((), device=r.device))
    bonus = torch.einsum("bchtd,hd,bchtd->bcht", rc, u.float(), kc)
    out = o_inter + a @ vc + bonus[..., None] * vc
    return out.permute(0, 1, 3, 2, 4).reshape(B, S, H, N).to(r.dtype), state


def chunked_wkv(r, k, v, logw, u, state0):
    """K4's chunked decomposition in plain PyTorch fp32, cut into segments as
    the kernel plans the call."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import wkv6 as wk
    B, S, H, _ = r.shape
    return ref.wkv6_chunked_reference(r, k, v, logw, u, state0,
                                      segments=wk.plan_segments(B, H, S)[0])


def imprecise_wkv(rel_err: float, seed: int):
    """K4 and K4′ run on fp32 copies of r, k and v (the same arithmetic), the
    output given a relative error of up to ``rel_err`` (seeded, uniform)
    before its bf16 rounding: the planted precision fault of phase 19 (b)."""
    import torch
    from repro_torch.kernels import wkv6 as wk
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def fn(r, k, v, logw, u, s0):
        out, state = wk.WKV6.apply(r.float(), k.float(), v.float(), logw, u, s0)
        noise = torch.rand(out.shape, generator=gen, device=out.device) * 2 - 1
        return (out * (1 + rel_err * noise)).to(r.dtype), state
    return fn


def bf16_ulp_away(x):
    """x (a bf16 scalar) moved one bf16 ulp away from zero."""
    import torch
    return (x.view(torch.int16) + 1).view(torch.bfloat16)


def first_token_witness(arch, grad_fn, params, batch, used, ctl, ops0, plains) -> None:
    """Phase 19 (b)'s witness of the step's conditioning, on the first batch,
    at layer 0's WKV operands: each path's fp32 output error relative to its
    head's spread (the scale the group norm divides by; the kernel on fp32
    copies of r, k and v, the same arithmetic), how many of its bf16 outputs
    at t = 0 round other than the float64 control's, and the control's step
    with one of those values moved one bf16 ulp away from zero, at positions
    a seeded generator picks."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import wkv6 as wk
    from repro_torch.models.rwkv6 import GROUP_NORM_EPS
    r, k, v, logw, u, s0 = ops0
    want = ref.wkv6_reference(r.double(), k.double(), v.double(), logw, u, s0,
                              acc=torch.float64)[0]
    spread = (want.var(-1, correction=0, keepdim=True) + GROUP_NORM_EPS).sqrt()
    paths = {"kernel": wk.wkv6, **plains}
    errors, flips = {}, {}
    with torch.no_grad():
        for n, fn in paths.items():
            e = (fn(r.float(), k.float(), v.float(), logw, u, s0)[0].double() - want) / spread
            errors[n] = dict(rms=float(e.pow(2).mean().sqrt()), max=float(e.abs().max()))
            got = fn(r, k, v, logw, u, s0)[0]
            flips[n] = int((got[:, 0] != want[:, 0].to(got.dtype)).sum())
    gen = torch.Generator().manual_seed(1)
    H, N = r.shape[2], r.shape[3]
    moved = {}
    for _ in range(3):
        h, d = (int(torch.randint(n, (1,), generator=gen)) for n in (H, N))
        layer = [0]

        def bumped(*args, h=h, d=d):
            out, state = controls()["wkv6"](*args)
            if layer[0] == 0:
                o = out.detach().clone()
                o[0, 0, h, d] = bf16_ulp_away(o[0, 0, h, d])
                out = out + (o - out.detach())
            layer[0] += 1
            return out, state
        dist = step_distances(plain_step(arch, "control + 1 ulp", grad_fn, params, batch,
                                         used, {"wkv6": bumped}), ctl)
        moved[f"h {h}, d {d}"] = {key: dist[key] for key in
                                  ("loss", "grad_norm", "layers/tm_cm/bonus_u", "embed")}
    print(f"[train] {arch} batch 0, layer 0's WKV: fp32 output error / the head's spread "
          f"{json.dumps(errors)}; bf16 outputs at t = 0 rounded other than the control's, "
          f"of {r.shape[0] * H * N}: {flips}; the control with one of them one bf16 ulp "
          f"away from zero, distances: {json.dumps(moved)}")


def train_check_batches(arch: str, run: dict) -> float:
    """Phase 19 (b) for rwkv6-7b: the train-step check over RWKV_BATCHES
    batches (see above) → the kernel path's worst ratio."""
    import statistics
    import torch
    from repro_torch.kernels import wkv6 as wk
    from repro_torch.training.data import DataConfig, host_batch
    from repro_torch.training.step import make_grad_fn
    cfg, model, state = train_setup(arch, run["layers"])
    params = state["params"]
    del state
    grad_fn = make_grad_fn(model, remat=False)
    used = train_kernels(cfg)
    plains = {"sequential": wk.plain, "chunked": chunked_wkv, "reference": reference_wkv}
    kern, worst_plain, fault, ratios = [], [], [], []
    for b in range(run["batches"]):
        batch = host_batch(DataConfig(global_batch=run["batch"], seq_len=run["seq"]), cfg, b)
        ops0 = []

        def control(*args):
            if not ops0:
                ops0.extend(t.detach().clone() for t in args)
            return controls()["wkv6"](*args)
        ctl = plain_step(arch, "control", grad_fn, params, batch, used, {"wkv6": control})
        k_run = kernel_step(arch, grad_fn, params, batch, used)
        require(all(bool(torch.isfinite(t).all()) for t in k_run[:2]),
                f"{arch} loss and grad norm finite")
        kern.append(step_distances(k_run, ctl))
        del k_run
        wit = {n: step_distances(plain_step(arch, n, grad_fn, params, batch, used,
                                            {"wkv6": fn}), ctl) for n, fn in plains.items()}
        worst_plain.append({key: max(w[key] for w in wit.values()) for key in kern[-1]})
        fault.append(step_distances(step_run(grad_fn, params, batch, {
            "wkv6": imprecise_wkv(RWKV_FAULT, b)}), ctl))
        single = {n: max(d[key] / max(TRAIN_FLOOR, TRAIN_DRIFT * wit["sequential"][key])
                         for key in d)
                  for n, d in (("kernel", kern[-1]), *wit.items(), ("fault", fault[-1]))}
        ratios.append(single)
        print(f"[train] {arch} batch {b}: loss {float(ctl[0])}; single-step worst ratio to "
              f"max({TRAIN_FLOOR}, {TRAIN_DRIFT} x the sequential plain distance), not held: "
              f"{json.dumps(single)}; bonus_u distances kernel "
              f"{kern[-1]['layers/tm_cm/bonus_u']}, "
              + ", ".join(f"{n} {w['layers/tm_cm/bonus_u']}" for n, w in wit.items()))
        if b == 0:
            first_token_witness(arch, grad_fn, params, batch, used, ctl, ops0, plains)
        del ctl, ops0
        torch.cuda.empty_cache()
    over = {n: sum(r[n] > 1.0 for r in ratios) for n in ratios[0]}
    print(f"[train] {arch}: batches over 1 in the single-step check, of {len(ratios)}: "
          f"{over}")

    def median(runs):
        return {key: statistics.median(r[key] for r in runs) for key in runs[0]}
    yard = median(worst_plain)
    worst_fault = max(median(fault)[key] / max(TRAIN_FLOOR, TRAIN_DRIFT * yard[key])
                      for key in yard)
    print(f"[train] {arch}: planted fault (K4's output {RWKV_FAULT} off before its bf16 "
          f"rounding): median worst ratio {worst_fault}")
    require(worst_fault > 1.0, f"{arch}: the planted precision fault fails the check "
            f"({worst_fault})")
    return held_step(arch, median(kern), yard, f"medians over {len(kern)} batches, "
                     "against the largest of three plain fp32 versions' distances")


def train_slice(arch: str, layers: int = 0, batch: int = 4, seq: int = 2048, steps: int = 3):
    """Phases 18 (c) and 19 (c): ``arch`` at full width (its first
    ``layers`` when given, else full depth), ``steps`` steps through
    ``launch/train.py``'s config, init and step pieces (the gradient, then
    the update, apart so that each one's peak shows), with remat."""
    import torch
    from repro_torch.launch import train
    from repro_torch.models.registry import count_params, param_shapes
    from repro_torch.training.data import DataConfig, host_batch
    from repro_torch.training.optimizer import OptimizerConfig, adamw_update
    from repro_torch.training.step import make_grad_fn
    from repro_torch.training.tree import flatten
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg, model, state = train_setup(arch, layers)
    torch.cuda.synchronize()
    init_s, init_gb = time.perf_counter() - t0, torch.cuda.max_memory_allocated() / 1e9
    n = count_params(param_shapes(model))
    full = train.model_config(arch)
    require(cfg.d_model == full.d_model and cfg.num_layers == (layers or full.num_layers)
            and cfg.param_dtype == "float32",
            f"{arch} at full width ({cfg.d_model}), {cfg.num_layers} layers, fp32 masters")
    used = train_kernels(cfg)
    params, opt = state["params"], state["opt"]
    first = {p: t[(0,) * (t.dim() - 1)].clone() for p, t in flatten(params)}
    opt_cfg = OptimizerConfig(learning_rate=3e-4, warmup_steps=max(steps // 10, 1),
                              total_steps=steps)
    data = DataConfig(global_batch=batch, seq_len=seq)
    grad_fn = make_grad_fn(model, remat=True)
    times, peaks, metrics = [], [], []
    # the main path: counts at 0 just before, read just after
    reset_launches()
    for step in range(steps):
        batch_ = host_batch(data, cfg, step)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        grads, aux = grad_fn(params, batch_)
        torch.cuda.synchronize()
        t2, step_gb = time.perf_counter(), torch.cuda.max_memory_allocated() / 1e9
        torch.cuda.reset_peak_memory_stats()
        params, opt, m = adamw_update(opt_cfg, grads, opt, params)
        torch.cuda.synchronize()
        t3, update_gb = time.perf_counter(), torch.cuda.max_memory_allocated() / 1e9
        del grads
        times.append((t2 - t1, t3 - t2))
        peaks.append((step_gb, update_gb))
        metrics.append((float(aux["ce"]), float(m["grad_norm"])))
    launched = train_launches_read(used)
    launches = {**{k: f for k, (f, _) in launched.items()},
                **{k + "_bwd": b for k, (_, b) in launched.items()}}
    moved = sum(not torch.equal(t[(0,) * (t.dim() - 1)], first[p]) for p, t in flatten(params))
    require(all(np.isfinite(x) for m_ in metrics for x in m_),
            f"{arch} loss and grad norm finite {metrics}")
    require(moved == len(first), f"{arch}: {moved} of {len(first)} leaves moved")
    want = {k: (2 * n_ * steps, n_ * steps) for k, n_ in used.items()}
    require(launched == want, f"{arch} launches {launched}: each kernel twice a layer a step "
            f"(remat), its backward once ({want})")
    print(f"[train] {arch} full width, {cfg.num_layers} layers ({n} parameters, fp32 "
          f"masters), batch {data.global_batch} x {data.seq_len}, remat: init {init_s:.3f} s, "
          f"peak {init_gb:.2f} GB; per step (gradient s, update s) {times}, peaks (GB) "
          f"{peaks}; (loss, grad norm) {metrics}; launches {launches}; {moved} of "
          f"{len(first)} leaves moved")
    return launches, times


def train_learns(tmp: str, arch: str = "granite-3-2b", restart: bool = True):
    """Phases 18 (d) and 19 (d): ``launch/train.py``'s main on ``arch``'s
    ~100M config with examples_torch/train_100m.py's other flags, the loss's
    last tenth at least 1 nat below its first; then (``restart``) 50 steps
    killed at step 30 and restored from the step-20 checkpoint give the
    parameters and optimizer state of 50 steps without a failure."""
    import contextlib
    import io
    import torch
    from repro_torch.launch import train
    from repro_torch.models import build_model
    from repro_torch.training import checkpoint as ckpt
    from repro_torch.training.data import DataConfig
    from repro_torch.training.ft import RunnerConfig, TrainingRunner
    from repro_torch.training.optimizer import OptimizerConfig
    from repro_torch.training.tree import flatten
    cfg = train.model_config(arch, reduce=True)
    used = train_kernels(cfg)
    flags = example("train_100m").arguments(
        ["--arch", arch, "--ckpt-dir", f"{tmp}/{arch}-100m", "--device", "cuda"])
    steps = int(flags[flags.index("--steps") + 1])
    out = io.StringIO()
    reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        train.main(flags)
    learn_s = time.perf_counter() - t0
    lines = out.getvalue().splitlines()
    for line in lines:
        print(f"[train] 100M {line}")
    first, last = map(float, re.search(r"first10=(\S+) last10=(\S+)", lines[-1]).groups())
    launched = train_launches_read(used)
    require(last <= first - 1.0, f"the {arch} 100M run learns: last tenth {last}, first {first}")
    want = {k: (2 * n * steps, n * steps) for k, n in used.items()}
    require(launched == want, f"{arch} 100M launches {launched}, want {want}")
    note = ""
    if restart:
        model = build_model(cfg)
        opt_cfg = OptimizerConfig(learning_rate=3e-3, warmup_steps=5, total_steps=50)
        step_fn = train.make_step_fn(model, opt_cfg, DataConfig(global_batch=8, seq_len=256))
        results = {}
        for name, fail in (("killed", 30), ("whole", None)):
            runner = TrainingRunner(RunnerConfig(ckpt_dir=f"{tmp}/{arch}-{name}", ckpt_every=20,
                                                 max_steps=50, fail_at_step=fail),
                                    step_fn, train.make_init_state_fn(model), device="cuda")
            res = runner.run()
            require(res["final_step"] == 50 and res["restarts"] == (fail is not None),
                    f"{name} run: {res['final_step']} steps, {res['restarts']} restarts")
            results[name] = ckpt.restore(f"{tmp}/{arch}-{name}")[1]
        pairs = list(zip(flatten(results["killed"]), flatten(results["whole"])))
        same = all(pa == pb and torch.equal(a, b) for (pa, a), (pb, b) in pairs)
        require(same, f"{arch}: the restarted run's final state bitwise the uninterrupted run's")
        note = (f"; 50 steps killed at 30 and restored from step 20: final params, m, v and "
                f"step bitwise those of the uninterrupted run ({len(pairs)} leaves)")
    print(f"[train] {arch} 100M: {steps} steps in {learn_s:.1f} s, loss first tenth {first}, last "
          f"tenth {last}; launches (forward, backward) {launched}{note}")
    return launched


def train_launches(kernel: str, arch: str, slice_launches: dict, launches_100m,
                   slices19: dict) -> dict:
    """A phase-18 record's launches and the run they were counted on (K1′ at
    recurrentgemma-9b's shapes: on phase 19's slice)."""
    if kernel in slices19.get(arch, {}):
        return dict(launches=slices19[arch][kernel],
                    launches_on=f"train, {arch} at {TRAIN19_SLICE[arch]} layers x "
                    f"{TRAIN19_STEPS} steps with remat")
    if arch == TRAIN_SLICE["arch"]:
        return dict(launches=slice_launches[kernel],
                    launches_on=f"train, 40 layers x {TRAIN_SLICE['steps']} steps with remat")
    if arch.endswith("100M"):
        return dict(launches=launches_100m["flash_attention"][1],
                    launches_on="train, 4 layers x 200 steps "
                    "(launch/train.py --reduce), with remat")
    if arch in TRAIN_CHECKS:
        n = TRAIN_CHECKS[arch]["layers"]
        return dict(launches=n, launches_on=f"one train step's check, {n} layers, no remat")
    return dict(launches=0, launches_on="none: a check at the model's training shapes "
                "(this script trains no such model on the card)")


def phase_train():
    """Phase 18: K1's backward at each model's training shapes, train-step
    checks of granite-3-2b (4 layers) and gemma2-2b (2 layers), the slice
    (granite-3-2b whole, 3 steps) and the 100M run."""
    import tempfile
    import torch
    t_phase = time.perf_counter()
    records = {("flash_attention_bwd", model, variant):
               merge([flash_bwd_case(label, **case) for label, case in cases])
               for (model, variant), cases in FLASH_BWD_CASES.items()}
    records.update({
        ("flash_attention", "granite-3-2b", "training shape, B 4 x 2048, no lengths"):
            merge([flash_case("granite-3-2b", 32, 8, 0, 0.0, d=64, prompts=(2048,) * 4)])})
    torch.cuda.empty_cache()
    for arch, run in TRAIN_CHECKS.items():
        train_check(arch, run)
        torch.cuda.empty_cache()
    launches, _ = train_slice(TRAIN_SLICE["arch"], batch=TRAIN_SLICE["batch"],
                              seq=TRAIN_SLICE["seq"], steps=TRAIN_SLICE["steps"])
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        launches_100m = train_learns(tmp)
    print(f"[train] phase 18 s={time.perf_counter() - t_phase:.1f}")
    return records, launches, launches_100m


# Phase 19: the hybrid and RWKV6 families train on the card.
#
# K3's backward (rglru_scan_bwd.cu) against the float64 gradient, entry by
# entry, with limits from its own arithmetic (u = UNIT; every step rounded
# as written, no fused multiply-add).  Its fp32 states are recomputed as the
# forward computes them, so with A_t the forward recurrence on |a|, |b| and
# |s0| (A_{-1} = |s0|) their error is F_t ≤ |a_t| F_{t-1} + 2u·A_t (a
# product, then a sum, each rounded: F_{-1} = 0).  The reversed scan: with
# M_t = |g_t| + |a_{t+1}| M_{t+1} (M_{S-1} = |g_{S-1}| + |g_last|) bounding
# |ds_t|, the carry round(a·ds) and the sum round(g + carry) give
# E_t ≤ |a_{t+1}| E_{t+1} + u·|a_{t+1}| M_{t+1} + 2u·M_t, which contracts
# with the decays as the state's does.  So db_t is within E_t, da_t =
# round(ds·s_{t-1}) within E_t·A_{t-1} + M_t·F_{t-1} + u·M_t·A_{t-1}, and ds0
# = round(a_0·ds_0) within |a_0| E_0 + u·|a_0| M_0; each limit is 2 x that
# + (bf16 outputs) RTOL·|want| + UNIT·max|want| (``held_bwd``; a floor in
# the output's own scale, not ATOL: a model's gradients are ~1e-4), the
# factor 2 as for K4's forward.
#
# K4's backward (wkv6_bwd.cu, T = 32 steps a chunk, N the head size, C
# chunks in the forward's segments of Lc, ``wk.plan_segments``) likewise,
# after its decomposition (tests/test_torch_wkv6_bwd_chunked.py).  Factors:
# a running product of at most T - 1 factors e^{w} (expf ≤ 2 ulp = 4u, each
# product rounded) is within 5Tu in any order; a sum of n products on the
# CUDA cores within (n + 1)u of the sum of their absolute values.  A
# contraction on the tensor cores (mma.sync tf32) adds what the FMA
# derivation lacks, 60u of its absolute sum: 12u of the tf32 split (the
# dropped small·small product and what each small part's own rounding
# leaves, 4u each; 4u where one operand is exact in tf32) and 48u of the
# tensor core's own sums, which truncate (≤ 2u each) over the ≤ 24 products
# of a k8 step in three passes; the k8 steps are then added in IEEE fp32,
# within the (n + 1)u above.  The carried matrices: the states S_c (errors
# E_c, absolute recurrence A_c, A_0 = |s0|) and the gradients Go_c of the
# chunks' ends (errors F_c, absolute recurrence Ga_c from |dS|) are each
# updated as M' = round(D·M + increment), the increment a contraction of
# the decayed rows: with I_c the chunk's absolute increment,
# E' ≤ D·E + (|x| + T + 6)u·D·A + (6T + 62)u·I (x = Σ w of the chunk, its
# decay D = e^x a double sum rounded once, then expf), and F likewise from
# the other end; at a segment boundary the chains of segments add
# (|X| + 5)u·d·A (X = Σ w of the segment, d = e^X, A the absolute state
# entering it; Ga leaving it for F), as for K4's forward.  Each output is
# then within γ·(its value on absolute inputs, ``wk.plain_grad`` on |r|,
# |k|, |v|, |u|, |s0|, |do|, |dS|) plus what the carried errors reach it
# through:
# - dr: γ = (N + 6T + 126)u (two contractions deep: P, then P against the
#   decayed k), + pd ⊙ (E_c |do|); dk: γ likewise, + sd ⊙ (F_c |v|); dv: γ
#   likewise, + F_cᵀ (|k| ⊙ sd);
# - dlogw: γ = (N + 7T + 130)u times W_t, the absolute value of every term of
#   the reverse-cumsum identity (D·rowsum(Ga⊙A) + Σ_{s<t} |k| sd (Ga|v|) +
#   Σ_{τ>t} |r|·|dr′| + Σ_{s≥t} |k|·|dk′ intra|, which cancel to leave
#   dlogw), + what E_c and F_c reach through it (summed over the chunk);
# - du: γ = (N + T + B·C + 64)u (P, a chunk's sum, then B·C chunks' in
#   order); dstate0: the carried error F at the sequence's start.
# Each limit is 2 x that + (bf16 outputs) RTOL·|want| + UNIT·max|want|, as
# above.
# ``wk.plain_grad`` in float64 (the explicit sequential formulas) is the
# want at the full shape; it is itself held to float64 autograd through the
# plain forward on a slice (the autograd graph of the whole would take tens
# of GB), and K3's to autograd at the full shape.
BWD_CASE = dict(B=4, S=2048)          # the training shape of both families
RG_WIDTH = 4096                       # recurrentgemma-9b's RG-LRU width
TRAIN19_CHECKS = {"recurrentgemma-9b": dict(layers=3, batch=2, seq=2048),
                  "rwkv6-7b": dict(layers=2, batch=1, seq=1024, batches=RWKV_BATCHES)}
TRAIN19_SLICE = {"recurrentgemma-9b": 6, "rwkv6-7b": 8}   # layers at full width
TRAIN19_STEPS = 3
TRAIN19_RESTART = "rwkv6-7b"           # the 100M run killed and restored
BWD_FAULT_FACTOR = 10.0               # a planted fault fails by this much at least
# phase 19 (a)'s K4′ cases: label → (B, S, H, N, dtype of r/k/v/do)
WKV_BWD_SHAPES = {"rwkv6-7b": (4, 2048, 64, 64, "bfloat16"),
                  "N 32": (4, 2048, 128, 32, "bfloat16"),
                  "partial chunk": (4, 300, 64, 64, "bfloat16"),
                  "100M": (8, 256, 32, 16, "float32")}


def rglru_bwd_limits(a, b, s0, g, g_last):
    """K3′'s limits on (da, db, ds0), entry by entry (see above)."""
    import torch
    a, b, s0, g, g_last = (t.double().abs() for t in (a, b, s0, g, g_last))
    S, u = a.shape[1], UNIT
    A, F = [s0], [torch.zeros_like(s0)]
    for t in range(S):
        A.append(a[:, t] * A[-1] + b[:, t])
        F.append(a[:, t] * F[-1] + 2 * u * A[-1])
    M, E = [None] * S, [None] * S
    m, e = g_last, torch.zeros_like(s0)          # |a_{t+1}| M_{t+1}, and its error
    for t in reversed(range(S)):
        M[t] = g[:, t] + m
        E[t] = e + 2 * u * M[t]
        m, e = a[:, t] * M[t], a[:, t] * E[t] + u * a[:, t] * M[t]
    if not S:
        return torch.zeros_like(a), torch.zeros_like(b), 0 * s0
    M, E, Ap, Fp = (torch.stack(x, dim=1) for x in (M, E, A[:-1], F[:-1]))
    return 2 * (E * Ap + M * Fp + u * M * Ap), 2 * E, 2 * e


def held_bwd(got, want, limits):
    """(max |got − want|, worst ratio to the derived limit + RTOL·|want|
    for bf16 outputs + UNIT·max|want| (a floor in the output's own scale:
    gradients in a model are ~1e-4, where ATOL would hide everything), each
    output's ratio)."""
    import torch
    errs, ratios = [], []
    for x, w, lim in zip(got, want, limits):
        e = (x.double() - w).abs()
        if not e.numel():
            errs.append(0.0)
            ratios.append(0.0)
            continue
        rtol = RTOL if x.dtype == torch.bfloat16 else 0.0
        floor = UNIT * float(w.abs().max()) + 1e-300
        errs.append(float(e.max()))
        ratios.append(float((e / (lim + rtol * w.abs() + floor)).max()))
    return max(errs), max(ratios), ratios


def rglru_bwd_inputs(dtype: str, B: int = BWD_CASE["B"], S: int = BWD_CASE["S"],
                     R: int = RG_WIDTH):
    """K3′'s operands (a, b, s0, g, g_last) on the card from a seed: a in
    [0.5, 0.999), b and g normal, a, b and g in ``dtype``."""
    import torch
    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(5)
    a = (0.5 + 0.499 * torch.rand((B, S, R), generator=gen, device="cuda")).to(dt)
    b = (0.1 * torch.randn((B, S, R), generator=gen, device="cuda")).to(dt)
    s0 = torch.randn((B, R), generator=gen, device="cuda")
    g = torch.randn((B, S, R), generator=gen, device="cuda").to(dt)
    g_last = torch.randn((B, R), generator=gen, device="cuda")
    return a, b, s0, g, g_last


def rglru_bwd_case(dtype: str):
    """Phase 19 (a): K3′ at recurrentgemma-9b's training shape, a/b/g in
    ``dtype`` (the model sends fp32; bf16 is the calibration's dtype), held
    to float64 autograd through the plain forward; the fp32 plain version
    against the same limits as a control; faults: g_last dropped, s_{t-1}
    shifted by one."""
    import torch
    from repro_torch.kernels import rglru_scan as rg
    from repro_torch.kernels.ref import rglru_reference
    B, S, R = BWD_CASE["B"], BWD_CASE["S"], RG_WIDTH
    dt = getattr(torch, dtype)
    args = rglru_bwd_inputs(dtype)
    a, b, s0, gs, g_last = args
    got = rg.rglru_scan_bwd(*args)
    plan = rg.last_bwd_plan
    torch.cuda.synchronize()
    require([x.dtype for x in got] == [dt, dt, torch.float32], "rglru_scan_bwd dtypes")
    require(plan.variant == "ring", f"rglru_scan_bwd {dtype} at the training shape runs the ring")
    # the ring and the register kernel (PR 23's) walk the same rounded steps
    register = rg.rglru_scan_bwd(*args, use=rg.REGISTER)
    require(all(torch.equal(x, y) for x, y in zip(got, register)),
            f"rglru_scan_bwd {dtype}: the ring {plan} bitwise equal to the register kernel")
    # and the plain version's fp32 walk, rounded to a's type
    plain32 = [x.to(y.dtype) for x, y in zip(rg.plain_grad(*args), got)]
    require(all(torch.equal(x, y) for x, y in zip(got, plain32)),
            f"rglru_scan_bwd {dtype} bitwise equal to its plain version's fp32 walk")
    with torch.enable_grad():
        xs = [t.double().requires_grad_() for t in (a, b, s0)]
        seq, last = rglru_reference(*xs)
        want = torch.autograd.grad((seq * gs.double()).sum() + (last * g_last.double()).sum(),
                                   xs)
    states = seq.detach()
    del seq, last, xs
    formulas = max(rel(x, w) for x, w in zip(rg.plain_grad(*args, acc=torch.float64), want))
    require(formulas <= 1e-12, f"K3's plain backward against float64 autograd {formulas}")
    limits = rglru_bwd_limits(*args)
    err, ratio, ratios = held_bwd(got, want, limits)
    require(all(bool(torch.isfinite(x).all()) for x in got), "rglru_scan_bwd finite")
    require(ratio <= 1.0, f"rglru_scan_bwd {dtype} max|err| {err}, ratios {ratios}")
    control = [x.to(y.dtype) for x, y in zip(rg.plain_grad(*args), got)]
    control_ratio = held_bwd(control, want, limits)[1]
    require(control_ratio <= 1.0, f"rglru_scan_bwd's fp32 plain control {control_ratio}")
    shifted = (got[1].double() * states, got[1], got[2])   # da_t = ds_t·s_t
    faults = {"g_last_dropped": held_bwd(rg.rglru_scan_bwd(a, b, s0, gs), want, limits)[1],
              "state_shifted_by_one": held_bwd(shifted, want, limits)[1]}
    require(all(f >= BWD_FAULT_FACTOR for f in faults.values()),
            f"rglru_scan_bwd check rejects planted faults by {BWD_FAULT_FACTOR}x: {faults}")
    ms_bound, by = bound_of(costs.rglru_scan_bwd(B, S, R, a.element_size()))
    res = dict(max_abs_err=err, limit_ratio=ratio, ratios=ratios, control_ratio=control_ratio,
               fault_ratio=faults, formulas_vs_autograd=formulas, plan=plan._asdict(),
               ms=cuda_ms(lambda: rg.rglru_scan_bwd(*args), 20),
               register_ms=cuda_ms(lambda: rg.rglru_scan_bwd(*args, use=rg.REGISTER), 20),
               plain_ms=cuda_ms(lambda: rg.plain_grad(*args), 2),
               library_ms=None,   # no single PyTorch call computes the reversed scan
               bound_ms=ms_bound, bound_by=by)
    print(f"[kernel rglru_scan_bwd] recurrentgemma-9b {dtype} B={B} S={S} R={R} "
          + json.dumps(res))
    return res


def wkv_bwd_limits(r, k, v, logw, u, s0, do, ds):
    """K4′'s limits on (dr, dk, dv, dlogw, du, dstate0), entry by entry
    (see above)."""
    import torch
    from repro_torch.kernels import wkv6 as wk
    B, S, H, N = r.shape
    T, unit = wk.CHUNK, UNIT
    C = -(-S // T)

    def chunked(x):  # (B, S, H, N) → (C, B, H, T, N) in float64, zeros past S
        x = torch.nn.functional.pad(x.double(), (0, 0, 0, 0, 0, C * T - S))
        return x.reshape(B, C, T, H, N).permute(1, 0, 3, 2, 4)

    def unchunk(x):
        return x.permute(1, 0, 3, 2, 4).reshape(B, C * T, H, N)[:, :S]

    def rcum(x):     # Σ_{τ≥t} along the chunk
        return x.flip(3).cumsum(3).flip(3)
    ra, ka, va, oa = (chunked(x.abs()) for x in (r, k, v, do))
    lw = chunked(logw)
    e = torch.exp(lw)
    ones = torch.ones_like(e[:, :, :, :1])
    pd = torch.cat([ones, e[:, :, :, :-1]], dim=3).cumprod(dim=3)
    sd = torch.cat([e[:, :, :, 1:], ones], dim=3).flip(3).cumprod(dim=3).flip(3)
    x = lw.sum(dim=3)
    D = torch.exp(x)[..., None]
    kd, rd = ka * sd, ra * pd
    grow, g_inc = (x.abs()[..., None] + T + 6) * unit * D, (6 * T + 62) * unit
    Lc = wk.plan_segments(B, H, S)[1]

    def seg_step(p):  # (|X| + 5)u·d of segment p, a column of rows d
        X = x[p * Lc:(p + 1) * Lc].sum(dim=0)[..., None]
        return (X.abs() + 5) * unit * torch.exp(X)
    A, E = [s0.double().abs()], [torch.zeros_like(s0, dtype=torch.float64)]
    for c in range(C - 1):
        inc = torch.einsum("bhtd,bhte->bhde", kd[c], va[c])
        E.append(D[c] * E[c] + grow[c] * A[c] + g_inc * inc)
        A.append(D[c] * A[c] + inc)
        if (c + 1) % Lc == 0:   # chunk c + 1 starts a segment: the segments' chain
            p = (c + 1) // Lc - 1
            E[-1] = E[-1] + seg_step(p) * A[p * Lc]
    Go, F = [None] * C, [None] * C
    go, f = ds.double().abs(), torch.zeros_like(A[0])
    for c in reversed(range(C)):
        Go[c], F[c] = go, f
        inc = torch.einsum("bhtd,bhte->bhde", rd[c], oa[c])
        f = D[c] * f + grow[c] * go + g_inc * inc
        go = D[c] * go + inc
        if c and c % Lc == 0:   # chunk c starts segment c / Lc: the chain leaving it
            f = f + seg_step(c // Lc) * Go[min(c + Lc, C) - 1]
    A, E, Go, F = (torch.stack(m) for m in (A, E, Go, F))
    mag = wk.plain_grad(r.abs(), k.abs(), v.abs(), logw, u.abs(), s0.abs(), do.abs(),
                        ds.abs(), acc=torch.float64)
    Mdr, Mdk, Mdv = (chunked(m) for m in mag[:3])
    ptt = (va * oa).sum(-1, keepdim=True)
    ua = u.double().abs()[None, None, :, None, :]
    gv = torch.einsum("cbhde,cbhte->cbhtd", Go, va)
    se = torch.einsum("cbhde,cbhte->cbhtd", E, oa)
    fv = torch.einsum("cbhde,cbhte->cbhtd", F, va)
    g_rkv = (N + 6 * T + 126) * unit
    ks = kd * gv
    rr = ra * (Mdr - ua * ka * ptt).clamp(min=0)
    ki = ka * (Mdk - sd * gv - ua * ra * ptt).clamp(min=0)
    W = ((D[..., 0] * (Go * A).sum(-1))[:, :, :, None] + (ks.cumsum(3) - ks)
         + (rcum(rr) - rr) + rcum(ki))
    carried_w = ((rd * se).sum(3) + D[..., 0] * ((Go * E).sum(-1) + (F * A).sum(-1))
                 + 2 * (kd * fv).sum(3))[:, :, :, None]
    return (2 * unchunk(g_rkv * Mdr + pd * se),
            2 * unchunk(g_rkv * Mdk + sd * fv),
            2 * unchunk(g_rkv * Mdv + torch.einsum("cbhtd,cbhde->cbhte", kd, F)),
            2 * unchunk((N + 7 * T + 130) * unit * W + carried_w),
            2 * (N + T + B * C + 64) * unit * mag[4],
            2 * f)


def wkv6_bwd_faults(args, want):
    """K4′'s planted faults, each the float64 gradient with the fault in
    it, composed of ``wk.plain_grad`` calls: the gradient not carried across
    the boundary into the middle chunk (the steps before it computed as if
    the sequence ended there); the u term dropped from dk; and in the middle
    chunk dlogw without its state term (that chunk run from a zero state,
    with the true gradient of the state it leaves)."""
    import torch
    from repro_torch.kernels import wkv6 as wk
    r, k, v, logw, u, s0, do, ds = args
    S = r.shape[1]
    b0 = wk.CHUNK * (-(-S // wk.CHUNK) // 2)
    b1 = min(b0 + wk.CHUNK, S)
    f64 = torch.float64

    def part(lo, hi, state, dstate):
        return wk.plain_grad(*(t[:, lo:hi] for t in (r, k, v, logw)), u, state,
                             do[:, lo:hi], dstate, acc=f64)

    def state_at(t):
        return wk.plain(*(x[:, :t] for x in (r, k, v, logw)), u, s0, acc=f64)[1]
    head, tail = part(0, b0, s0, None), part(b0, S, state_at(b0), ds)
    carry = tuple(torch.cat([x, y], dim=1) for x, y in zip(head[:4], tail[:4])) + (
        head[4] + tail[4], head[5])
    vdo = (v.double() * do.double()).sum(-1, keepdim=True)
    no_u = (want[0], want[1] - r.double() * u.double() * vdo) + tuple(want[2:])
    leaving = part(b1, S, state_at(b1), ds)[5]          # the gradient of the state at b1
    alone = part(b0, b1, torch.zeros_like(s0), leaving)[3]
    no_state = want[:3] + (torch.cat([want[3][:, :b0], alone, want[3][:, b1:]], dim=1),) \
        + tuple(want[4:])
    return {"carry_dropped_at_a_chunk_boundary": carry, "u_dropped_from_dk": no_u,
            "dlogw_without_its_state_term": no_state}


def wkv6_bwd_inputs(B: int, S: int, H: int, N: int, dtype: str = "bfloat16"):
    """K4′'s operands (r, k, v, logw, u, s0, do, dS) on the card from a
    seed: r, k, v and do in ``dtype``, logw = −exp(·), u, state0 and the
    final state's gradient nonzero."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(6)
    dt = getattr(torch, dtype)

    def normal(shape, scale=1.0):
        return scale * torch.randn(shape, generator=gen, device="cuda")
    shape = (B, S, H, N)
    r, k = normal(shape, 0.5).to(dt), normal(shape, 0.5).to(dt)
    v, logw = normal(shape).to(dt), -torch.exp(normal(shape))
    u, s0 = normal((H, N), 0.1), normal((B, H, N, N), 0.1)
    do, ds = normal(shape).to(dt), normal((B, H, N, N))
    return r, k, v, logw, u, s0, do, ds


def wkv6_bwd_case(label: str, B: int, S: int, H: int, N: int, dtype: str = "bfloat16"):
    """Phase 19 (a): K4′ at B x S, H heads of N, r/k/v/do in ``dtype``,
    logw = −exp(·), u, state0 and the final state's gradient nonzero, held
    to the float64 sequential formulas (themselves held to float64 autograd
    on batch 0's first heads) within ``wkv_bwd_limits``; the fp32 plain
    version as a control; the three planted faults.  A head size outside
    ``wk.HEAD_SIZES`` runs padded (``wk.pad_heads``): K4 is then held too,
    within ``wkv_atol``."""
    import torch
    from repro_torch.kernels import wkv6 as wk
    dt = getattr(torch, dtype)
    args = wkv6_bwd_inputs(B, S, H, N, dtype)
    r, k, v, logw, u, s0, do, ds = args
    got = wk.wkv6_bwd(*args)
    torch.cuda.synchronize()
    require([x.dtype for x in got] == [dt] * 3 + [torch.float32] * 3, "wkv6_bwd dtypes")
    forward_ratio = None
    if N not in wk.HEAD_SIZES:
        forward_ratio = held_wkv(wk.wkv6(*args[:6]), wkv_want(*args[:6]), wkv_atol(*args[:6]))[1]
        require(forward_ratio <= 1.0, f"wkv6 {label}, heads of {N} padded: {forward_ratio}")
    want = wk.plain_grad(*args, acc=torch.float64)
    hs = min(H, 8)     # float64 autograd on batch 0's first heads
    sl = [t[:1, :, :hs] for t in (r, k, v, logw)] + [u[:hs], s0[:1, :hs]]
    with torch.enable_grad():
        xs = [t.double().requires_grad_() for t in sl]
        out, st = wk.plain(*xs, acc=torch.float64)
        auto = torch.autograd.grad((out * do[:1, :, :hs].double()).sum()
                                   + (st * ds[:1, :hs]).sum(), xs)
    del out, st, xs
    formulas = max(rel(x, w) for x, w in zip(
        wk.plain_grad(*sl, do[:1, :, :hs], ds[:1, :hs], acc=torch.float64), auto))
    require(formulas <= 1e-10, f"K4's plain backward against float64 autograd {formulas}")
    limits = wkv_bwd_limits(*args)
    err, ratio, ratios = held_bwd(got, want, limits)
    require(all(bool(torch.isfinite(x.float()).all()) for x in got), "wkv6_bwd finite")
    require(ratio <= 1.0, f"wkv6_bwd {label} max|err| {err}, ratios {ratios}")
    control = [x.to(y.dtype) for x, y in zip(wk.plain_grad(*args), got)]
    control_ratio = held_bwd(control, want, limits)[1]
    require(control_ratio <= 1.0, f"wkv6_bwd {label}'s fp32 plain control {control_ratio}")
    faults = {name: held_bwd(f, want, limits)[1]
              for name, f in wkv6_bwd_faults(args, want).items()}
    require(all(f >= BWD_FAULT_FACTOR for f in faults.values()),
            f"wkv6_bwd {label} check rejects planted faults by {BWD_FAULT_FACTOR}x: {faults}")
    again = wk.wkv6_bwd(*args)
    require(all(torch.equal(x, y) for x, y in zip(got, again)), f"wkv6_bwd {label} deterministic")
    cost = costs.wkv6_bwd(B, S, H, N, r.element_size())
    ms_bound, by = bound_of(cost)
    res = dict(max_abs_err=err, limit_ratio=ratio, ratios=ratios,
               control_ratio=control_ratio, fault_ratio=faults, formulas_vs_autograd=formulas,
               **({} if forward_ratio is None else {"padded_to": wk.kernel_head_size(N),
                                                     "forward_limit_ratio": forward_ratio}),
               bytes_ms=cost.bytes / PEAK_BYTES * 1e3,
               ms=cuda_ms(lambda: wk.wkv6_bwd(*args), 10),
               plain_ms=cuda_ms(lambda: wk.plain_grad(*args), 1),
               library_ms=None,   # no single PyTorch call computes the recurrence's gradient
               bound_ms=ms_bound, bound_by=by)
    print(f"[kernel wkv6_bwd] {label} B={B} S={S} H={H} N={N} " + json.dumps(res))
    return res


def phase_recurrent_train():
    """Phase 19: K3′ and K4′ alone, train-step checks of recurrentgemma-9b
    (3 layers) and rwkv6-7b (2), the slice (6 and 8 layers at full width,
    TRAIN19_STEPS steps each) and the ~100M runs (one killed and restored).
    Each record carries its launches and the run they were counted on."""
    import tempfile
    import torch
    t_phase = time.perf_counter()
    B, S = BWD_CASE["B"], BWD_CASE["S"]
    cases = [   # (record key, record, (the run its launches are counted on, model))
        (("rglru_scan_bwd", "recurrentgemma-9b", f"fp32 a/b/g, B {B} x {S}, R 4096"),
         merge([rglru_bwd_case("float32")]), ("slice", "recurrentgemma-9b")),
        (("rglru_scan_bwd", "recurrentgemma-9b", f"bf16 a/b/g (the calibration's dtype), "
          f"B {B} x {S}, R 4096"), merge([rglru_bwd_case("bfloat16")]), (None, "")),
        (("wkv6_bwd", "rwkv6-7b", f"bf16, B {B} x {S}, 64 heads of 64"),
         merge([wkv6_bwd_case("rwkv6-7b", *WKV_BWD_SHAPES["rwkv6-7b"])]), ("slice", "rwkv6-7b")),
        (("wkv6_bwd", "rwkv6-7b", f"N 32: bf16, B {B} x {S}, 128 heads of 32"),
         merge([wkv6_bwd_case("N 32", *WKV_BWD_SHAPES["N 32"])]), (None, "")),
        (("wkv6_bwd", "rwkv6-7b", f"S 300 (a partial last chunk), B {B}, 64 heads of 64"),
         merge([wkv6_bwd_case("partial chunk", *WKV_BWD_SHAPES["partial chunk"])]), (None, "")),
        (("wkv6_bwd", "rwkv6-7b 100M", "the ~100M config's shape: fp32, B 8 x 256, 32 heads "
          "of 16 (padded to 32)"), merge([wkv6_bwd_case("100M", *WKV_BWD_SHAPES["100M"])]),
         ("100M", "rwkv6-7b")),
    ]
    t_a = time.perf_counter() - t_phase
    for arch, run in TRAIN19_CHECKS.items():
        torch.cuda.empty_cache()
        (train_check_batches if "batches" in run else train_check)(arch, run)
    t_b = time.perf_counter() - t_phase - t_a
    slices = {}
    for arch, layers in TRAIN19_SLICE.items():
        torch.cuda.empty_cache()
        slices[arch] = train_slice(arch, layers, BWD_CASE["B"], BWD_CASE["S"], TRAIN19_STEPS)[0]
    t_c = time.perf_counter() - t_phase - t_a - t_b
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        learned = {arch: train_learns(tmp, arch, restart=arch == TRAIN19_RESTART)
                   for arch in TRAIN19_SLICE}
    print(f"[train] phase 19 s={time.perf_counter() - t_phase:.1f} (a {t_a:.1f}, b {t_b:.1f}, "
          f"c {t_c:.1f})")
    records = {}
    for (kernel, arch, variant), rec, (on, model) in cases:
        if on == "slice":
            launched = dict(launches=slices[model][kernel],
                            launches_on=f"train, {model} at {TRAIN19_SLICE[model]} layers x "
                            f"{TRAIN19_STEPS} steps with remat")
        elif on == "100M":
            launched = dict(launches=learned[model][BACKWARD[kernel]][1],
                            launches_on=f"train, {model}'s ~100M config x 200 steps "
                            "(launch/train.py --reduce), with remat")
        else:
            launched = dict(launches=0, launches_on="none: a check at a shape no trained "
                            "config takes (the kernel's launches are on its other rows)")
        records[(kernel, arch, variant)] = {**launched, **rec}
    return records, slices


# ---- phase 20: cost accounting ---------------------------------------------
# (b)'s gemma2-2b cells: (kind, global batch, sequence or cache length), at
# shapes that fit the card.  Their meta run allocates the tensors the card's
# run allocates, in the same order, each freed when its last reference
# dies (Python reference counts on both), the kernels' scratch included
# (``kernels/meta.py``); the card adds the caching allocator's rounding of
# each block to 512 bytes and any workspace a library call takes through
# the allocator.  So the card's peak is held within COST_PEAK_RATIO of the
# meta run's.  The operands' bytes are held exactly to what the step's
# tensors requested of the allocator (its ``requested_bytes`` counter);
# ``memory_allocated`` counts whole blocks, each rounded to 512 bytes and
# up to 1 MiB more where the allocator does not split a block, so it is
# printed beside.
COST_CELLS = (("prefill", 4, 2048), ("decode", 8, 4096))
COST_PEAK_RATIO = (0.99, 1.05)


def leaves(tree):
    from torch.utils._pytree import tree_flatten
    flat, spec = tree_flatten(tree)
    return [t for t in flat if hasattr(t, "untyped_storage")], spec


def requested(which: str = "current") -> int:
    """Bytes the live tensors requested of the caching allocator (``which``
    "current") or their peak since the last reset ("peak")."""
    import torch
    return torch.cuda.memory_stats()[f"requested_bytes.all.{which}"]


def cost_operands(cell, model):
    """The cell's operands on the card, from a seed: the model's own random
    init, random prompt tokens of full length (prefill), or a full cache of
    random k/v whose next position is its last slot (decode), so the step
    attends every slot the cost pass counts."""
    import torch
    B, S = cell.shape.global_batch, cell.shape.seq_len
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    g = torch.Generator(device="cuda").manual_seed(1)
    prefill = cell.shape.kind == "prefill"
    tokens = torch.randint(0, cell.cfg.vocab_size,
                           (cell.args[1]["tokens"] if prefill else cell.args[2]).shape,
                           generator=g, device="cuda", dtype=torch.int32)
    if prefill:
        return params, {"tokens": tokens,
                        "lengths": torch.full((B,), S, dtype=torch.int32, device="cuda")}
    cache = model.init_cache(B, S)
    cache["lengths"].fill_(S - 1)
    for leaf in leaves(cache)[0]:
        if leaf.is_floating_point():
            leaf.normal_(generator=g)
        elif leaf.dim() > 1:          # slot_pos: slot t holds position t
            leaf.copy_(torch.arange(S, dtype=torch.int32, device="cuda").expand_as(leaf))
    return params, cache, tokens


def cost_cell(kind: str, B: int, S: int) -> dict:
    """Phase 20 (b): a gemma2-2b cell counted on meta, then run on the card
    through K1 and K2: the operands' bytes against the card's allocation,
    the meta peak against the card's, the counted FLOPs beside the step's
    time, the launches exact, the logits finite."""
    import torch
    from repro_torch.configs import ShapeSpec
    from repro_torch.launch import cells, costing
    from repro_torch.models import build_model
    from repro_torch.serving.engine import make_decode_fn, make_prefill_fn
    arch = "gemma2-2b"
    shape = ShapeSpec(f"{kind}_{B}x{S}", S, B, kind)
    build = cells.build_prefill_cell if kind == "prefill" else cells.build_decode_cell
    cell = build(arch, shape)
    argument_bytes = costing.storage_bytes(cell.args)
    _, counted, meta_peak = costing.count(cell.fn, *cell.args)
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    before, before_req = torch.cuda.memory_allocated(), requested()
    model = build_model(cell.cfg)
    args = cost_operands(cell, model)
    torch.cuda.synchronize()
    placed, placed_req = torch.cuda.memory_allocated() - before, requested() - before_req
    (got, got_spec), (want, want_spec) = leaves(args), leaves(cell.args)
    require(got_spec == want_spec and [(t.shape, t.dtype) for t in got]
            == [(t.shape, t.dtype) for t in want], f"cost {kind}: operands as the cell's")
    require(placed_req == argument_bytes,
            f"cost {kind}: the card's operands requested {placed_req} B of the allocator, "
            f"argument_bytes {argument_bytes}")
    step = (make_prefill_fn(model) if kind == "prefill" else make_decode_fn(model))
    run = ((lambda: step(args[0], **args[1])) if kind == "prefill"
           else (lambda: step(*args)))
    lengths0 = args[1]["lengths"] if kind == "decode" else None
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    out = run()
    torch.cuda.synchronize()
    real_peak = torch.cuda.max_memory_allocated() - before
    requested_peak = requested("peak") - before_req
    launched = read_launches()
    logits = out[1]
    require(tuple(logits.shape) == (B, cell.cfg.vocab_size)
            and bool(torch.isfinite(logits).all()), f"cost {kind}: logits finite, (B, V)")
    n_attn = layer_counts(cell.cfg)[0]
    want_launches = {**{k: 0 for k in KERNELS},
                     ("flash_attention" if kind == "prefill" else "decode_attention"): n_attn}
    require(launched == want_launches, f"cost {kind}: launches {launched} != {want_launches}")
    ratio = real_peak / meta_peak
    require(COST_PEAK_RATIO[0] <= ratio <= COST_PEAK_RATIO[1],
            f"cost {kind}: the card's peak {real_peak} B is {ratio}x the meta run's "
            f"{meta_peak} B, outside {COST_PEAK_RATIO}")
    del out, logits

    def timed():
        if lengths0 is not None:
            args[1]["lengths"] = lengths0         # the cache's next position again
        return run()
    times = []
    for _ in range(4):
        torch.cuda.synchronize()
        t = time.perf_counter()
        timed()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    step_s = float(np.median(times[1:]))
    res = dict(argument_bytes=argument_bytes, allocated_bytes=placed,
               meta_peak_bytes=meta_peak, card_peak_bytes=real_peak, peak_ratio=ratio,
               requested_peak_ratio=requested_peak / meta_peak,
               counted_flops=counted["flops"], counted_bytes=counted["bytes"],
               step_s=step_s, step_s_all=times,
               attained_tflops=counted["flops"] / step_s / 1e12, launches=launched)
    print(f"[cost] {arch} {kind} B={B} S={S} " + json.dumps(res))
    del args
    return res


def phase_cost():
    """Phase 20: (a) the dry-run's 40 records on this host; (b) two gemma2-2b
    cells on the card against their counts; (c) the paper's Fig. 9 and
    Fig. 10 (b) measured on the card, Fig. 10 (a) from (a)'s records."""
    import tempfile
    import torch
    from repro_torch.analysis import report
    from repro_torch.configs import ARCHS, SHAPES
    from repro_torch.launch import dryrun, figures
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        records_dir = str(Path(tmp) / "dryrun")
        recs = dryrun.run(list(ARCHS), list(SHAPES), records_dir)
        t_a = time.perf_counter() - t_phase
        status = [("SKIP" if r.get("skipped") else "OK" if r["ok"] else "FAIL") for r in recs]
        print(report.roofline_table(report.load_cells(records_dir)))
        print(f"[cost] (a) dry-run: {len(recs)} records, {status.count('OK')} OK, "
              f"{status.count('SKIP')} SKIP, {status.count('FAIL')} FAIL, s={t_a:.1f} "
              "(accounting on hw.GPU_H100's data-sheet rates, not timings)")
        require(len(recs) == 40 and status.count("OK") == 32 and status.count("SKIP") == 8,
                f"dry-run: 32 OK and 8 SKIP of 40, got {len(recs)}: "
                f"{ {s: status.count(s) for s in set(status)} }")
        for kind, B, S in COST_CELLS:
            torch.cuda.empty_cache()
            cost_cell(kind, B, S)
        t_b = time.perf_counter() - t_phase - t_a
        torch.cuda.empty_cache()
        fig9 = figures.fig9(tmp)
        fig10 = figures.fig10(tmp, records_dir)
    heat = {"rows", "cols", "matrix", "row_key", "col_key", "value_key"}
    require(set(fig9) == {f"{f}/result.{v}" for f in figures.FAMILIES
                          for v in ("latency_s", "attained_gflops")}
            and all(set(hm) == heat and len(hm["rows"]) == len(figures.LAYERS)
                    and len(hm["cols"]) == len(figures.WIDTHS) for hm in fig9.values()),
            "fig9 has the reference's keys and grid")
    require(set(fig10) == {"real", "generated"} and len(fig10["real"]) == 32
            and all(set(r) == {"intensity", "attained_tflops", "roofline_bound",
                               "dominant_term"} for r in fig10["real"].values())
            and len(fig10["generated"]) == 8
            and all(set(p) == {"intensity", "attained_flops"}
                    for p in fig10["generated"].values()), "fig10 has the reference's keys")
    print("[cost] fig9 " + json.dumps(fig9))
    print("[cost] fig10 " + json.dumps(fig10))
    print(f"[cost] phase 20 s={time.perf_counter() - t_phase:.1f} (a {t_a:.1f}, b {t_b:.1f})")
    return recs


# Phase 21: distribution at world size 1.  The dry-run's production meshes
# are fake groups of 256 and 512 ranks in worker processes on this host.
DIST_CELLS = (("gemma2-2b", "granite-moe-3b-a800m", "dbrx-132b"),
              ("train_4k", "prefill_32k", "decode_32k"))
DIST_MOE_RULES = {"gspmd": "MOE_EP_RULES", "local": "MOE_LOCAL_RULES",
                  "ep_local": "MOE_EP_LOCAL_RULES"}
# Phase 21 (e): granite-moe-3b-a800m's train step at full width, depth cut
DIST_MOE_TRAIN = dict(layers=4, batch=2, seq=2048)


def dist_train(mesh) -> None:
    """Phase 21 (a) and (c): granite-3-2b's gradient with and without the
    1 × 1 mesh, then the update on it and compressed_psum."""
    import torch
    from repro_torch.dist import sharding as shd
    from repro_torch.training.compress import compressed_psum, dequantize, quantize
    from repro_torch.training.data import DataConfig, host_batch
    from repro_torch.training.optimizer import OptimizerConfig, adamw_update, opt_state_axes
    from repro_torch.training.step import make_grad_fn
    from repro_torch.training.tree import flatten
    arch = TRAIN_SLICE["arch"]
    cfg, model, state = train_setup(arch)
    used = train_kernels(cfg)
    grad_fn = make_grad_fn(model, remat=True)
    batch = {k: torch.as_tensor(v).cuda() for k, v in host_batch(
        DataConfig(global_batch=TRAIN_SLICE["batch"], seq_len=TRAIN_SLICE["seq"]),
        cfg, 0).items()}
    runs = {}
    # the plain step twice (its first call warms the card up), the mesh's
    # between: its gradients stay until compared
    for name in ("plain", "mesh", "plain again"):
        params, args = state["params"], batch
        if name == "mesh":
            axes = model.logical_axes()
            params = shd.shard_tree(params, axes, shd.TRAIN_RULES, mesh)
            args = shd.shard_tree(batch, {k: ("batch", "seq") for k in batch},
                                  shd.TRAIN_RULES, mesh)
        ctx = (shd.activation_sharding(mesh, shd.TRAIN_RULES) if name == "mesh"
               else contextlib.nullcontext())
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        reset_launches()
        t1 = time.perf_counter()
        with ctx:
            grads, aux = grad_fn(params, args)
        torch.cuda.synchronize()
        runs[name] = dict(s=time.perf_counter() - t1,
                          gb=(torch.cuda.max_memory_allocated() - held) / 1e9,
                          launches=train_launches_read(used), grads=grads, aux=aux,
                          params=params)
        del grads
        if name == "mesh":          # compared, then the plain gradients go
            local = {p: g.to_local() for p, g in flatten(runs["mesh"]["grads"])}
            same = [p for p, g in flatten(runs["plain"].pop("grads")) if torch.equal(local[p], g)]
            torch.cuda.empty_cache()
    runs["plain again"].pop("grads")
    plain, meshed, again = runs["plain"], runs["mesh"], runs["plain again"]
    plain_loss = plain["aux"]["ce"]
    loss = (float(plain_loss), float(meshed["aux"]["ce"].to_local()))
    require(torch.equal(meshed["aux"]["ce"].to_local(), plain_loss),
            f"{arch} on the 1 x 1 mesh: loss bitwise the plain step's {loss}")
    require(len(same) == len(local), f"{arch} on the 1 x 1 mesh: {len(same)} of {len(local)} "
            "gradient leaves bitwise the plain step's")
    want = {k: (2 * n, n) for k, n in used.items()}
    require(meshed["launches"] == want, f"{arch} on the mesh launches {meshed['launches']}, "
            f"want {want}")
    g = next(iter(local.values()))
    require(torch.equal(compressed_psum(g), dequantize(*quantize(g))),
            "(c) compressed_psum over the nccl group of one is dequantize(quantize(g))")
    n_leaves, g_shape = len(local), tuple(g.shape)
    del local, g
    torch.cuda.empty_cache()
    opt = shd.shard_tree(state["opt"], opt_state_axes(model.logical_axes()),
                         shd.TRAIN_RULES, mesh)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    with shd.activation_sharding(mesh, shd.TRAIN_RULES):
        _, _, metrics = adamw_update(OptimizerConfig(), meshed["grads"], opt, meshed["params"])
    torch.cuda.synchronize()
    update_s = time.perf_counter() - t1
    gnorm = float(metrics["grad_norm"].to_local())
    require(np.isfinite(gnorm), f"grad norm finite {gnorm}")
    print(f"[dist] (a) {arch} whole, {cfg.num_layers} layers, batch {TRAIN_SLICE['batch']} x "
          f"{TRAIN_SLICE['seq']}, remat, fp32 masters, nccl group of 1, mesh "
          f"{shd.mesh_sizes(mesh)}: loss {loss[1]} and {len(same)} of {n_leaves} gradient "
          f"leaves bitwise the plain step's; gradient s: plain {plain['s']:.3f} (first call), "
          f"mesh {meshed['s']:.3f}, plain again {again['s']:.3f}; peak GB above what each "
          f"run found allocated: plain {plain['gb']:.2f}, mesh {meshed['gb']:.2f}, plain "
          f"again {again['gb']:.2f}; "
          f"launches (forward, backward) {meshed['launches']}; update on the mesh "
          f"{update_s:.3f} s, grad norm {gnorm}")
    print(f"[dist] (c) compressed_psum of a {g_shape} leaf over the nccl group of 1: "
          "bitwise dequantize(quantize(g))")


def dist_moe(mesh) -> None:
    """Phase 21 (b): granite-moe-3b-a800m's prefill and decode step under
    each MoE mode on the 1 × 1 mesh against the run without a mesh."""
    import torch
    from repro_torch.dist import sharding as shd
    from repro_torch.models import moe
    arch = "granite-moe-3b-a800m"
    cfg, m, params, tokens, lengths, max_len, extra = model_setup(arch, MODEL_RUNS.get(arch, {}))
    ref = Routing()
    pre0, dec0, tok, launches0 = prefill_and_step(m, params, tokens, lengths, max_len,
                                                  extra, {}, route=ref)
    notes = []
    for mode, rules_name in list(DIST_MOE_RULES.items()) + [("ep_local fault", None)]:
        rules = getattr(shd, rules_name or DIST_MOE_RULES["ep_local"])
        placed = shd.shard_tree(params, m.logical_axes(), rules, mesh)
        offset = moe._expert_offset
        if rules_name is None:      # the planted fault: each rank's experts one off
            moe._expert_offset = lambda mesh_, E_l: offset(mesh_, E_l) + 1
        try:
            with shd.activation_sharding(mesh, rules):
                pre, dec, _, launches = prefill_and_step(
                    m, placed, tokens, lengths, max_len, extra, {}, tok=tok,
                    route=Routing(pin=ref))
        finally:
            moe._expert_offset = offset
        same = torch.equal(pre.to_local(), pre0) and torch.equal(dec.to_local(), dec0)
        if rules_name is None:
            require(not same, "the planted fault (ep_local's expert offset + 1) changes the "
                    "logits")
            notes.append(f"{mode}: logits changed, max |diff| "
                         f"{max_diff(dec.to_local(), dec0):.3g}")
            continue
        require(same, f"{arch} under {rules_name} on the 1 x 1 mesh: prefill and decode "
                "logits bitwise the run without a mesh")
        require(launches == launches0, f"{mode} launches {launches}, without a mesh "
                f"{launches0}")
        notes.append(f"{mode} ({rules_name}): bitwise, launches {launches}")
    print(f"[dist] (b) {arch} full width, {cfg.num_layers} layers, prompts "
          f"{tuple(lengths.tolist())}, routing pinned: " + "; ".join(notes))


def dist_moe_train(mesh) -> None:
    """Phase 21 (e): granite-moe-3b-a800m's train step on the 1 × 1 mesh
    under each MoE mode's rules against the same step without a mesh.  The
    forward is the same, but not every gradient bit: in each MoE block the
    aux loss's router term of x's gradient arrives through its own
    ``local_map`` and is added after the block's own terms, where autograd
    without a mesh adds the three terms in another order.  So the mesh's
    distances from the control (attention in float64) are held to
    max(TRAIN_FLOOR, TRAIN_DRIFT × the run without a mesh's), launches
    exact, no plain call."""
    import torch
    from repro_torch.dist import sharding as shd
    from repro_torch.training.data import DataConfig, host_batch
    from repro_torch.training.step import make_grad_fn
    arch, run = "granite-moe-3b-a800m", DIST_MOE_TRAIN
    cfg, model, state = train_setup(arch, run["layers"])
    params = state["params"]
    del state
    batch = {k: torch.as_tensor(v).cuda() for k, v in host_batch(
        DataConfig(global_batch=run["batch"], seq_len=run["seq"]), cfg, 0).items()}
    grad_fn = make_grad_fn(model, remat=False)
    used = train_kernels(cfg)
    ctl = plain_step(arch, "control", grad_fn, params, batch, used,
                     {k: controls()[k] for k in used})
    t1 = time.perf_counter()
    bare = kernel_step(arch, grad_fn, params, batch, used)
    bare_s = time.perf_counter() - t1
    notes = []
    for mode, rules_name in DIST_MOE_RULES.items():
        rules = getattr(shd, rules_name)
        placed = shd.shard_tree(params, model.logical_axes(), rules, mesh)
        args = shd.shard_tree(batch, {k: ("batch", "seq") for k in batch}, rules, mesh)
        t1 = time.perf_counter()
        with shd.activation_sharding(mesh, rules):
            got = kernel_step(arch, grad_fn, placed, args, used)
        s_mesh = time.perf_counter() - t1
        got = (got[0].to_local(), got[1].to_local(),
               {p: g.to_local() for p, g in got[2].items()})
        same = sum(torch.equal(g, bare[2][p]) for p, g in got[2].items())
        worst = held_step(arch, step_distances(got, ctl), step_distances(bare, ctl),
                          f"1 x 1 mesh under {rules_name} against no mesh")
        notes.append(f"{mode} ({rules_name}): loss bitwise {torch.equal(got[0], bare[0])}, "
                     f"{same} of {len(got[2])} gradient leaves bitwise, worst ratio {worst:.4g}, "
                     f"step s {s_mesh:.3f}")
        del got, placed, args
        torch.cuda.empty_cache()
    print(f"[dist] (e) {arch} full width, {run['layers']} layers, batch {run['batch']} x "
          f"{run['seq']}, fp32 masters, no remat: without a mesh step s {bare_s:.3f}; "
          + "; ".join(notes) + f"; launches (forward, backward) "
          f"{ {k: (n, n) for k, n in used.items()} } in each run, no plain call")


def one_by_one_counts(arch: str, shape: str) -> dict:
    """A cell's production counts on a 1 × 1 fake mesh (a worker process)."""
    from repro_torch.launch import cells, costing
    from repro_torch.launch.mesh import make_accounting_mesh
    cell = cells.build_cell(arch, shape, make_accounting_mesh((1, 1), ("data", "model")))
    return costing.count_costs(cell.fn, *cell.args)


def dist_dryrun(one_records) -> None:
    """Phase 21 (d): the production meshes' dry-run, and 1 × 1 against
    phase 20 (a)."""
    import multiprocessing
    import tempfile
    from concurrent.futures import ProcessPoolExecutor
    t0 = time.perf_counter()
    archs, shapes = DIST_CELLS
    # ep_local needs the experts to divide over "model": granite-moe-3b-a800m's
    # 40 do not at 16, so its blocks run gspmd there; dbrx-132b's 16 do
    runs = [(["--rules", r], r) for r in ("default", "ep_local", "moe_local")]
    rule_archs = {"default": archs, "ep_local": ("granite-moe-3b-a800m", "dbrx-132b"),
                  "moe_local": ("granite-moe-3b-a800m",)}
    with tempfile.TemporaryDirectory() as tmp:
        # the three at once: each pool's longest cells run beside the others'
        procs = []
        for flags, rules in runs:
            log = open(Path(tmp) / f"{rules}.log", "w+")
            procs.append((flags, log, subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                 ",".join(rule_archs[rules]), "--shape", ",".join(shapes), "--mesh", "both",
                 "--out", tmp] + flags,
                cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                stdout=log, stderr=subprocess.STDOUT, text=True)))
        for flags, log, proc in procs:
            proc.wait()
            log.seek(0)
            require(proc.returncode == 0, f"dry-run --mesh both {flags}: {log.read()[-6000:]}")
            log.close()
        recs = [json.loads(p.read_text()) for p in sorted(Path(tmp).glob("*.json"))]
    t_mesh = time.perf_counter() - t0
    n_recs = 2 * len(shapes) * sum(map(len, rule_archs.values()))
    require(len(recs) == n_recs and all(r["ok"] and not r.get("skipped") for r in recs),
            f"dry-run on the production meshes: {n_recs} records OK, got "
            f"{[(r['arch'], r['shape'], r['mesh'], r['rules'], r.get('error')) for r in recs]}")
    want_mode = {("granite-moe-3b-a800m", "default"): "gspmd",
                 ("granite-moe-3b-a800m", "ep_local"): "gspmd",
                 ("granite-moe-3b-a800m", "moe_local"): "local",
                 ("dbrx-132b", "default"): "gspmd", ("dbrx-132b", "ep_local"): "ep_local"}
    modes = {(r["arch"], r["rules"]): r["moe_mode"] for r in recs if "moe_mode" in r}
    require(all(r.get("moe_mode") == want_mode[r["arch"], r["rules"]] for r in recs
                if (r["arch"], r["rules"]) in want_mode),
            f"the MoE blocks' modes {modes}, want {want_mode}")
    for r in recs:
        rf = r["roofline"]
        colls = {k: (v["count"], v["bytes"]) for k, v in rf["collectives"].items() if v["count"]}
        print(f"[dist] (d) {r['arch']} {r['shape']} {r['mesh']} {r['rules']}: dominant "
              f"{rf['dominant']}, step {rf['step_time_s']:.4f} s (compute {rf['compute_s']:.4f}, "
              f"memory {rf['memory_s']:.4f}, collective {rf['collective_s']:.4f}), collective "
              f"bytes/device {rf['collective_bytes_per_device']:.4g}, (count, bytes) {colls}, "
              f"chips {rf['chips']}, peak {r['memory']['peak_bytes'] / 1e9:.2f} GB/device"
              + (f", MoE mode {r['moe_mode']}" if "moe_mode" in r else ""))
    t1 = time.perf_counter()
    cells_ = [(a, s) for a in archs for s in shapes]
    with ProcessPoolExecutor(len(cells_), mp_context=multiprocessing.get_context("spawn")) as pool:
        got = list(pool.map(one_by_one_counts, *zip(*cells_)))
    want = {(r["arch"], r["shape"]): r["production_costs_scan_body_once"]
            for r in one_records if not r.get("skipped")}
    for (a, s), costs in zip(cells_, got):
        require(costs == want[a, s], f"{a} {s} on a 1 x 1 fake mesh counts {costs}, phase 20 "
                f"(a) {want[a, s]}")
    print(f"[dist] (d) {len(recs)} records OK on 16x16 and 2x16x16 (s={t_mesh:.1f}); the "
          f"{len(cells_)} cells on a 1 x 1 fake mesh count phase 20 (a)'s FLOPs, bytes, "
          f"transcendentals and collectives digit for digit (s={time.perf_counter() - t1:.1f})")


def phase_dist(one_records) -> None:
    """Phase 21: distribution at world size 1 on the card; the production
    meshes' accounting on this host."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    t0 = time.perf_counter()
    mesh = make_host_mesh(1)
    require(dist.get_backend() == "nccl" and dist.get_world_size() == 1,
            f"an nccl group of one: {dist.get_backend()}, {dist.get_world_size()}")
    try:
        dist_train(mesh)
        torch.cuda.empty_cache()
        dist_moe(mesh)
        torch.cuda.empty_cache()
        dist_moe_train(mesh)
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    dist_dryrun(one_records)
    print(f"[dist] phase 21 s={time.perf_counter() - t0:.1f}")


# Phase 22: the example flows on the port.  The golden texts are the
# reference's stdout (examples/*.py on the CPU), which
# tests/test_torch_examples_sim.py holds both the reference and the port to,
# byte for byte; flows.json names each flow's arguments and the files it
# writes, with their SHA-256.
EXAMPLES = ROOT / "examples_torch"
GOLDEN = ROOT / "tests" / "golden_torch_examples"
# quickstart's followers run concurrently and PerfDB keeps its records in the
# order they complete (in the reference as in the port), so jobs whose
# results tie on a table's sort key may print in either order.  Its ties are
# jobs of one spec (api-job and quickstart-14), whose rows print the same
# but for the job id: each run of such rows is compared as a multiset.
# Every other row keeps its place, also where its rounded sort key prints as
# its neighbour's.
UNORDERED_ROWS = ("quickstart",)


def example(name: str):
    """``examples_torch/<name>.py`` as a module (the folder is no package)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(f"examples_torch_{name}",
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def golden_flows() -> dict:
    """case → {"flow", "args", "files"}: flows.json, ``{golden}`` in an
    argument replaced by the golden directory."""
    flows = json.loads((GOLDEN / "flows.json").read_text())
    for case in flows.values():
        case["args"] = [a.format(golden=GOLDEN) for a in case.get("args", [])]
    return flows


def flow_dir(tmp) -> Path:
    """A working directory for a flow: the profiles resolve in its
    ``configs/``, and the files a flow writes land in it."""
    (Path(tmp) / "configs").symlink_to(ROOT / "configs")
    return Path(tmp)


def flow_output(run, workdir) -> str:
    """The stdout of ``run()`` with ``workdir`` as the working directory."""
    import io
    here = os.getcwd()
    out = io.StringIO()
    os.chdir(workdir)
    try:
        with contextlib.redirect_stdout(out):
            run()
    finally:
        os.chdir(here)
    return out.getvalue()


def settled(text: str) -> str:
    """``text`` with each run of consecutive lines that are equal but for
    their first word sorted: the order concurrent followers may leave."""
    def but_the_first_word(line):
        words = line.split(None, 1)
        return words[1] if len(words) == 2 else (line,)
    return "\n".join(line for _, run in itertools.groupby(text.split("\n"),
                                                         but_the_first_word)
                     for line in sorted(run))


def against_golden(case: str, text: str) -> tuple:
    """(``text``, ``case``'s golden text), ties settled where the flow is
    one of UNORDERED_ROWS: equal when the flow printed its golden."""
    want = (GOLDEN / f"{case}.txt").read_text()
    if case in UNORDERED_ROWS:
        return settled(text), settled(want)
    return text, want


def held_to_golden(case: str, text: str) -> None:
    """Raises, with the lines that differ, unless ``text`` is ``case``'s
    golden text."""
    import difflib
    got, want = against_golden(case, text)
    require(got == want, f"{case} differs from its golden:\n" + "\n".join(
        difflib.unified_diff(want.split("\n"), got.split("\n"), "golden", "printed",
                             lineterm="", n=0)))


def sha256(path) -> str:
    import hashlib
    return hashlib.sha256(Path(path).read_bytes()).hexdigest()


def examples_serve() -> dict:
    """Phase 22 (a): serve_benchmark at full width on the card."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.serving.workload import generate
    sb = example("serve_benchmark")
    cfg = sb.model_config("cuda")
    full = get_config("gemma2-2b")
    require((cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.vocab_size)
            == (full.num_layers, full.d_model, full.num_heads, full.vocab_size),
            "serve_benchmark serves gemma2-2b at full width")
    print(f"[examples] serve_benchmark on {card()}:")
    reset_launches()
    t0 = time.perf_counter()
    rows = sb.main([])
    serve_s = time.perf_counter() - t0
    launches = read_launches()
    backward = {k: counters()[k].launches_bwd for k in BACKWARD.values()}
    n = len(generate(sb.BASE.workload))
    want = {k: 0 for k in KERNELS}
    for policy, res in rows:
        require(res["requests"] == n, f"{policy.name}: {res['requests']} of {n} requests served")
        require(all(np.isfinite(v) for v in res.values()), f"{policy.name}: finite metrics")
        for k, v in served_launches(cfg, policy, res, sb.DECODE_STEPS).items():
            want[k] += v
    require([p.name for p, _ in rows] == ["none", "tfs-window", "tris-preferred"],
            f"policies {[p.name for p, _ in rows]}")
    require(rows[0][1]["mean_batch"] == 1.0, "none serves one request a batch")
    print(f"[examples] serve_benchmark: {len(rows)} policies x {n} requests in {serve_s:.1f} s "
          f"({cfg.name}, {cfg.num_layers} layers, max_len {sb.MAX_LEN}: K2 reads a "
          f"{sb.MAX_LEN}-slot cache), launches {json.dumps(launches)}, backward "
          f"{json.dumps(backward)}")
    require(launches == want, f"serve_benchmark launches {launches} != {want}")
    require(not any(backward.values()), f"no backward kernel launched: {backward}")
    torch.cuda.empty_cache()
    examples_checked(sb, max(getattr(p, "max_batch", 1) for p, _ in rows))
    return launches


def examples_checked(sb, max_batch: int) -> None:
    """serve_benchmark's own shapes, outside its timed run: its card config
    with run_server's weights (seed 0), a prefill of each batch size 1 to
    ``max_batch`` of its prompts and one decode step into its MAX_LEN-slot
    cache, every K1 and K2 call held to the plain version in float64
    (``checked_kernels``), each limit ratio at most 1.  These launches come
    after the counts are read and are not counted."""
    import torch
    from repro_torch.kernels.decode_attention import plan_splits
    from repro_torch.models import build_model
    cfg = sb.model_config("cuda")
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    S = sb.BASE.workload.prompt_tokens
    rng = np.random.default_rng(0)
    worst = {}
    for B in range(1, max_batch + 1):
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S))
                                  .astype(np.int32)).cuda()
        lengths = torch.full((B,), S, dtype=torch.int32, device="cuda")
        prefill_and_step(model, params, tokens, lengths, sb.MAX_LEN, {},
                         checked_kernels(worst, {}))
    splits = {B: plan_splits(B, cfg.num_kv_heads, sb.MAX_LEN, cfg.head_dim, 2)[0]
              for B in range(1, max_batch + 1)}
    print(f"[examples] serve_benchmark's shapes (B 1..{max_batch} x {S} tokens, "
          f"max_len {sb.MAX_LEN}, K2 splits {json.dumps(splits)}): per-call limit ratio "
          f"{json.dumps(worst)} (fail above 1)")
    require(set(worst) == {"flash_attention", "decode_attention"},
            f"K1 and K2 held on serve_benchmark's shapes: {sorted(worst)}")
    require(all(r <= 1.0 for r in worst.values()),
            "every K1 and K2 call on serve_benchmark's shapes within the limit")
    del model, params
    torch.cuda.empty_cache()


def examples_host() -> None:
    """Phase 22 (b): the ten flows that run on the host, against their
    goldens."""
    import tempfile
    for case, flow in golden_flows().items():
        main = example(flow["flow"]).main
        with tempfile.TemporaryDirectory() as tmp:
            workdir = flow_dir(tmp)
            t0 = time.perf_counter()
            got = flow_output(lambda: main(flow["args"]), workdir)
            held_to_golden(case, got)
            files = {f: sha256(workdir / f) for f in flow.get("files", {})}
        require(files == flow.get("files", {}), f"{case}: files {files} != the reference's")
        print(f"[examples] {case}: {len(got.splitlines())} lines as the golden"
              f"{', files equal' if files else ''} in {time.perf_counter() - t0:.1f} s")


def phase_examples() -> dict:
    """Phase 22: (a) and (b); (c) is phase 18 (d) and 19 (d) reading
    examples_torch/train_100m.py."""
    import torch
    t0 = time.perf_counter()
    launches = examples_serve()
    torch.cuda.empty_cache()
    examples_host()
    print(f"[examples] phase 22 s={time.perf_counter() - t0:.1f}")
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
        # the MoE archs: 3 and 6 query heads per kv head, global, no softcap
        ("flash_attention", "granite-moe-3b-a800m", ""): merge([
            flash_case("granite-moe-3b-a800m", 24, 8, 0, 0.0, d=64)]),
        ("decode_attention", "granite-moe-3b-a800m", ""): merge([
            decode_case("granite-moe-3b-a800m", 24, 8, 4736, 0, 0.0, ring=False, d=64)]),
        ("flash_attention", "dbrx-132b", ""): merge([
            flash_case("dbrx-132b", 48, 8, 0, 0.0, d=128)]),
        ("decode_attention", "dbrx-132b", ""): merge([
            decode_case("dbrx-132b", 48, 8, 4736, 0, 0.0, ring=False, d=128)]),
        # the encoder-decoder: not causal, no lengths; Sq != Skv on the
        # cross-attention, and K2 without slot positions
        ("flash_attention", "whisper-tiny", "encoder self-attention, 1500 x 1500"): merge([
            flash_cross_case("whisper-tiny encoder", 4, 6, 1500, 1500, 64)]),
        ("flash_attention", "whisper-tiny", "cross-attention in prefill, 432 x 1500"): merge([
            flash_cross_case("whisper-tiny cross-attention", 4, 6, 432, 1500, 64)]),
        ("decode_attention", "whisper-tiny", "cross-attention in decode, T = 1500"): merge([
            decode_cross_case("whisper-tiny cross-attention", 8, 6, 1500, 64)]),
        # the VLM: 7 query heads per kv head, at its prefill lengths
        ("flash_attention", "llava-next-34b", ""): merge([
            flash_case("llava-next-34b", 56, 8, 0, 0.0, d=128, prompts=LLAVA_LENGTHS)]),
        ("decode_attention", "llava-next-34b", ""): merge([
            decode_case("llava-next-34b", 56, 8, 4736, 0, 0.0, ring=False, d=128)]),
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
    # phases 13-15: the MoE family
    torch.cuda.empty_cache()
    launches["granite-moe-3b-a800m"] = phase_model("granite-moe-3b-a800m")
    torch.cuda.empty_cache()
    phase_serving("granite-moe-3b-a800m")
    torch.cuda.empty_cache()
    launches["dbrx-132b"] = phase_model("dbrx-132b")
    # phases 16-17: the encoder-decoder and VLM families
    for arch in ("whisper-tiny", "llava-next-34b"):
        torch.cuda.empty_cache()
        launches[arch] = phase_model(arch)
    # phase 18: training
    torch.cuda.empty_cache()
    train_records, slice_launches, launches_100m = phase_train()
    # phase 19: the hybrid and RWKV6 families train
    torch.cuda.empty_cache()
    train19_records, slices19 = phase_recurrent_train()
    # phase 20: cost accounting
    torch.cuda.empty_cache()
    one_records = phase_cost()
    # phase 21: distribution
    torch.cuda.empty_cache()
    phase_dist(one_records)
    # phase 22: the example flows
    torch.cuda.empty_cache()
    examples = phase_examples()
    src = "src/repro_torch/kernels/csrc/"
    replaces = {"flash_attention": "src/repro/kernels/flash_attention.py:94",
                "decode_attention": "src/repro/kernels/decode_attention.py:73",
                "rglru_scan": "src/repro/kernels/rglru_scan.py:53",
                "wkv6": "src/repro/kernels/wkv6.py:66",
                "int8_matmul": "src/repro/kernels/int8_matmul.py:45"}
    replaces_bwd = {
        "rglru_scan_bwd": "none: the reference differentiates its RG-LRU's "
                          "jax.lax.associative_scan with XLA (src/repro/models/rglru.py:73-87)",
        "wkv6_bwd": "none: the reference differentiates its chunked WKV with XLA "
                    "(src/repro/models/rwkv6.py:29-91)"}
    print(f"[done] wall_s={time.perf_counter() - t0:.1f}")
    print(json.dumps({"kernels": [
        dict(name=kernel, model=arch, **({"variant": variant} if variant else {}),
             route="cuda", source=f"{src}{kernel}.cu", replaces=replaces[kernel],
             launches=(calibration if arch == "calibration" else launches[arch])[kernel],
             launches_on=("calibration sweep, all its dtypes together"
                          if arch == "calibration" else
                          f"generate, {MODEL_RUNS[arch]['layers']} layers"
                          if MODEL_RUNS.get(arch, {}).get("layers") else "generate"),
             hook_launches=hook[kernel], plan_hook_launches=plan_hook[kernel],
             **({"examples_launches": examples[kernel]} if arch == "gemma2-2b" else {}),
             **rec)
        for (kernel, arch, variant), rec in records.items()] + [
        dict(name=kernel, model=arch, variant=variant, route="cuda",
             source=f"{src}{kernel}.cu",
             replaces=replaces.get(kernel, "none: the reference takes the attention gradient "
                                   "from XLA's autodiff of attend "
                                   "(src/repro/models/layers.py:133-148)"),
             **train_launches(kernel, arch, slice_launches, launches_100m, slices19),
             hook_launches=hook.get(kernel, 0), plan_hook_launches=plan_hook.get(kernel, 0),
             **rec)
        for (kernel, arch, variant), rec in train_records.items()] + [
        dict(name=kernel, model=arch, variant=variant, route="cuda",
             source=f"{src}{kernel}.cu", replaces=replaces_bwd[kernel],
             hook_launches=0, plan_hook_launches=0, **rec)
        for (kernel, arch, variant), rec in train19_records.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
