#!/usr/bin/env python3
"""Which parity measures the kernels need, on one H100.

    python3 parity_probe.py [--kernel attention|wkv6|flash_bwd|recurrent_bwd]
                            [NAME:SWITCH=VALUE,SWITCH=VALUE ...]

``--kernel recurrent_bwd`` builds K3's and K4's backward kernels and their
forward kernels once per variant (with no arguments: the shipped build and
``WKV_BWD_UNDONE``: K4′'s tf32 kernel with 1 and 2 tf32 passes,
``WKV_BWD_TF32_PASSES``, its wgmma kernel with one bf16 part,
``WKV_BWD_PARTS``, and with its clock64 stamps, ``WKV_BWD_PROF``;
``NAME:SRC=DIR`` builds DIR's copy of the sources, a parent commit's, and
calls its backwards through the current entry points, K4′ as the tf32
kernel at every shape, in ``plan_bwd_segments``' segments or, with
``PLAN=one``, in one segment a (b, h)) and prints, per variant: ptxas's
report; on ``chip_smoke.py`` phase 19 (a)'s cases, K3′'s outputs bitwise
against the first variant's and, for a shipped-API variant, its plan and
its ring against its register kernel, and K4′'s plan and limit ratio per
output (dr, dk, dv, dlogw, du, dstate0) against the float64 plain version
within ``chip_smoke.wkv_bwd_limits``; for both, whether two calls give the
same bits, the time (the variants in order, then in reverse) and each
launch's device time (``torch.profiler``); then K3's and K4's forward on
phase 3's inputs, their times in turns and whether their outputs have the
first variant's bits; and, for a variant built with ``WKV_BWD_PROF=1``,
K4′'s wgmma kernel's cycles a chunk in each phase (``BWD_STAMP_PHASES``)
at rwkv6-7b's row; and, for the shipped build, K4′'s two kernels on the
same bf16 N = 64 inputs at rows about ``wk.backward_plan``'s cut
(``WKV_BWD_CUT_SHAPES``), limit ratios and times in turns.

``--kernel flash_bwd`` builds K1's backward once per variant of its bf16
parity switches (with no arguments: the shipped build and ``BWD_VARIANTS``,
each of its measures set otherwise alone: P and dS in 1 and 3 bf16 parts,
``PARITY_BWD_PARTS``; the gradient products' k16 steps each summed from
zero and added in IEEE fp32, ``PARITY_BWD_FRESH``; S and dP in wgmma
chains of 8 k16 steps, ``PARITY_QK_CHAIN``; the IEEE exponentials,
``PARITY_IEEE_EXP``) and prints, per variant, ptxas's report and the HGMMA
count of each kernel, and, on each of ``chip_smoke.py`` phase 18's K1′
cases, the limit ratio of dq, dk and dv against the float64 plain version
(the float64 gradients computed once a case), whether two calls give the
same bits, the backward's time given the forward's state, taken twice (in
the variants' order, then in reverse), and each kernel's device time
(``torch.profiler``); for the first variant also the limit ratio with D
taken from K1's bf16 output instead of its fp32 one.  K1's forward is built
beside it with the same switches, and its time on the case's inputs is
printed with whether its output has the first variant's bits.  A variant
``NAME:SRC=DIR`` builds DIR's copy of the sources instead, with no switches
set, and calls them through the C entry points of a forward that keeps no
state and a backward that sweeps for its own statistics (``legacy_flash*``):
a parent commit's, to time the two in turns in one call and to show K1's
output unchanged.

``--kernel wkv6`` builds K4 once per variant of its tf32 passes (with no
arguments: the shipped 3 and the variants ``WKV_UNDONE``: 1 and 2 passes
on every product of the tf32 kernel, which runs fp32 and N = 32, and
on the wgmma kernel's level-32 block of A, ``WKV_TF32_PASSES``, and 1 pass
on the tf32 kernel's two output products alone, ``WKV_OUT_TF32_PASSES``)
and prints, per variant, ptxas's report and the HGMMA and HMMA counts of
K4's SASS, the worst limit ratio of any K4 call of an rwkv6-7b prefill on
its own bf16 activations against the float64 plain version
(``chip_smoke.py`` phase 8's check), its output's and its final state's
apart, with the drift ratio, phase 3's K4 cases, and the times of those
cases and of an rwkv6-7b prefill taken in turns (the variants in order,
then in reverse) with each launch's device time, and, for a variant that
sets ``WKV_PROF=1``, the wgmma kernel's clock64 stamps of one block at
rwkv6-7b's row, as cycles a chunk in each phase (``STAMP_PHASES``).  A variant
``NAME:SRC=DIR`` (a parent's sources, whose tf32 kernel ran every head
size and dtype) runs through the same C entry point, with that kernel's
plan (chunks of 32, ``wk.plan_bwd_segments``) in place of
``wk.forward_plan``.  The
default, ``attention``:

The bf16 tensor-core paths of K1 (flash_attention) and K2 (decode_attention)
are held to one bf16 ulp of their plain versions computed in float64, and
take measures to get there; each is a build-time switch in
``src/repro_torch/kernels/csrc/common.cuh`` (``PARITY_*``) whose default is
what each kernel sets before including it (K1 keeps three measures, K2
none).  This script builds both kernels once per variant, a name and the
switches it sets on nvcc's command line for both (``shipped`` sets none;
with no arguments the variants are the shipped kernels and each of K1's
measures set otherwise alone, ``UNDONE``, which leaves K2 as it ships; a
variant ``NAME:SRC=DIR`` builds DIR's copy of the sources, a parent
commit's, with no switches set), into ``build/repro_torch/variants/<name>/``,
and for each variant prints:
- ptxas's registers and spill stores of every bf16 instantiation, and how
  many HGMMA and HMMA instructions (wgmma, mma.sync) K1's SASS holds;
- on gemma2-2b's, recurrentgemma-9b's, granite-moe-3b-a800m's (d = 64) and
  dbrx-132b's (d = 128, 4 layers) own activations at full width
  (``chip_smoke.py`` phase 4's random bf16 weights and prompts): the worst
  limit ratio of any K1 and any K2 call of a prefill and first decode step,
  each call against its float64 plain version as phase 4 holds it (above 1
  fails), and the bf16 drift ratio of the logits;
- ``chip_smoke.py`` phase 3's K2 cases: limit ratio, planted-fault ratios
  and times;
- phase 3's K1 cases and phase 18's training shape (``K1_CASES``): limit
  ratio, whether two calls give the same bits, the time by CUDA events
  taken in turns (the variants in order, then in reverse) and each
  launch's device time (``torch.profiler``);
then, as its last line, one JSON object with all of it.  Nothing is held:
a variant that fails a check is reported, and the next one runs.
"""
from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402  (puts src/ on the path)

# K1's parity measures one at a time, each set otherwise than K1 ships it
# (K2 ships with none): P·V chained into the accumulator, or summed from
# zero each k16 step instead of a tile; P in 2 bf16 parts; the fast
# exponentials; Q·Kᵀ in chains of 8 k16 steps (two at d = 256) instead of
# one
UNDONE = {"pv_chained": {"PARITY_PV_FRESH": 0},
          "pv_fresh_step": {"PARITY_PV_FRESH": 1},
          "p_two_parts": {"PARITY_P_PARTS": 2},
          "fast_exp": {"PARITY_IEEE_EXP": 0},
          "qk_chains_8": {"PARITY_QK_CHAIN": 8}}
# K4 with fewer tf32 passes per product than the 3 it ships with: on every
# product, or on those that give the outputs alone
WKV_UNDONE = {"one_pass": {"WKV_TF32_PASSES": 1}, "two_passes": {"WKV_TF32_PASSES": 2},
              "one_pass_output": {"WKV_OUT_TF32_PASSES": 1}}
# K1's backward with each of its measures set otherwise than it ships (2
# parts, chained, one chain of S and dP, the fast exponentials) alone
BWD_VARIANTS = {"parts1": {"PARITY_BWD_PARTS": 1}, "parts3": {"PARITY_BWD_PARTS": 3},
                "fresh_step": {"PARITY_BWD_FRESH": 1}, "qk_chains_8": {"PARITY_QK_CHAIN": 8},
                "ieee_exp": {"PARITY_IEEE_EXP": 1}}
# K4′ with fewer tf32 passes per product than its tf32 kernel ships with
# (fp32, N = 32 and B·H below the card's SMs), its wgmma kernel with one
# bf16 part fewer, and the wgmma kernel's clock64 stamps (WKV_BWD_PROF)
WKV_BWD_UNDONE = {"bwd_one_pass": {"WKV_BWD_TF32_PASSES": 1},
                  "bwd_two_passes": {"WKV_BWD_TF32_PASSES": 2},
                  "bwd_one_part": {"WKV_BWD_PARTS": 1},
                  "bwd_stamps": {"WKV_BWD_PROF": 1}}
# per mode: the kernels built, the models whose activations hold them, the
# default variants besides the shipped build
MODES = {"attention": (("flash_attention", "decode_attention"),
                       ("gemma2-2b", "recurrentgemma-9b", "granite-moe-3b-a800m", "dbrx-132b"),
                       UNDONE),
         "wkv6": (("wkv6",), ("rwkv6-7b",), WKV_UNDONE),
         "flash_bwd": (("flash_attention_bwd", "flash_attention"), (), BWD_VARIANTS),
         "recurrent_bwd": (("rglru_scan_bwd", "wkv6_bwd", "rglru_scan", "wkv6"), (),
                           WKV_BWD_UNDONE)}
# the cached loader of each kernel's library: (module, function)
LOADERS = {"flash_attention_bwd": ("flash_attention", "_lib_bwd"),
           "rglru_scan_bwd": ("rglru_scan", "_lib_bwd"), "wkv6_bwd": ("wkv6", "_lib_bwd")}
MODE = "attention"
KERNELS, ARCHS = MODES[MODE][:2]
VARIANTS: dict = {}   # name → switches of this run's variants


def parse(args):
    """``NAME:S=V,S=V`` arguments → {name: {switch: value}}."""
    variants = {}
    for arg in args:
        name, _, sets = arg.partition(":")
        variants[name] = dict(kv.split("=") for kv in sets.split(",") if kv)
    return variants


def variant_dir(name: str) -> Path:
    from repro_torch.kernels import _build
    return _build.BUILD_DIR / "variants" / name


def build(variants) -> dict:
    """Both kernels of every variant, one nvcc each, all started together;
    → {name: {instantiation: [registers, spill bytes]}} of the bf16 ones."""
    from repro_torch.kernels import _build
    nvcc, procs = _build._nvcc(), []
    for name, sets in variants.items():
        out = variant_dir(name)
        out.mkdir(parents=True, exist_ok=True)
        src = Path(sets["SRC"]) if "SRC" in sets else _build.CSRC
        for kernel in KERNELS:
            cmd = [nvcc, *_build.NVCC_FLAGS,
                   *(f"-D{s}={v}" for s, v in sets.items() if s not in NOT_SWITCHES),
                   "-o", str(out / f"lib{kernel}.so"), str(src / f"{kernel}.cu")]
            log = out / f"lib{kernel}.log"
            with open(log, "w") as f:
                procs.append((log, subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT)))
    failed = [log.read_text() for log, proc in procs if proc.wait()]
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    report = {}
    for name in variants:
        regs = report[name] = {}
        for kernel in KERNELS:
            fn, spill = None, 0
            for line in (variant_dir(name) / f"lib{kernel}.log").read_text().splitlines():
                if "Compiling entry function" in line:
                    k1 = re.search(r"flash_(?:bf16|wgmma)_kernelILi(\d+)E", line)
                    k2 = re.search(r"decode_kernelI13__nv_bfloat16Li(\d+)ELi(\d+)E", line)
                    k1b = re.search(r"\d(bwd_\w+?_kernel)I(f?)Li(\d+)E", line)
                    other = re.search(r"\d+(\w+_kernel)(I\w*?E)?", line)
                    fn = (f"K1 d={k1[1]}" if k1 else f"K2 d={k2[1]} NG={k2[2]}" if k2
                          else f"{k1b[1]} {'fp32' if k1b[2] else 'bf16'} d={k1b[3]}" if k1b
                          else "".join(g for g in other.groups() if g)
                          if other and KERNELS[0] != "flash_attention" else None)
                elif fn and "spill stores" in line:
                    spill = int(re.search(r"(\d+) bytes spill stores", line)[1])
                elif fn and "Used" in line:
                    regs[fn] = [int(re.search(r"Used (\d+) registers", line)[1]), spill]
                    fn = None
        if "flash_attention" in KERNELS:  # which instruction K1's bf16 products run on
            regs["K1 sass"] = {fn: ops for fn, ops in cs.sass_ops(
                variant_dir(name) / "libflash_attention.so").items() if "f32" not in fn}
        if "flash_attention_bwd" in KERNELS:   # and K1′'s bf16 kernels'
            regs["K1′ sass"] = {fn: ops for fn, ops in cs.sass_ops(
                variant_dir(name) / "libflash_attention_bwd.so").items()
                if "bf16" in fn or "wgmma" in fn}
        if KERNELS == ("wkv6",):   # and K4's, every kernel of the library
            regs["K4 sass"] = cs.sass_ops(variant_dir(name) / "libwkv6.so")
    return report


SHIPPED_PLAN = None   # wk.forward_plan as shipped, kept while a parent's plan stands in
SHIPPED_BWD_PLAN = None   # and wk.backward_plan
SHIPPED_LIB_BWD = None    # and wk._lib_bwd, the loader of K4′'s library
NOT_SWITCHES = ("SRC", "PLAN")   # variant settings that are no -D for nvcc


def parent_plan(B: int, H: int, S: int, N: int, dtype):
    """The tf32 kernel's plan, which a parent's K4 takes at every head size
    and dtype: chunks of 32 in ``wk.plan_bwd_segments``' segments."""
    from repro_torch.kernels import wkv6 as wk
    return (*wk.plan_bwd_segments(B, H, S), wk.BWD_CHUNK)


def parent_bwd_plan(one: bool):
    """The tf32 backward's plan, which a parent's K4′ takes at every head size
    and dtype: chunks of 32 in ``wk.plan_bwd_segments``' segments, or
    (``one``) in one segment a (b, h)."""
    from repro_torch.kernels import wkv6 as wk

    def plan(B: int, H: int, S: int, N: int, dtype):
        P, Lc = (1, -(-S // wk.BWD_CHUNK)) if one and S else wk.plan_bwd_segments(B, H, S)
        return P, Lc, wk.BWD_CHUNK
    return plan


def parent_lib_bwd(directory: Path):
    """A loader of a parent's K4′ library, which holds only the tf32 kernel's
    entry ``wkv6_bwd``, bound as the current loader binds it."""
    lib = ctypes.CDLL(str(directory / "libwkv6_bwd.so"))
    lib.wkv6_bwd.restype = ctypes.c_int
    lib.wkv6_bwd.argtypes = [ctypes.c_void_p] * 19 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    return lambda: lib


def use(name: str) -> None:
    """Point the probed kernels' wrappers at variant ``name``'s libraries:
    their cached loaders are filled from the variant's directory (K4′ of a
    SRC variant through ``parent_lib_bwd``).  K4 and K4′ of a SRC variant
    plan their calls as that parent did (K4′ in one segment a (b, h) where
    the variant sets ``PLAN=one``)."""
    global SHIPPED_PLAN, SHIPPED_BWD_PLAN, SHIPPED_LIB_BWD
    from repro_torch.kernels import _build
    from repro_torch.kernels import wkv6 as wk
    SHIPPED_PLAN = SHIPPED_PLAN or wk.forward_plan
    SHIPPED_BWD_PLAN = SHIPPED_BWD_PLAN or wk.backward_plan
    SHIPPED_LIB_BWD = SHIPPED_LIB_BWD or wk._lib_bwd
    wk._lib_bwd = SHIPPED_LIB_BWD
    sets = VARIANTS.get(name, {})
    # (--kernel wkv6 times a parent's tf32 forward, planned as it was)
    wk.forward_plan = parent_plan if (MODE == "wkv6" and "SRC" in sets) else SHIPPED_PLAN
    wk.backward_plan = (parent_bwd_plan(sets.get("PLAN") == "one")
                        if ("wkv6_bwd" in KERNELS and "SRC" in sets) else SHIPPED_BWD_PLAN)
    shipped = _build.library
    _build.library = lambda kernel: ctypes.CDLL(str(variant_dir(name) / f"lib{kernel}.so"))
    try:
        for kernel in KERNELS:
            if kernel == "wkv6_bwd" and "SRC" in sets:
                wk._lib_bwd = parent_lib_bwd(variant_dir(name))
                continue
            module, loader = LOADERS.get(kernel, (kernel, "_lib"))
            fn = getattr(cs.counters()[module], loader)
            fn.cache_clear()
            fn()
    finally:
        _build.library = shipped


def model_checks(arch: str, variants) -> dict:
    """Per variant: the worst call of each probed kernel in a prefill and
    first decode step of ``arch`` on its own bf16 activations, and the drift
    ratio."""
    import torch
    cfg, model, params, tokens, lengths, max_len, extra = cs.model_setup(
        arch, cs.MODEL_RUNS.get(arch, {}))
    args = (params, tokens, lengths, max_len, extra)
    *plain16, tok, _ = cs.prefill_and_step(model, *args, cs.plain_kernels())
    *plain32, _, _ = cs.prefill_and_step(cs.fp32_activations(cfg), *args,
                                         cs.plain_kernels(), tok)
    far_plain = cs.max_diff(plain16, plain32)
    out = {}
    for name in variants:
        use(name)
        worst, reported = {}, {}
        *run, _, _ = cs.prefill_and_step(model, *args, cs.checked_kernels(worst, reported), tok)
        out[name] = {**{kernel: worst[kernel] for kernel in KERNELS},
                     **{key: reported[key] for key in ("wkv6_output", "wkv6_state")
                        if key in reported},
                     "drift_ratio": cs.max_diff(run, plain32) / far_plain}
        print(f"[model] {arch} {name} {json.dumps(out[name])}", flush=True)
    del model, params
    torch.cuda.empty_cache()
    return out


def kernel_cases(variants) -> dict:
    """Per variant: phase 3's cases of the probed kernels, their checks
    recorded, not held."""
    failures = []
    cs.require = lambda cond, what: cond or failures.append(what)
    cases = {
        "attention": {
            "K2 gemma2-2b window 4096": lambda: cs.decode_case(
                "gemma2-2b", 8, 4, 4736, 4096, 50.0, ring=False),
            "K2 gemma2-2b global": lambda: cs.decode_case(
                "gemma2-2b", 8, 4, 4736, 0, 50.0, ring=False),
            "K2 recurrentgemma-9b": lambda: cs.decode_case(
                "recurrentgemma-9b", 16, 1, 2048, 2048, 0.0, ring=True)},
        "wkv6": {label: (lambda args=args: cs.wkv6_case(*args, planned(*args)))
                 for label, args in WKV_CASES.items()},
    }[MODE]
    keys = ("limit_ratio", "out_ratio", "state_ratio", "fault_ratio", "ms", "library_ms",
            "bound_ms")
    out = {}
    for name in variants:
        use(name)
        failures.clear()
        out[name] = {case: {key: res[key] for key in keys if key in res}
                     for case, res in ((case, run()) for case, run in cases.items())}
        out[name]["failed_checks"] = list(failures)
    return out


# phase 3's K4 cases: wkv6_case's arguments but the segments
WKV_CASES = {
    "K4 rwkv6-7b": ("rwkv6-7b", len(cs.PROMPTS), max(cs.PROMPTS), 64, 64, cs.PROMPTS, 1000),
    "K4 rwkv6-7b one prompt": ("rwkv6-7b one prompt", 1, max(cs.PROMPTS), 64, 64,
                               (max(cs.PROMPTS),), 1000),
    "K4 calibration": ("calibration", 4, 256, 2, 32, (256,) * 4, 100)}


def planned(label, B, S, H, N, *rest) -> int:
    """The segments the probed variant's K4 plans for a case (bf16)."""
    import torch
    from repro_torch.kernels import wkv6 as wk
    return wk.forward_plan(B, H, S, N, torch.bfloat16)[0]


def wkv6_turns(variants) -> dict:
    """Per variant, K4's time on each of ``WKV_CASES``' inputs and an
    rwkv6-7b prefill at full width (``cs.PROMPTS``), by CUDA events in turns
    (the variants in order, then in reverse), each K4 call's device time
    (``torch.profiler``), and whether its output has the first variant's
    bits."""
    import torch
    from repro_torch.kernels import wkv6 as wk
    from repro_torch.serving.engine import make_prefill_fn
    out = {name: {} for name in variants}
    for label, (_, B, S, H, N, prompts, _) in WKV_CASES.items():
        args, first = cs.wkv6_inputs(B, S, H, N, prompts), None
        for name in variants:
            use(name)
            got = wk.wkv6(*args)
            first = got if first is None else first
            out[name][label] = dict(bitwise_first=all(torch.equal(x, y)
                                                      for x, y in zip(got, first)))
        for order in (list(variants), list(variants)[::-1]):
            for name in order:
                use(name)
                out[name][label].setdefault("ms", []).append(
                    cs.cuda_ms(lambda: wk.wkv6(*args), 20))
        for name in variants:
            use(name)
            out[name][label]["device_ms"] = passes_ms(lambda: wk.wkv6(*args))
            print(f"[turns] {label} {name} {json.dumps(out[name][label])}", flush=True)
        del args, first
        torch.cuda.empty_cache()
    cfg, model, params, tokens, lengths, max_len, extra = cs.model_setup("rwkv6-7b", {})
    prefill = make_prefill_fn(model, max_len)
    for order in (list(variants), list(variants)[::-1]):
        for name in order:
            use(name)
            out[name].setdefault("rwkv6-7b prefill", {}).setdefault("ms", []).append(
                cs.cuda_ms(lambda: prefill(params, tokens, lengths, **extra), 3))
    for name in variants:
        use(name)
        rec = out[name]["rwkv6-7b prefill"]
        rec["wkv6_device_ms"] = {key: ms for key, ms in passes_ms(
            lambda: prefill(params, tokens, lengths, **extra), 1).items() if "wkv6" in key}
        print(f"[turns] rwkv6-7b prefill {name} {json.dumps(rec)}", flush=True)
    del model, params
    torch.cuda.empty_cache()
    return out


# the phases between K4's WKV_PROF stamps (csrc/wkv6.cu): name → (from, to)
STAMP_PHASES = {"prep e^w": (1, 2), "prep slot wait": (2, 3), "prep column walks": (3, 4),
                "prep A walk": (4, 5), "mma level-32 and rd·S issue": (6, 7),
                "mma A·V issue": (7, 8), "mma retire": (8, 9), "mma state and outputs": (9, 10)}


def wkv6_stamps(variants) -> dict:
    """Per variant built with WKV_PROF: K4's clock64 stamps of block (0, 0,
    0) at rwkv6-7b's row, the mean cycles of each of ``STAMP_PHASES`` and
    the chunk period over chunks 2-14 of the first 16."""
    import torch
    from repro_torch.kernels import wkv6 as wk
    _, B, S, H, N, prompts, _ = WKV_CASES["K4 rwkv6-7b"]
    args = cs.wkv6_inputs(B, S, H, N, prompts)
    out = {}
    for name, sets in variants.items():
        if "WKV_PROF" not in sets:
            continue
        use(name)
        lib = wk._lib()
        lib.wkv6_prof.restype = ctypes.c_int
        lib.wkv6_prof.argtypes = [ctypes.c_void_p]
        wk.wkv6(*args)
        torch.cuda.synchronize()
        raw = (ctypes.c_longlong * (16 * 11))()
        if lib.wkv6_prof(raw):
            raise RuntimeError(f"wkv6_prof of {name} failed")
        rows = [raw[11 * i:11 * (i + 1)] for i in range(16)]
        span = range(2, 15)
        rec = {phase: sum(rows[i][b] - rows[i][a] for i in span) / len(span)
               for phase, (a, b) in STAMP_PHASES.items()}
        rec["period"] = sum(rows[i + 1][6] - rows[i][6] for i in span) / len(span)
        out[name] = rec
        print(f"[stamps] {name} {json.dumps(rec)}", flush=True)
    return out


# the phases between K4′'s WKV_BWD_PROF stamps (csrc/wkv6_bwd.cu), a chunk of
# the reverse walk: name → (from, to)
BWD_STAMP_PHASES = {
    "prep e^w and the decays": (0, 1), "prep slot wait": (1, 2),
    "prep the levels' operands": (2, 3), "prep A's diagonal walks": (3, 4),
    "prep the exchange (paced by the MMA's levels)": (4, 5), "prep P's blocks wait": (5, 6),
    "prep dr's and dk's diagonal walks": (6, 7), "prep r ⊙ pd": (7, 8),
    "prep F region wait": (8, 9), "prep k ⊙ sd": (9, 10), "prep outputs and dlogw": (10, 11),
    "mma first products, slot wait": (12, 13), "mma the levels' dr and dk": (13, 14),
    "mma A's products": (14, 15), "mma r ⊙ pd wait": (15, 16), "mma chain and dv": (16, 17),
    "mma dv out, Go carried": (17, 18)}


def wkv6_bwd_stamps(variants) -> dict:
    """Per variant built with WKV_BWD_PROF: K4′'s clock64 stamps of block
    (0, 0) at rwkv6-7b's training row, the mean cycles of each of
    ``BWD_STAMP_PHASES`` and the chunk period over chunks 2-14 of the
    first 16 of the reverse walk, and the forward walk's period."""
    import torch
    from repro_torch.kernels import wkv6 as wk
    args = cs.wkv6_bwd_inputs(*cs.WKV_BWD_SHAPES["rwkv6-7b"])
    out = {}
    for name, sets in variants.items():
        if "WKV_BWD_PROF" not in sets:
            continue
        use(name)
        lib = wk._lib_bwd()
        lib.wkv6_bwd_prof.restype = ctypes.c_int
        lib.wkv6_bwd_prof.argtypes = [ctypes.c_void_p]
        wk.wkv6_bwd(*args)
        torch.cuda.synchronize()
        chunks, stamps = 16, 19
        raw = (ctypes.c_longlong * (2 * chunks * stamps))()
        if lib.wkv6_bwd_prof(raw):
            raise RuntimeError(f"wkv6_bwd_prof of {name} failed")
        rows = [raw[stamps * i:stamps * (i + 1)] for i in range(2 * chunks)]
        span = range(2, 15)
        rec = {phase: sum(rows[i][b] - rows[i][a] for i in span) / len(span)
               for phase, (a, b) in BWD_STAMP_PHASES.items()}
        rec["period"] = sum(rows[i + 1][12] - rows[i][12] for i in span) / len(span)
        fwd = rows[chunks:]
        rec["forward walk period"] = sum(fwd[i + 1][3] - fwd[i][3] for i in span) / len(span)
        out[name] = rec
        print(f"[stamps] wkv6_bwd {name} {json.dumps(rec)}", flush=True)
    return out


# bf16 rows at N = 64 about the wgmma kernel's cut (wk.BWD_WGMMA_HEADS):
# label → (B, S, H, N, dtype of r/k/v/do)
WKV_BWD_CUT_SHAPES = {"B 1, 64 heads": (1, 2048, 64, 64, "bfloat16"),
                      "B 1, 96 heads": (1, 2048, 96, 64, "bfloat16"),
                      "B 2, 64 heads": (2, 2048, 64, 64, "bfloat16"),
                      "B 1, 132 heads": (1, 2048, 132, 64, "bfloat16")}


def wkv6_bwd_cut(variants) -> dict:
    """Per variant that sets nothing (the shipped build): K4′'s two kernels
    on the same inputs at ``WKV_BWD_CUT_SHAPES``, whatever
    ``wk.backward_plan`` routes there: the wgmma kernel (one segment, chunks
    of 64) and the tf32 kernel (``plan_bwd_segments``), each one's limit
    ratio (``chip_smoke.wkv_bwd_limits``), times in turns (wgmma, tf32,
    tf32, wgmma) and each launch's device time."""
    import torch
    from repro_torch.kernels import wkv6 as wk
    out = {}
    for name, sets in variants.items():
        if sets:
            continue
        use(name)
        rec = out[name] = {}
        for label, (B, S, H, N, dtype) in WKV_BWD_CUT_SHAPES.items():
            args = cs.wkv6_bwd_inputs(B, S, H, N, dtype)
            P, Lc = wk.plan_bwd_segments(B, H, S)
            kernels = {"wgmma": lambda: wk._bwd_wgmma(*args),
                       "tf32": lambda: wk._bwd_tf32(*args, P=P, Lc=Lc)}
            want = wk.plain_grad(*args, acc=torch.float64)
            limits = cs.wkv_bwd_limits(*args)
            row = rec[label] = {"routed": wk.backward_plan(B, H, S, N, args[0].dtype),
                                "tf32_plan": [P, Lc]}
            for kernel, fn in kernels.items():
                row[f"{kernel}_limit_ratio"] = cs.held_bwd(fn(), want, limits)[1]
            del want, limits
            for kernel in ("wgmma", "tf32", "tf32", "wgmma"):
                row.setdefault(f"{kernel}_ms", []).append(cs.cuda_ms(kernels[kernel], 10))
            for kernel, fn in kernels.items():
                row[f"{kernel}_launches_ms"] = passes_ms(fn)
            print(f"[cut] wkv6_bwd {label} {name} {json.dumps(row)}", flush=True)
            del args
            torch.cuda.empty_cache()
    return out


# phase 3's K1 cases (and phase 18's training shape): (q, k, v, kwargs, rows
# compared per sequence or None)
K1_CASES = {
    "K1 gemma2-2b window 4096": lambda: (*cs.flash_inputs(8, 4, 4096, 50.0), cs.PROMPTS),
    "K1 gemma2-2b global": lambda: (*cs.flash_inputs(8, 4, 0, 50.0), cs.PROMPTS),
    "K1 recurrentgemma-9b": lambda: (*cs.flash_inputs(16, 1, 2048, 0.0), cs.PROMPTS),
    "K1 granite-moe-3b-a800m": lambda: (*cs.flash_inputs(24, 8, 0, 0.0, d=64), cs.PROMPTS),
    "K1 dbrx-132b": lambda: (*cs.flash_inputs(48, 8, 0, 0.0, d=128), cs.PROMPTS),
    "K1 whisper-tiny encoder": lambda: (*cs.flash_cross_inputs(4, 6, 1500, 1500, 64),
                                        dict(causal=False), None),
    "K1 whisper-tiny cross-attention": lambda: (*cs.flash_cross_inputs(4, 6, 432, 1500, 64),
                                                dict(causal=False), None),
    "K1 llava-next-34b": lambda: (*cs.flash_inputs(56, 8, 0, 0.0, d=128,
                                                   prompts=cs.LLAVA_LENGTHS), cs.LLAVA_LENGTHS),
    "K1 granite-3-2b train": lambda: (*cs.flash_inputs(32, 8, 0, 0.0, d=64,
                                                       prompts=(2048,) * 4), None),
}


def k1_cases(variants) -> dict:
    """Per variant, on each of ``K1_CASES``: the limit ratio against the
    float64 plain version (computed once a case), whether two calls give
    the same bits, the time by CUDA events (the variants in order, then in
    reverse) and each launch's device time (``torch.profiler``)."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    out = {name: {} for name in variants}
    for label, make in K1_CASES.items():
        q, k, v, kw, rows = make()
        want = cs.flash_want(q, k, v, **kw)
        for name in variants:
            use(name)
            got, again = fa.flash_attention(q, k, v, **kw), fa.flash_attention(q, k, v, **kw)
            err, ratio = cs.held(got, want, rows)
            out[name][label] = dict(limit_ratio=ratio, max_abs_err=err,
                                    bitwise_twice=torch.equal(got, again))
            del got, again
        del want
        for order in (list(variants), list(variants)[::-1]):
            for name in order:
                use(name)
                out[name][label].setdefault("ms", []).append(
                    cs.cuda_ms(lambda: fa.flash_attention(q, k, v, **kw), 10))
        for name in variants:
            use(name)
            out[name][label]["device_ms"] = passes_ms(lambda: fa.flash_attention(q, k, v, **kw))
            print(f"[case] {label} {name} {json.dumps(out[name][label])}", flush=True)
        del q, k, v
        torch.cuda.empty_cache()
    for name in variants:
        out[name]["worst_k1_limit_ratio"] = max(c["limit_ratio"] for c in out[name].values())
    return out


def passes_ms(fn, reps: int = 3) -> dict:
    """Device milliseconds a call of each kernel that ``fn`` launches
    (``torch.profiler`` over ``reps`` calls after a warm-up one)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    def short(key):   # "void ns::(anonymous namespace)::name<T, 64>(args)" → "name<T, 64>"
        return re.sub(r"^void |\w+::|\(anonymous namespace\)::", "", key).split("(")[0][:80]
    return {short(e.key): e.device_time_total / 1e3 / reps for e in prof.key_averages()
            if e.device_time_total > 0}


def legacy_flash(q, k, v, *, causal, window, softcap, lengths):
    """K1 through the C entry point of a forward that keeps no state for
    the backward, for a SRC variant built from such a source."""
    import math
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    fn = fa._lib().flash_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + [ctypes.c_float,
                                                                 ctypes.c_float, ctypes.c_void_p]
    B, H, Sq, d = q.shape
    out = torch.empty_like(q)
    strides = (ctypes.c_longlong * 12)(*(q.stride()[:3] + k.stride()[:3] + v.stride()[:3]
                                         + out.stride()[:3]))
    _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    None if lengths is None else lengths.data_ptr(), strides, B, H,
                    k.shape[1], Sq, k.shape[2], d, fa.DTYPES[q.dtype], int(causal),
                    int(window), float(softcap), 1.0 / math.sqrt(d),
                    torch.cuda.current_stream().cuda_stream), "legacy flash_attention")
    return out


def legacy_flash_bwd(q, k, v, dout, *, causal, window, softcap, lengths):
    """K1′ through the C entry point of a backward that sweeps for its own
    statistics (lse and D scratch of 64-row pitch), for a SRC variant built
    from such a source."""
    import math
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    fn = fa._lib_bwd().flash_attention_bwd
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 9 + [ctypes.c_float,
                                                                  ctypes.c_float, ctypes.c_void_p]
    B, H, Sq, d = q.shape
    if dout.stride(-1) != 1 or any(st * 2 % 16 for st in dout.stride()[:-1]):
        dout = dout.contiguous()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    stats = torch.empty((2, B, H, -(-Sq // 64) * 64), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 21)(*(st for t in (q, k, v, dout, dq, dk, dv)
                                         for st in t.stride()[:3]))
    _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), dq.data_ptr(),
                    dk.data_ptr(), dv.data_ptr(), stats[0].data_ptr(), stats[1].data_ptr(),
                    None if lengths is None else lengths.data_ptr(), strides, B, H,
                    k.shape[1], Sq, k.shape[2], d, fa.DTYPES[q.dtype], int(causal),
                    int(window), float(softcap), 1.0 / math.sqrt(d),
                    torch.cuda.current_stream().cuda_stream), "legacy flash_attention_bwd")
    return dq, dk, dv


def bwd_cases(variants) -> dict:
    """Per variant, on each of phase 18's K1′ cases: the limit ratio of dq,
    dk and dv against the float64 plain version, whether two calls give the
    same bits, the backward's time given the forward's state (the variants
    in order, then in reverse) and each kernel's; K1's forward on the same
    inputs, its time and whether it has the first variant's bits; for the
    first variant, the limit ratio with D from K1's bf16 output.  A SRC
    variant runs through the parent's entry points (``legacy_flash*``)."""
    import torch
    from repro_torch.kernels import flash_attention as fa

    def runners(name, q, k, v, kw):
        """(forward, backward of dout) of variant ``name`` on these inputs."""
        if "SRC" in variants[name]:
            return (lambda: legacy_flash(q, k, v, **kw),
                    lambda dout: legacy_flash_bwd(q, k, v, dout, **kw))
        state = fa.flash_attention(q, k, v, return_stats=True, **kw)[1:]
        return (lambda: fa.flash_attention(q, k, v, **kw),
                lambda dout: fa.flash_attention_bwd(q, k, v, dout, *state, **kw))

    out = {name: {} for name in variants}
    first_name = next(iter(variants))
    for cases in cs.FLASH_BWD_CASES.values():
        for label, case in cases:
            q, k, v, dout, kw = cs.flash_bwd_inputs(**case)
            want = cs.flash_bwd_want(q, k, v, dout, **kw)
            first = None   # K1's output from the first variant's build
            run = {}
            for name in variants:
                use(name)
                fwd, bwd = run[name] = runners(name, q, k, v, kw)
                got, again = bwd(dout), bwd(dout)
                _, ratio, parts = cs.held_grads(got, want)
                o = fwd()
                first = o if first is None else first
                rec = out[name][label] = dict(
                    limit_ratio=ratio, limit_ratio_dq_dk_dv=parts,
                    bitwise_twice=all(torch.equal(a, b) for a, b in zip(got, again)),
                    k1_bitwise_first=torch.equal(o, first),
                    k1_ms=cs.cuda_ms(fwd, 3))
                if name == first_name and q.dtype == torch.bfloat16 \
                        and "SRC" not in variants[name]:
                    o16 = o.float().contiguous()   # D from the bf16 output
                    lse = fa.flash_attention(q, k, v, return_stats=True, **kw)[2]
                    rec["limit_ratio_d_from_bf16_output"] = cs.held_grads(
                        fa.flash_attention_bwd(q, k, v, dout, o16, lse, **kw), want)[1]
                    del o16, lse
                del got, again, o
            del want, first
            for order in (list(variants), list(variants)[::-1]):
                for name in order:
                    use(name)
                    bwd = run[name][1]
                    out[name][label].setdefault("ms", []).append(cs.cuda_ms(lambda: bwd(dout), 3))
            for name in variants:
                use(name)
                bwd = run[name][1]
                out[name][label]["passes_ms"] = passes_ms(lambda: bwd(dout))
                print(f"[case] {label} {name} {json.dumps(out[name][label])}", flush=True)
            del run
            torch.cuda.empty_cache()
    for name in variants:
        out[name]["worst_limit_ratio"] = max(c["limit_ratio"] for c in out[name].values())
    return out


def recurrent_cases(variants) -> dict:
    """Per variant: K3′ at phase 19 (a)'s two cases, its outputs bitwise
    against the first variant's and, where the variant plans a ring,
    against its own register kernel; K4′ at phase 19 (a)'s four cases, each
    output's limit ratio (``chip_smoke.wkv_bwd_limits``), its plan and
    whether two calls give the same bits; the times of both, the variants
    in order, then in reverse, and each launch's device time; then K3's and
    K4's forward on phase 3's inputs, their times in turns and whether their
    outputs have the first variant's bits.  A SRC variant runs through the
    current entry points, ``rglru_scan_bwd`` and the tf32 ``wkv6_bwd`` (the
    tf32 kernel at every shape, ``parent_bwd_plan``)."""
    import torch
    from repro_torch.kernels import rglru_scan as rg
    from repro_torch.kernels import wkv6 as wk

    def runner(name, kernel):
        return rg.rglru_scan_bwd if kernel == "rglru_scan_bwd" else wk.wkv6_bwd
    cases = [(f"K3′ {dtype}", "rglru_scan_bwd", lambda dtype=dtype: cs.rglru_bwd_inputs(dtype))
             for dtype in ("float32", "bfloat16")]
    cases += [(f"K4′ {label}", "wkv6_bwd", lambda shape=shape: cs.wkv6_bwd_inputs(*shape))
              for label, shape in cs.WKV_BWD_SHAPES.items()]
    out = {name: {} for name in variants}
    for label, kernel, make in cases:
        args = make()
        checked = kernel == "wkv6_bwd"
        if checked:
            want = wk.plain_grad(*args, acc=torch.float64)
            limits = cs.wkv_bwd_limits(*args)
        first = None
        for name in variants:
            use(name)
            run = runner(name, kernel)
            got, again = run(*args), run(*args)
            plan = None if checked or "SRC" in variants[name] else rg.last_bwd_plan
            first = got if first is None else first
            rec = out[name][label] = dict(
                bitwise_twice=all(torch.equal(x, y) for x, y in zip(got, again)),
                bitwise_first=all(torch.equal(x, y) for x, y in zip(got, first)))
            if checked:
                rec["limit_ratio"], rec["ratios"] = cs.held_bwd(got, want, limits)[1:]
                B, S, H, N = args[0].shape
                rec["plan"] = wk.backward_plan(B, H, S, N, args[0].dtype)
            elif "SRC" not in variants[name]:
                regs = rg.rglru_scan_bwd(*args, use=rg.REGISTER)
                rec["plan"] = plan._asdict()
                rec["ring_equals_register"] = all(torch.equal(x, y) for x, y in zip(got, regs))
            del got, again
        if checked:
            del want, limits
        for order in (list(variants), list(variants)[::-1]):
            for name in order:
                use(name)
                run = runner(name, kernel)
                out[name][label].setdefault("ms", []).append(cs.cuda_ms(lambda: run(*args), 5))
        for name in variants:
            use(name)
            run = runner(name, kernel)
            out[name][label]["launches_ms"] = passes_ms(lambda: run(*args))
            print(f"[case] {label} {name} {json.dumps(out[name][label])}", flush=True)
        del args, first
        torch.cuda.empty_cache()
    forward = [("K3 fp32", rg.rglru_scan, lambda: cs.rglru_inputs("float32")),
               ("K3 bf16", rg.rglru_scan, lambda: cs.rglru_inputs("bfloat16")),
               ("K4 rwkv6-7b", wk.wkv6,
                lambda: cs.wkv6_inputs(len(cs.PROMPTS), max(cs.PROMPTS), 64, 64, cs.PROMPTS)),
               ("K4 calibration", wk.wkv6, lambda: cs.wkv6_inputs(4, 256, 2, 32, (256,) * 4))]
    for label, fn, make in forward:
        args, first = make(), None
        for name in variants:
            use(name)
            got = fn(*args)
            first = got if first is None else first
            out[name][label] = dict(bitwise_first=all(torch.equal(x, y)
                                                      for x, y in zip(got, first)))
        for order in (list(variants), list(variants)[::-1]):
            for name in order:
                use(name)
                out[name][label].setdefault("ms", []).append(cs.cuda_ms(lambda: fn(*args), 10))
        for name in variants:
            print(f"[case] {label} {name} {json.dumps(out[name][label])}", flush=True)
        del args, first
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("parity_probe: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    global MODE, KERNELS, ARCHS, VARIANTS
    args = sys.argv[1:]
    if args[:1] == ["--kernel"]:
        MODE, args = args[1], args[2:]
    KERNELS, ARCHS, default = MODES[MODE]
    variants = VARIANTS = parse(args) or {"shipped": {}, **default}
    cs.phase_device()
    result = {name: {"switches": sets} for name, sets in variants.items()}
    for name, regs in build(variants).items():
        result[name]["ptxas"] = regs
        print(f"[ptxas] {name} {json.dumps(regs)}", flush=True)
    for arch in ARCHS:
        for name, rec in model_checks(arch, variants).items():
            result[name][arch] = rec
    cases = {"flash_bwd": bwd_cases, "recurrent_bwd": recurrent_cases}.get(MODE, kernel_cases)
    for name, rec in cases(variants).items():
        result[name]["cases"] = rec
    if MODE == "attention":
        for name, rec in k1_cases(variants).items():
            result[name]["k1_cases"] = rec
    if MODE == "wkv6":
        for name, rec in wkv6_turns(variants).items():
            result[name]["turns"] = rec
        for name, rec in wkv6_stamps(variants).items():
            result[name]["stamps"] = rec
    if MODE == "recurrent_bwd":
        for name, rec in wkv6_bwd_stamps(variants).items():
            result[name]["stamps"] = rec
        for name, rec in wkv6_bwd_cut(variants).items():
            result[name]["cut"] = rec
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
