"""Where a served batch's time goes: one prefill and a few decode steps of a
full-width model under ``torch.profiler``, on the card.

  PYTHONPATH=src python -m repro_torch.launch.profile_step [--arch NAME]

runs a model of the catalog (gemma2-2b unless ``--arch`` names another) at
batch 8 with 512-token prompts and 15 decode steps (the module constants
below; an encoder-decoder, whisper-tiny, gets 1500 stub frames from a seed,
its encoder's 30 s of audio, and 432-token prompts, so that prompt and steps
stay within its 448-token decoder context), and prints, for the prefill and
for the mean decode step: wall time (host clock around work that ends in
``torch.cuda.synchronize()``), device busy time (the union of the kernel
intervals in the trace), the device's idle share, the number of kernels
launched, the kernels that take the most device time, the device time of
each of the port's own kernels, and the least time a step that reads every
weight once could take (``weight_read_bound_ms``: the parameter bytes over
the card's 3.35 TB/s).
For an MoE arch it also gives the device time of the MoE block's parts
(``moe_ms``: route, dispatch, the expert products, gather; "other" the
block's remaining elementwise work) and the expert weights' share of the
read bound (``expert_read_bound_ms``): the reference's capacity dispatch
runs every expert's buffer, so a decode step reads all of them.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import time
from collections import defaultdict

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import hw, resolve_device
from repro_torch.configs import get_config
from repro_torch.models import build_model, moe
from repro_torch.models.registry import count_params
from repro_torch.serving.engine import (greedy_sample, make_decode_fn,
                                        make_prefill_fn, serving_config)

BATCH = 8
PROMPT_TOKENS = 512
DECODE_STEPS = 15
ENCDEC_FRAMES = 1500
ENCDEC_PROMPT_TOKENS = 432
# the MoE block's parts, each a function of models/moe.py the profile wraps
# in a span of its own; "block" spans the whole of moe_apply
MOE_SPANS = {"block": "moe_apply", "route": "_route", "dispatch": "_dispatch_indices",
             "scatter": "_scatter_local", "experts": "_expert_ffn", "gather": "_gather_local"}


@contextlib.contextmanager
def moe_spans():
    """``torch.profiler.record_function`` spans ("moe.route", ...) around the
    MoE block's parts while profiling; the package itself carries none.
    ``_moe_core`` and ``moe_apply`` look the parts up in the module when
    called, so the wrapped ones run inside the block."""
    saved = {name: getattr(moe, fn) for name, fn in MOE_SPANS.items()}

    def spanned(name, fn):
        def run(*args, **kw):
            with torch.profiler.record_function(f"moe.{name}"):
                return fn(*args, **kw)
        return run
    for name, fn in saved.items():
        setattr(moe, MOE_SPANS[name], spanned(name, fn))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(moe, MOE_SPANS[name], fn)


def _busy(events) -> float:
    """Microseconds during which at least one kernel ran."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, end = 0.0, float("-inf")
    for s, e in spans:
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


def _window(fn, n: int):
    """Profile ``fn`` run n times → (wall ms per run, device-busy ms per run,
    kernels per run, top kernels by device ms per run, the port's kernels'
    device ms per run, the MoE spans' device ms per run)."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n
    spans = {f"moe.{name}" for name in MOE_SPANS}
    # device-side copies of the spans (annotations, not kernels) are left out
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA and e.name not in spans]
    if not kernels:
        raise RuntimeError("the trace holds no device activity")
    per_name = defaultdict(float)
    for e in kernels:
        per_name[e.name] += e.time_range.elapsed_us() / 1e3 / n
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:8]
    port = {k: v for k, v in per_name.items() if "repro_torch" in k}
    # a span's device time: the kernels launched inside it (CPU-side events)
    moe_ms = defaultdict(float)
    for e in prof.events():
        if e.name in spans and e.device_type == torch.autograd.DeviceType.CPU:
            moe_ms[e.name[4:]] += e.device_time_total / 1e3 / n
    if moe_ms:
        moe_ms["other"] = moe_ms["block"] - sum(v for k, v in moe_ms.items() if k != "block")
    return wall, _busy(kernels) / 1e3 / n, len(kernels) / n, top, port, dict(moe_ms)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2-2b")
    arch = ap.parse_args().arch
    dev = resolve_device("cuda")
    cfg = serving_config(get_config(arch))
    model = build_model(cfg, dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    bw = hw.HARDWARE["h100"].hbm_bw
    width = torch.finfo(model.pdt).bits // 8
    bounds = {"weight_read_bound_ms": count_params(model.param_shapes()) * width / bw * 1e3}
    if cfg.is_moe:
        experts = cfg.num_layers * 3 * cfg.num_experts * cfg.d_model * cfg.d_ff
        bounds["expert_read_bound_ms"] = experts * width / bw * 1e3
    B, S = BATCH, ENCDEC_PROMPT_TOKENS if cfg.is_encdec else PROMPT_TOKENS
    toks = torch.ones((B, S), dtype=torch.int32, device=dev)
    lens = torch.full((B,), S, dtype=torch.int32, device=dev)
    extra = {}
    if cfg.is_encdec:
        extra["frames"] = torch.randn((B, ENCDEC_FRAMES, cfg.d_model), device=dev,
                                      generator=torch.Generator(device=dev).manual_seed(1))
    prefill = make_prefill_fn(model, S + DECODE_STEPS + 1)
    decode = make_decode_fn(model)
    state = {}

    def run_prefill():
        state["cache"], logits = prefill(params, toks, lens, **extra)
        state["tok"] = greedy_sample(logits)

    def run_decode():
        state["cache"], logits = decode(params, state["cache"], state["tok"])
        state["tok"] = greedy_sample(logits)

    run_prefill()
    run_decode()                                 # warm-up
    for name, fn, n in (("prefill", run_prefill, 1),
                        ("decode_step", run_decode, DECODE_STEPS)):
        if name == "prefill":
            fn()                                 # a second warm prefill
        with moe_spans():
            wall, busy, count, top, port, moe_ms = _window(fn, n)
        print(json.dumps({
            "phase": name, "arch": arch, "batch": B, "prompt_tokens": S,
            **({"frames": ENCDEC_FRAMES} if cfg.is_encdec else {}),
            "wall_ms": wall, "device_busy_ms": busy,
            "device_idle_share": 1.0 - busy / wall, "kernels": count,
            "top_kernels_ms": {k[:80]: v for k, v in top},
            "port_kernels_ms": port, **({"moe_ms": moe_ms} if cfg.is_moe else {}),
            **bounds}))


if __name__ == "__main__":
    main()
