"""K3's variants and ring shapes timed on the card: the measurements behind
``repro_torch.kernels.rglru_scan.plan``.

    PYTHONPATH=src python -m repro_torch.launch.sweep_rglru [--json PATH]
    PYTHONPATH=src python -m repro_torch.launch.sweep_rglru --calibration N [--register]

For each shape (recurrentgemma-9b's prefill in ``chip_smoke.py``, B=4
S=4700 R=4096; a batch of one; ``profile_step.py``'s batch 8 of 512; the
calibration sweep's largest point, B=4 S=256 R=256), in fp32 and bf16, it
runs the register variant, the planner's plan and a grid of ring shapes
(C in ``RING_CHANNELS``, T from 16 to 128, P from 1 to 8, within a block's
shared memory), holds each bitwise to the plain version, and prints one JSON
line per shape: each plan's milliseconds (CUDA events around 10
back-to-back calls, the better of 2 runs), the planner's plan, the bytes
bound, and the card's name and power limit.  ``--json`` also writes the
lines to PATH.  ``--calibration N`` instead runs the calibration sweep's
``rglru_scan`` points (``kernel_records``, both types) N times and prints,
per run and type, the fit's coefficients and the mean and per-point wall
latencies: K3's side of ``chip_smoke.py`` phase 10, repeated to show its
spread (with ``--register``, every call held to the register variant, the
planner's alternative at these sizes).  Without ``--register`` it reads
nothing of the planner, so it also runs against a tree whose K3 has none.
Needs a card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
from typing import Any, Dict, List

import torch

from repro_torch import resolve_device
from repro_torch.kernels import rglru_scan as rg

SHAPES = ((4, 4700, 4096), (1, 4700, 4096), (8, 512, 4096), (4, 256, 256))
STEPS = (16, 32, 64, 128)
STAGES = (1, 2, 3, 4, 6, 8)
PEAK_BYTES = 3.35e12       # H100 SXM HBM3 bandwidth


def _ms(fn, reps: int = 10, runs: int = 2) -> float:
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(runs):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / reps)
    return best


def sweep_shape(B: int, S: int, R: int, dtype: torch.dtype, dev) -> Dict[str, Any]:
    """Every plan of the grid at one shape: {"C,T,P" or "register": ms}."""
    g = torch.Generator(device=dev).manual_seed(0)
    a = (0.5 + 0.499 * torch.rand((B, S, R), generator=g, device=dev)).to(dtype)
    b = (0.1 * torch.randn((B, S, R), generator=g, device=dev)).to(dtype)
    s0 = torch.randn((B, R), generator=g, device=dev)
    want = rg.plain(a, b, s0)
    item = a.element_size()
    plans: List[rg.Plan] = [rg.REGISTER] + [
        rg.Plan("ring", C, T, P) for C in rg.RING_CHANNELS for T in STEPS for P in STAGES
        if rg.Plan("ring", C, T, P).smem_bytes(item) <= rg.SMEM_PER_BLOCK and T * P <= 2 * S]
    times = {}
    for p in plans:
        got = rg.rglru_scan(a, b, s0, use=p)
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            raise AssertionError(f"rglru_scan {p} at B={B} S={S} R={R} {dtype} differs "
                                 "from its plain version")
        key = "register" if p.variant == "register" else f"{p.channels},{p.steps},{p.stages}"
        times[key] = _ms(lambda: rg.rglru_scan(a, b, s0, use=p))
    chosen = rg.plan(B, S, R, item, torch.cuda.get_device_properties(dev).multi_processor_count)
    best = min((k for k in times if k != "register"), key=times.get)
    return {"B": B, "S": S, "R": R, "dtype": str(dtype).split(".")[1],
            "plan": chosen._asdict(),
            "plan_ms": times[f"{chosen.channels},{chosen.steps},{chosen.stages}"],
            "best": best, "best_ms": times[best], "register_ms": times["register"],
            "bound_ms": item * 3.0 * B * S * R / PEAK_BYTES * 1e3, "ms": times}


def calibration_runs(n: int, card: str) -> None:
    """K3's calibration points, n times over: one JSON line per run and type."""
    from repro_torch.calibrate import fit_kernel_records, kernel_records
    for run in range(n):
        records = kernel_records(["rglru_scan"])
        for key, fit in sorted(fit_kernel_records(records).items()):
            points = {f"B={r['batch']} S={r['tokens']}": r["result"]["latency_s"]
                      for r in records if f"{r['kernel']}/{r['dtype']}" == key}
            print(json.dumps({"card": card, "run": run, "fit": key,
                              "coef": list(fit["coef"]),
                              "mean_latency_s": sum(points.values()) / len(points),
                              "latency_s": points}), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--json", default=None)
    ap.add_argument("--calibration", type=int, default=0)
    ap.add_argument("--register", action="store_true")
    args = ap.parse_args()
    dev = resolve_device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    if args.calibration:
        if args.register:
            rg.plan = lambda *a, **kw: rg.REGISTER
        calibration_runs(args.calibration, card)
        return
    lines = []
    for B, S, R in SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            line = json.dumps({"card": card, **sweep_shape(B, S, R, dtype, dev)})
            print(line, flush=True)
            lines.append(line)
    if args.json:
        with open(args.json, "w") as f:
            f.write("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
