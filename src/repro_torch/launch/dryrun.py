"""Dry-run: every (arch × shape) cell on meta tensors, ported from
``repro.launch.dryrun``.

Two passes per cell:

1. PRODUCTION pass — the real step at the real shape, run once on meta
   tensors (shapes and dtypes, nothing allocated or computed), so shape
   errors surface here.  ``memory`` holds the operands' bytes
   (``argument_bytes``, exact), the outputs' (``output_bytes``, of which
   ``alias_bytes`` are operands updated in place), and the peak of the live
   bytes tracked over the run (``peak_bytes``; ``temp_bytes`` is the peak
   above the operands).  The reference compiles instead, and its
   ``lower_s``/``compile_s`` become the seconds to build the cell and to
   run it.  The port's layers are a Python loop, so this run's costs
   (``production_costs_scan_body_once``, the reference's key) count every
   layer.

2. COST pass — two depth-reduced variants of the same model counted
   (``launch/costing.py``) and extrapolated to the full depth:

       total = cost(d1) + (n_full − n1)·(cost(d2) − cost(d1))

   then ``memory_model.estimate_bytes`` and the roofline on ``hw.GPU_H100``
   (``analysis/roofline.py``): accounting on the card's data-sheet rates,
   not a timing.

Meshes (``--mesh``):
  one      the port's card, no mesh (the default: the one-card pass, records
           ``{arch}__{shape}__single.json`` with ``"mesh": "1"``);
  single   the reference's 16 × 16 pod, ``"mesh": "16x16"``;
  multi    its two pods, 2 × 16 × 16, ``"mesh": "2x16x16"``;
  both     single and multi.
A production mesh is a ``DeviceMesh`` over a fake group in this process
(``launch/mesh.py``): the cell's operands are DTensors over meta blocks,
every count is per device, and the collectives DTensor issues are counted
by kind (``launch/costing.py``); the roofline runs at the mesh's chip count
with the collective term at ``hw.GPU_H100.link_bw``.  Their records are
``{arch}__{shape}__{16x16|2x16x16}[__{rules}].json``.  ``--rules`` takes the
reference's seven rule sets (``dist.sharding.RULE_SETS``) on a production
mesh; on one device only the default.  An MoE arch's mesh records say which
of ``models/moe.py``'s modes its blocks ran in (``moe_mode``): ep_local
needs the experts to divide over "model", so granite-moe-3b-a800m's 40 run
gspmd under ``--rules ep_local`` at 16 × 16 and dbrx-132b's 16 run
ep_local.

Usage (the reference's flags):
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --shape all \\
      --mesh both --out out/dryrun

Nothing runs on a device, so there is no ``--device``.
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import json
import multiprocessing
import os
import time
import traceback
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path
from typing import Optional

from repro_torch.analysis import memory_model
from repro_torch.analysis import roofline as roofline_lib
from repro_torch.configs import ARCHS, SHAPES, applicable, get_config
from repro_torch.dist import sharding as shd
from repro_torch.launch.cells import build_cell
from repro_torch.launch.costing import (count, count_costs, depth_variants, extrapolate,
                                        shared_bytes, storage_bytes)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.moe import mode_name

RULE_SETS = shd.RULE_SETS
MESHES = {"one": [None], "single": [False], "multi": [True], "both": [False, True]}


def record_tag(arch: str, shape: str, multi_pod: Optional[bool] = None,
               rules: str = "default") -> str:
    """A record's file name (no suffix)."""
    if multi_pod is None:
        return f"{arch}__{shape}__single"
    return (f"{arch}__{shape}__{'2x16x16' if multi_pod else '16x16'}"
            + ("" if rules == "default" else f"__{rules}"))


def run_cell(arch: str, shape_name: str, multi_pod: Optional[bool] = None,
             rules_name: str = "default", grad_accum: int = 1,
             remat: bool = True, cost_pass: bool = True) -> dict:
    """One cell's record: on the port's one device (``multi_pod`` None), or
    on the reference's 16 × 16 (False) or 2 × 16 × 16 (True) mesh."""
    if multi_pod is None and rules_name != "default":
        raise ValueError(f"rules {rules_name!r} need a production mesh (--mesh single, "
                         "multi or both)")
    shape = SHAPES[shape_name]
    cfg = get_config(arch)
    rec = {"arch": arch, "shape": shape_name,
           "mesh": "1" if multi_pod is None else "2x16x16" if multi_pod else "16x16",
           "rules": rules_name, "ok": False}
    if not applicable(shape, cfg):
        rec.update(ok=True, skipped=True,
                   reason="long_500k needs sub-quadratic attention; "
                          "this arch has global full attention")
        return rec
    kw = dict(grad_accum=grad_accum, remat=remat) if shape.kind == "train" else {}
    try:
        # ---- production pass --------------------------------------------
        t0 = time.time()
        mesh = None if multi_pod is None else make_production_mesh(multi_pod=multi_pod)
        rules = RULE_SETS[rules_name]
        cell = build_cell(arch, shape_name, mesh, rules, **kw)
        t1 = time.time()
        argument_bytes = storage_bytes(cell.args)
        outputs, prod_costs, peak = count(cell.fn, *cell.args)
        t2 = time.time()
        output_bytes = storage_bytes(outputs)
        rec.update(
            ok=True,
            lower_s=round(t1 - t0, 2),
            compile_s=round(t2 - t1, 2),
            tokens=cell.tokens,
            memory={
                "argument_bytes": argument_bytes,
                "output_bytes": output_bytes,
                "temp_bytes": peak - argument_bytes,
                "alias_bytes": shared_bytes(outputs, cell.args),
                "peak_bytes": peak,
            },
            production_costs_scan_body_once=prod_costs,
        )
        if cfg.is_moe and mesh is not None:       # the mode the MoE blocks ran in
            rec["moe_mode"] = mode_name(
                mesh, cell.rules, shape.global_batch // grad_accum,
                1 if shape.kind == "decode" else shape.seq_len, cfg.num_experts)
        del outputs
        # ---- cost pass (two depths, extrapolated) ------------------------
        if cost_pass:
            d1, d2, n1, n_full = depth_variants(cfg)
            costs = []
            for dcfg in (d1, d2):
                c = build_cell(arch, shape_name, mesh, rules, cfg=dcfg, **kw)
                costs.append(count_costs(c.fn, *c.args))
            total = extrapolate(costs[0], costs[1], n1, n_full)
            bytes_model = memory_model.estimate_bytes(
                shape.kind, cell.cfg, shape, cell.mem_info)
            report = roofline_lib.analyze(
                flops_per_device=total["flops"],
                bytes_per_device=total["bytes"],
                bytes_model_per_device=bytes_model,
                collectives=total["collectives"],
                chips=1 if mesh is None else mesh.size(), model_flops=cell.model_flops)
            rec["roofline"] = report.to_dict()
            rec["cost_depths"] = [d1.num_layers, d2.num_layers, n_full]
    except Exception as e:  # a failed cell is a bug — record it loudly
        rec.update(ok=False, error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-2000:])
    return rec


def run(archs, shapes, out: str, rules: str = "default", grad_accum: int = 1,
        remat: bool = True, cost_pass: bool = True, mesh: str = "one") -> list:
    """Every (arch, shape, mesh) cell → its record, each written to
    ``{out}/{record_tag}.json`` and reported on one line, in order.  The
    cells run in worker processes, one a core: each is Python dispatch on
    the host, and they share nothing (each worker makes its own fake
    group)."""
    if mesh == "one" and rules != "default":
        raise ValueError(f"--rules {rules} needs a production mesh (--mesh single, "
                         "multi or both)")
    outdir = Path(out)
    outdir.mkdir(parents=True, exist_ok=True)
    cells = [(arch, shape, multi) for arch in archs for shape in shapes
             for multi in MESHES[mesh]]
    job = functools.partial(run_cell, rules_name=rules,
                            grad_accum=grad_accum, remat=remat, cost_pass=cost_pass)
    workers = min(len(cells), len(os.sched_getaffinity(0)))
    with contextlib.ExitStack() as stack:
        if workers > 1:
            pool = stack.enter_context(ProcessPoolExecutor(
                workers, mp_context=multiprocessing.get_context("spawn")))
            results = pool.map(job, *zip(*cells))
        else:
            results = map(job, *zip(*cells))
        records = []
        for (arch, shape, multi), rec in zip(cells, results):
            tag = record_tag(arch, shape, multi, rules)
            (outdir / f"{tag}.json").write_text(json.dumps(rec, indent=2))
            status = ("SKIP" if rec.get("skipped")
                      else "OK" if rec["ok"] else "FAIL")
            dom = rec.get("roofline", {}).get("dominant", "-")
            step = rec.get("roofline", {}).get("step_time_s", 0)
            mfu = rec.get("roofline", {}).get("model_flops_util", 0)
            print(f"[{status}] {tag:58s} dom={dom:10s} "
                  f"step={step:.4f}s mfu={mfu:.3f}", flush=True)
            if not rec["ok"]:
                print("   ", rec.get("error"), flush=True)
            records.append(rec)
    return records


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="one", choices=list(MESHES))
    ap.add_argument("--rules", default="default", choices=list(RULE_SETS))
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--no-cost-pass", action="store_true",
                    help="production pass only (skip the roofline cost pass)")
    ap.add_argument("--out", default="out/dryrun")
    args = ap.parse_args(argv)

    archs = list(ARCHS) if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    records = run(archs, shapes, args.out, args.rules, grad_accum=args.grad_accum,
                  remat=not args.no_remat, cost_pass=not args.no_cost_pass,
                  mesh=args.mesh)
    n_ok = sum(r["ok"] for r in records)
    n_fail = len(records) - n_ok
    print(f"dry-run complete: {n_ok} ok, {n_fail} failed")
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
