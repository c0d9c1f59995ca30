"""The source paper's two measured figures on the port: Fig. 9
(``fig9_sensitivity``) and Fig. 10 (``fig10_roofline``), the counterparts of
``benchmarks/bench_sensitivity.py`` and ``benchmarks/bench_roofline.py``.

    PYTHONPATH=src python -m repro_torch.launch.figures [fig9|fig10|all] \\
        [--device cpu] [--out out/figures] [--dryrun out/dryrun]

Fig. 9: generated canonical models (``core/generator.py``) over layers ×
width, each timed by ``MeasuredLatency(model, warmup=1, iters=3)``, into a
PerfDB and latency / attained-GFLOP/s heat maps.  Fig. 10: (a) arithmetic
intensity and attained FLOP/s of every dry-run record
(``launch/dryrun.py``) against the ridge of ``hw.GPU_H100``; (b) generated
models measured, intensity from their parameter bytes.

The reference's grids, PerfDB records, ``name,us_per_call,derived`` rows and
JSON payloads.  Models run on the card unless ``--device cpu`` is given,
under ``torch.no_grad()`` with fp32 products in IEEE fp32 (no TF32); the
JSON goes to ``{out}/fig9_sensitivity.json`` and
``{out}/fig10_roofline.json``, nothing else is written.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Any, Dict

import torch

from repro_torch import hw as hw_lib
from repro_torch import ieee_fp32, resolve_device
from repro_torch.core import generator as gen
from repro_torch.core.analysis import heatmap, render_heatmap, roofline_point
from repro_torch.core.perfdb import PerfDB
from repro_torch.serving.latency_model import MeasuredLatency

LAYERS = (2, 4, 8)
WIDTHS = (128, 256, 512)
FAMILIES = ("fc", "transformer")     # the paper's CNN/Transformer pair analog
# Fig. 10 (b): generated models at 4 layers
ROOFLINE_FAMILIES = ("fc", "transformer")
ROOFLINE_WIDTHS = (128, 512)
ROOFLINE_BATCHES = (1, 16)


def emit(name: str, us_per_call: float, derived: str) -> None:
    print(f"{name},{us_per_call:.2f},{derived}", flush=True)


def save_json(out: str, name: str, payload: Any) -> Path:
    path = Path(out) / f"{name}.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(payload, indent=2, default=str))
    return path


def _measure(spec: gen.GeneratedSpec, device) -> tuple:
    """(latency in s, the model) of one generated model on ``device``."""
    model, inputs = gen.build(spec, device)
    with torch.no_grad(), ieee_fp32():
        return MeasuredLatency(model, warmup=1, iters=3).measure(*inputs), model


def fig9(out: str, device=None) -> Dict[str, Any]:
    """Paper Fig. 9: hyper-parameter sensitivity heat maps over generated
    models (layers × width → latency and attained GFLOP/s)."""
    dev = resolve_device(device)
    db = PerfDB()
    for family in FAMILIES:
        for L in LAYERS:
            for W in WIDTHS:
                spec = gen.GeneratedSpec(family=family, layers=L, width=W,
                                         batch=4, seq=32)
                lat, _ = _measure(spec, dev)
                flops = spec.batch * gen.flops_estimate(spec)
                db.insert({
                    "generated": {"family": family, "layers": L, "width": W},
                    "result": {"latency_s": lat,
                               "attained_gflops": flops / lat / 1e9},
                })
                emit(f"fig9.{family}.L{L}.W{W}", lat * 1e6,
                     f"gflops={flops/lat/1e9:.2f}")
    maps = {}
    for family in FAMILIES:
        for value in ("result.latency_s", "result.attained_gflops"):
            hm = heatmap(db, row_key="generated.layers",
                         col_key="generated.width", value_key=value,
                         **{"generated.family": family})
            maps[f"{family}/{value}"] = hm
            print(render_heatmap(hm))
    save_json(out, "fig9_sensitivity", maps)
    return maps


def fig10(out: str, dryrun: str = "out/dryrun", device=None) -> Dict[str, Any]:
    """Paper Fig. 10: (a) the dry-run records' intensity and attained FLOP/s
    against the H100's ridge; (b) generated models, measured."""
    dev = resolve_device(device)
    result = {"real": {}, "generated": {}}
    hw = hw_lib.GPU_H100
    # (a) real-world models from the dry-run roofline pass
    for f in sorted(Path(dryrun).glob("*__single.json")):
        rec = json.loads(f.read_text())
        r = rec.get("roofline")
        if not rec.get("ok") or not r:
            continue
        intensity = r["flops_per_device"] / max(r["bytes_model_per_device"], 1)
        attained = r["flops_per_device"] / max(r["step_time_s"], 1e-12)
        bound = ("memory" if intensity < hw.ridge_intensity() else "compute")
        result["real"][f"{rec['arch']}/{rec['shape']}"] = {
            "intensity": intensity, "attained_tflops": attained / 1e12,
            "roofline_bound": bound, "dominant_term": r["dominant"],
        }
        emit(f"fig10a.{rec['arch']}.{rec['shape']}", 0.0,
             f"AI={intensity:.1f};attained_TF={attained/1e12:.2f};{bound}")
    # (b) generated models, measured
    for family in ROOFLINE_FAMILIES:
        for W in ROOFLINE_WIDTHS:
            for b in ROOFLINE_BATCHES:
                spec = gen.GeneratedSpec(family=family, layers=4, width=W,
                                         batch=b, seq=32)
                lat, model = _measure(spec, dev)
                flops = b * gen.flops_estimate(spec)
                pt = roofline_point(flops, gen.param_bytes(model), lat)
                result["generated"][spec.name + f"/b{b}"] = pt
                emit(f"fig10b.{family}.W{W}.b{b}", lat * 1e6,
                     f"AI={pt['intensity']:.1f};"
                     f"attained_GF={pt['attained_flops']/1e9:.2f}")
    save_json(out, "fig10_roofline", result)
    return result


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("figure", nargs="?", default="all", choices=["fig9", "fig10", "all"])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--out", default="out/figures")
    ap.add_argument("--dryrun", default="out/dryrun",
                    help="the dry-run records Fig. 10 (a) reads")
    args = ap.parse_args(argv)
    if args.figure in ("fig9", "all"):
        fig9(args.out, args.device)
    if args.figure in ("fig10", "all"):
        fig10(args.out, args.dryrun, args.device)


if __name__ == "__main__":
    main()
