"""Kernel-calibration smoke sweep, the twin of ``benchmarks/bench_kernels.py
--smoke``: every registered Hopper kernel through the calibration backend
(``repro_torch.calibrate.kernel_bench``) on a CI-sized grid — batches (1, 2)
× seqs (64, 128) in fp32 (int8 for the int8 matmul) — each verified against
its reference, then fitted per (kernel, dtype).

    PYTHONPATH=src python -m repro_torch.launch.bench_kernels [--device cpu] [--json PATH]

Runs on the card unless ``--device cpu`` is given; ``--json`` writes the
metrics dict to PATH (nothing is written otherwise).
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Any, Dict, Optional

from repro_torch.calibrate import fit_kernel_records, kernel_records, kernel_registry


def run_smoke(json_path: Optional[str] = None, device=None) -> Dict[str, Any]:
    """Sweep every registered kernel on a tiny grid, verify against the
    references, fit, and return (and print) per-(kernel, dtype) metrics."""
    names = sorted(kernel_registry())
    records = kernel_records(names, batches=(1, 2), seqs=(64, 128),
                             dtypes=("float32",), repeats=2,
                             meta={"job_id": "bench-kernels"}, device=device)
    fits = fit_kernel_records(records)
    out = {"n_records": len(records), "n_fits": len(fits),
           "verified_pairs": len({(r["kernel"], r["dtype"]) for r in records
                                  if r["result"]["max_err_vs_ref"] is not None}),
           "kernels": {}}
    for key, fit in sorted(fits.items()):
        series = [r["result"]["latency_s"] for r in records
                  if f"{r['kernel']}/{r['dtype']}" == key]
        entry = {"latency_s_min": min(series),
                 "latency_s_max": max(series),
                 "n_points": fit["n_points"],
                 "max_err_vs_ref": fit["max_err_vs_ref"]}
        out["kernels"][key] = entry
        print(f"kernels.calib.{key},{entry['latency_s_min'] * 1e6:.2f},"
              f"points={fit['n_points']};max_err={fit['max_err_vs_ref']:.2e};"
              f"mode={records[0]['result']['mode']}", flush=True)
    if json_path:
        path = Path(json_path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(out, indent=2, default=str))
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--json", metavar="PATH", default=None,
                    help="write the metrics dict to PATH")
    args = ap.parse_args()
    run_smoke(json_path=args.json, device=args.device)


if __name__ == "__main__":
    main()
