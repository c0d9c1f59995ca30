"""Roofline report: read the dry-run records and print, per cell, the
three roofline terms, the dominant bottleneck and the MFU, the counterpart
of ``examples/roofline_report.py``.

    PYTHONPATH=src python -m repro_torch.launch.roofline_report [DIR]

DIR holds ``launch/dryrun.py``'s records (default ``out/dryrun``).  The
terms are accounting on ``hw.GPU_H100``'s data-sheet rates, not timings.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path


def report(dryrun_dir: str) -> str:
    lines = [f"{'arch':22s} {'shape':12s} {'dominant':11s} {'step_s':>9s} "
             f"{'compute_s':>10s} {'memory_s':>9s} {'coll_s':>9s} {'MFU':>6s}"]
    rows = []
    for f in sorted(Path(dryrun_dir).glob("*__single.json")):
        rec = json.loads(f.read_text())
        if rec.get("skipped") or not rec.get("ok") or "roofline" not in rec:
            continue
        rows.append((rec["arch"], rec["shape"], rec["roofline"]))
    for arch, shape, r in sorted(rows, key=lambda t: -t[2]["step_time_s"]):
        lines.append(f"{arch:22s} {shape:12s} {r['dominant']:11s} "
                     f"{r['step_time_s']:9.4f} {r['compute_s']:10.4f} "
                     f"{r['memory_s']:9.4f} {r['collective_s']:9.4f} "
                     f"{r['model_flops_util']:6.3f}")
    doms = [r["dominant"] for _, _, r in rows]
    lines.append(f"\n{len(rows)} cells: "
                 + ", ".join(f"{d}-bound: {doms.count(d)}" for d in
                             ("collective", "memory", "compute")))
    return "\n".join(lines)


if __name__ == "__main__":
    print(report(sys.argv[1] if len(sys.argv) > 1 else "out/dryrun"))
