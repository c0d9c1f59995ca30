"""Assemble the roofline table from dry-run records, ported from
``repro.analysis.report``: the reference's logic, unchanged."""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional


def load_cells(dryrun_dir: str, mesh: str = "single",
               rules: Optional[str] = None) -> List[Dict]:
    out = []
    suffix = f"__{mesh}" + (f"__{rules}" if rules else "")
    for f in sorted(Path(dryrun_dir).glob(f"*{suffix}.json")):
        if rules is None and f.stem.count("__") != 2:
            continue
        out.append(json.loads(f.read_text()))
    return out


def roofline_table(cells: List[Dict]) -> str:
    hdr = ("| arch | shape | compute s | memory s (model) | memory s (HLO) |"
           " collective s | dominant | useful | MFU | peak GB/dev |\n"
           "|---|---|---|---|---|---|---|---|---|---|")
    rows = [hdr]
    for c in cells:
        if c.get("skipped"):
            rows.append(f"| {c['arch']} | {c['shape']} | — | — | — | — | "
                        f"skip ({'sub-quadratic only' if 'long' in c['shape'] else ''}) | — | — | — |")
            continue
        if not c.get("ok") or "roofline" not in c:
            rows.append(f"| {c['arch']} | {c['shape']} | FAILED |||||||||")
            continue
        r = c["roofline"]
        peak = c["memory"]["peak_bytes"] / 2 ** 30
        rows.append(
            f"| {c['arch']} | {c['shape']} | {r['compute_s']:.4f} | "
            f"{r['memory_s']:.4f} | {r['memory_s_hlo']:.4f} | "
            f"{r['collective_s']:.4f} | **{r['dominant']}** | "
            f"{r['useful_ratio']:.2f} | {r['model_flops_util']:.3f} | "
            f"{peak:.2f} |")
    return "\n".join(rows)


def pick_hillclimb_cells(cells: List[Dict]) -> Dict[str, Dict]:
    """Worst roofline fraction, most collective-bound, paper-representative."""
    live = [c for c in cells if c.get("ok") and "roofline" in c]
    worst = min(live, key=lambda c: c["roofline"]["model_flops_util"])
    coll = max(live, key=lambda c: (c["roofline"]["collective_s"]
                                    / max(c["roofline"]["step_time_s"], 1e-12)))
    # most representative of InferBench: a *serving decode* cell of a
    # mainstream dense model (the paper benchmarks online inference)
    reps = [c for c in live if c["shape"] == "decode_32k"
            and c["arch"] in ("yi-9b", "granite-8b", "gemma2-2b")]
    rep = max(reps, key=lambda c: c["roofline"]["step_time_s"])
    return {"worst_mfu": worst, "most_collective": coll,
            "paper_representative": rep}
