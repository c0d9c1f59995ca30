"""Three-term roofline analysis of a dry-run cell, ported from
``repro.analysis.roofline``.

    compute_term    = per-device FLOPs / peak FLOP/s per chip
    memory_term     = per-device bytes / HBM bandwidth per chip
    collective_term = per-device collective operand bytes / link bandwidth

The FLOPs and bytes come from the cost pass over meta tensors
(``launch/costing.py``); the collectives are passed in (the reference
parses them from HLO text, which the port has none of; on one device they
are zero).  ``hw`` defaults to the port's card, ``hw.GPU_H100``: the terms
are accounting on its data-sheet rates, not timings.  The "useful" ratio
MODEL_FLOPS / (FLOPs × chips) exposes remat and redundant compute.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from repro_torch import hw as hw_lib


@dataclasses.dataclass
class RooflineReport:
    flops_per_device: float
    bytes_per_device: float            # counted (unfused, every op)
    bytes_model_per_device: float      # analytic fused model
    collective_bytes_per_device: float
    chips: int
    compute_s: float
    memory_s_hlo: float                # from the counted bytes
    memory_s: float                    # from the fused model
    collective_s: float
    dominant: str
    model_flops: float
    useful_ratio: float
    step_time_s: float
    model_flops_util: float            # MFU against the roofline step time
    collectives: Dict[str, Dict[str, float]]

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)


def analyze(*, flops_per_device: float, bytes_per_device: float,
            chips: int, model_flops: float,
            bytes_model_per_device: Optional[float] = None,
            collectives: Optional[Dict] = None,
            hw: hw_lib.HardwareModel = hw_lib.GPU_H100) -> RooflineReport:
    colls = collectives if collectives is not None else {}
    coll_bytes = float(sum(v["bytes"] for v in colls.values()))
    compute_s = flops_per_device / hw.peak_flops
    memory_s_hlo = bytes_per_device / hw.hbm_bw
    bytes_model = (bytes_model_per_device if bytes_model_per_device is not None
                   else bytes_per_device)
    memory_s = bytes_model / hw.hbm_bw
    collective_s = coll_bytes / hw.link_bw
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    dominant = max(terms, key=terms.get)
    step_time = max(terms.values())
    total_hlo_flops = flops_per_device * chips
    useful = model_flops / total_hlo_flops if total_hlo_flops else 0.0
    mfu = (model_flops / (chips * hw.peak_flops * step_time)
           if step_time > 0 else 0.0)
    return RooflineReport(
        flops_per_device=flops_per_device,
        bytes_per_device=bytes_per_device,
        bytes_model_per_device=bytes_model,
        collective_bytes_per_device=coll_bytes,
        chips=chips,
        compute_s=compute_s,
        memory_s_hlo=memory_s_hlo,
        memory_s=memory_s,
        collective_s=collective_s,
        dominant=dominant,
        model_flops=model_flops,
        useful_ratio=useful,
        step_time_s=step_time,
        model_flops_util=mfu,
        collectives=colls,
    )
