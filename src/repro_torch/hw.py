"""Hardware models for roofline / cost analysis, ported from ``repro.hw``.

The port's own copy of ``HardwareModel`` and the ``HARDWARE`` catalog, with
the card the port runs on, ``h100``, added beside the reference's entries;
nothing is registered into ``repro.hw``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional


@dataclasses.dataclass(frozen=True)
class HardwareModel:
    """Peak-rate model of one accelerator chip (the roofline ceiling)."""

    name: str
    arch: str
    peak_flops: float          # FLOP/s at the serving dtype (bf16 for TPU)
    peak_flops_fp32: float     # FLOP/s at fp32
    hbm_bytes: int             # on-chip HBM capacity
    hbm_bw: float              # bytes/s HBM bandwidth
    link_bw: float             # bytes/s inter-chip interconnect per chip
    tdp_watts: float           # board power for the energy model
    cloud_usd_per_hour: Optional[float] = None  # on-demand, per chip/board

    # ---- roofline helpers -------------------------------------------------
    def ridge_intensity(self) -> float:
        """Arithmetic intensity (FLOP/byte) at the memory/compute ridge."""
        return self.peak_flops / self.hbm_bw

    def attainable_flops(self, intensity: float) -> float:
        """Roofline: attainable FLOP/s at a given arithmetic intensity."""
        return min(self.peak_flops, intensity * self.hbm_bw)


# The reference's primary target: one TPU v5e chip.
TPU_V5E = HardwareModel(
    name="tpu-v5e",
    arch="TPU v5e",
    peak_flops=197e12,          # bf16
    peak_flops_fp32=98.5e12,
    hbm_bytes=16 * 1024**3,
    hbm_bw=819e9,
    link_bw=50e9,               # per ICI link
    tdp_watts=170.0,
    cloud_usd_per_hour=1.20,    # public on-demand us-central pricing
)

# The port's target: one H100 SXM (NVIDIA's data sheet: dense bf16 tensor
# cores, fp32 outside them, HBM3, NVLink 900 GB/s = 450 GB/s each way, 700 W
# board power).  No price: the port does not bill its card.
GPU_H100 = HardwareModel(
    name="h100", arch="GPU (Hopper)", peak_flops=989e12,
    peak_flops_fp32=67e12, hbm_bytes=80 * 1024**3, hbm_bw=3.35e12,
    link_bw=450e9, tdp_watts=700.0, cloud_usd_per_hour=None)

# Paper Table 1 platforms (FP16 peak used as the serving dtype peak).
GPU_V100 = HardwareModel(
    name="v100", arch="GPU (Volta)", peak_flops=31.4e12,
    peak_flops_fp32=15.7e12, hbm_bytes=32 * 1024**3, hbm_bw=900e9,
    link_bw=25e9, tdp_watts=300.0, cloud_usd_per_hour=2.48)
GPU_2080TI = HardwareModel(
    name="2080ti", arch="GPU (Turing)", peak_flops=28.5e12,
    peak_flops_fp32=14.25e12, hbm_bytes=11 * 1024**3, hbm_bw=616e9,
    link_bw=8e9, tdp_watts=250.0, cloud_usd_per_hour=None)
GPU_T4 = HardwareModel(
    name="t4", arch="GPU (Turing)", peak_flops=16.2e12,
    peak_flops_fp32=8.1e12, hbm_bytes=16 * 1024**3, hbm_bw=300e9,
    link_bw=4e9, tdp_watts=70.0, cloud_usd_per_hour=0.95)
GPU_P4 = HardwareModel(
    name="p4", arch="GPU (Pascal)", peak_flops=11.0e12,
    peak_flops_fp32=5.5e12, hbm_bytes=8 * 1024**3, hbm_bw=192e9,
    link_bw=4e9, tdp_watts=75.0, cloud_usd_per_hour=0.60)
CPU_XEON = HardwareModel(
    name="cpu-xeon", arch="CPU", peak_flops=1.4e12,
    peak_flops_fp32=1.4e12, hbm_bytes=128 * 1024**3, hbm_bw=68e9,
    link_bw=1e9, tdp_watts=135.0, cloud_usd_per_hour=0.34)

HARDWARE: Dict[str, HardwareModel] = {
    h.name: h for h in (TPU_V5E, GPU_H100, GPU_V100, GPU_2080TI, GPU_T4, GPU_P4,
                        CPU_XEON)
}
