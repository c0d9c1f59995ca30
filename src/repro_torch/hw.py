"""Hardware models for roofline / cost analysis, ported from ``repro.hw``.

The port's own copy of ``HardwareModel`` and the ``HARDWARE`` catalog, with
the card the port runs on, ``h100``, added beside the reference's entries;
nothing is registered into ``repro.hw``.  The energy, CO2 and pricing tables
and functions are the reference's, unchanged: ``h100`` has no row in them,
so it costs 0.0, the reference's rule for unlisted (self-hosted) hardware.
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

# Energy → CO2: global-average grid intensity (kg CO2e per kWh), the same
# methodology as carbontracker used in the paper's Fig. 8.
CO2_KG_PER_KWH = 0.475

# Cloud providers offering the chip (paper Fig. 8b uses anonymized labels).
# Every key of the reference's HARDWARE has at least one entry so
# cloud_cost_usd never falls into the silent-zero path for its catalog
# hardware; the port's h100 has none and costs 0.0 (2080ti has no public
# cloud SKU; the rate is a render-farm-style hourly equivalent, cpu-xeon
# mirrors its on-demand board price).
CLOUD_RATES_USD_PER_HOUR: Dict[str, Dict[str, float]] = {
    "tpu-v5e": {"C1/I1": 1.20, "C1/I2": 0.84},        # on-demand vs 1yr-commit
    "v100":    {"C1/I1": 2.48, "C2/I1": 3.06},
    "2080ti":  {"C3/I1": 0.56},
    "t4":      {"C1/I3": 0.95, "C2/I3": 0.35},
    "p4":      {"C2/I2": 0.60},
    "cpu-xeon": {"C1/I4": 0.34, "C2/I4": 0.30},
}

# Preemptible/spot pricing per chip-hour: the discount a spot pool's
# replica-seconds are billed at (in exchange for the reclamation risk the
# cluster simulator's seeded preemption process models).  Ratios follow
# typical public spot discounts (55–70% off on-demand).
SPOT_RATES_USD_PER_HOUR: Dict[str, float] = {
    "tpu-v5e": 0.48,
    "v100": 0.74,
    "2080ti": 0.20,
    "t4": 0.11,
    "p4": 0.22,
    "cpu-xeon": 0.10,
}

PRICING_CLASSES = ("reserved", "spot")


def energy_joules(hw: HardwareModel, seconds: float, util: float = 1.0) -> float:
    """Energy for a span at a given average utilization (idle draw ~30% TDP)."""
    avg_watts = hw.tdp_watts * (0.3 + 0.7 * min(max(util, 0.0), 1.0))
    return avg_watts * seconds


def co2_kg(joules: float) -> float:
    return joules / 3.6e6 * CO2_KG_PER_KWH


def cloud_rate_usd_per_hour(hw_name: str, *, instance: str | None = None,
                            pricing: str = "reserved") -> float:
    """$/chip-hour for one hardware key under a pricing class.

    ``pricing="reserved"`` (default) reads the on-demand table — the
    cheapest listed instance, or the named ``instance``.  ``"spot"``
    reads the preemptible table (falling back to 30% of on-demand for
    hardware without a listed spot rate).  Unknown hardware costs 0.0
    (self-hosted); an unknown *instance* on known hardware is a
    configuration mistake and raises.
    """
    if pricing not in PRICING_CLASSES:
        raise ValueError(f"unknown pricing class {pricing!r} "
                         f"(expected one of {PRICING_CLASSES})")
    rates = CLOUD_RATES_USD_PER_HOUR.get(hw_name, {})
    if not rates:
        return 0.0
    if instance is not None and instance not in rates:
        raise KeyError(f"no instance {instance!r} offering {hw_name!r} "
                       f"(known: {sorted(rates)})")
    rate = rates[instance] if instance else min(rates.values())
    if pricing == "spot":
        return SPOT_RATES_USD_PER_HOUR.get(hw_name, rate * 0.3)
    return rate


def cloud_cost_usd(hw_name: str, seconds: float, instance: str | None = None,
                   pricing: str = "reserved") -> float:
    rate = cloud_rate_usd_per_hour(hw_name, instance=instance,
                                   pricing=pricing)
    return rate * seconds / 3600.0
