"""Production arrival processes: diurnal cycles, flash crowds, and
scale-to-saturation sweeps.  A copy of ``repro.scenarios.arrivals``: the
same numpy ``Generator`` draws in the same order, so the same spec gives
the reference's arrival times exactly.

These layer under the existing ``WorkloadSpec`` kinds — ``generate``
dispatches ``kind="diurnal" | "flash-crowd" | "sweep"`` here, so every
consumer (single-replica simulator, cluster loop, planner, benches)
gets them for free.  The non-homogeneous kinds sample by Lewis–Shedler
thinning: candidates are drawn from a homogeneous Poisson process at
the envelope rate ``λ_max`` and accepted with probability
``λ(t)/λ_max``, which is exact and stays deterministic under the
workload's seed.

  diurnal      λ(t) = rate · (1 + amplitude · sin(2πt/period))
               — the day/night cycle every consumer service sees,
               compressed to simulation scale via ``diurnal_period_s``.
  flash-crowd  λ(t) = rate, then at ``flash_start_s`` a spike to
               ``rate · burst_factor`` decaying exponentially with time
               constant ``flash_decay_s`` — the retweet/incident shape.
  sweep        geometric rate steps from ``ramp_min_rate`` to
               ``ramp_max_rate`` (the existing ``ramp`` is linear) —
               doubling toward saturation covers decades of load with
               few steps, the shape capacity sweeps actually use.

``mean_rate`` returns the time-averaged λ of any kind analytically, so
a bench can compare a flash crowd against a steady Poisson stream *at
equal mean rate* — same offered work, different burstiness.
"""
from __future__ import annotations

import math
from typing import List

import numpy as np


def _thinned_times(rng: np.random.Generator, lam, lam_max: float,
                   duration_s: float) -> List[float]:
    """Lewis–Shedler thinning of a rate function ``lam(t)`` under the
    envelope ``lam_max`` over [0, duration)."""
    times: List[float] = []
    t = 0.0
    while True:
        t += rng.exponential(1.0 / lam_max)
        if t >= duration_s:
            return times
        if rng.random() < lam(t) / lam_max:
            times.append(t)


def diurnal_rate(spec, t: float) -> float:
    """Instantaneous λ(t) of the diurnal cycle."""
    return spec.rate * (1.0 + spec.diurnal_amplitude
                        * math.sin(2.0 * math.pi * t
                                   / spec.diurnal_period_s))


def diurnal_times(spec, rng: np.random.Generator) -> List[float]:
    lam_max = spec.rate * (1.0 + spec.diurnal_amplitude)
    return _thinned_times(rng, lambda t: diurnal_rate(spec, t), lam_max,
                          spec.duration_s)


def flash_params(spec) -> tuple:
    """(start_s, decay_s) with the spec's <0 sentinels resolved to the
    defaults: spike at one third of the window, decaying over a tenth."""
    start = spec.flash_start_s if spec.flash_start_s >= 0 \
        else spec.duration_s / 3.0
    decay = spec.flash_decay_s if spec.flash_decay_s > 0 \
        else spec.duration_s / 10.0
    return start, decay


def flash_rate(spec, t: float) -> float:
    """Instantaneous λ(t): baseline before the spike, then baseline plus
    an exponentially-decaying surge of magnitude (burst_factor−1)·rate."""
    start, decay = flash_params(spec)
    if t < start:
        return spec.rate
    return spec.rate * (1.0 + (spec.burst_factor - 1.0)
                        * math.exp(-(t - start) / decay))


def flash_crowd_times(spec, rng: np.random.Generator) -> List[float]:
    lam_max = spec.rate * max(spec.burst_factor, 1.0)
    return _thinned_times(rng, lambda t: flash_rate(spec, t), lam_max,
                          spec.duration_s)


def sweep_step_rates(spec) -> List[float]:
    """Geometric rate ladder from ``ramp_min_rate`` to ``ramp_max_rate``
    over ``ramp_steps`` equal-length windows (single step → min rate,
    matching the linear ramp's convention)."""
    if spec.ramp_steps == 1:
        return [spec.ramp_min_rate]
    ratio = (spec.ramp_max_rate / spec.ramp_min_rate) \
        ** (1.0 / (spec.ramp_steps - 1))
    return [spec.ramp_min_rate * ratio ** k for k in range(spec.ramp_steps)]


def sweep_times(spec, rng: np.random.Generator) -> List[float]:
    step_len = spec.duration_s / spec.ramp_steps
    times: List[float] = []
    for k, rate in enumerate(sweep_step_rates(spec)):
        t, end = k * step_len, (k + 1) * step_len
        while True:
            t += rng.exponential(1.0 / max(rate, 1e-9))
            if t >= end:
                break
            times.append(t)
    return times


def mean_rate(spec) -> float:
    """Time-averaged λ over the workload window, analytically.

    The steady-Poisson control for any bursty kind: a ``poisson``
    workload at ``mean_rate(spec)`` offers the same total work with
    none of the burstiness.
    """
    kind = spec.kind
    if kind == "diurnal":
        # sinusoid over a fractional number of periods
        w = 2.0 * math.pi / spec.diurnal_period_s
        integral = spec.rate * (spec.duration_s
                                + spec.diurnal_amplitude
                                * (1.0 - math.cos(w * spec.duration_s)) / w)
        return integral / spec.duration_s
    if kind == "flash-crowd":
        start, decay = flash_params(spec)
        start = min(start, spec.duration_s)
        surge = (spec.rate * (spec.burst_factor - 1.0) * decay
                 * (1.0 - math.exp(-(spec.duration_s - start) / decay)))
        return spec.rate + surge / spec.duration_s
    if kind == "sweep":
        return sum(sweep_step_rates(spec)) / spec.ramp_steps
    if kind == "ramp":
        from repro_torch.serving.workload import ramp_step_rates
        return sum(ramp_step_rates(spec)) / spec.ramp_steps
    if kind == "burst":
        return spec.rate * (1.0 + spec.burst_fraction
                            * (spec.burst_factor - 1.0))
    return spec.rate
