"""ObsSpec — the opt-in switch for the serving observability layer.

Observability is strictly *observational*: enabling it must never move a
simulated number.  The spec therefore only controls what gets recorded
and how densely it is sampled; the engines and the event loop behave
byte-identically with it on or off (asserted by the golden-summary
tests in ``tests/test_obs.py``).

``ObsSpec`` hangs off ``ClusterSpec.obs`` (and, for the declarative
path, ``BenchmarkJobSpec.obs``).  ``None`` — the default everywhere —
keeps the fast path untouched: no recorder is constructed, no hook
fires, and seeded golden summaries stay byte-identical.

A copy of ``repro.obs.spec``, importing only ``repro_torch``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

# sampling the gauges more often than this many times per run buys no
# insight and bloats the persisted time-series; the auto interval and
# the explicit-interval floor both respect it
MAX_SAMPLES_PER_RUN = 100_000
# auto interval: ~this many ticks across the workload window
AUTO_TICKS = 200
# fallback tick for workloads with no declared window (trace replay)
DEFAULT_INTERVAL_S = 0.05


@dataclasses.dataclass(frozen=True)
class ObsSpec:
    """What the observability layer records for one run.

    ``timeseries``        — drive the ``MetricsRecorder``: fixed-tick
                            gauges (queue depth, batch/KV occupancy,
                            live replicas) + cumulative counters
                            (arrivals, completions, preemptions),
                            sliceable per replica / pool / tenant and
                            attached to ``SimResult.timeseries``.
    ``timeline``          — collect per-engine iteration/batch activity
                            spans so ``repro_torch.obs.timeline`` can export a
                            Chrome-trace JSON with engine lanes next to
                            the per-request stage spans (which are
                            derived from ``RequestTrace`` and need no
                            recording).
    ``sample_interval_s`` — gauge sampling tick; 0 (default) derives it
                            from the workload window (~200 ticks/run,
                            50 ms for windowless trace replay).
    """
    timeseries: bool = True
    timeline: bool = True
    sample_interval_s: float = 0.0

    def __post_init__(self):
        if self.sample_interval_s < 0:
            raise ValueError("ObsSpec.sample_interval_s must be >= 0 "
                             f"(got {self.sample_interval_s}; 0 = auto)")

    @property
    def enabled(self) -> bool:
        return self.timeseries or self.timeline

    def resolve_interval(self, window_s: float) -> float:
        """Concrete sampling tick for a run with the given workload
        window (0 = no declared window, e.g. trace replay)."""
        if self.sample_interval_s > 0:
            interval = self.sample_interval_s
        elif window_s > 0:
            interval = window_s / AUTO_TICKS
        else:
            interval = DEFAULT_INTERVAL_S
        if window_s > 0:
            # hard cap on ticks per run, whatever the caller asked for
            interval = max(interval, window_s / MAX_SAMPLES_PER_RUN)
        return interval

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ObsSpec":
        return cls(**dict(d))
