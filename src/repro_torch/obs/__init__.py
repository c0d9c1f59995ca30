"""Serving observability, ported from ``repro.obs``: span timelines,
time-series metrics, reports.

Opt-in via ``ObsSpec`` on ``ClusterSpec``/``BenchmarkJobSpec`` — with it
unset (the default) the simulator's fast path is untouched and golden
summaries stay byte-identical.  See the README "Observability" section.
"""
from repro_torch.obs.recorder import EngineSpan, MetricsRecorder, Timeseries
from repro_torch.obs.spec import ObsSpec
from repro_torch.obs.timeline import (build_trace, request_stage_spans,
                                      write_trace)

__all__ = [
    "ObsSpec", "MetricsRecorder", "Timeseries", "EngineSpan",
    "build_trace", "write_trace", "request_stage_spans",
    "render_report", "write_report",
]


def __getattr__(name):
    # lazy so `python -m repro_torch.obs.report` doesn't import the module
    # twice (runpy would warn about the package-level binding)
    if name in ("render_report", "write_report"):
        from repro_torch.obs import report
        return getattr(report, name)
    raise AttributeError(name)
