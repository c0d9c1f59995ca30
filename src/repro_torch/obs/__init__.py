"""Serving observability, ported from ``repro.obs``: the opt-in ``ObsSpec``
and the time-series recorder the cluster simulator drives.  Span timelines
(``obs/timeline.py``) and HTML reports (``obs/report.py``) come with the
next slice of the port.
"""
from repro_torch.obs.recorder import EngineSpan, MetricsRecorder, Timeseries
from repro_torch.obs.spec import ObsSpec

__all__ = ["ObsSpec", "MetricsRecorder", "Timeseries", "EngineSpan"]
