"""Deprecated leader/follower entry point (paper §4.1, Fig. 1 & 5).

The orchestration now lives in :mod:`repro_torch.core.session` — submissions go
through ``BenchmarkSession`` and a pluggable ``Executor``, and results are
typed ``JobResult`` objects.  This module keeps the old ``Leader.submit()``
+ ``run_all()`` surface (untyped PerfDB record dicts) as a thin shim so
existing scripts keep working for one release.

A copy of ``repro.core.leader``, importing only ``repro_torch``.
"""
from __future__ import annotations

import warnings
from typing import Any, Dict, List, Optional

from repro_torch.core.perfdb import PerfDB
from repro_torch.core.session import (BenchmarkSession, Follower, InlineExecutor,
                                execute_job)

__all__ = ["Leader", "Follower", "execute_job"]


class Leader:
    """Deprecated: use ``repro_torch.core.session.BenchmarkSession``.

    One behavior change vs the old Leader: duplicate pending ``job_id``s
    are now rejected with ``ValueError`` (the old path silently executed
    both submissions against the last-registered spec, double-writing
    the PerfDB under one id). Give repeated trials distinct job ids.
    """

    def __init__(self, n_workers: int = 4, db: Optional[PerfDB] = None,
                 lb: str = "qa", order: str = "sjf", device=None):
        warnings.warn(
            "repro_torch.core.leader.Leader is deprecated; use "
            "repro_torch.core.session.BenchmarkSession instead",
            DeprecationWarning, stacklevel=2)
        self._session = BenchmarkSession(n_workers=n_workers, db=db,
                                         lb=lb, order=order,
                                         executor=InlineExecutor(),
                                         device=device)

    @property
    def db(self) -> PerfDB:
        return self._session.db

    @property
    def workers(self) -> List[Follower]:
        return self._session.followers

    @property
    def scheduler(self):
        return self._session.scheduler

    def submit(self, spec) -> None:
        self._session.submit(spec)

    def run_all(self) -> List[Dict[str, Any]]:
        """Schedule and execute all queued submissions; returns records."""
        return [r.to_record() for r in self._session.run()]
