"""Synthetic trace scaler: grow a small seed trace to production volume.
A copy of ``repro.scenarios.synth``.

Replaying a recorded trace is the most realistic workload the simulator
has — but recorded traces are small, and the planner's questions are
about millions-of-users volume.  ``scale_trace`` takes a seed JSONL
trace (the schema in ``configs/traces/README.md``) and emits a trace
``factor×`` larger over the same time window, preserving the three
properties that make a trace *realistic*:

  * **interarrival burstiness** — output interarrival gaps are a
    bootstrap resample of the seed's empirical gaps, compressed by
    ``factor``; the coefficient of variation (CV, the standard
    burstiness statistic) is preserved by construction, where naive
    Poisson superposition would wash it out toward CV = 1;
  * **session-length distribution** — whole seed sessions are cloned as
    templates, so the requests-per-session distribution (and each
    request's prompt/output/payload columns) is resampled, not
    re-modeled;
  * **prefix-sharing structure** — each cloned session keeps its seed
    session's ``prefix_tokens`` pattern under a fresh session id, so
    prefix-cache hit rates scale the way real multiplied traffic would.

The output is plain rows (list of dicts) — ``write_trace_rows`` emits
replayable JSONL for ``WorkloadSpec(kind="trace", trace_path=...)``.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, List, Sequence, Union

import numpy as np

RowsOrPath = Union[str, Path, Sequence[Dict[str, Any]]]


def load_trace_rows(path: Union[str, Path]) -> List[Dict[str, Any]]:
    """Parse a JSONL trace file into rows (comments/blank lines skipped,
    sorted by arrival)."""
    rows = []
    for line in Path(path).read_text().splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        rows.append(json.loads(line))
    rows.sort(key=lambda d: float(d["arrival_s"]))
    return rows


def write_trace_rows(rows: Sequence[Dict[str, Any]],
                     path: Union[str, Path],
                     header: str = "") -> Path:
    """Emit rows as replayable JSONL (optional ``#`` header comment)."""
    path = Path(path)
    lines = [f"# {header}"] if header else []
    lines += [json.dumps(r) for r in rows]
    path.write_text("\n".join(lines) + "\n")
    return path


def _coerce_rows(rows: RowsOrPath) -> List[Dict[str, Any]]:
    if isinstance(rows, (str, Path)):
        return load_trace_rows(rows)
    return sorted((dict(r) for r in rows),
                  key=lambda d: float(d["arrival_s"]))


def _sessions(rows: Sequence[Dict[str, Any]]) -> List[List[Dict[str, Any]]]:
    """Group rows by session id, preserving each session's row order."""
    by_id: Dict[Any, List[Dict[str, Any]]] = {}
    for r in rows:
        by_id.setdefault(r.get("session_id", 0), []).append(r)
    return list(by_id.values())


def trace_stats(rows: RowsOrPath) -> Dict[str, float]:
    """The preservation statistics the scaler is judged by.

    ``interarrival_cv`` is std/mean of the aggregate arrival gaps (1.0
    for a Poisson process, higher = burstier); session lengths count
    requests per session.
    """
    rows = _coerce_rows(rows)
    times = np.array([float(r["arrival_s"]) for r in rows])
    deltas = np.diff(times)
    lens = np.array([len(s) for s in _sessions(rows)], dtype=float)
    mean_gap = float(deltas.mean()) if len(deltas) else 0.0
    return {
        "requests": float(len(rows)),
        "sessions": float(len(lens)),
        "duration_s": float(times[-1] - times[0]) if len(times) else 0.0,
        "mean_interarrival_s": mean_gap,
        "interarrival_cv": (float(deltas.std() / mean_gap)
                            if mean_gap > 0 else 0.0),
        "session_len_p50": float(np.percentile(lens, 50)) if len(lens)
        else 0.0,
        "session_len_p95": float(np.percentile(lens, 95)) if len(lens)
        else 0.0,
        "mean_prompt_tokens": float(np.mean(
            [r.get("prompt_tokens", 0) for r in rows])) if rows else 0.0,
        "mean_prefix_tokens": float(np.mean(
            [r.get("prefix_tokens", 0) for r in rows])) if rows else 0.0,
    }


def scale_trace(seed: RowsOrPath, factor: float, *,
                seed_rng: int = 0) -> List[Dict[str, Any]]:
    """Scale a seed trace ``factor×`` in volume over the same window.

    Arrival times are a cumulative sum of gaps bootstrapped from the
    seed's empirical interarrival distribution and divided by
    ``factor`` (CV-preserving rate scale-up).  Requests are drawn from
    cloned seed sessions: each clone keeps its template's row sequence
    (prompt/output/payload/prefix/tenant columns) under a fresh session
    id, and its requests take arrival slots in template order so
    within-session causality holds.
    """
    rows = _coerce_rows(seed)
    if len(rows) < 2:
        raise ValueError("seed trace needs at least 2 requests to carry "
                         "an interarrival distribution")
    if factor <= 0:
        raise ValueError(f"scale factor must be > 0 (got {factor})")
    rng = np.random.default_rng(seed_rng)
    times = np.array([float(r["arrival_s"]) for r in rows])
    t0 = times[0]
    deltas = np.diff(times)
    templates = _sessions(rows)
    n_out = max(int(round(len(rows) * factor)), 1)

    # clone whole sessions until the request budget is covered; the last
    # clone is truncated to land exactly on n_out (negligible bias at
    # any real factor)
    slots: List[tuple] = []          # (new_session_id, template_row)
    sid = 0
    while len(slots) < n_out:
        tmpl = templates[rng.integers(0, len(templates))]
        for row in tmpl:
            if len(slots) >= n_out:
                break
            slots.append((sid, row))
        sid += 1

    # aggregate arrival times: bootstrapped gaps, compressed by factor
    gaps = rng.choice(deltas, size=n_out) / factor
    out_times = t0 + np.cumsum(gaps)

    # interleave sessions across the timeline, then hand each session's
    # requests its assigned times in ascending order (template order ==
    # time order within a session)
    order = rng.permutation(n_out)
    rows_by_sid: Dict[int, List[Dict[str, Any]]] = {}
    assigned: Dict[int, List[int]] = {}
    for slot_idx, (s, row) in enumerate(slots):
        rows_by_sid.setdefault(s, []).append(row)
        assigned.setdefault(s, []).append(int(order[slot_idx]))
    out: List[Dict[str, Any]] = []
    for new_sid, time_idxs in assigned.items():
        time_idxs.sort()
        for tmpl_row, ti in zip(rows_by_sid[new_sid], time_idxs):
            row = dict(tmpl_row)
            row["arrival_s"] = round(float(out_times[ti]), 6)
            row["session_id"] = new_sid
            out.append(row)
    out.sort(key=lambda r: r["arrival_s"])
    return out
