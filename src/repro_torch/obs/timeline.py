"""Chrome-trace timeline export (``chrome://tracing`` / Perfetto), a copy
of ``repro.obs.timeline``.

Per-request stage spans are *derived* from ``RequestTrace`` after the
run — the simulator already records every stage duration, so the hot
loop pays nothing for them.  Per-engine activity spans (continuous-
batching iterations, request-level batch occupations) come from the
``MetricsRecorder`` engine hooks and need ``ObsSpec.timeline`` on.

Lane layout (one Chrome-trace *process* per replica):

  pid = replica_id + 1      process_name "replica 3 · decode"
    tid 0                   "engine" — iteration/batch activity spans
    tid req_id + 1          "req 17 · tenantA" — that request's stages:
                            preprocess → transmit → queue (batch-wait
                            nested at its tail) → prefill → kv-transfer
                            → decode → postprocess

Span derivation is anchored at both ends of the trace: queue duration
is exactly ``t_queue``; for non-preempted requests the prefill and
decode spans partition ``t_inference`` exactly (asserted by the
reconciliation test).  Preempted/migrated requests interleave wait and
service segments the trace only stores as totals, so their interior
boundaries are clamped (never negative, never past ``done_s``) while
the end-to-end extent stays exact.

Under ``trace_sample < 1`` the timeline is a *sample*: an explicit
``sampling_rate`` counter track rides along (and ``metadata.
sampling_rate`` is set) so a partial picture is never mistaken for the
full run — the HTML report surfaces the same warning.

No runtime imports from ``repro_torch.serving`` (results are duck-typed), so
obs stays a leaf the serving layer may import freely.
"""
from __future__ import annotations

import json
from typing import TYPE_CHECKING, Any, Dict, List, Optional

if TYPE_CHECKING:                           # pragma: no cover
    from repro_torch.serving.simulator import RequestTrace, SimResult

US = 1e6                                    # trace timestamps are in µs

# stage → lane color hint (trace-viewer reserved color names)
_STAGE_CNAME = {
    "preprocess": "grey",
    "transmit": "thread_state_runnable",
    "queue": "bad",
    "batch_wait": "terrible",
    "prefill": "thread_state_running",
    "kv_transfer": "yellow",
    "decode": "good",
    "postprocess": "grey",
}


def _event(name: str, start_s: float, end_s: float, pid: int, tid: int,
           args: Optional[Dict[str, Any]] = None,
           cname: Optional[str] = None) -> Dict[str, Any]:
    ev = {"name": name, "ph": "X", "ts": round(start_s * US, 3),
          "dur": round(max(end_s - start_s, 0.0) * US, 3),
          "pid": pid, "tid": tid, "cat": "sim"}
    if args:
        ev["args"] = args
    if cname:
        ev["cname"] = cname
    return ev


def _meta(name: str, pid: int, value: str,
          tid: Optional[int] = None) -> Dict[str, Any]:
    ev: Dict[str, Any] = {"name": name, "ph": "M", "pid": pid,
                          "args": {"name": value}}
    if tid is not None:
        ev["tid"] = tid
    return ev


def request_stage_spans(tr: "RequestTrace") -> List[Dict[str, Any]]:
    """The (name, start_s, end_s) stage spans of one request, derived
    from its trace.  Pure timing — no pid/tid assignment."""
    arr = tr.request.arrival_s
    enqueue = arr + tr.t_preprocess + tr.t_transmit
    svc_start = enqueue + tr.t_queue
    svc_end = tr.done_s - tr.t_postprocess
    spans = [
        ("preprocess", arr, arr + tr.t_preprocess),
        ("transmit", arr + tr.t_preprocess, enqueue),
        ("queue", enqueue, svc_start),
    ]
    if tr.t_batch_wait > 0:
        # the policy-attributable tail of the queue wait, nested inside it
        spans.append(("batch_wait", svc_start - tr.t_batch_wait, svc_start))
    ft = tr.first_token_s
    if ft > 0.0:
        if ft > svc_start:
            spans.append(("prefill", svc_start, min(ft, svc_end)))
        kv_end = ft
        if tr.t_kv_transfer > 0:
            kv_end = min(ft + tr.t_kv_transfer, svc_end)
            spans.append(("kv_transfer", ft, kv_end))
        if svc_end > kv_end:
            spans.append(("decode", kv_end, svc_end))
    elif svc_end > svc_start:
        spans.append(("inference", svc_start, svc_end))
    if tr.t_postprocess > 0:
        spans.append(("postprocess", svc_end, tr.done_s))
    return [(n, s, max(e, s)) for n, s, e in spans]


def build_trace(result: "SimResult", *, title: str = "",
                max_requests: int = 0) -> Dict[str, Any]:
    """Chrome-trace dict for one ``SimResult``.

    ``max_requests`` > 0 caps the request lanes (earliest arrivals
    kept) for very large runs; engine lanes and the counter tracks are
    never capped.
    """
    events: List[Dict[str, Any]] = []
    pools: Dict[int, str] = {}
    # ---- engine activity lanes (needs ObsSpec.timeline) -------------------
    for sp in (result.engine_spans or []):
        pools.setdefault(sp.replica, sp.pool)
        events.append(_event(
            sp.kind, sp.start_s, sp.end_s, sp.replica + 1, 0,
            args={"batch": sp.batch, "n_prefill": sp.n_prefill}))
    # ---- per-request stage lanes (derived from RequestTrace) --------------
    traces = sorted(result.traces, key=lambda t: t.request.arrival_s)
    if max_requests > 0:
        traces = traces[:max_requests]
    for tr in traces:
        pid = tr.replica + 1
        tid = tr.request.req_id + 1
        tenant = tr.request.tenant
        label = f"req {tr.request.req_id}" + (f" · {tenant}" if tenant
                                              else "")
        events.append(_meta("thread_name", pid, label, tid=tid))
        args = {"req_id": tr.request.req_id,
                "prompt_tokens": tr.request.prompt_tokens,
                "tokens_out": tr.tokens_out,
                "batch_size": tr.batch_size,
                "preemptions": tr.preemptions}
        if tenant:
            args["tenant"] = tenant
        for name, start, end in request_stage_spans(tr):
            events.append(_event(name, start, end, pid, tid, args=args,
                                 cname=_STAGE_CNAME.get(name)))
    # ---- process metadata -------------------------------------------------
    pids = sorted({ev["pid"] for ev in events})
    for pid in pids:
        pool = pools.get(pid - 1, "serve")
        events.append(_meta("process_name", pid,
                            f"replica {pid - 1} · {pool}"))
        events.append({"name": "process_sort_index", "ph": "M", "pid": pid,
                       "args": {"sort_index": pid}})
        events.append(_meta("thread_name", pid, "engine", tid=0))
    # ---- sampling disclosure ----------------------------------------------
    served = result.requests_served or len(result.traces)
    rate = len(result.traces) / served if served else 1.0
    metadata: Dict[str, Any] = {"requests_recorded": len(result.traces),
                                "requests_served": served,
                                "sampling_rate": rate,
                                "duration_s": result.duration_s}
    if title:
        metadata["title"] = title
    if rate < 1.0 - 1e-9 and pids:
        # explicit counter track: a sampled timeline must say so
        pid0 = pids[0]
        for t in (0.0, result.duration_s):
            events.append({"name": "sampling_rate", "ph": "C",
                           "ts": round(t * US, 3), "pid": pid0,
                           "args": {"rate": round(rate, 6)}})
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "metadata": metadata}


def write_trace(result: "SimResult", path: str, *, title: str = "",
                max_requests: int = 0) -> str:
    """Write the Chrome-trace JSON for ``result`` to ``path`` (load it
    at https://ui.perfetto.dev or chrome://tracing); returns the path."""
    trace = build_trace(result, title=title, max_requests=max_requests)
    with open(path, "w") as f:
        json.dump(trace, f)
    return str(path)
