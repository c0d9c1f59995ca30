"""Static HTML run reports from PerfDB records (zero dependencies), a copy
of ``repro.obs.report``: the same records give the same HTML, byte for byte.

``render_report`` turns one or more PerfDB records (the JSONL rows
``JobResult.to_record`` writes) into a single self-contained HTML file:
summary cards, latency-percentile tables, stage breakdowns, inline-SVG
time-series charts for records that carried a ``Timeseries`` (ObsSpec
runs), provenance (events, ``sim_events_per_sec``) and, when a baseline
plus bench dumps are supplied, the CI regression delta table.

Entry points::

    python -m repro_torch.obs.report out/perfdb.jsonl -o out/report.html \\
        --baseline benchmarks/baselines/ci_baseline.json \\
        --bench sim=out/bench_simulator.json

    BenchmarkSession.report("report.html")      # the session's results

The chart styling follows the repo-wide viz conventions: categorical
series colors in fixed slot order, one axis per chart, a legend for
two-series charts, ink tokens (never series colors) for text, and a
selected dark mode via ``prefers-color-scheme``.
"""
from __future__ import annotations

import argparse
import html as _html
import json
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.obs.recorder import Timeseries

# ---- palette (validated default; see docs: dataviz reference) --------------
_CSS = """
:root { color-scheme: light; }
body {
  margin: 0; padding: 24px 32px; background: #f9f9f7; color: #0b0b0b;
  font-family: system-ui, -apple-system, "Segoe UI", sans-serif;
  --surface-1: #fcfcfb; --text-primary: #0b0b0b;
  --text-secondary: #52514e; --muted: #898781; --grid: #e1e0d9;
  --baseline: #c3c2b7; --border: rgba(11,11,11,0.10);
  --series-1: #2a78d6; --series-2: #eb6834; --series-3: #1baf7a;
  --good: #0ca30c; --bad: #d03b3b; --warn-bg: #fff3da;
  --warn-border: #fab219;
}
@media (prefers-color-scheme: dark) {
  :root { color-scheme: dark; }
  body {
    background: #0d0d0d; color: #ffffff;
    --surface-1: #1a1a19; --text-primary: #ffffff;
    --text-secondary: #c3c2b7; --muted: #898781; --grid: #2c2c2a;
    --baseline: #383835; --border: rgba(255,255,255,0.10);
    --series-1: #3987e5; --series-2: #d95926; --series-3: #199e70;
    --good: #0ca30c; --bad: #e66767; --warn-bg: #332a12;
    --warn-border: #fab219;
  }
}
h1 { font-size: 22px; margin: 0 0 4px; }
h2 { font-size: 16px; margin: 28px 0 10px; color: var(--text-primary); }
.sub { color: var(--text-secondary); font-size: 13px; margin-bottom: 18px; }
.warn {
  background: var(--warn-bg); border: 1px solid var(--warn-border);
  border-radius: 6px; padding: 10px 14px; margin: 14px 0; font-size: 13px;
}
.cards { display: flex; flex-wrap: wrap; gap: 12px; }
.card {
  background: var(--surface-1); border: 1px solid var(--border);
  border-radius: 8px; padding: 12px 16px; min-width: 150px;
}
.card .k { color: var(--text-secondary); font-size: 12px; }
.card .v { font-size: 20px; margin-top: 2px; }
.card .u { color: var(--muted); font-size: 12px; }
table {
  border-collapse: collapse; background: var(--surface-1);
  border: 1px solid var(--border); border-radius: 8px; font-size: 13px;
}
th, td { padding: 6px 12px; text-align: right;
         font-variant-numeric: tabular-nums; }
th { color: var(--text-secondary); font-weight: 600;
     border-bottom: 1px solid var(--grid); }
td:first-child, th:first-child { text-align: left;
                                 font-variant-numeric: normal; }
tr + tr td { border-top: 1px solid var(--grid); }
.ok { color: var(--good); }
.fail { color: var(--bad); font-weight: 600; }
.charts { display: flex; flex-wrap: wrap; gap: 16px; }
.chart {
  background: var(--surface-1); border: 1px solid var(--border);
  border-radius: 8px; padding: 10px 12px;
}
.chart .t { font-size: 13px; color: var(--text-primary);
            margin-bottom: 4px; }
.legend { font-size: 12px; color: var(--text-secondary); margin-top: 2px; }
.legend .sw { display: inline-block; width: 10px; height: 10px;
              border-radius: 2px; margin: 0 4px 0 10px;
              vertical-align: -1px; }
svg text { fill: var(--muted); font-size: 10px;
           font-variant-numeric: tabular-nums; }
"""

_SERIES_VARS = ("--series-1", "--series-2", "--series-3")


def _esc(s: Any) -> str:
    return _html.escape(str(s), quote=True)


def _fmt(v: Any, digits: int = 4) -> str:
    if isinstance(v, float):
        if v != v:                                  # NaN
            return "–"
        if v == 0:
            return "0"
        if abs(v) >= 1000:
            return f"{v:,.0f}"
        return f"{v:.{digits}g}"
    return str(v)


# ---- inline-SVG line chart -------------------------------------------------
def _downsample(xs: List[float], ys: List[float],
                limit: int = 600) -> Tuple[List[float], List[float]]:
    n = len(xs)
    if n <= limit:
        return xs, ys
    stride = n / limit
    idx = sorted({int(i * stride) for i in range(limit)} | {n - 1})
    return [xs[i] for i in idx], [ys[i] for i in idx]


def svg_chart(title: str, series: Sequence[Tuple[str, List[float],
                                                 List[float]]],
              *, width: int = 420, height: int = 160,
              y_unit: str = "") -> str:
    """One chart: ≤3 named series over a shared x (seconds) axis."""
    pad_l, pad_r, pad_t, pad_b = 44, 8, 6, 18
    iw, ih = width - pad_l - pad_r, height - pad_t - pad_b
    x_max = max((xs[-1] for _, xs, _ in series if xs), default=1.0) or 1.0
    y_max = max((max(ys) for _, _, ys in series if ys), default=1.0)
    y_max = y_max * 1.05 or 1.0

    def X(x: float) -> float:
        return pad_l + x / x_max * iw

    def Y(y: float) -> float:
        return pad_t + ih - y / y_max * ih

    parts = [f'<svg width="{width}" height="{height}" role="img" '
             f'aria-label="{_esc(title)}">']
    for frac in (0.5, 1.0):                       # hairline gridlines
        gy = Y(y_max / 1.05 * frac)
        parts.append(f'<line x1="{pad_l}" y1="{gy:.1f}" '
                     f'x2="{width - pad_r}" y2="{gy:.1f}" '
                     'stroke="var(--grid)" stroke-width="1"/>')
        parts.append(f'<text x="{pad_l - 4}" y="{gy + 3:.1f}" '
                     f'text-anchor="end">{_fmt(y_max / 1.05 * frac, 3)}'
                     '</text>')
    base_y = Y(0)
    parts.append(f'<line x1="{pad_l}" y1="{base_y:.1f}" '
                 f'x2="{width - pad_r}" y2="{base_y:.1f}" '
                 'stroke="var(--baseline)" stroke-width="1"/>')
    for xf in (0.0, 0.5, 1.0):                    # x ticks (seconds)
        parts.append(f'<text x="{X(x_max * xf):.1f}" '
                     f'y="{height - 4}" text-anchor="middle">'
                     f'{_fmt(x_max * xf, 3)}s</text>')
    for si, (_, xs, ys) in enumerate(series):
        if not xs:
            continue
        dxs, dys = _downsample(xs, ys)
        pts = " ".join(f"{X(x):.1f},{Y(y):.1f}"
                       for x, y in zip(dxs, dys))
        color = f"var({_SERIES_VARS[min(si, 2)]})"
        parts.append(f'<polyline points="{pts}" fill="none" '
                     f'stroke="{color}" stroke-width="2" '
                     'stroke-linejoin="round"/>')
    parts.append("</svg>")
    legend = ""
    if len(series) >= 2:
        legend = '<div class="legend">' + "".join(
            f'<span class="sw" style="background:'
            f'var({_SERIES_VARS[min(i, 2)]})"></span>{_esc(name)}'
            for i, (name, _, _) in enumerate(series)) + "</div>"
    if y_unit:
        title = f"{title} ({y_unit})"
    return (f'<div class="chart"><div class="t">{_esc(title)}</div>'
            + "".join(parts) + legend + "</div>")


# ---- record sections -------------------------------------------------------
_CARD_KEYS = [
    ("throughput_rps", "throughput", "req/s"),
    ("goodput_rps", "goodput", "req/s"),
    ("p99_s", "p99 latency", "s"),
    ("ttft_p99_s", "TTFT p99", "s"),
    ("tpot_p99_s", "TPOT p99", "s"),
    ("slo_attainment", "SLO attainment", ""),
    ("phase_slo_attainment", "phase SLO", ""),
    ("utilization", "utilization", ""),
    ("cost_per_1k_req", "cost / 1k req", "$"),
    ("sim_events_per_sec", "sim events/s", ""),
]

_PCT_COLS = [("p50_s", "p50"), ("p95_s", "p95"), ("p99_s", "p99"),
             ("mean_s", "mean"), ("ttft_p50_s", "TTFT p50"),
             ("ttft_p99_s", "TTFT p99"), ("tpot_p50_s", "TPOT p50"),
             ("tpot_p99_s", "TPOT p99")]

_STAGES = ["preprocess", "transmit", "queue", "batch_wait", "kv_transfer",
           "inference", "postprocess"]


def _record_label(rec: Dict[str, Any]) -> str:
    spec = rec.get("spec", {})
    bits = [str(rec.get("job_id", "run"))]
    arch = rec.get("arch") or rec.get("profile")
    if arch:
        bits.append(str(arch))
    hwd = rec.get("hardware")
    if hwd:
        bits.append(f"{hwd}×{rec.get('chips', 1)}")
    pol = rec.get("policy") or spec.get("software", {}).get("policy")
    if pol:
        bits.append(str(pol))
    return " · ".join(bits)


def _cards_html(res: Dict[str, Any]) -> str:
    cards = []
    for key, label, unit in _CARD_KEYS:
        v = res.get(key)
        if v is None:
            continue
        unit_s = f' <span class="u">{_esc(unit)}</span>' if unit else ""
        cards.append(f'<div class="card"><div class="k">{_esc(label)}'
                     f'</div><div class="v">{_fmt(v)}{unit_s}</div></div>')
    return f'<div class="cards">{"".join(cards)}</div>' if cards else ""


def _timeseries_html(ts: Timeseries) -> str:
    charts = []
    t = ts.times
    if not t:
        return ""
    charts.append(svg_chart("Queue depth (cluster total)",
                            [("queue", t, ts.total("queue_depth"))],
                            y_unit="requests"))
    arr, comp = ts.rate("arrivals"), ts.rate("completions")
    if any(arr) or any(comp):
        charts.append(svg_chart("Arrival vs completion rate",
                                [("arrivals", t, arr),
                                 ("completions", t, comp)],
                                y_unit="req/s"))
    occ = ts.total("batch_occupancy")
    if any(occ):
        charts.append(svg_chart("Batch occupancy (slots in use)",
                                [("slots", t, occ)]))
    if "kv_occupancy" in ts.gauges:
        charts.append(svg_chart("KV occupancy (mean fraction)",
                                [("kv", t, ts.total("kv_occupancy",
                                                    mean=True))]))
    live = [float(v) for v in ts.live_replicas]
    if live and (max(live) != min(live)):
        charts.append(svg_chart("Live replicas",
                                [("replicas", t, live)]))
    return f'<div class="charts">{"".join(charts)}</div>'


def _percentile_table(records: List[Dict[str, Any]]) -> str:
    rows = []
    for rec in records:
        res = rec.get("result", {})
        if not any(k in res for k, _ in _PCT_COLS):
            continue
        cells = "".join(f"<td>{_fmt(res.get(k, float('nan')))}</td>"
                        for k, _ in _PCT_COLS)
        rows.append(f"<tr><td>{_esc(_record_label(rec))}</td>{cells}</tr>")
    if not rows:
        return ""
    head = "".join(f"<th>{_esc(lbl)}</th>" for _, lbl in _PCT_COLS)
    return ("<h2>Latency percentiles (s)</h2><table><tr><th>run</th>"
            f"{head}</tr>{''.join(rows)}</table>")


def _stage_table(records: List[Dict[str, Any]]) -> str:
    rows = []
    for rec in records:
        st = rec.get("stages")
        if not st:
            continue
        cells = "".join(f"<td>{_fmt(st.get(k, 0.0))}</td>"
                        for k in _STAGES)
        rows.append(f"<tr><td>{_esc(_record_label(rec))}</td>{cells}</tr>")
    if not rows:
        return ""
    head = "".join(f"<th>{_esc(k)}</th>" for k in _STAGES)
    return ("<h2>Mean stage latency (s)</h2><table><tr><th>run</th>"
            f"{head}</tr>{''.join(rows)}</table>")


def _provenance_table(records: List[Dict[str, Any]]) -> str:
    rows = []
    for rec in records:
        res = rec.get("result", {})
        if "sim_events_per_sec" not in res and "events" not in res:
            continue
        rows.append(
            f"<tr><td>{_esc(_record_label(rec))}</td>"
            f"<td>{_fmt(res.get('events', float('nan')))}</td>"
            f"<td>{_fmt(res.get('requests_served', float('nan')))}</td>"
            f"<td>{_fmt(res.get('sim_events_per_sec', float('nan')))}</td>"
            f"<td>{_fmt(rec.get('benchmark_wall_s', float('nan')))}</td>"
            "</tr>")
    if not rows:
        return ""
    return ("<h2>Simulator provenance</h2><table><tr><th>run</th>"
            "<th>events</th><th>served</th><th>events/s</th>"
            f"<th>wall (s)</th></tr>{''.join(rows)}</table>")


# ---- baseline delta table --------------------------------------------------
def _compare_baseline(baseline: Dict[str, Any],
                      inputs: Dict[str, Dict[str, Any]]
                      ) -> List[Tuple[str, float, Optional[float],
                                      Optional[float], str]]:
    """Same semantics as ``benchmarks/check_regression.py`` (the gate);
    re-implemented here because the installed package cannot import the
    repo's ``benchmarks/`` scripts."""
    def get_path(node, path):
        for part in path.split("."):
            if not isinstance(node, dict) or part not in node:
                return None
            node = node[part]
        return node

    tol0 = float(baseline.get("default_tolerance", 0.15))
    rows = []
    for name, entry in baseline.get("metrics", {}).items():
        ns, _, path = name.partition(":")
        base = float(entry["value"])
        direction = entry.get("direction", "higher")
        tol = float(entry.get("tolerance", tol0))
        cur = get_path(inputs.get(ns), path)
        if cur is None:
            rows.append((name, base, None, None, "MISSING"))
            continue
        cur = float(cur)
        delta = (cur - base) / abs(base) if base != 0 else (
            0.0 if cur == 0 else float("inf"))
        worse = abs(delta) if direction == "near" else (
            -delta if direction == "higher" else delta)
        failed = worse > tol
        abs_tol = entry.get("abs_tolerance")
        if failed and abs_tol is not None:
            worse_abs = abs(cur - base) if direction == "near" else (
                (base - cur) if direction == "higher" else (cur - base))
            failed = worse_abs > float(abs_tol)
        rows.append((name, base, cur, delta,
                     "FAIL" if failed else "ok"))
    return rows


def _baseline_table(baseline: Dict[str, Any],
                    inputs: Dict[str, Dict[str, Any]]) -> str:
    rows = _compare_baseline(baseline, inputs)
    if not rows:
        return ""
    body = []
    for name, base, cur, delta, status in rows:
        cls = "ok" if status == "ok" else "fail"
        cur_s = _fmt(cur) if cur is not None else "–"
        delta_s = f"{delta:+.1%}" if delta is not None else "–"
        body.append(f"<tr><td>{_esc(name)}</td><td>{_fmt(base)}</td>"
                    f"<td>{cur_s}</td><td>{delta_s}</td>"
                    f'<td class="{cls}">{_esc(status)}</td></tr>')
    return ("<h2>Baseline deltas</h2><table><tr><th>metric</th>"
            "<th>baseline</th><th>current</th><th>delta</th><th>status"
            f"</th></tr>{''.join(body)}</table>")


# ---- top-level render ------------------------------------------------------
def render_report(records: Sequence[Dict[str, Any]], *,
                  title: str = "Benchmark run report",
                  baseline: Optional[Dict[str, Any]] = None,
                  bench_inputs: Optional[Dict[str, Dict[str, Any]]] = None
                  ) -> str:
    records = list(records)
    parts = [f"<h1>{_esc(title)}</h1>",
             f'<div class="sub">{len(records)} PerfDB record(s)</div>']
    sampled = [rec for rec in records
               if rec.get("result", {}).get("sampling_rate", 1.0)
               < 1.0 - 1e-9]
    if sampled:
        rates = ", ".join(
            f"{_esc(rec.get('job_id', '?'))}: "
            f"{rec['result']['sampling_rate']:.1%}" for rec in sampled)
        parts.append(
            '<div class="warn">⚠ Per-request traces were <b>sampled</b> '
            f"(trace_sample &lt; 1) — {rates}. Percentiles and the span "
            "timeline cover the sampled subset; counting aggregates are "
            "exact.</div>")
    for rec in records:
        res = rec.get("result", {})
        parts.append(f"<h2>{_esc(_record_label(rec))}</h2>")
        parts.append(_cards_html(res))
        ts_dict = res.get("timeseries") or rec.get("timeseries")
        if ts_dict:
            parts.append(_timeseries_html(Timeseries.from_dict(ts_dict)))
    parts.append(_percentile_table(records))
    parts.append(_stage_table(records))
    parts.append(_provenance_table(records))
    if baseline is not None:
        parts.append(_baseline_table(baseline, bench_inputs or {}))
    body = "\n".join(p for p in parts if p)
    return ("<!DOCTYPE html>\n<html><head><meta charset=\"utf-8\">"
            f"<title>{_esc(title)}</title><style>{_CSS}</style></head>"
            f"<body>\n{body}\n</body></html>\n")


def write_report(records: Sequence[Dict[str, Any]], path: str, *,
                 title: str = "Benchmark run report",
                 baseline: Optional[Dict[str, Any]] = None,
                 bench_inputs: Optional[Dict[str, Dict[str, Any]]] = None
                 ) -> str:
    out = render_report(records, title=title, baseline=baseline,
                        bench_inputs=bench_inputs)
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(out)
    return str(p)


def load_records(path: str) -> List[Dict[str, Any]]:
    """Read PerfDB JSONL (or a JSON list) into record dicts."""
    text = Path(path).read_text()
    stripped = text.lstrip()
    if stripped.startswith("["):
        return list(json.loads(stripped))
    return [json.loads(line) for line in text.splitlines() if line.strip()]


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report",
        description="Render a static HTML report from PerfDB records")
    ap.add_argument("perfdb", nargs="+",
                    help="PerfDB JSONL file(s) (or JSON record lists)")
    ap.add_argument("-o", "--out", default="report.html",
                    help="output HTML path (default report.html)")
    ap.add_argument("--title", default="Benchmark run report")
    ap.add_argument("--baseline", default=None,
                    help="ci_baseline.json for the delta table")
    ap.add_argument("--bench", action="append", default=[],
                    metavar="NAME=PATH",
                    help="bench --json dump for the delta table "
                         "(repeatable; namespaces match the baseline)")
    args = ap.parse_args(argv)

    records: List[Dict[str, Any]] = []
    for path in args.perfdb:
        records.extend(load_records(path))
    baseline = None
    if args.baseline:
        baseline = json.loads(Path(args.baseline).read_text())
    bench_inputs: Dict[str, Dict[str, Any]] = {}
    for item in args.bench:
        name, _, path = item.partition("=")
        if not path:
            ap.error(f"--bench {item!r} is not NAME=PATH")
        bench_inputs[name] = json.loads(Path(path).read_text())
    write_report(records, args.out, title=args.title, baseline=baseline,
                 bench_inputs=bench_inputs)
    print(f"wrote {args.out} ({len(records)} record(s))")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
