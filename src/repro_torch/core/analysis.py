"""Analysis stage (paper §4.2.5 + §4.3.1): aggregator, CDF, heat maps,
roofline points, configuration recommender, leaderboard.

A copy of ``repro.core.analysis``, importing only ``repro_torch``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch import hw as hw_lib
from repro_torch.core.perfdb import PerfDB


# ---- CDF (Fig. 11) ---------------------------------------------------------
def cdf(values: Sequence[float], points: int = 100) -> Tuple[List[float], List[float]]:
    v = np.sort(np.asarray(values, dtype=float))
    if len(v) == 0:
        return [], []
    qs = np.linspace(0, 1, points)
    return list(np.quantile(v, qs)), list(qs)


# ---- heat maps (Fig. 9) ----------------------------------------------------
def heatmap(db: PerfDB, *, row_key: str, col_key: str, value_key: str,
            **filters) -> Dict[str, Any]:
    """Pivot PerfDB records into a (rows × cols) matrix of means.

    Dotted keys resolve through :meth:`PerfDB.get_path`; zero matching
    records yield an empty matrix rather than an error.
    """
    recs = db.query(**filters)
    get = PerfDB.get_path
    empty = {"rows": [], "cols": [], "matrix": [],
             "row_key": row_key, "col_key": col_key, "value_key": value_key}
    if not recs:
        return empty
    rows = sorted({get(r, row_key) for r in recs} - {None})
    cols = sorted({get(r, col_key) for r in recs} - {None})
    if not rows or not cols:
        return empty
    mat = np.full((len(rows), len(cols)), np.nan)
    for r in recs:
        rv, cv, val = get(r, row_key), get(r, col_key), get(r, value_key)
        if rv is None or cv is None or val is None:
            continue
        i, j = rows.index(rv), cols.index(cv)
        mat[i, j] = val if np.isnan(mat[i, j]) else (mat[i, j] + val) / 2
    return {"rows": rows, "cols": cols, "matrix": mat.tolist(),
            "row_key": row_key, "col_key": col_key, "value_key": value_key}


def render_heatmap(hm: Dict[str, Any], fmt: str = "{:7.3f}") -> str:
    lines = [f"heatmap: {hm['value_key']}  (rows={hm['row_key']}, "
             f"cols={hm['col_key']})"]
    header = " " * 10 + "".join(f"{c!s:>10}" for c in hm["cols"])
    lines.append(header)
    for rname, row in zip(hm["rows"], hm["matrix"]):
        cells = "".join(f"{fmt.format(v) if v == v else '      -':>10}"
                        for v in row)
        lines.append(f"{rname!s:>10}{cells}")
    return "\n".join(lines)


# ---- roofline points (Fig. 10) ---------------------------------------------
def roofline_point(flops: float, bytes_moved: float,
                   runtime_s: float) -> Dict[str, float]:
    """(arithmetic intensity, attained FLOP/s) for one measured run."""
    return {
        "intensity": flops / max(bytes_moved, 1.0),
        "attained_flops": flops / max(runtime_s, 1e-12),
    }


def roofline_ceiling(hw: hw_lib.HardwareModel,
                     intensities: Sequence[float]) -> List[float]:
    return [hw.attainable_flops(i) for i in intensities]


# ---- SLO attainment + saturation knee (cluster capacity planning) ----------
def slo_attainment(latencies: Sequence[float], slo_latency_s: float) -> float:
    """Fraction of requests whose latency met the SLO."""
    lat = np.asarray(latencies, dtype=float)
    if lat.size == 0:
        return 0.0
    return float(np.mean(lat <= slo_latency_s))


def jain_index(values: Sequence[float]) -> float:
    """Jain's fairness index: (Σx)² / (n·Σx²) over per-tenant allocations.

    1.0 when every tenant gets an equal (share-normalized) allocation,
    → 1/n as a single tenant monopolizes; 0.0 for empty/all-zero input
    (nothing was allocated, so no fairness to speak of).
    """
    v = np.asarray(values, dtype=float)
    denom = v.size * float(np.square(v).sum())
    if denom == 0.0:
        return 0.0
    return float(v.sum()) ** 2 / denom


def saturation_knee(rates: Sequence[float], p99s: Sequence[float],
                    slo_latency_s: float) -> Optional[float]:
    """Highest offered rate whose p99 still meets the SLO (ramp sweeps).

    Scans (rate, p99) pairs in increasing-rate order and returns the last
    rate before the SLO is first violated — the serving capacity knee —
    or None if even the lowest rate misses the SLO.
    """
    knee = None
    for rate, p99 in sorted(zip(rates, p99s)):
        if p99 <= slo_latency_s:
            knee = rate
        else:
            break
    return knee


# ---- calibration fit quality + capacity plan (repro_torch.calibrate) -------------
def fit_report(profile) -> str:
    """Human-readable fit-quality report for a ``CalibrationProfile``.

    Duck-typed (profile objects or their dict form) so the analysis
    layer stays import-light.
    """
    if isinstance(profile, dict):
        from repro_torch.calibrate.profile import CalibrationProfile
        profile = CalibrationProfile.from_dict(profile)
    lines = [f"calibration profile: {profile.key}  "
             f"(chips={profile.chips}, source={profile.source})"]
    for phase, names in (("prefill", ("base_s", "per_token_s",
                                      "per_token_per_prompt_s")),
                         ("decode", ("base_s", "alpha_s", "beta_s"))):
        fit = getattr(profile, phase)
        coef = "  ".join(f"{n}={c:.3e}" for n, c in zip(names, fit.coef))
        lines.append(f"  {phase:8s} {coef}")
        if fit.derived_from:
            lines.append(f"  {'':8s} (derived from {fit.derived_from}; "
                         "no measured points)")
        else:
            lines.append(f"  {'':8s} n={fit.n_points}  "
                         f"mean|rel err|={fit.mean_rel_err:.1%}  "
                         f"max={fit.max_rel_err:.1%}  R²={fit.r2:.4f}")
    if profile.holdout:
        h = profile.holdout
        lines.append("  holdout  " + "  ".join(
            f"{k}={v:.1%}" if k.endswith("rel_err") else f"{k}={v:g}"
            for k, v in sorted(h.items())))
    return "\n".join(lines)


def fleet_label(fleet) -> str:
    """Compact one-line label for a fleet composition — a ``+``-joined
    ``N×hardware`` term per pool, annotated with ``(spot)`` pricing and
    ``@region`` placement when set (PoolSpec dicts or instances)."""
    terms = []
    for p in fleet:
        if not isinstance(p, dict):
            p = dataclasses.asdict(p)
        term = f"{p.get('replicas', 1)}x{p.get('hardware') or 'base'}"
        if p.get("pricing", "reserved") != "reserved":
            term += f"({p['pricing']})"
        if p.get("region"):
            term += f"@{p['region']}"
        terms.append(term)
    return "+".join(terms)


def plan_table(plan) -> str:
    """Render a ``PlanResult`` grid: feasible configs first, best starred;
    memory-rejected candidates print their rejection reason.  The
    ``split`` column shows disaggregated candidates as ``P+D``
    (prefill+decode replicas), ``-`` for colocated; the ``fleet``
    column compacts heterogeneous compositions to
    ``2xtpu-v5e+2xt4(spot)``, ``-`` for flat clusters."""
    best = plan.best
    slos = []
    if getattr(plan, "slo_latency_s", None) is not None:
        slos.append(f"e2e ≤ {plan.slo_latency_s * 1e3:.0f}ms")
    if getattr(plan, "ttft_slo_s", None) is not None:
        slos.append(f"ttft ≤ {plan.ttft_slo_s * 1e3:.0f}ms")
    if getattr(plan, "tpot_slo_s", None) is not None:
        slos.append(f"tpot ≤ {plan.tpot_slo_s * 1e3:.1f}ms")
    header = (f"capacity plan vs {plan.profile_key}: "
              f"SLO p({' ∧ '.join(slos)}) ≥ "
              f"{plan.slo_target:.0%}, minimize {plan.objective}")
    cols = f"{'':2s}{'replicas':>9}{'split':>7}{'fleet':>24}" \
           f"{'policy':>12}" \
           f"{'router':>14}{'slots':>7}{'mode':>12}{'thr rps':>9}" \
           f"{'p99 ms':>8}{'ttft99':>8}{'slo':>6}{plan.objective:>18}"
    lines = [header, cols]
    for c in plan.candidates:
        m = c.metrics
        slots = getattr(c, "max_batch", 0) or "-"
        split = getattr(c, "split", None)
        split_s = f"{split[0]}+{split[1]}" if split else "-"
        fleet = getattr(c, "fleet", None)
        fleet_s = fleet_label(fleet) if fleet else "-"
        mode = getattr(c, "speed_mode", "fp16") or "fp16"
        prefix = f"{'':2s}{c.replicas:>9}{split_s:>7}{fleet_s:>24}" \
                 f"{c.policy:>12}" \
                 f"{c.router:>14}{slots:>7}{mode:>12}"
        if getattr(c, "infeasible_reason", None):
            lines.append(f"m {prefix[2:]}  REJECTED: {c.infeasible_reason}")
            continue
        star = "* " if best is not None and c == best else \
            ("  " if c.meets_slo else "x ")
        ttft99 = m.get("ttft_p99_s")
        ttft_s = f"{ttft99 * 1e3:>8.1f}" if ttft99 is not None \
            else f"{'-':>8}"
        lines.append(f"{star}{prefix[2:]}"
                     f"{m['throughput_rps']:>9.1f}{m['p99_s'] * 1e3:>8.1f}"
                     f"{ttft_s}"
                     f"{m['slo_attainment']:>6.2f}{c.objective:>18.6f}")
    if best is None:
        lines.append("  (no configuration met the SLO target)")
    return "\n".join(lines)


# ---- KV-cache memory accounting (memory-aware serving) ---------------------
def memory_table(db: PerfDB, **filters) -> str:
    """Per-job KV-cache occupancy / prefix-hit / preemption table over
    benchmark records that ran with memory accounting enabled."""
    recs = [r for r in db.query(**filters) if r.get("memory")]
    cols = f"{'job_id':>16}{'arch':>14}{'policy':>12}{'blocks':>8}" \
           f"{'peak occ':>10}{'mean occ':>10}{'hit rate':>10}" \
           f"{'preempt':>9}{'evict':>7}"
    lines = ["KV-cache accounting (per-replica blocks)", cols]
    for r in recs:
        m = r["memory"]
        lines.append(
            f"{r.get('job_id', '?'):>16}{r.get('arch', '?'):>14}"
            f"{r.get('policy', '?'):>12}"
            f"{m.get('total_blocks_per_replica', 0):>8}"
            f"{m.get('peak_occupancy', 0.0):>10.2%}"
            f"{m.get('mean_occupancy', 0.0):>10.2%}"
            f"{m.get('prefix_hit_rate', 0.0):>10.2%}"
            f"{m.get('preemptions', 0):>9}{m.get('evictions', 0):>7}")
    if not recs:
        lines.append("  (no records with memory accounting)")
    return "\n".join(lines)


# ---- recommender (paper's utility function) --------------------------------
def recommend(db: PerfDB, *, slo_latency_s: float, metric: str = "p99_s",
              objective: str = "cost_per_1k_req", top: int = 3,
              **filters) -> List[Dict[str, Any]]:
    """Top-k configurations meeting the latency SLO at minimum objective."""
    recs = [r for r in db.query(**filters)
            if r.get("result", {}).get(metric) is not None
            and r["result"][metric] <= slo_latency_s]
    recs.sort(key=lambda r: r["result"].get(objective, float("inf")))
    return recs[:top]


# ---- leaderboard ------------------------------------------------------------
def leaderboard(db: PerfDB, *, sort_by: str = "throughput_rps",
                ascending: bool = False, limit: int = 20,
                **filters) -> str:
    recs = [r for r in db.query(**filters) if "result" in r]
    if "kind" not in filters:
        # calibration grid points / plan records aren't serving results;
        # keep them out unless a kind is asked for explicitly
        recs = [r for r in recs if r.get("kind", "benchmark") == "benchmark"]
    recs.sort(key=lambda r: r["result"].get(sort_by, 0.0), reverse=not ascending)
    cols = ["job_id", "arch", "policy", "chips", "throughput_rps",
            "p50_s", "p99_s", "utilization", "cost_per_1k_req"]
    lines = ["  ".join(f"{c:>16}" for c in cols)]
    for r in recs[:limit]:
        res = r["result"]
        row = [r.get("job_id", "?"), r.get("arch", "?"),
               r.get("policy", "?"), r.get("chips", "?")]
        row += [f"{res.get(k, float('nan')):.4g}" for k in cols[4:]]
        lines.append("  ".join(f"{str(c):>16}" for c in row))
    return "\n".join(lines)
