"""Least-squares calibration fitter (measure → model), ported from
``repro.calibrate.fit`` (numpy only).

Turns ``kind="calibration"`` PerfDB records — one measured or oracle
latency per (phase, batch, tokens) grid point — into the parametric
:class:`~repro_torch.serving.latency_model.FittedLatencyModel` coefficients:

    prefill(b, s) = p0 + p1·(b·s) + p2·(b·s²)      (FLOPs + attention)
    decode(b, c)  = d0 + α·b + β·(b·c)             (step + KV read)

Both forms are linear in their parameters, so the fit is an ordinary
least-squares solve with a non-negativity projection (a negative latency
slope is always a fitting artifact, never physics).  Degenerate design
columns — e.g. an fc-family grid where the prompt never varies, or a
CPU decode sweep with no KV context — are detected and dropped, their
coefficients pinned to zero, instead of poisoning the solve.

Residual diagnostics (mean/max relative error, R²) ride along in the
profile; an optional deterministic holdout split reports how well the
fit predicts grid points it never saw.
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.calibrate.profile import CalibrationProfile, PhaseFit

PREFILL, DECODE = "prefill", "decode"
_EPS = 1e-12


# ---- record plumbing -------------------------------------------------------
def _point(rec: Dict[str, Any]) -> Tuple[str, float, float, float]:
    """(phase, batch, tokens, latency_s) from a calibration record."""
    res = rec.get("result", rec)
    lat = res.get("latency_s")
    if lat is None:
        raise ValueError(f"calibration record without result.latency_s: "
                         f"{sorted(rec)}")
    return (str(rec.get("phase", PREFILL)), float(rec.get("batch", 1)),
            float(rec.get("tokens", 0)), float(lat))


def split_points(records: Iterable[Dict[str, Any]]
                 ) -> Dict[str, List[Tuple[float, float, float]]]:
    """Group records into per-phase (batch, tokens, latency) points."""
    phases: Dict[str, List[Tuple[float, float, float]]] = {PREFILL: [],
                                                           DECODE: []}
    for rec in records:
        phase, batch, tokens, lat = _point(rec)
        phases.setdefault(phase, []).append((batch, tokens, lat))
    return phases


def _design(phase: str, batch: np.ndarray, tokens: np.ndarray) -> np.ndarray:
    if phase == PREFILL:
        toks = batch * tokens
        return np.stack([np.ones_like(toks), toks, toks * tokens], axis=1)
    if phase == DECODE:
        return np.stack([np.ones_like(batch), batch, batch * tokens], axis=1)
    raise ValueError(f"unknown phase {phase!r}")


# ---- the solve -------------------------------------------------------------
def _lstsq_nonneg(X: np.ndarray, y: np.ndarray) -> np.ndarray:
    """OLS with degenerate-column dropping and a non-negativity projection.

    Columns with no variation (beyond the intercept) or that duplicate an
    earlier kept column are excluded up front; any column whose fitted
    coefficient comes back negative is zeroed and the rest refit (a crude
    active-set NNLS — exact for these tiny, well-conditioned systems).
    """
    n, k = X.shape
    keep: List[int] = [0]                       # intercept always in
    for j in range(1, k):
        col = X[:, j]
        if np.ptp(col) <= _EPS * max(1.0, float(np.abs(col).max(initial=0))):
            continue                            # constant → intercept's job
        if any(np.allclose(col, X[:, i]) for i in keep[1:]):
            continue                            # duplicate column
        keep.append(j)
    active = list(keep)
    coef = np.zeros(k)
    for _ in range(k + 1):
        sol, *_ = np.linalg.lstsq(X[:, active], y, rcond=None)
        neg = [active[i] for i, c in enumerate(sol)
               if c < -_EPS and active[i] != 0]
        if not neg:
            coef[:] = 0.0
            for i, j in enumerate(active):
                coef[j] = max(float(sol[i]), 0.0)
            return coef
        active = [j for j in active if j not in neg]
    coef[:] = 0.0
    coef[0] = max(float(np.mean(y)), 0.0)       # pathological fallback
    return coef


def _diagnostics(X: np.ndarray, y: np.ndarray,
                 coef: np.ndarray) -> Tuple[float, float, float]:
    pred = X @ coef
    rel = np.abs(pred - y) / np.maximum(np.abs(y), _EPS)
    ss_res = float(np.sum((y - pred) ** 2))
    ss_tot = float(np.sum((y - np.mean(y)) ** 2))
    r2 = 1.0 - ss_res / ss_tot if ss_tot > _EPS else 1.0
    return float(np.mean(rel)), float(np.max(rel)), r2


def fit_phase(points: Sequence[Tuple[float, float, float]],
              phase: str) -> PhaseFit:
    """Least-squares fit of one phase's (batch, tokens, latency) points."""
    if not points:
        raise ValueError(f"no {phase} points to fit")
    arr = np.asarray(points, dtype=float)
    batch, tokens, y = arr[:, 0], arr[:, 1], arr[:, 2]
    X = _design(phase, batch, tokens)
    coef = _lstsq_nonneg(X, y)
    mean_rel, max_rel, r2 = _diagnostics(X, y, coef)
    return PhaseFit(coef=(float(coef[0]), float(coef[1]), float(coef[2])),
                    n_points=len(points), mean_rel_err=mean_rel,
                    max_rel_err=max_rel, r2=r2)


def _phase_predict(fit: PhaseFit, phase: str, batch: float,
                   tokens: float) -> float:
    X = _design(phase, np.asarray([batch], float), np.asarray([tokens], float))
    return float(X[0] @ np.asarray(fit.coef))


def _holdout_split(points: Sequence[Tuple[float, float, float]],
                   fraction: float) -> Tuple[list, list]:
    """Deterministic split: every k-th point (in grid order) held out."""
    if fraction <= 0.0 or len(points) < 4:
        return list(points), []
    k = max(int(round(1.0 / fraction)), 2)
    pts = sorted(points)
    train = [p for i, p in enumerate(pts) if i % k != k - 1]
    held = [p for i, p in enumerate(pts) if i % k == k - 1]
    return (train, held) if train else (list(pts), [])


def _holdout_errs(fit: PhaseFit, phase: str, held: Sequence) -> List[float]:
    return [abs(_phase_predict(fit, phase, b, t) - y) / max(abs(y), _EPS)
            for b, t, y in held]


# ---- public entry ----------------------------------------------------------
def fit_records(records: Iterable[Dict[str, Any]], *, model: str,
                hardware: str, chips: int = 1, source: str = "measured-cpu",
                holdout_fraction: float = 0.0,
                cold_start_s: float = 2.0,
                grid: Optional[Dict[str, Sequence[int]]] = None
                ) -> CalibrationProfile:
    """Fit a :class:`CalibrationProfile` from calibration records.

    With ``holdout_fraction > 0`` each phase is first fit on a
    deterministic train split and scored on the held-out grid points
    (``profile.holdout``); the shipped coefficients are then refit on
    *all* points — the holdout numbers measure generalization, the final
    fit uses every measurement.

    A grid with no usable decode points (e.g. fc/cnn generated families,
    which have no autoregressive phase) derives the decode fit from the
    prefill coefficients at prompt length 1, so the profile always
    drives the full simulator interface.
    """
    phases = split_points(records)
    if not phases[PREFILL] and not phases[DECODE]:
        raise ValueError("no calibration records to fit")
    if not phases[PREFILL]:
        # decode-only sweep: a decode step *is* a 1-token prefill
        phases[PREFILL] = [(b, 1.0, y) for b, _, y in phases[DECODE]]

    holdout: Dict[str, float] = {}
    fits: Dict[str, PhaseFit] = {}
    for phase in (PREFILL, DECODE):
        pts = phases[phase]
        if not pts:
            continue
        train, held = _holdout_split(pts, holdout_fraction)
        if held:
            probe = fit_phase(train, phase)
            errs = _holdout_errs(probe, phase, held)
            holdout[f"{phase}_mean_rel_err"] = float(np.mean(errs))
            holdout[f"{phase}_max_rel_err"] = float(np.max(errs))
            holdout[f"{phase}_points"] = len(held)
        fits[phase] = fit_phase(pts, phase)

    if DECODE not in fits:
        p0, p1, p2 = fits[PREFILL].coef
        fits[DECODE] = PhaseFit(coef=(p0, p1 + p2, 0.0),
                                n_points=0, derived_from=PREFILL)
    if holdout:
        errs = [v for k, v in holdout.items() if k.endswith("mean_rel_err")]
        holdout["mean_rel_err"] = float(np.mean(errs))

    return CalibrationProfile(
        model=model, hardware=hardware, chips=chips, source=source,
        prefill=fits[PREFILL], decode=fits[DECODE],
        cold_start_s=float(cold_start_s),
        holdout=holdout or None, grid=dict(grid) if grid else None)
