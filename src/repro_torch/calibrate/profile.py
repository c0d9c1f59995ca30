"""Calibration profiles — named, persisted latency-model fits; ported from
``repro.calibrate.profile`` with the same schema, so a profile written by
either package is read by the other.

A profile is the JSON artifact that closes the measure→model→plan loop:
the microbenchmark harness measures a (batch × seq) grid, the fitter
turns the records into the parametric coefficients below, and the
capacity planner reloads them (by path or ``model@hardware`` key) to
drive the cluster simulator without re-running any benchmark.

Profiles live under ``configs/profiles/`` as
``<model>__<hardware>.json``; the schema is documented in
``configs/profiles/README.md`` and versioned via the ``schema`` field.
"""
from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path
from typing import Any, Dict, Optional, Sequence, Tuple, Union

PROFILE_SCHEMA = "repro.calibration-profile.v1"
DEFAULT_PROFILE_DIR = "configs/profiles"

PREFILL_TERMS = ("base_s", "per_token_s", "per_token_per_prompt_s")
DECODE_TERMS = ("base_s", "alpha_s", "beta_s")


@dataclasses.dataclass(frozen=True)
class PhaseFit:
    """One phase's fitted coefficients + residual diagnostics.

    ``coef`` is ordered like the phase's design matrix —
    prefill: ``(base, per-token, per-token·prompt)``;
    decode: ``(base, α per-sequence, β per-cached-token)``.
    """
    coef: Tuple[float, float, float]
    n_points: int = 0
    mean_rel_err: float = 0.0
    max_rel_err: float = 0.0
    r2: float = 1.0
    derived_from: Optional[str] = None   # e.g. decode reused a prefill fit

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "PhaseFit":
        d = dict(d)
        d["coef"] = tuple(float(c) for c in d["coef"])
        return cls(**d)


@dataclasses.dataclass(frozen=True)
class CalibrationProfile:
    """A (model, hardware) latency fit, persistable as JSON."""
    model: str
    hardware: str
    chips: int
    source: str                       # measured-cpu | oracle
    prefill: PhaseFit
    decode: PhaseFit
    cold_start_s: float = 2.0
    holdout: Optional[Dict[str, float]] = None   # held-out validation errs
    grid: Optional[Dict[str, Sequence[int]]] = None
    # per-kernel microbench fits keyed "<kernel>/<dtype>" — PhaseFit dict
    # plus provenance (backend, phase, n_points, max_err vs reference);
    # produced by a kernel_bench backend, absent on plain profiles
    kernels: Optional[Dict[str, Dict[str, Any]]] = None
    # calibrated SpeedMode parameter dicts keyed by mode name ("int8",
    # "speculative", ...) — resolve_speed_mode() consults these before
    # the built-in presets when the planner expands its speed_modes axis
    speed_modes: Optional[Dict[str, Dict[str, Any]]] = None
    created_ts: Optional[float] = None
    schema: str = PROFILE_SCHEMA

    @property
    def key(self) -> str:
        return f"{self.model}@{self.hardware}"

    # ---- serialization ----------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["prefill"] = self.prefill.to_dict()
        d["decode"] = self.decode.to_dict()
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "CalibrationProfile":
        d = dict(d)
        schema = d.get("schema", PROFILE_SCHEMA)
        if schema != PROFILE_SCHEMA:
            raise ValueError(f"unsupported profile schema {schema!r} "
                             f"(this build reads {PROFILE_SCHEMA!r})")
        d["prefill"] = PhaseFit.from_dict(d["prefill"])
        d["decode"] = PhaseFit.from_dict(d["decode"])
        return cls(**d)

    def to_json(self, indent: int = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    @classmethod
    def from_json(cls, text: str) -> "CalibrationProfile":
        return cls.from_dict(json.loads(text))

    def save(self, profile_dir: Union[str, Path] = DEFAULT_PROFILE_DIR
             ) -> Path:
        path = profile_path(profile_dir, self.model, self.hardware)
        path.parent.mkdir(parents=True, exist_ok=True)
        prof = self if self.created_ts is not None else \
            dataclasses.replace(self, created_ts=time.time())
        path.write_text(prof.to_json() + "\n")
        return path

    # ---- use --------------------------------------------------------------
    def to_latency_model(self):
        """The simulator-facing oracle for this profile."""
        from repro_torch.serving.latency_model import FittedLatencyModel
        return FittedLatencyModel.from_profile(self)

    def predict(self, phase: str, batch: int, tokens: int) -> float:
        """Closed-form prediction for one grid point (diagnostics/tests)."""
        lm = self.to_latency_model()
        if phase == "prefill":
            return lm.prefill_latency(batch, tokens)
        if phase == "decode":
            return lm.decode_latency(batch, tokens)
        raise ValueError(f"unknown phase {phase!r}")


def profile_path(profile_dir: Union[str, Path], model: str,
                 hardware: str) -> Path:
    return Path(profile_dir) / f"{model}__{hardware}.json"


def load_profile(ref: Union[str, Path],
                 profile_dir: Union[str, Path] = DEFAULT_PROFILE_DIR
                 ) -> CalibrationProfile:
    """Load a profile by JSON path or ``model@hardware`` key.

    A key is resolved to ``<profile_dir>/<model>__<hardware>.json``.
    """
    path = Path(ref)
    if not path.exists() and "@" in str(ref):
        model, _, hardware = str(ref).partition("@")
        path = profile_path(profile_dir, model, hardware)
    if not path.exists():
        have = sorted(p.name for p in Path(profile_dir).glob("*.json")) \
            if Path(profile_dir).is_dir() else []
        raise FileNotFoundError(
            f"no calibration profile at {ref!r} (profile_dir={profile_dir}; "
            f"available: {have or 'none'})")
    return CalibrationProfile.from_json(path.read_text())
