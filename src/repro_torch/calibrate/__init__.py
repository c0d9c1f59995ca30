"""repro_torch.calibrate — ``repro.calibrate`` on the card: automatic
latency-model calibration + SLO-aware capacity planning (measure → model →
plan), with the reference's schema.

  1. **measure** — :mod:`.microbench` sweeps prefill/decode latency over a
     (batch × seq) grid (generated models on the device, the roofline
     oracle for registered archs), and :mod:`.kernel_bench` times the
     Hopper kernels on its hook, emitting ``kind="calibration"`` PerfDB
     records;
  2. **model** — :mod:`.fit` least-squares fits the parametric
     ``FittedLatencyModel`` coefficients and persists them as named
     :mod:`.profile` JSONs keyed by (model, hardware), ``h100`` included;
  3. **plan** — :mod:`.planner` reloads a profile and searches a replicas ×
     batching-policy × router grid with the cluster simulator for the
     best configuration meeting a latency SLO target.

All three run through ``BenchmarkSession.submit`` via ``CalibrationSpec`` /
``PlanSpec``, the ``repro_torch.launch.run_jobs`` launcher, or directly
through the functions re-exported here.
"""
from repro_torch.calibrate.fit import fit_phase, fit_records, split_points
from repro_torch.calibrate.kernel_bench import (attach_kernel_calibration,
                                                derive_speed_modes,
                                                fit_kernel_records,
                                                kernel_records,
                                                kernel_registry)
from repro_torch.calibrate.microbench import (fit_calibration,
                                              measured_records,
                                              oracle_records,
                                              run_calibration_job,
                                              sweep_calibration)
from repro_torch.calibrate.planner import (PlanCandidate, PlanResult,
                                           plan_capacity, plan_from_spec,
                                           run_plan_job, simulate_candidate)
from repro_torch.calibrate.profile import (DEFAULT_PROFILE_DIR, PROFILE_SCHEMA,
                                           CalibrationProfile, PhaseFit,
                                           load_profile, profile_path)

__all__ = [
    "CalibrationProfile", "PhaseFit", "PlanCandidate", "PlanResult",
    "DEFAULT_PROFILE_DIR", "PROFILE_SCHEMA",
    "attach_kernel_calibration", "derive_speed_modes", "fit_calibration",
    "fit_kernel_records", "fit_phase", "fit_records", "kernel_records",
    "kernel_registry", "load_profile", "measured_records", "oracle_records",
    "plan_capacity", "plan_from_spec", "profile_path", "run_calibration_job",
    "run_plan_job", "simulate_candidate", "split_points",
    "sweep_calibration",
]
