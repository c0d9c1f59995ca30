"""repro_torch.calibrate — the measure → model half of ``repro.calibrate``
on the card: the microbenchmark sweeps and the calibration stage runner
(:mod:`.microbench`), the Hopper-kernel calibration backend
(:mod:`.kernel_bench`), the least-squares fitter (:mod:`.fit`) and
calibration profiles (:mod:`.profile`), with the reference's schema.  The
capacity planner (model → plan) comes with the next slice of the port.
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
from repro_torch.calibrate.profile import (DEFAULT_PROFILE_DIR, PROFILE_SCHEMA,
                                           CalibrationProfile, PhaseFit,
                                           load_profile, profile_path)

__all__ = [
    "CalibrationProfile", "PhaseFit", "DEFAULT_PROFILE_DIR", "PROFILE_SCHEMA",
    "attach_kernel_calibration", "derive_speed_modes", "fit_calibration",
    "fit_kernel_records", "fit_phase", "fit_records", "kernel_records",
    "kernel_registry", "load_profile", "measured_records", "oracle_records",
    "profile_path", "run_calibration_job", "split_points",
    "sweep_calibration",
]
