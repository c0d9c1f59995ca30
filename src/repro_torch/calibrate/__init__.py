"""repro_torch.calibrate — the measure → model half of ``repro.calibrate``
on the card: the Hopper-kernel calibration backend (:mod:`.kernel_bench`),
the least-squares fitter (:mod:`.fit`) and calibration profiles
(:mod:`.profile`), with the reference's schema.
"""
from repro_torch.calibrate.fit import fit_phase, fit_records, split_points
from repro_torch.calibrate.kernel_bench import (attach_kernel_calibration,
                                                derive_speed_modes,
                                                fit_kernel_records,
                                                kernel_records,
                                                kernel_registry)
from repro_torch.calibrate.profile import (DEFAULT_PROFILE_DIR, PROFILE_SCHEMA,
                                           CalibrationProfile, PhaseFit,
                                           load_profile, profile_path)

__all__ = [
    "CalibrationProfile", "PhaseFit", "DEFAULT_PROFILE_DIR", "PROFILE_SCHEMA",
    "attach_kernel_calibration", "derive_speed_modes", "fit_kernel_records",
    "fit_phase", "fit_records", "kernel_records", "kernel_registry",
    "load_profile", "profile_path", "split_points",
]
