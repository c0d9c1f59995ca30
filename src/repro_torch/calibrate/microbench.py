"""Microbenchmark harness (the measure step of measure → model → plan),
ported from ``repro.calibrate.microbench``.

Sweeps prefill/decode latency over a (batch × seq) grid and emits one
PerfDB record per grid point under ``kind="calibration"``, with the
reference's schema:

  * **measured mode** — §4.2.2 generated canonical models (fc / cnn /
    lstm / transformer) are built once on the device and wall-clocked for
    real at every grid point (``MeasuredLatency``, which waits for the
    card).  Families with a sequence axis yield prefill points at every
    (batch, seq) plus per-step decode points at seq 1; fc/cnn have no
    autoregressive phase, so their forward cost becomes prompt-length-1
    prefill points and the fitter derives the decode curve.  The records'
    mode names the device: ``"measured-cuda"`` on the card,
    ``"measured-cpu"`` (the reference's) on the CPU.
  * **oracle mode** — registered archs are swept through the analytic
    roofline ``LatencyModel``.  Registered archs have no measured mode, as
    in the reference.

``run_calibration_job`` is the :class:`BenchmarkSession` stage runner for
:class:`~repro_torch.core.spec.CalibrationSpec` submissions: sweep, fit,
the kernel hook (the port's Hopper kernels on the same grid), optionally
persist the named profile, and return a typed ``JobResult`` whose
``extra_records`` carry the raw grid for PerfDB.
"""
from __future__ import annotations

import math
import time
from typing import Any, Dict, Iterable, List, Optional, Sequence

from repro_torch import hw as hw_lib
from repro_torch import ieee_fp32, resolve_device
from repro_torch.calibrate.fit import fit_records
from repro_torch.calibrate.profile import CalibrationProfile
from repro_torch.core.results import JobResult
from repro_torch.core.spec import CalibrationSpec

SEQ_FAMILIES = ("lstm", "transformer")     # generated families with a seq axis


def _record(spec_meta: Dict[str, Any], phase: str, batch: int, tokens: int,
            latency_s: float, mode: str) -> Dict[str, Any]:
    return dict(spec_meta, kind="calibration", phase=phase,
                batch=int(batch), tokens=int(tokens),
                result={"latency_s": float(latency_s), "mode": mode})


def oracle_records(oracle, *, batches: Sequence[int], seqs: Sequence[int],
                   contexts: Optional[Sequence[int]] = None,
                   meta: Optional[Dict[str, Any]] = None
                   ) -> List[Dict[str, Any]]:
    """Sweep any ``LatencyOracle`` analytically over the grid.

    Used by ``LatencyModel.to_profile`` (roofline → profile round-trip)
    and by tests that synthesize records from a known fitted model.
    """
    contexts = tuple(contexts) if contexts else tuple(seqs)
    meta = dict(meta or {})
    records = []
    for b in batches:
        for s in seqs:
            records.append(_record(meta, "prefill", b, s,
                                   oracle.prefill_latency(b, s), "oracle"))
        for c in contexts:
            records.append(_record(meta, "decode", b, c,
                                   oracle.decode_latency(b, c), "oracle"))
    return records


def measured_records(spec: CalibrationSpec,
                     meta: Optional[Dict[str, Any]] = None,
                     device=None) -> List[Dict[str, Any]]:
    """Execute the generated model for real on ``device`` (the card unless
    ``device="cpu"``) at every grid point."""
    from repro_torch.core import generator as gen_lib
    from repro_torch.serving.latency_model import MeasuredLatency

    model = spec.model
    if model.kind != "generated":
        raise ValueError("measured calibration needs a generated model "
                         f"(got {model.kind!r}:{model.name!r}); registered "
                         "archs calibrate through the oracle mode")
    dev = resolve_device(device)
    meta = dict(meta or {})
    has_seq = model.family in SEQ_FAMILIES
    seqs = tuple(spec.seqs) if has_seq else (1,)

    # params are independent of (batch, seq) — build once, on the device
    base = gen_lib.GeneratedSpec(family=model.family, layers=model.layers,
                                 width=model.width)
    module, _ = gen_lib.build(base, dev)
    clock = MeasuredLatency(module, iters=max(spec.repeats, 1),
                            reducer="min")

    def inputs_for(batch: int, seq: int):
        point = gen_lib.GeneratedSpec(family=model.family,
                                      layers=model.layers, width=model.width,
                                      batch=batch, seq=seq)
        return gen_lib.example_inputs(point, dev)

    # (phase, batch, tokens, inputs) for every grid point
    points = []
    for b in spec.batches:
        for s in seqs:
            # a full forward over s tokens is the prefill analog; fc/cnn
            # collapse to prompt length 1 (one "token" per example)
            points.append(("prefill", b, s, inputs_for(b, s)))
        if has_seq:
            # one-token step = the decode analog (no KV context on the
            # stateless generated models — the fitter pins β to zero)
            points.append(("decode", b, 0, inputs_for(b, 1)))

    # two sweeps over the grid, keeping the per-point minimum: the second
    # pass washes out first-touch effects (clock ramp, allocator growth)
    # that would bias early points.  The model is fp32: its products stay
    # IEEE fp32, whatever the caller's TF32 settings
    best = [math.inf] * len(points)
    with ieee_fp32():
        for _ in range(2):
            for i, (_, _, _, inputs) in enumerate(points):
                best[i] = min(best[i], clock.measure(*inputs))

    mode = f"measured-{dev.type}"
    return [_record(meta, phase, b, toks, lat, mode)
            for (phase, b, toks, _), lat in zip(points, best)]


def resolve_mode(spec: CalibrationSpec) -> str:
    if spec.mode in ("measured", "oracle"):
        return spec.mode
    return "measured" if spec.model.kind == "generated" else "oracle"


def _oracle(spec: CalibrationSpec):
    from repro_torch.configs import get_config
    from repro_torch.serving.latency_model import LatencyModel
    return LatencyModel(get_config(spec.model.name),
                        hw=hw_lib.HARDWARE[spec.hardware], chips=spec.chips)


def sweep_calibration(spec: CalibrationSpec, db=None,
                      device=None) -> List[Dict[str, Any]]:
    """Run the microbenchmark sweep; append records to ``db`` if given.
    ``device`` is where a measured sweep runs (the card unless
    ``device="cpu"``); the oracle mode touches no device."""
    meta = {"job_id": spec.job_id, "user": spec.user,
            "arch": spec.model.label, "hardware": spec.hardware,
            "chips": spec.chips}
    if resolve_mode(spec) == "measured":
        records = measured_records(spec, meta, device=device)
    else:
        records = oracle_records(_oracle(spec), batches=spec.batches,
                                 seqs=spec.seqs, contexts=spec.contexts,
                                 meta=meta)
    if db is not None:
        for rec in records:
            db.append(rec)
    return records


def fit_calibration(spec: CalibrationSpec,
                    records: Iterable[Dict[str, Any]]) -> CalibrationProfile:
    """Fit the sweep's records into this spec's named profile.  A measured
    profile's ``source`` is its records' mode, which names the device they
    ran on (``"measured-cpu"``, the reference's, or ``"measured-cuda"``)."""
    mode = resolve_mode(spec)
    records = list(records)
    cold_start_s = 2.0
    if mode == "oracle":
        source = "oracle"
        cold_start_s = _oracle(spec).cold_start()
    else:
        modes = {r["result"]["mode"] for r in records}
        if len(modes) != 1:
            raise ValueError(f"measured records from more than one device: {sorted(modes)}")
        source = modes.pop()
    # grid metadata comes from the records actually measured — measured
    # fc/cnn sweeps collapse the seq axis, so the spec's grid would lie
    grid = {
        "batches": sorted({r["batch"] for r in records}),
        "seqs": sorted({r["tokens"] for r in records
                        if r["phase"] == "prefill"}),
        "contexts": sorted({r["tokens"] for r in records
                            if r["phase"] == "decode"}),
    }
    return fit_records(
        records, model=spec.model.label, hardware=spec.hardware,
        chips=spec.chips, source=source,
        holdout_fraction=spec.holdout_fraction,
        cold_start_s=cold_start_s, grid=grid)


def run_calibration_job(spec: CalibrationSpec, device=None) -> JobResult:
    """BenchmarkSession stage runner for a calibration submission.
    ``device`` is where the measured sweep and the kernel hook run (the
    card unless ``device="cpu"``)."""
    t0 = time.time()
    records = sweep_calibration(spec, device=device)
    profile = fit_calibration(spec, records)
    kernel_recs: List[Dict[str, Any]] = []
    if spec.kernels:
        # Hopper-kernel backend: microbench the requested kernels on the
        # same (batch × seq) grid and fold their fits + derived speed
        # modes into the profile (records keep backend provenance)
        from repro_torch.calibrate import kernel_bench
        meta = {"job_id": spec.job_id, "user": spec.user,
                "arch": spec.model.label, "hardware": spec.hardware,
                "chips": spec.chips}
        kernel_recs = kernel_bench.kernel_records(
            spec.kernels, batches=spec.batches, seqs=spec.seqs,
            repeats=max(spec.repeats, 1), target=spec.kernel_target,
            meta=meta, device=device)
        profile = kernel_bench.attach_kernel_calibration(
            profile, kernel_recs)
        records = records + kernel_recs
    saved: Optional[str] = None
    if spec.profile_dir:
        saved = str(profile.save(spec.profile_dir))
    metrics: Dict[str, Any] = {
        "mode": profile.source,
        "n_records": len(records),
        "prefill_mean_rel_err": profile.prefill.mean_rel_err,
        "prefill_r2": profile.prefill.r2,
        "decode_mean_rel_err": profile.decode.mean_rel_err,
        "decode_r2": profile.decode.r2,
        "profile_key": profile.key,
        "profile_path": saved,
        "profile": profile.to_dict(),
    }
    if kernel_recs:
        metrics["n_kernel_records"] = len(kernel_recs)
        metrics["kernels"] = sorted({r["kernel"] for r in kernel_recs})
    if profile.holdout:
        metrics["holdout"] = dict(profile.holdout)
    return JobResult(spec=spec, metrics=metrics, extra_records=records,
                     benchmark_wall_s=time.time() - t0)
