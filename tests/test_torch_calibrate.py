"""The port's kernel-calibration backend against ``repro.calibrate`` on the
same inputs.

The registries agree on names, phases and dtypes; on each case's inputs
(made by the port from a numpy seed, converted to jnp) the port's reference
is within ``VERIFY_TOL`` (scaled by max|want|) of the JAX reference, and the
port's kernel entry point (its plain version on the CPU) within it of the
Pallas kernel in interpret mode (bit for bit for int8).  The fitter, the
profile schema, the fitted oracle and its speed modes give the reference's
numbers exactly (rtol 1e-12 for the least-squares solve); the records keep
the reference's keys under ``backend="hopper-kernel"``; and nothing that
measures runs without a card unless the CPU is asked for.
"""
import dataclasses
import json
import types
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import hw as jhw  # noqa: E402
from repro.calibrate import fit as jfit  # noqa: E402
from repro.calibrate import kernel_bench as jkb  # noqa: E402
from repro.calibrate import profile as jprofile  # noqa: E402
from repro.serving import latency_model as jlm  # noqa: E402
from repro_torch import hw  # noqa: E402
from repro_torch.calibrate import fit, kernel_bench as kb, profile  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch.bench_kernels import run_smoke  # noqa: E402
from repro_torch.serving import latency_model as lm  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
PROFILE = REPO / "configs" / "profiles" / "gemma2-2b__tpu-v5e.json"
PAIRS = [(name, dt) for name, case in sorted(kb.kernel_registry().items())
         for dt in case.dtypes]


def to_jnp(t):
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.float().numpy(), dtype=jnp.bfloat16)
    return jnp.asarray(t.numpy())


def first(out):
    return out[0] if isinstance(out, tuple) else out


def as64(x):
    return (x.double().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x, dtype=np.float64))


def test_registries_agree():
    port, ref = kb.kernel_registry(), jkb.kernel_registry()
    assert sorted(port) == sorted(ref)
    for name in ref:
        assert (port[name].name, port[name].phase, tuple(port[name].dtypes)) == \
            (ref[name].name, ref[name].phase, tuple(ref[name].dtypes))
    assert kb.VERIFY_TOL == jkb.VERIFY_TOL
    assert (kb.DEFAULT_BATCHES, kb.DEFAULT_SEQS, kb.DEFAULT_DTYPES) == \
        (jkb.DEFAULT_BATCHES, jkb.DEFAULT_SEQS, jkb.DEFAULT_DTYPES)


@pytest.mark.parametrize("name,dtype", PAIRS, ids=[f"{n}-{d}" for n, d in PAIRS])
def test_case_matches_reference_on_the_same_inputs(name, dtype):
    batch, seq, seed = 1, 64, 0
    port, ref = kb.kernel_registry()[name], jkb.kernel_registry()[name]
    args, kwargs = port.make(batch, seq, dtype, seed, torch.device("cpu"))
    _, jax_kwargs = ref.make(batch, seq, dtype, seed)     # the Pallas block sizes
    jargs = [to_jnp(a) for a in args]
    want_ref = as64(first(ref.ref_fn(*jargs)))
    want_kernel = as64(first(ref.kernel_fn(*jargs, **jax_kwargs)))
    got_ref = as64(first(port.ref_fn(*args, **kwargs)))
    got_kernel = as64(first(port.kernel_fn(*args, **kwargs)))
    tol = kb.VERIFY_TOL[dtype] * max(1.0, float(np.abs(want_ref).max()))
    assert got_ref.shape == want_ref.shape == got_kernel.shape
    assert np.abs(got_ref - want_ref).max() <= tol
    if dtype == "int8":
        np.testing.assert_array_equal(got_kernel, want_kernel)
    else:
        assert np.abs(got_kernel - want_kernel).max() <= tol
    # the port's own check on these inputs passes
    assert kb._verify(port, dtype, batch, seq, seed, torch.device("cpu")) <= tol


def grid_points(phase, seed):
    rng = np.random.default_rng(seed)
    pts = []
    for b in (1, 2, 4, 8):
        for s in (16, 64, 256):
            base = 2e-3 + 3e-6 * b * s + 1e-9 * b * s * s if phase == "prefill" \
                else 1e-3 + 2e-4 * b + 5e-8 * b * s
            pts.append((float(b), float(s), base * (1.0 + 0.05 * rng.standard_normal())))
    return pts


def assert_dicts_close(a, b, rtol=1e-12):
    assert a.keys() == b.keys()
    for key in a:
        if isinstance(a[key], dict):
            assert_dicts_close(a[key], b[key], rtol)
        elif isinstance(a[key], (float, tuple, list)) and a[key] is not None:
            np.testing.assert_allclose(np.asarray(a[key], float), np.asarray(b[key], float),
                                       rtol=rtol, atol=0)
        else:
            assert a[key] == b[key], key


@pytest.mark.parametrize("phase", ["prefill", "decode"])
def test_fit_phase_gives_the_reference_coefficients(phase):
    pts = grid_points(phase, seed=1)
    assert_dicts_close(fit.fit_phase(pts, phase).to_dict(),
                       jfit.fit_phase(pts, phase).to_dict())
    # a degenerate column (one prompt length) is dropped in both
    flat = [(b, 64.0, y) for b, _, y in pts]
    assert_dicts_close(fit.fit_phase(flat, phase).to_dict(),
                       jfit.fit_phase(flat, phase).to_dict())


def test_fit_records_gives_the_reference_profile():
    recs = [{"kind": "calibration", "phase": phase, "batch": b, "tokens": s,
             "result": {"latency_s": y}}
            for phase in ("prefill", "decode") for b, s, y in grid_points(phase, 2)]
    kw = dict(model="m", hardware="h100", holdout_fraction=0.25, grid={"batch": [1, 2]})
    assert_dicts_close(fit.fit_records(recs, **kw).to_dict(),
                       jfit.fit_records(recs, **kw).to_dict())
    assert fit.split_points(recs) == jfit.split_points(recs)
    prefill_only = [r for r in recs if r["phase"] == "prefill"]
    assert_dicts_close(fit.fit_records(prefill_only, **kw).to_dict(),
                       jfit.fit_records(prefill_only, **kw).to_dict())


def test_profiles_are_read_by_both_packages():
    port = profile.load_profile(PROFILE)
    ref = jprofile.load_profile(PROFILE)
    assert port.to_dict() == ref.to_dict()
    assert port.schema == ref.schema == profile.PROFILE_SCHEMA == jprofile.PROFILE_SCHEMA
    assert jprofile.CalibrationProfile.from_json(port.to_json()).to_dict() == ref.to_dict()
    assert profile.CalibrationProfile.from_json(ref.to_json()).to_dict() == port.to_dict()
    assert profile.profile_path("d", "m", "h") == jprofile.profile_path("d", "m", "h")
    key = f"{port.model}@{port.hardware}"
    assert profile.load_profile(key, REPO / "configs" / "profiles").to_dict() == ref.to_dict()


def test_fitted_oracle_and_speed_modes_agree_exactly():
    port = lm.FittedLatencyModel.from_profile(str(PROFILE))
    ref = jlm.FittedLatencyModel.from_profile(str(PROFILE))
    assert {k: v.to_dict() for k, v in lm.SPEED_MODES.items()} == \
        {k: v.to_dict() for k, v in jlm.SPEED_MODES.items()}
    for mode in [None, *lm.SPEED_MODES]:
        p = port if mode is None else port.with_speed_mode(lm.resolve_speed_mode(mode))
        r = ref if mode is None else ref.with_speed_mode(jlm.resolve_speed_mode(mode))
        assert (p.prefill_coef, p.decode_coef, p.name) == (r.prefill_coef, r.decode_coef,
                                                           r.name)
        for b in (1, 3, 16):
            for t in (1, 128, 4096):
                assert p.prefill_latency(b, t) == r.prefill_latency(b, t)
                assert p.decode_latency(b, t) == r.decode_latency(b, t)
                assert p.request_latency(b, t, 5) == r.request_latency(b, t, 5)
                assert p.iteration_latency(b, t, b + 1, t) == r.iteration_latency(b, t, b + 1, t)
    prof = profile.load_profile(PROFILE)
    assert prof.predict("prefill", 4, 512) == jprofile.load_profile(PROFILE).predict(
        "prefill", 4, 512)
    assert kb.derive_speed_modes() == jkb.derive_speed_modes()
    over = {"int8": {"compute_scale": 1.2}}
    assert lm.resolve_speed_mode("int8", over).to_dict() == \
        jlm.resolve_speed_mode("int8", over).to_dict()


def test_hardware_catalog_copies_the_reference_and_adds_h100():
    for name, ref in jhw.HARDWARE.items():
        assert dataclasses.asdict(hw.HARDWARE[name]) == dataclasses.asdict(ref)
    h100 = hw.HARDWARE["h100"]
    assert (h100.peak_flops, h100.peak_flops_fp32, h100.hbm_bw, h100.tdp_watts,
            h100.cloud_usd_per_hour) == (989e12, 67e12, 3.35e12, 700.0, None)
    assert "h100" not in jhw.HARDWARE
    assert lm.FittedLatencyModel.from_profile(
        dataclasses.replace(profile.load_profile(PROFILE), hardware="h100")).hw is h100


def test_kernel_records_keep_the_reference_schema_and_fits():
    kw = dict(batches=(1, 2), seqs=(64,), repeats=1, meta={"job_id": "t"})
    recs = kb.kernel_records(device="cpu", **kw)
    assert len(recs) == 2 * len(PAIRS)
    ref_recs = jkb.kernel_records(["int8_matmul"], **kw)
    assert all(r.keys() == ref_recs[0].keys() and
               r["result"].keys() == ref_recs[0]["result"].keys() for r in recs)
    assert all(r["backend"] == "hopper-kernel" and r["result"]["mode"] == "reference-cpu"
               and r["kind"] == "calibration" for r in recs)
    fits = kb.fit_kernel_records(recs)
    relabelled = [dict(r, backend=jkb.BACKEND) for r in recs]
    ref_fits = jkb.fit_kernel_records(relabelled)
    assert fits.keys() == ref_fits.keys() and len(fits) == len(PAIRS)
    for key in fits:
        assert_dicts_close(dict(fits[key], backend=None), dict(ref_fits[key], backend=None))
    assert kb.fit_kernel_records(relabelled) == {}      # other backends are skipped
    base = profile.load_profile(PROFILE)
    port = kb.attach_kernel_calibration(base, recs)
    ref = jkb.attach_kernel_calibration(jprofile.load_profile(PROFILE), relabelled)
    assert port.speed_modes == ref.speed_modes and port.kernels.keys() == ref.kernels.keys()
    assert (port.prefill, port.decode) == (base.prefill, base.decode)


def test_bench_kernels_smoke_on_the_cpu(tmp_path):
    path = tmp_path / "out" / "kernels.json"
    out = run_smoke(json_path=str(path), device="cpu")
    assert (out["n_records"], out["n_fits"], out["verified_pairs"]) == (20, 5, 5)
    assert sorted(out["kernels"]) == sorted(f"{n}/{'int8' if n == 'int8_matmul' else 'float32'}"
                                            for n in kb.kernel_registry())
    assert json.loads(path.read_text()) == json.loads(json.dumps(out))


def test_measured_latency_counts_calls_and_reduces(monkeypatch):
    calls = []

    def fn(x):
        calls.append(x)
        return torch.zeros(1)
    clock = iter([0.0, 5.0, 10.0, 12.0, 20.0, 29.0])
    monkeypatch.setattr(lm, "time", types.SimpleNamespace(perf_counter=lambda: next(clock)))
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a: pytest.fail("a CPU result needs no wait"))
    assert lm.MeasuredLatency(fn, warmup=2, iters=3, reducer="min").measure(7) == 2.0
    assert calls == [7] * 5
    clock = iter([1.0, 9.0])
    calls.clear()
    assert lm.MeasuredLatency(fn, warmup=1, iters=4).measure(8) == 2.0
    assert calls == [8] * 5


def test_compute_scale_is_clamped_and_never_swallows_a_failure(monkeypatch):
    scale = kb._measured_int8_compute_scale(repeats=1, device="cpu")
    assert 1.0 <= scale <= 1.5
    modes = kb.derive_speed_modes(measure_compute_scale=True, repeats=1, device="cpu")
    assert 1.0 <= modes["int8"]["compute_scale"] <= 1.5

    def broken(*args):
        raise RuntimeError("int8_matmul: CUDA error 98")
    monkeypatch.setattr(ops, "int8_matmul", broken)
    with pytest.raises(RuntimeError, match="CUDA error"):
        kb.derive_speed_modes(measure_compute_scale=True, repeats=1, device="cpu")


def test_nothing_measures_without_a_card_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: kb.kernel_records(["int8_matmul"], batches=(1,), seqs=(64,)),
                 lambda: kb.derive_speed_modes(measure_compute_scale=True),
                 lambda: kb.resolve_target(),
                 lambda: run_smoke()):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert kb.resolve_target("cpu") == "reference"
