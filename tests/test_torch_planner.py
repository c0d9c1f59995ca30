"""The port's capacity planner against ``repro.calibrate.planner`` on the
same inputs, on the CPU.

Every case plans on ``configs/profiles/gemma2-2b__tpu-v5e.json`` (or, in the
last, on an h100 profile the port's calibration fits on the CPU) through
both planners.  Candidate order, ``meets_slo``, ``infeasible_reason``,
``speed_mode``, ``split``, ``fleet`` and the best candidate must be equal;
metrics within rtol 1e-9 (two simulators in two packages; the reference's
own goldens miss by one ulp).  ``simulate_candidate`` re-runs the best
candidate and must reproduce its metrics exactly.

The reference's hardware catalog has no ``h100``: the h100 case lends it the
port's tier for the test (``monkeypatch``), so the reference plans on the
same profile with the same hardware row.
"""
import dataclasses
import json
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro import hw as jhw  # noqa: E402
from repro.calibrate import microbench as jmb  # noqa: E402
from repro.calibrate import planner as jplanner  # noqa: E402
from repro.core import spec as jspec  # noqa: E402
from repro_torch import hw  # noqa: E402
from repro_torch.calibrate import microbench as mb  # noqa: E402
from repro_torch.calibrate import planner  # noqa: E402
from repro_torch.calibrate.profile import load_profile  # noqa: E402
from repro_torch.core import spec as pspec  # noqa: E402
from test_torch_simulator import assert_close  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
JOBS = REPO / "configs" / "jobs"
PROFILES = str(REPO / "configs" / "profiles")
RTOL_SIM = 1e-9
EXACT = ("replicas", "policy", "router", "max_batch", "meets_slo", "split",
         "speed_mode", "infeasible_reason", "fleet")


def plan_job(config: str, job_id: str) -> dict:
    """One plan job of a committed config, its profile read from the repo."""
    (job,) = [j for j in json.loads((JOBS / config).read_text())["jobs"]
              if j["job_id"] == job_id]
    return dict({k: v for k, v in job.items() if k != "kind"}, profile_dir=PROFILES)


BASE = dict(job_id="p", profile="gemma2-2b@tpu-v5e", profile_dir=PROFILES,
            workload={"kind": "poisson", "rate": 120, "duration_s": 2,
                      "prompt_tokens": 256, "output_tokens": 8,
                      "output_tokens_max": 48, "seed": 4},
            slo_latency_s=0.3, slo_target=0.9)

CASES = {
    "calibrate_plan": plan_job("calibrate_plan.json", "plan-gemma2"),
    "mixed_fleet": plan_job("mixed_fleet.json", "fleet-plan"),
    "multi_tenant": plan_job("multi_tenant.json", "mt-plan"),
    # KV budget: the larger slot counts cannot hold their working set
    "memory": dict(BASE, replicas=[1, 2], policies=["continuous"],
                   max_batches=[4, 16, 64],
                   memory={"hbm_gb": 0.5, "block_tokens": 16,
                           "kv_bytes_per_token": 98304}),
    # disaggregated (prefill, decode) splits beside the colocated grid
    "disaggregated": dict(BASE, replicas=[2, 3], policies=["tfs", "continuous"],
                          prefill_decode_splits=[[1, 1], [2, 1]],
                          ttft_slo_s=0.2, tpot_slo_s=0.03, slo_latency_s=None),
    # speed modes, with a memory budget that int8's half-size KV relaxes
    "speed_modes": dict(BASE, replicas=[1, 2], policies=["continuous"],
                        max_batches=[16, 32],
                        speed_modes=["fp16", "int8", "speculative"],
                        objective="cost_per_goodput",
                        memory={"hbm_gb": 0.75, "block_tokens": 16,
                                "kv_bytes_per_token": 98304}),
}


def plans(job: dict):
    """The port's and the reference's plan of one job dict."""
    return (planner.plan_from_spec(pspec.PlanSpec(**job)),
            jplanner.plan_from_spec(jspec.PlanSpec(**job)))


def assert_plans_equal(got, want):
    assert (got.profile_key, got.objective, got.slo_latency_s, got.slo_target) == \
        (want.profile_key, want.objective, want.slo_latency_s, want.slo_target)
    assert len(got.candidates) == len(want.candidates) > 0
    for i, (g, w) in enumerate(zip(got.candidates, want.candidates)):
        gd, wd = g.to_dict(), w.to_dict()
        assert {k: gd[k] for k in EXACT} == {k: wd[k] for k in EXACT}, i
        assert_close(gd["metrics"], wd["metrics"], RTOL_SIM, f"candidate {i}")
        assert_close(g.objective, w.objective, RTOL_SIM, f"candidate {i} objective")
    best, ref_best = got.best, want.best
    assert (best is None) == (ref_best is None)
    if best is not None:
        assert got.candidates.index(best) == want.candidates.index(ref_best)
        assert_close(best.to_dict(), ref_best.to_dict(), RTOL_SIM, "best")


def resimulated(job: dict, candidate):
    spec = pspec.PlanSpec(**job)
    return planner.simulate_candidate(
        load_profile(spec.profile, spec.profile_dir), spec.workload, candidate,
        tenants=spec.tenants, max_prefill=spec.max_prefill,
        kv_network=spec.kv_network, network=spec.network, memory=spec.memory)


@pytest.mark.parametrize("case", sorted(CASES))
def test_plan_equals_the_reference(case):
    job = CASES[case]
    got, want = plans(job)
    assert_plans_equal(got, want)
    reasons = [c.infeasible_reason for c in got.candidates]
    if case == "memory":
        assert any(reasons) and not all(reasons)
    if case == "disaggregated":
        assert {tuple(c.split) for c in got.candidates if c.split} == {(1, 1), (2, 1)}
    if case == "speed_modes":
        assert {c.speed_mode for c in got.candidates} == {"fp16", "int8", "speculative"}
    if case == "mixed_fleet":
        assert any(c.fleet for c in got.candidates)
    if case == "multi_tenant":
        assert all(set(c.metrics["tenants"]) == {"chatbot", "classifier"}
                   for c in got.candidates if c.metrics)
    best = got.best
    if best is not None and best.fleet is None:
        # plan → verify: the best candidate re-simulated on its own
        res = resimulated(job, best)
        assert res.summary() == {k: best.metrics[k] for k in res.summary()}


@pytest.mark.parametrize("case", ["calibrate_plan", "multi_tenant"])
def test_plan_job_record_equals_the_reference(case):
    job = CASES[case]
    got = planner.run_plan_job(pspec.PlanSpec(**job))
    want = jplanner.run_plan_job(jspec.PlanSpec(**job))
    rec = {k: v for k, v in got.to_record().items() if k not in ("benchmark_wall_s", "ts")}
    ref = {k: v for k, v in want.to_record().items() if k not in ("benchmark_wall_s", "ts")}
    assert_close(json.loads(json.dumps(rec)), json.loads(json.dumps(ref)), RTOL_SIM)


def test_planner_errors_as_in_the_reference():
    wl = pspec.PlanSpec(**BASE).workload
    with pytest.raises(ValueError, match="at least one SLO"):
        planner.plan_capacity("gemma2-2b@tpu-v5e", wl)
    with pytest.raises(ValueError, match="resolves no SLO"):
        planner.plan_capacity(load_profile("gemma2-2b@tpu-v5e", PROFILES), wl,
                              tenants=({"name": "bare"},))
    with pytest.raises(ValueError, match="unknown plan objective"):
        planner.plan_capacity(load_profile("gemma2-2b@tpu-v5e", PROFILES), wl,
                              slo_latency_s=0.3, replicas=(1,), policies=("tfs",),
                              objective="nope")


# calibrate_plan.json's calibration grid, on the port's card
H100_CALIBRATION = dict(job_id="cal-h100", model={"name": "gemma2-2b"}, hardware="h100",
                        chips=1, batches=[1, 2, 4, 8, 16], seqs=[32, 64, 128, 256],
                        holdout_fraction=0.25)
H100_PLAN = dict(job_id="plan-h100", profile="gemma2-2b@h100",
                 workload=plan_job("calibrate_plan.json", "plan-gemma2")["workload"],
                 slo_latency_s=0.25, slo_target=0.99, replicas=[1, 2, 4],
                 policies=["tfs", "continuous"], routers=["least-loaded"],
                 speed_modes=["fp16", "int8", "speculative"], objective="p99_s")


def test_h100_profile_fitted_by_the_port_plans_as_in_the_reference(tmp_path, monkeypatch):
    """The port's oracle calibration of gemma2-2b on h100 (with a kernel on
    its hook, the kernels' plain versions on the CPU) saves a profile; the
    port's planner reads it.  The reference, lent the port's h100 row, fits
    the same profile and plans the same candidates on it."""
    monkeypatch.setitem(jhw.HARDWARE, "h100",
                        jhw.HardwareModel(**dataclasses.asdict(hw.GPU_H100)))
    cal = mb.run_calibration_job(pspec.CalibrationSpec(
        **H100_CALIBRATION, kernels=["int8_matmul"], profile_dir=str(tmp_path)),
        device="cpu")
    ref_cal = jmb.run_calibration_job(jspec.CalibrationSpec(**H100_CALIBRATION))
    m = cal.metrics
    assert m["mode"] == "oracle" and m["profile_key"] == "gemma2-2b@h100"
    assert m["n_kernel_records"] == 20
    for phase in ("prefill", "decode"):
        assert_close(m["profile"][phase], ref_cal.metrics["profile"][phase], 1e-12, phase)
    profile = load_profile("gemma2-2b@h100", str(tmp_path))
    assert profile.hardware == "h100" and sorted(profile.kernels) == ["int8_matmul/int8"]
    assert sorted(profile.speed_modes) == ["fp16", "int8", "speculative"]
    job = dict(H100_PLAN, profile_dir=str(tmp_path))
    got, want = plans(job)
    assert len(got.candidates) == 18
    assert_plans_equal(got, want)
    # h100 has no price: the cost objective would tie every candidate
    assert all(c.metrics["cost_usd"] == 0.0 for c in got.candidates)
    assert [c.objective for c in got.candidates if c.meets_slo] == \
        sorted(c.objective for c in got.candidates if c.meets_slo)
    if got.best is not None:
        res = resimulated(job, got.best)
        assert res.summary() == {k: got.best.metrics[k] for k in res.summary()}
