"""The port's scenario library against ``repro.scenarios`` on the same inputs,
on the CPU.

* The profile catalog: the same profiles, the same table, and a job that
  names a scenario resolves to the reference's job.
* Arrivals: diurnal, flash-crowd and sweep times are the reference's exactly
  (the same numpy ``Generator`` draws in the same order), and so are their
  instantaneous and mean rates.
* ``scale_trace`` on ``configs/traces/seed_chat.jsonl`` gives the reference's
  rows exactly, and ``trace_stats`` its statistics.
* ``generate_multi_tenant`` gives the reference's merged, tenant-tagged
  stream exactly; ``tenant_report`` over one simulation of that stream gives
  the reference's report within rtol 1e-9 (two simulators in two packages;
  the reference's own goldens miss by one ulp), and ``tenant_table`` its
  text.
"""
import dataclasses
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import scenarios as jscen  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.core import session as jsession  # noqa: E402
from repro.core import spec as jspec  # noqa: E402
from repro.scenarios import arrivals as jarrivals  # noqa: E402
from repro.scenarios import tenants as jtenants  # noqa: E402
from repro.serving import cluster as jcluster  # noqa: E402
from repro.serving import latency_model as jlm  # noqa: E402
from repro.serving import workload as jworkload  # noqa: E402
from repro_torch import scenarios as scen  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import session  # noqa: E402
from repro_torch.core import spec as pspec  # noqa: E402
from repro_torch.scenarios import arrivals  # noqa: E402
from repro_torch.scenarios import tenants  # noqa: E402
from repro_torch.serving import cluster  # noqa: E402
from repro_torch.serving import latency_model as lm  # noqa: E402
from repro_torch.serving import workload  # noqa: E402
from test_torch_simulator import assert_close  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
SEED_TRACE = REPO / "configs" / "traces" / "seed_chat.jsonl"
RTOL_SIM = 1e-9
TENANTS = ({"name": "chatbot", "share": 3.0, "scenario": "chat"},
           {"name": "classifier", "share": 1.0, "scenario": "classification"})

ARRIVALS = [
    dict(kind="diurnal", rate=40.0, duration_s=12.0),
    dict(kind="diurnal", rate=25.0, duration_s=7.5, diurnal_amplitude=0.9,
         diurnal_period_s=3.0),
    dict(kind="flash-crowd", rate=20.0, duration_s=9.0, burst_factor=6.0),
    dict(kind="flash-crowd", rate=15.0, duration_s=6.0, burst_factor=4.0,
         flash_start_s=1.0, flash_decay_s=0.5),
    dict(kind="sweep", duration_s=8.0, ramp_min_rate=4.0, ramp_max_rate=128.0,
         ramp_steps=6),
    dict(kind="sweep", duration_s=3.0, ramp_min_rate=10.0, ramp_max_rate=10.0,
         ramp_steps=1),
]


def test_the_catalog_is_the_reference_catalog():
    assert scen.list_profiles() == jscen.list_profiles()
    assert scen.catalog_table() == jscen.catalog_table()
    for name in jscen.list_profiles():
        got, want = scen.get_profile(name), jscen.get_profile(name)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.slos() == want.slos()
        assert got.workload_overrides() == want.workload_overrides()
    with pytest.raises(ValueError, match="unknown scenario"):
        scen.get_profile("nope")


@pytest.mark.parametrize("name", jscen.list_profiles())
def test_a_named_scenario_resolves_as_in_the_reference(name):
    job = dict(job_id="j", scenario=name, workload={"rate": 12.0, "prompt_tokens": 96})
    got = pspec.BenchmarkJobSpec(**job)
    want = jspec.BenchmarkJobSpec(**job)
    assert dataclasses.asdict(got.workload) == dataclasses.asdict(want.workload)
    assert (got.slo_ttft_s, got.slo_tpot_s, got.slo_latency_s) == \
        (want.slo_ttft_s, want.slo_tpot_s, want.slo_latency_s)
    # idempotent: the record's spec round-trips to the same job
    assert pspec.spec_from_dict(got.to_dict()).to_dict() == got.to_dict()


@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("spec", ARRIVALS, ids=lambda s: s["kind"])
def test_arrival_times_equal_the_reference(spec, seed):
    got_spec = workload.WorkloadSpec(seed=seed, **spec)
    want_spec = jworkload.WorkloadSpec(seed=seed, **spec)
    fn = {"diurnal": "diurnal_times", "flash-crowd": "flash_crowd_times",
          "sweep": "sweep_times"}[spec["kind"]]
    got = getattr(arrivals, fn)(got_spec, np.random.default_rng(seed))
    want = getattr(jarrivals, fn)(want_spec, np.random.default_rng(seed))
    assert len(got) > 0 and got == want
    assert arrivals.mean_rate(got_spec) == jarrivals.mean_rate(want_spec)
    for t in np.linspace(0.0, spec["duration_s"], 7):
        if spec["kind"] == "diurnal":
            assert arrivals.diurnal_rate(got_spec, t) == jarrivals.diurnal_rate(want_spec, t)
        elif spec["kind"] == "flash-crowd":
            assert arrivals.flash_rate(got_spec, t) == jarrivals.flash_rate(want_spec, t)
    if spec["kind"] == "sweep":
        assert arrivals.sweep_step_rates(got_spec) == jarrivals.sweep_step_rates(want_spec)
    # through generate, with the prompt and session draws after the times
    assert [dataclasses.asdict(r) for r in workload.generate(got_spec)] == \
        [dataclasses.asdict(r) for r in jworkload.generate(want_spec)]


@pytest.mark.parametrize("kind", ["poisson", "uniform", "burst", "ramp"])
def test_mean_rate_of_the_older_kinds_equals_the_reference(kind):
    spec = dict(kind=kind, rate=30.0, duration_s=4.0, ramp_min_rate=5.0,
                ramp_max_rate=50.0, ramp_steps=3)
    assert arrivals.mean_rate(workload.WorkloadSpec(**spec)) == \
        jarrivals.mean_rate(jworkload.WorkloadSpec(**spec))


@pytest.mark.parametrize("factor,seed", [(0.5, 0), (10.0, 0), (100.0, 3)])
def test_scale_trace_equals_the_reference(factor, seed):
    rows = scen.load_trace_rows(SEED_TRACE)
    assert rows == jscen.load_trace_rows(SEED_TRACE)
    got = scen.scale_trace(SEED_TRACE, factor, seed_rng=seed)
    want = jscen.scale_trace(SEED_TRACE, factor, seed_rng=seed)
    assert len(got) == max(int(round(len(rows) * factor)), 1)
    assert got == want
    assert scen.trace_stats(got) == jscen.trace_stats(want)
    assert scen.trace_stats(SEED_TRACE) == jscen.trace_stats(SEED_TRACE)


def test_scaled_trace_rows_replay_as_in_the_reference(tmp_path):
    rows = scen.scale_trace(SEED_TRACE, 4.0, seed_rng=1)
    path = scen.write_trace_rows(rows, tmp_path / "port.jsonl", header="x4")
    ref_path = jscen.write_trace_rows(rows, tmp_path / "ref.jsonl", header="x4")
    assert path.read_text() == ref_path.read_text()
    got = workload.generate(workload.WorkloadSpec(kind="trace", trace_path=str(path)))
    want = jworkload.generate(jworkload.WorkloadSpec(kind="trace", trace_path=str(path)))
    assert [dataclasses.asdict(r) for r in got] == [dataclasses.asdict(r) for r in want]
    with pytest.raises(ValueError, match="at least 2"):
        scen.scale_trace([{"arrival_s": 0.0}], 2.0)
    with pytest.raises(ValueError, match="factor"):
        scen.scale_trace(SEED_TRACE, 0.0)


TENANT_MIXES = [
    TENANTS,
    ({"name": "steady", "share": 1.0, "scenario": "summarization"},
     {"name": "bursty", "rate": 6.0, "scenario": "code-generation",
      "workload": {"kind": "flash-crowd", "burst_factor": 5.0}},
     {"name": "rag", "share": 2.0, "scenario": "rag-long-context",
      "slo_latency_s": 3.0}),
]


@pytest.mark.parametrize("mix", range(len(TENANT_MIXES)))
def test_multi_tenant_stream_equals_the_reference(mix):
    spec = dict(kind="poisson", rate=20.0, duration_s=5.0, seed=7)
    got = tenants.generate_multi_tenant(workload.WorkloadSpec(
        tenants=TENANT_MIXES[mix], **spec))
    want = jtenants.generate_multi_tenant(jworkload.WorkloadSpec(
        tenants=TENANT_MIXES[mix], **spec))
    assert {r.tenant for r in got} == {t["name"] for t in TENANT_MIXES[mix]}
    assert [dataclasses.asdict(r) for r in got] == [dataclasses.asdict(r) for r in want]
    for t, jt in zip(tenants.coerce_tenants(TENANT_MIXES[mix]),
                     jtenants.coerce_tenants(TENANT_MIXES[mix])):
        assert t.to_dict() == jt.to_dict()
        assert tenants.resolve_tenant_slos(t) == jtenants.resolve_tenant_slos(jt)


def test_tenant_validation_as_in_the_reference():
    for bad, match in ((dict(name=""), "non-empty"), (dict(name="a", share=0.0), "share"),
                       (dict(name="a", scenario="nope"), "unknown scenario")):
        with pytest.raises(ValueError, match=match):
            tenants.TenantSpec(**bad)
    with pytest.raises(ValueError, match="duplicate"):
        tenants.coerce_tenants(({"name": "a"}, {"name": "a"}))
    with pytest.raises(ValueError, match="closed-loop"):
        tenants.generate_multi_tenant(workload.WorkloadSpec(
            kind="closed", tenants=({"name": "a"},)))


PORT = (workload, cluster, lm, session, pspec, get_config)
REF = (jworkload, jcluster, jlm, jsession, jspec, ref_get_config)


def simulate(pkg, spec, trace_sample=1.0, **cluster_kw):
    """gemma2-2b on 4 chips behind two continuous-batching replicas, through
    one package's (``PORT`` or ``REF``) simulator."""
    wl, cl, lat, sess, sp, config = pkg
    policy = sess.resolve_policy(sp.SoftwareSpec(policy="continuous", max_batch=16))
    return cl.simulate_cluster(
        wl.WorkloadSpec(**spec), policy, lat.LatencyModel(config("gemma2-2b"), chips=4),
        cluster=cl.ClusterSpec(replicas=2, **cluster_kw), network=lat.NETWORKS["lan"],
        trace_sample=trace_sample)


def test_tenant_report_over_one_simulation_equals_the_reference():
    spec = dict(rate=20.0, duration_s=8.0, seed=7, tenants=TENANTS)
    res, ref = simulate(PORT, spec), simulate(REF, spec)
    assert res.tenants() == ref.tenants() == ["chatbot", "classifier"]
    got = scen.tenant_report(res, TENANTS)
    want = jscen.tenant_report(ref, TENANTS)
    assert_close(got, want, RTOL_SIM, "tenant_report")
    assert sum(p["requests"] for p in got["per_tenant"].values()) == len(res.traces)
    assert tenants.tenant_table(got) == jtenants.tenant_table(want)
