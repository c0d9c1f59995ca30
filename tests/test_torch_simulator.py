"""The port's roofline oracle, parameter accounting and copies of the
framework-free serving stack against the JAX package on the same inputs.

``repro_torch.models.registry`` must count exactly the parameters and FLOPs
per token of ``repro.models.registry`` for every ported architecture, the
roofline ``LatencyModel`` must give the reference's prefill, decode and
cold-start latencies (rtol 1e-12) on the reference's hardware, with and
without each speed mode, and ``simulate_cluster`` the reference's summaries
on the job configs that need neither the planner nor the scenario library
(rtol 1e-9; cross-framework checks use tolerances, never byte equality).
The copies of the memory model, the hardware pricing and the network tables
are held to theirs.
"""
import dataclasses
import math
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro import hw as jhw  # noqa: E402
from repro.analysis import memory_model as jmm  # noqa: E402
from repro.configs import ARCHS as REF_ARCHS  # noqa: E402
from repro.configs import shapes as jshapes  # noqa: E402
from repro.core import session as jsession  # noqa: E402
from repro.core.spec import load_jobs as ref_load_jobs  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.serving import cluster as jcluster  # noqa: E402
from repro.serving import latency_model as jlm  # noqa: E402
from repro.serving import memory as jmem  # noqa: E402
from repro_torch import hw  # noqa: E402
from repro_torch.analysis import memory_model as mm  # noqa: E402
from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.configs import shapes  # noqa: E402
from repro_torch.configs.catalog import PENDING  # noqa: E402
from repro_torch.core import session  # noqa: E402
from repro_torch.core.spec import load_jobs  # noqa: E402
from repro_torch.models import registry as reg  # noqa: E402
from repro_torch.serving import cluster  # noqa: E402
from repro_torch.serving import latency_model as lm  # noqa: E402
from repro_torch.serving import memory as mem  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
RTOL_LAT = 1e-12
RTOL_SIM = 1e-9
SIM_CONFIGS = ("cluster", "disaggregated", "memory_pressure")
HW = ("tpu-v5e", "v100", "cpu-xeon")
GRID = [(b, s) for b in (1, 3, 16) for s in (1, 64, 700, 5000)]


def assert_close(got, want, rtol, path="summary"):
    """Nested dicts/lists of numbers equal within ``rtol`` (non-numbers
    exactly)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), path
        for k in want:
            assert_close(got[k], want[k], rtol, f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_close(g, w, rtol, f"{path}[{i}]")
    elif isinstance(want, float) and not isinstance(want, bool):
        assert isinstance(got, (int, float)), path
        assert got == want or math.isclose(got, want, rel_tol=rtol, abs_tol=0.0) \
            or (math.isnan(got) and math.isnan(want)), f"{path}: {got!r} != {want!r}"
    else:
        assert got == want, f"{path}: {got!r} != {want!r}"


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_parameter_accounting_equals_the_reference(arch):
    tree = reg.param_shapes(reg.build_model(ARCHS[arch], "meta"))
    ref_tree = jreg.param_shapes(jreg.build_model(REF_ARCHS[arch]))
    for exclude_embed in (False, True):
        assert reg.count_params(tree, exclude_embed) == \
            jreg.count_params(ref_tree, exclude_embed)
    assert reg.model_flops_per_token(ARCHS[arch]) == \
        jreg.model_flops_per_token(REF_ARCHS[arch])


def pair(arch, hw_name, **kw):
    return (lm.LatencyModel(ARCHS[arch], hw=hw.HARDWARE[hw_name], **kw),
            jlm.LatencyModel(REF_ARCHS[arch], hw=jhw.HARDWARE[hw_name], **kw))


def assert_same_latencies(port, ref):
    assert port.n_params == ref.n_params
    assert port.flops_per_token == ref.flops_per_token
    for b, s in GRID:
        assert math.isclose(port.prefill_latency(b, s), ref.prefill_latency(b, s),
                            rel_tol=RTOL_LAT)
        assert math.isclose(port.decode_latency(b, s), ref.decode_latency(b, s),
                            rel_tol=RTOL_LAT)
    assert math.isclose(port.request_latency(4, 128, 9), ref.request_latency(4, 128, 9),
                        rel_tol=RTOL_LAT)
    assert math.isclose(port.iteration_latency(2, 64, 5, 300),
                        ref.iteration_latency(2, 64, 5, 300), rel_tol=RTOL_LAT)
    assert math.isclose(port.cold_start(), ref.cold_start(), rel_tol=RTOL_LAT)
    assert math.isclose(port.kv_bytes_per_token(), ref.kv_bytes_per_token(),
                        rel_tol=RTOL_LAT)
    assert port.weight_bytes() == ref.weight_bytes()


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_latency_model_equals_the_reference(arch):
    for hw_name in HW:
        for kw in ({}, {"int8": True}, {"chips": 4}):
            port, ref = pair(arch, hw_name, **kw)
            assert_same_latencies(port, ref)
            for mode in ("fp16", "int8", "speculative"):
                assert_same_latencies(lm.apply_speed_mode(port, mode),
                                      jlm.apply_speed_mode(ref, mode))


def test_latency_model_extras_equal_the_reference():
    port, ref = pair("gemma2-2b", "v100", chips=2)
    p, r = port.to_profile(holdout_fraction=0.25), ref.to_profile(holdout_fraction=0.25)
    assert_close(p.to_dict(), r.to_dict(), RTOL_LAT)
    # the generic wrapper for oracles without with_speed_mode
    for mode in ("int8", "speculative"):
        wp = lm.SpeedModeOracle(lm.FittedLatencyModel(prefill_coef=(1e-3, 2e-6, 1e-9),
                                                      decode_coef=(2e-3, 1e-5, 3e-8),
                                                      hw=hw.HARDWARE["v100"]),
                                lm.SPEED_MODES[mode])
        wr = jlm.SpeedModeOracle(jlm.FittedLatencyModel(prefill_coef=(1e-3, 2e-6, 1e-9),
                                                        decode_coef=(2e-3, 1e-5, 3e-8),
                                                        hw=jhw.HARDWARE["v100"]),
                                 jlm.SPEED_MODES[mode])
        assert [wp.prefill_latency(b, s) for b, s in GRID] == \
            [wr.prefill_latency(b, s) for b, s in GRID]
        assert [wp.decode_latency(b, s) for b, s in GRID] == \
            [wr.decode_latency(b, s) for b, s in GRID]
    assert {k: dataclasses.asdict(v) for k, v in lm.NETWORKS.items()} == \
        {k: dataclasses.asdict(v) for k, v in jlm.NETWORKS.items()}
    for a, b in [("us-central", "eu-west"), ("eu-west", "us-east"), ("x", "y"),
                 ("us-east", "us-east"), ("", "eu-west")]:
        got, want = lm.inter_region_network(a, b), jlm.inter_region_network(a, b)
        assert (got and dataclasses.asdict(got)) == (want and dataclasses.asdict(want))
    assert (lm.LAUNCH_OVERHEAD_S, lm.COLD_START_DISK_BW, lm.COLD_START_CONST_S) == \
        (jlm.LAUNCH_OVERHEAD_S, jlm.COLD_START_DISK_BW, jlm.COLD_START_CONST_S)
    moved = lm.oracle_for_hardware(port, "t4", 8)
    assert_same_latencies(moved, jlm.oracle_for_hardware(ref, "t4", 8))
    assert lm.oracle_for_hardware(port, "v100", 2) is port
    with pytest.raises(ValueError, match="re-target"):
        lm.oracle_for_hardware(lm.FittedLatencyModel(), "t4")
    # the port's own card is in the port's catalog only
    h100 = lm.LatencyModel(ARCHS["gemma2-2b"], hw=hw.HARDWARE["h100"])
    assert h100.decode_latency(8, 512) > 0 and "h100" not in jhw.HARDWARE


@pytest.mark.parametrize("name", sorted(PENDING))
def test_pending_archs_raise_naming_their_queue_item(name):
    cfg = dataclasses.replace(ARCHS["gemma2-2b"], name=name)
    with pytest.raises(NotImplementedError, match="ROADMAP M"):
        lm.LatencyModel(cfg)
    with pytest.raises(NotImplementedError, match="ROADMAP M"):
        get_config(name)


def test_pricing_energy_and_memory_copies_equal_the_reference():
    assert hw.CLOUD_RATES_USD_PER_HOUR == jhw.CLOUD_RATES_USD_PER_HOUR
    assert hw.SPOT_RATES_USD_PER_HOUR == jhw.SPOT_RATES_USD_PER_HOUR
    assert (hw.PRICING_CLASSES, hw.CO2_KG_PER_KWH) == (jhw.PRICING_CLASSES, jhw.CO2_KG_PER_KWH)
    for name in jhw.HARDWARE:
        for pricing in hw.PRICING_CLASSES:
            assert hw.cloud_rate_usd_per_hour(name, pricing=pricing) == \
                jhw.cloud_rate_usd_per_hour(name, pricing=pricing)
            assert hw.cloud_cost_usd(name, 1234.5, pricing=pricing) == \
                jhw.cloud_cost_usd(name, 1234.5, pricing=pricing)
        assert hw.energy_joules(hw.HARDWARE[name], 3.5, 0.4) == \
            jhw.energy_joules(jhw.HARDWARE[name], 3.5, 0.4)
    assert hw.co2_kg(7e6) == jhw.co2_kg(7e6)
    # unlisted hardware costs 0.0, the reference's rule; the port adds no price
    assert hw.cloud_cost_usd("h100", 3600.0) == 0.0 == jhw.cloud_cost_usd("h100", 3600.0)
    with pytest.raises(KeyError):
        hw.cloud_rate_usd_per_hour("v100", instance="nope")
    with pytest.raises(ValueError):
        hw.cloud_rate_usd_per_hour("v100", pricing="nope")
    assert {k: dataclasses.asdict(v) for k, v in shapes.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jshapes.SHAPES.items()}
    for arch in ARCHS:
        assert mm.kv_bytes_per_token(ARCHS[arch]) == jmm.kv_bytes_per_token(REF_ARCHS[arch])
        info = {"params_bytes": 1e9, "cache_bytes": 2e8, "batch_dev": 4,
                "opt_bytes": 2e9, "vocab_shard_bytes_per_token": 1e3}
        for kind, shape in (("train", shapes.SHAPES["train_4k"]),
                            ("prefill", shapes.SHAPES["prefill_32k"]),
                            ("decode", shapes.SHAPES["decode_32k"])):
            assert mm.estimate_bytes(kind, ARCHS[arch], shape, info) == \
                jmm.estimate_bytes(kind, REF_ARCHS[arch], jshapes.SHAPES[shape.name], info)
    assert mm.serving_hbm_headroom(hw.HARDWARE["t4"], 2, 3e9) == \
        jmm.serving_hbm_headroom(jhw.HARDWARE["t4"], 2, 3e9)
    spec, ref_spec = mem.MemorySpec(hbm_gb=0.5), jmem.MemorySpec(hbm_gb=0.5)
    assert dataclasses.asdict(spec) == dataclasses.asdict(ref_spec)
    port, ref = pair("gemma2-2b", "v100")
    assert dataclasses.asdict(mem.resolve_memory(spec, port)) == \
        dataclasses.asdict(jmem.resolve_memory(ref_spec, ref))


def simulate(mod_session, mod_cluster, mod_lm, hw_lib, get_cfg, spec):
    lat = mod_lm.LatencyModel(get_cfg(spec.model.name), hw=hw_lib.HARDWARE[spec.hardware],
                              chips=spec.chips, int8=spec.software.int8)
    policy = mod_session.resolve_policy(spec.software)
    return mod_cluster.simulate_cluster(spec.workload, policy, lat, cluster=spec.cluster,
                                        network=mod_lm.NETWORKS[spec.network])


@pytest.mark.parametrize("config", SIM_CONFIGS)
def test_simulate_cluster_summaries_equal_the_reference(config):
    path = REPO / "configs" / "jobs" / f"{config}.json"
    specs, ref_specs = load_jobs(path), ref_load_jobs(path)
    assert [s.to_dict() for s in specs] == [s.to_dict() for s in ref_specs]
    for spec, ref_spec in zip(specs, ref_specs):
        got = simulate(session, cluster, lm, hw, get_config, spec)
        want = simulate(jsession, jcluster, jlm, jhw, lambda n: REF_ARCHS[n], ref_spec)
        assert_close(got.summary(), want.summary(), RTOL_SIM, spec.job_id)
        assert_close(got.stage_means(), want.stage_means(), RTOL_SIM, spec.job_id)
        assert (got.events, got.replicas, got.router, got.requests_served) == \
            (want.events, want.replicas, want.router, want.requests_served)
        assert_close(got.memory, want.memory, RTOL_SIM, spec.job_id)
        assert_close(got.billed_replica_seconds(), want.billed_replica_seconds(), RTOL_SIM)
