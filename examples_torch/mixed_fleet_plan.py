"""Plan a heterogeneous fleet on the port (``repro_torch``): device mix,
spot pricing, multi-region.

Retires the flat-identical-replica assumption end to end.  The planner
searches fleet compositions — all-v5e, a v5e+t4 device mix, and the
same mix with the t4 pool on interruptible spot capacity — under a
``cost_per_goodput`` objective, then the winner is re-simulated
independently.  A second run places the t4 pool in another region to
show the cross-region accounting.

Uses the analytic roofline oracle directly (pools that name their own
``hardware`` re-target it per pool; a fitted profile would instead need
a per-hardware profile on each pool).  The pools are the simulator's
data-sheet hardware models, as in ``examples/mixed_fleet_plan.py``, whose
inputs this flow keeps and whose output it prints; it runs on the host.

    PYTHONPATH=src python examples_torch/mixed_fleet_plan.py
"""
from repro_torch.calibrate import plan_capacity, simulate_candidate
from repro_torch.configs import get_config
from repro_torch.core.analysis import plan_table
from repro_torch.serving.batching import make_policy
from repro_torch.serving.cluster import ClusterSpec, PoolSpec, simulate_cluster
from repro_torch.serving.latency_model import LatencyModel
from repro_torch.serving.workload import WorkloadSpec

SLO_S = 0.4


def main(argv=None) -> None:
    lm = LatencyModel(get_config("gemma2-2b"), chips=4)
    wl = WorkloadSpec(kind="poisson", rate=120, duration_s=4,
                      prompt_tokens=128, output_tokens=8,
                      output_tokens_max=32, seed=21)

    # --- fleet grid: flat vs device mix vs spot-backed mix ------------------
    mixed = ({"name": "v5e", "replicas": 2},
             {"name": "t4", "hardware": "t4", "replicas": 2})
    spot = ({"name": "v5e", "replicas": 2},
            {"name": "t4", "hardware": "t4", "replicas": 2,
             "pricing": "spot", "preempt_mtbf_s": 2.0})

    plan = plan_capacity(
        lm, wl, slo_latency_s=SLO_S, slo_target=0.9,
        replicas=(3, 4), policies=("continuous",),
        routers=("cost-weighted",), objective="cost_per_goodput",
        fleets=(mixed, spot))
    print(plan_table(plan))

    best = plan.best
    if best is None:
        raise RuntimeError("nothing in the grid met the SLO")
    res = simulate_candidate(lm, wl, best)
    print(f"\nwinner re-simulated: attainment "
          f"{res.slo_attainment(SLO_S):.2f}, bill ${res.cost_usd():.5f}")
    if res.fleet is not None:
        for p in res.fleet["pools"]:
            print(f"  pool {p['name']:>4s} ({p['pricing']:>8s}): "
                  f"{p['replicas']} replicas, ${p['cost_usd']:.5f}")
        print(f"  spot preemptions: {res.fleet['spot_preemptions']}, "
              f"goodput lost to kills: "
              f"{res.preemption_goodput_loss(e2e_slo_s=SLO_S):.2f} rps")

    # --- multi-region: the t4 pool moves overseas ---------------------------
    pools = (PoolSpec(name="v5e", replicas=2, region="us-east"),
             PoolSpec(name="t4", hardware="t4", replicas=2, region="eu-west"))
    res = simulate_cluster(
        wl, make_policy("continuous", max_batch=16, max_prefill=8), lm,
        cluster=ClusterSpec(pools=pools, router="cost-weighted"))
    print(f"\ntwo-region fleet: cross_region_fraction "
          f"{res.fleet['cross_region_fraction']:.2f} "
          f"(front door us-east; each hop pays one WAN RTT), "
          f"p99 {res.percentile(99) * 1e3:.0f} ms")


if __name__ == "__main__":
    main()
