"""Multi-tenant serving with per-tenant SLOs in a few lines, on the port
(``repro_torch``).

Two tenants share one cluster: a chat product (3/4 of the traffic,
judged by TTFT/TPOT) and a latency-critical classifier (1/4, judged by
a tight e2e SLO).  The walkthrough answers the three questions
production teams ask of a shared deployment:

  1. does each tenant meet its *own* SLOs, and how fairly is goodput
     split (Jain's index over share-normalized goodput)?
  2. does the small tenant survive the big tenant's flash burst?
  3. what is the cheapest configuration under which *every* tenant
     meets its SLOs — and does that plan hold up when the winning
     config is independently re-simulated?

The latency oracle is the committed ``gemma2-2b@tpu-v5e`` profile, the
reference's input, so the flow prints what ``examples/multi_tenant_slo.py``
prints; everything runs on the simulator, on the host.

    PYTHONPATH=src python examples_torch/multi_tenant_slo.py
"""
from repro_torch.calibrate import load_profile, plan_capacity, simulate_candidate
from repro_torch.core.session import BenchmarkSession, resolve_policy
from repro_torch.core.spec import SoftwareSpec
from repro_torch.scenarios import tenant_report
from repro_torch.scenarios.tenants import tenant_table
from repro_torch.serving.cluster import ClusterSpec, simulate_cluster
from repro_torch.serving.latency_model import NETWORKS, FittedLatencyModel
from repro_torch.serving.workload import WorkloadSpec

TENANTS = ({"name": "chatbot", "share": 3.0, "scenario": "chat"},
           {"name": "classifier", "share": 1.0, "scenario": "classification"})


def main(argv=None) -> None:
    # --- 1. per-tenant report through the declarative session ---------------
    session = BenchmarkSession(n_workers=1)
    handle = session.submit({
        "job_id": "mt-demo", "model": {"name": "gemma2-2b"}, "chips": 4,
        "cluster": {"replicas": 2, "router": "least-loaded"},
        "software": {"policy": "continuous", "max_batch": 16},
        "workload": {"rate": 24, "duration_s": 6, "seed": 7,
                     "tenants": list(TENANTS)}})
    session.run()
    report = handle.result().metrics["tenants"]
    print(tenant_table(report))

    # --- 2. isolation: the big tenant bursts, the small one must survive ----
    oracle = FittedLatencyModel.from_profile("gemma2-2b@tpu-v5e")
    policy = resolve_policy(SoftwareSpec(policy="continuous", max_batch=16))
    cluster = ClusterSpec(replicas=2, router="least-loaded")

    def small_goodput(big_overrides):
        wl = WorkloadSpec(rate=24, duration_s=6, seed=7, tenants=(
            dict(TENANTS[0], workload=big_overrides), TENANTS[1]))
        res = simulate_cluster(wl, policy, oracle, cluster=cluster,
                               network=NETWORKS["lan"])
        return tenant_report(res, wl.tenants)["per_tenant"]["classifier"][
            "goodput_rps"]

    steady = small_goodput({})
    bursty = small_goodput({"kind": "burst", "burst_factor": 8.0})
    print(f"\nclassifier goodput: steady={steady:.1f} rps, "
          f"chatbot bursting={bursty:.1f} rps "
          f"(retained {bursty / max(steady, 1e-9):.0%})")

    # --- 3. cheapest config where every tenant meets its own SLOs -----------
    base = WorkloadSpec(rate=24, duration_s=4, seed=7)
    plan = plan_capacity(load_profile("gemma2-2b@tpu-v5e"), base,
                         tenants=TENANTS, slo_target=0.9,
                         replicas=(1, 2, 4), policies=("continuous",))
    best = plan.best
    print(f"\ncheapest tenant-feasible config: {best.replicas} replica(s), "
          f"{best.policy} batching (${best.objective:.5f} per 1k requests, "
          f"fairness {best.metrics['fairness_index']:.3f})")

    # trust, but verify: re-simulate the winner independently of the grid
    res = simulate_candidate(load_profile("gemma2-2b@tpu-v5e"), base, best,
                             tenants=TENANTS)
    verified = tenant_report(res, TENANTS)
    for name, per in verified["per_tenant"].items():
        status = "ok" if per["slo_attainment"] >= 0.9 else "MISSED"
        print(f"  re-verified {name}: attainment "
              f"{per['slo_attainment']:.2f} [{status}]")


if __name__ == "__main__":
    main()
