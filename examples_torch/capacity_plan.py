"""Capacity planning from a fitted calibration profile in a few lines, on
the port (``repro_torch``).

The measure → model → plan loop, end to end: calibrate a latency model
(here reusing the committed ``gemma2-2b@tpu-v5e`` profile, the reference's
inputs, so that the flow prints what ``examples/capacity_plan.py`` prints),
then ask the planner for the cheapest replicas × batching-policy × router
configuration that keeps p(e2e ≤ 250ms) ≥ 99% at the offered load.  The
planner runs on the host; nothing here touches a device.  A profile fitted
on the card (``repro_torch.launch.run_jobs`` on
``configs/jobs/calibrate_plan.json``) plans the same way, under an objective
other than cost: the port gives h100 no price.

    PYTHONPATH=src python examples_torch/capacity_plan.py
"""
from repro_torch.calibrate import load_profile, plan_capacity
from repro_torch.core import BenchmarkSession, PlanSpec
from repro_torch.core.analysis import plan_table
from repro_torch.serving.workload import WorkloadSpec


def main(argv=None) -> None:
    # --- declarative route: a PlanSpec through the BenchmarkSession ---------
    session = BenchmarkSession(n_workers=2)
    handle = session.submit(PlanSpec(
        job_id="plan-demo",
        profile="gemma2-2b@tpu-v5e",            # resolved in configs/profiles/
        workload=WorkloadSpec(kind="poisson", rate=600, duration_s=3,
                              prompt_tokens=128, output_tokens=4,
                              output_tokens_max=16, seed=0),
        slo_latency_s=0.25, slo_target=0.99,
        replicas=(1, 2, 4), policies=("tfs", "continuous"),
        routers=("round-robin", "least-loaded")))
    session.run()

    plan = handle.result().metrics
    best = plan["best"]
    print(f"profile: {plan['profile_key']}  "
          f"({plan['feasible']}/{plan['candidates']} configs meet the SLO)")
    if best:
        print(f"cheapest SLO-meeting config: {best['replicas']} replica(s), "
              f"{best['policy']} batching, {best['router']} router "
              f"(${best['objective']:.5f} per 1k requests, "
              f"attainment {best['metrics']['slo_attainment']:.2f})")
    else:
        print("no configuration in the grid met the SLO target")

    # --- library route: the same search as one function call ----------------
    result = plan_capacity(
        load_profile("gemma2-2b@tpu-v5e"),
        WorkloadSpec(kind="poisson", rate=600, duration_s=3, prompt_tokens=128,
                     output_tokens=4, output_tokens_max=16, seed=0),
        slo_latency_s=0.25, slo_target=0.99,
        replicas=(1, 2, 4), policies=("tfs", "continuous"))
    print()
    print(plan_table(result))


if __name__ == "__main__":
    main()
