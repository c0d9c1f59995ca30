"""Cluster capacity planning in a few lines, on the port (``repro_torch``):
how many replicas (and which batching policy) does a latency SLO need at a
given traffic level?

Sweeps replicas × policy over a ramped generation workload through the
declarative BenchmarkSession front end, then picks the cheapest
configuration that meets the SLO at 99% attainment.  The jobs run on the
cluster simulator, on the host; the inputs are the reference's, so the flow
prints what ``examples/cluster_capacity.py`` prints.

By default the sweep is clocked by the analytic roofline model; pass a
fitted calibration profile (path or ``model@hardware`` key, see
``configs/profiles/``) to clock it by measured/fitted coefficients
instead:

    PYTHONPATH=src python examples_torch/cluster_capacity.py
    PYTHONPATH=src python examples_torch/cluster_capacity.py \\
        --profile gemma2-2b@tpu-v5e
"""
import argparse

from repro_torch.core import (BenchmarkJobSpec, BenchmarkSession, ClusterSpec,
                              SweepSpec)
from repro_torch.serving.workload import WorkloadSpec

SLO_S = 0.25


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--profile", default=None,
                        help="calibration profile (JSON path or model@hardware "
                             "key) to use as the latency oracle instead of the "
                             "hard-coded analytic model")
    args = parser.parse_args(argv)

    base = BenchmarkJobSpec(
        job_id="capacity",
        model={"name": "gemma2-2b"},
        chips=4,
        slo_latency_s=SLO_S,
        profile=args.profile,
        software={"policy": "continuous", "max_batch": 16, "max_prefill": 8},
        cluster=ClusterSpec(replicas=1, router="least-loaded"),
        workload=WorkloadSpec(kind="ramp", duration_s=3, ramp_min_rate=50,
                              ramp_max_rate=400, ramp_steps=4,
                              output_tokens=8, output_tokens_max=32, seed=0),
    )
    sweep = SweepSpec(base, axes={
        "cluster.replicas": [1, 2, 4],
        "software.policy": ["tfs", "continuous"],
    })

    session = BenchmarkSession(n_workers=4)
    session.submit_sweep(sweep)
    results = session.run()

    oracle = args.profile if args.profile else "analytic roofline model"
    print(f"latency oracle: {oracle}\n")
    print(f"{'job':14s} {'policy':11s} {'replicas':>8} {'thr rps':>9} "
          f"{'p99 ms':>8} {'SLO att':>8} {'util':>6}")
    for r in sorted(results, key=lambda r: (r.spec.software.policy,
                                            r.spec.cluster.replicas)):
        m = r.metrics
        print(f"{r.job_id:14s} {r.spec.software.policy:11s} "
              f"{r.cluster['replicas']:8d} {m['throughput_rps']:9.1f} "
              f"{m['p99_s']*1e3:8.1f} {m['slo_attainment']:8.2f} "
              f"{m['utilization']:6.2f}")

    best = [r for r in results if r.metric("slo_attainment") >= 0.99]
    if best:
        cheapest = min(best, key=lambda r: r.metric("cost_per_1k_req"))
        print(f"\ncheapest config meeting the SLO: {cheapest.job_id} "
              f"(policy={cheapest.spec.software.policy}, "
              f"replicas={cheapest.cluster['replicas']}, "
              f"${cheapest.metric('cost_per_1k_req'):.4f}/1k req)")
    else:
        print("\nno swept config met the SLO at 99% attainment")


if __name__ == "__main__":
    main()
