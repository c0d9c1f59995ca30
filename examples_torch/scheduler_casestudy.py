"""Paper §5.5 case study on the port (``repro_torch``): two-tier
benchmark-job scheduling.

Reproduces Fig. 15 — queue-aware load balancing + SJF vs the RR+FCFS
baseline — and shows the sensitivity of the speedup to the job mix
(the paper's 1.43× sits inside the light-trace regime).  The scheduler
simulates job completion times on the host, with the reference's seeds, so
the flow prints what ``examples/scheduler_casestudy.py`` prints.

    PYTHONPATH=src python examples_torch/scheduler_casestudy.py
"""
import numpy as np

from repro_torch.core.scheduler import (ClusterScheduler, average_jct,
                                        evaluate_schedulers, make_job_trace)


def main(argv=None) -> None:
    print("Fig. 15 reproduction (4 workers, 200 jobs, mean of 5 seeds):\n")
    res = {k: [] for k in ("rr_fcfs", "qa_fcfs", "rr_sjf", "qa_sjf")}
    for seed in range(5):
        r = evaluate_schedulers(n_workers=4, n_jobs=200, seed=seed)
        for k in res:
            res[k].append(r[k])
    for k, v in res.items():
        print(f"  {k:10s} avg JCT = {np.mean(v):7.2f}s")
    print(f"\n  QA+SJF vs RR+FCFS speedup: "
          f"{np.mean(res['rr_fcfs']) / np.mean(res['qa_sjf']):.2f}x "
          f"(paper: 1.43x)\n")

    print("sensitivity to the job mix (speedup vs heavy-job fraction & load):")
    for heavy in (0.02, 0.05, 0.1, 0.2):
        row = []
        for rate in (0.25, 0.5, 1.0):
            sp = []
            for seed in range(6):
                jobs = make_job_trace(200, n_heavy_frac=heavy,
                                      arrival_rate=rate, seed=seed)
                rr = average_jct(ClusterScheduler(4, "rr", "fcfs").run(jobs))
                qa = average_jct(ClusterScheduler(4, "qa", "sjf").run(jobs))
                sp.append(rr / qa)
            row.append(f"{np.mean(sp):4.2f}x")
        print(f"  heavy={heavy:4.2f}:  " + "  ".join(row)
              + "   (rates 0.25 / 0.5 / 1.0 jobs/s)")
    print("\nthe paper's 1.43x falls inside the light-trace band.")


if __name__ == "__main__":
    main()
