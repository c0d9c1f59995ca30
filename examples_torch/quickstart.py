"""Quickstart on the port (``repro_torch``): the paper's end-to-end
workflow in ~20 lines.

Submit benchmark jobs in any of the three styles — Python objects, plain
dicts, or a config file ("a few lines of config") — let the session
schedule them across concurrent followers, and read the analysis:
leaderboard + top-3 configs under an SLO.  These jobs are clocked by the
roofline latency model and run on the host; the inputs are the
reference's, so the flow prints what ``examples/quickstart.py`` prints (rows
that tie on the leaderboard's sort key land in completion order, in both).

    PYTHONPATH=src python examples_torch/quickstart.py
"""
from pathlib import Path

from repro_torch.core import (BenchmarkJobSpec, BenchmarkSession,
                              ConcurrentFollowerExecutor, ModelRef)
from repro_torch.core.analysis import leaderboard, recommend
from repro_torch.serving.workload import WorkloadSpec

CONFIG = Path(__file__).resolve().parent.parent / "configs/jobs/quickstart.json"


def main(argv=None) -> None:
    session = BenchmarkSession(n_workers=4, lb="qa", order="sjf",
                               executor=ConcurrentFollowerExecutor())

    # style 1 — Python objects
    handle = session.submit(BenchmarkJobSpec(
        job_id="api-job",
        model=ModelRef(name="gemma2-2b"),
        chips=8,
        slo_latency_s=0.05,
        workload=WorkloadSpec(rate=500, duration_s=5, prompt_tokens=128),
    ))

    # style 2 — a plain dict
    session.submit({
        "job_id": "dict-job",
        "model": {"name": "granite-8b"},
        "chips": 8,
        "workload": {"rate": 200, "duration_s": 5},
    })

    # style 3 — a config file holding a whole sweep
    session.submit_file(CONFIG)

    records = session.run()
    print(f"\nexecuted {len(records)} benchmark jobs on "
          f"{len(session.followers)} followers\n")
    print(f"typed result for {handle.job_id}: "
          f"p99={handle.result().metric('p99_s')*1e3:.2f}ms "
          f"({handle.result().mode})\n")
    print(leaderboard(session.db, sort_by="throughput_rps", limit=8))

    print("\ntop-3 configurations under a 50 ms p99 SLO (cheapest first):")
    for r in recommend(session.db, slo_latency_s=0.05):
        print(f"  {r['job_id']:16s} policy={r['policy']:5s} chips={r['chips']:3d} "
              f"p99={r['result']['p99_s']*1e3:6.2f}ms "
              f"${r['result']['cost_per_1k_req']:.4f}/1k-req")


if __name__ == "__main__":
    main()
