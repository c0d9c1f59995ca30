"""Run a declarative job config through the port: the counterpart of the
reference's ``benchmarks/run.py --config``.

    PYTHONPATH=src python -m repro_torch.launch.run_jobs \\
        --config configs/jobs/quickstart.json \\
        [--executor inline|concurrent] [--workers 4] [--db out.jsonl] \\
        [--device cuda|cpu]

The reference's flags and defaults, plus ``--device``: where measured jobs
(generated models, measured calibrations, the calibration kernel hook) run,
the card unless ``cpu`` is asked for.  Simulated jobs, oracle calibrations
and plans touch no device.  Measured jobs on concurrent followers share one
card and disturb each other's timings, so give configs that hold them
``--executor inline``.  Relative paths in a config (``profile_dir``, trace
files, a plan's ``configs/profiles``) resolve against the working directory.
Prints the reference's leaderboard and SLO recommendations.
"""
from __future__ import annotations

import argparse
import time
from typing import List, Optional

from repro_torch.core import (BenchmarkSession, ConcurrentFollowerExecutor,
                              InlineExecutor, PerfDB, PlanSpec)
from repro_torch.core.analysis import leaderboard, recommend


def run_config(args) -> BenchmarkSession:
    """Submit every job of ``args.config`` to one session, run it, print
    the leaderboard and recommendations; returns the session."""
    executor = (ConcurrentFollowerExecutor() if args.executor == "concurrent"
                else InlineExecutor())
    session = BenchmarkSession(
        n_workers=args.workers,
        db=PerfDB(args.db) if args.db else None,
        executor=executor, device=args.device)
    handles = session.submit_file(args.config)
    print(f"# {len(handles)} jobs from {args.config} "
          f"({executor.name} executor, {args.workers} followers)")
    t0 = time.time()
    results = session.run()
    print(f"# executed {len(results)} jobs in {time.time()-t0:.1f}s")
    print(leaderboard(session.db, sort_by="throughput_rps", limit=20))
    slos = sorted({r.spec.slo_latency_s for r in results
                   if getattr(r.spec, "slo_latency_s", None) is not None
                   and not isinstance(r.spec, PlanSpec)})
    for slo in slos:
        print(f"\n# top configs under p99 <= {slo*1e3:.0f} ms:")
        for rec in recommend(session.db, slo_latency_s=slo):
            print(f"#   {rec['job_id']:24s} policy={rec['policy']:5s} "
                  f"chips={rec['chips']}")
    if args.db:
        print(f"# PerfDB records appended to {args.db}")
    return session


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--config", required=True,
                    help="JSON/TOML job or sweep config to execute")
    ap.add_argument("--executor", choices=("inline", "concurrent"),
                    default="concurrent")
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--db", default=None,
                    help="PerfDB JSONL path to append records to")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where measured jobs run (default: the card)")
    return ap.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> int:
    run_config(parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
