"""Watch a flash crowd hit a cluster — the observability walkthrough, on
the port (``repro_torch``).

A 2-replica cluster serves a steady 150 req/s baseline when a 10×
flash crowd lands a third of the way in.  With ``ObsSpec`` attached the
run produces all three observability artifacts:

  1. a time-series view of the incident: queue depth spiking and
     draining, batch occupancy pinning at the cap, the arrival vs.
     completion rate gap while the backlog clears;
  2. a Chrome-trace span timeline (load ``out/flash_trace.json`` at
     https://ui.perfetto.dev — one process per replica, the engine's
     iteration spans on lane 0 and per-request stage spans below);
  3. a standalone HTML report (``out/flash_report.html`` — open in any
     browser, no network access needed).

The script also shows the books balancing: the recorder's counters
reconcile exactly with the simulator's own aggregates, and the run's
summary is identical with observability on or off.

The cluster is simulated on the host, with the reference's inputs: the
flow prints what ``examples/observe_flash_crowd.py`` prints and writes the
same two files, byte for byte, into ``out/`` of the working directory.

    PYTHONPATH=src python examples_torch/observe_flash_crowd.py
"""
import dataclasses
from pathlib import Path

from repro_torch.configs import get_config
from repro_torch.obs import ObsSpec, write_report, write_trace
from repro_torch.serving.batching import make_policy
from repro_torch.serving.cluster import ClusterSpec, simulate_cluster
from repro_torch.serving.latency_model import LatencyModel
from repro_torch.serving.workload import WorkloadSpec


def main(argv=None) -> None:
    out = Path("out")
    out.mkdir(exist_ok=True)

    wl = WorkloadSpec(kind="flash-crowd", rate=150, duration_s=4.0,
                      burst_factor=10.0, output_tokens=16, seed=7)
    cluster = ClusterSpec(replicas=2, router="least-loaded",
                          obs=ObsSpec())
    lat = LatencyModel(get_config("gemma2-2b"), chips=4)

    res = simulate_cluster(wl, make_policy("continuous", max_batch=8,
                                           max_prefill=4), lat,
                           cluster=cluster)

    # --- 1. the incident in numbers -----------------------------------------
    ts = res.timeseries
    queue = ts.total("queue_depth")
    peak_i = queue.index(max(queue))
    print(f"requests served        {res.requests_served or len(res.traces)}")
    print(f"queue peak             {queue[peak_i]:.0f} requests "
          f"at t={ts.times[peak_i]:.2f}s")
    print(f"queue at end           {queue[-1]:.0f} (drained)")
    print(f"peak arrival rate      {max(ts.rate('arrivals')):.0f} req/s "
          f"(baseline {wl.rate:.0f})")
    print(f"completions counter    {ts.counter_total('completions')} "
          f"(== served: books balance)")
    print(f"live-replica integral  {ts.live_replica_integral():.2f}s "
          f"(== replica_seconds {res.replica_seconds:.2f}s)")

    # --- 2. observability never moves a simulated number --------------------
    res_off = simulate_cluster(wl, make_policy("continuous", max_batch=8,
                                               max_prefill=4), lat,
                               cluster=dataclasses.replace(cluster, obs=None))
    if res.summary() != res_off.summary():
        raise RuntimeError("observability moved the run's summary")
    print("summary identical with observability off ✓")

    # --- 3. artifacts --------------------------------------------------------
    trace_path = write_trace(res, out / "flash_trace.json",
                             title="flash crowd, 2 replicas")
    print(f"span timeline          {trace_path}  (load at ui.perfetto.dev)")

    rec = {"job_id": "flash-crowd-demo", "arch": "gemma2-2b",
           "hardware": "tpu-v5e", "chips": 4, "policy": "continuous",
           "result": dict(res.summary(),
                          requests_served=res.requests_served
                          or len(res.traces)),
           "timeseries": ts.to_dict()}
    report_path = write_report([rec], out / "flash_report.html",
                               title="Flash crowd walkthrough")
    print(f"HTML report            {report_path}")


if __name__ == "__main__":
    main()
