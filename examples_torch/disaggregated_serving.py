"""Disaggregated prefill/decode serving vs colocated, judged by phase
SLOs (TTFT/TPOT), on the port (``repro_torch``).

A mixed workload — short and very long prompts, short generations — is
served two ways at the same chip count:

  1. colocated: 4 replicas, each running continuous batching end-to-end
     (long prefills pad out iterations and stall decode);
  2. disaggregated: a 3-replica chunked-prefill pool plus a 1-replica
     decode pool, with the KV cache handed off over the cluster
     interconnect (bytes = kv_bytes_per_token × prompt_tokens).

It then asks the capacity planner the deployment question directly: under
a tight TTFT+TPOT SLO, is colocated or disaggregated cheaper — and how
does that answer flip when the KV handoff must cross a slow link?

Everything runs on the cluster simulator, on the host, with the
reference's inputs, so the flow prints what
``examples/disaggregated_serving.py`` prints.

Run:  PYTHONPATH=src python examples_torch/disaggregated_serving.py
"""
from repro_torch.calibrate.planner import plan_capacity
from repro_torch.configs import get_config
from repro_torch.core.analysis import plan_table
from repro_torch.serving.batching import make_policy
from repro_torch.serving.cluster import ClusterSpec, DisaggSpec, simulate_cluster
from repro_torch.serving.latency_model import LatencyModel
from repro_torch.serving.workload import WorkloadSpec

TTFT_SLO, TPOT_SLO = 0.35, 0.03


def main(argv=None) -> None:
    lm = LatencyModel(get_config("gemma2-2b"), chips=4)
    wl = WorkloadSpec(rate=230, duration_s=4, prompt_tokens=64,
                      prompt_tokens_max=4096, output_tokens=2,
                      output_tokens_max=8, seed=6)

    configs = {
        "colocated (4 replicas)":
            ClusterSpec(replicas=4, router="least-loaded"),
        "disaggregated (3 prefill + 1 decode)":
            ClusterSpec(disaggregation=DisaggSpec(
                prefill_replicas=3, decode_replicas=1,
                prefill_chunk_tokens=512, prefill_max_batch=8)),
    }

    print(f"mixed workload: {wl.rate:.0f} req/s, prompts "
          f"{wl.prompt_tokens}-{wl.prompt_tokens_max} tok, outputs "
          f"{wl.output_tokens}-{wl.output_tokens_max} tok\n")
    print(f"{'config':>38}{'thr rps':>9}{'ttft p99':>10}{'tpot p99':>10}"
          f"{'goodput':>9}")
    for name, cluster in configs.items():
        res = simulate_cluster(
            wl, make_policy("continuous", max_batch=16, max_prefill=8), lm,
            cluster=cluster)
        print(f"{name:>38}{res.throughput():>9.1f}"
              f"{res.ttft(99) * 1e3:>8.0f}ms{res.tpot(99) * 1e3:>8.1f}ms"
              f"{res.goodput(TTFT_SLO, TPOT_SLO):>9.1f}")
        if res.pools:
            print(f"{'':>38}  (KV handoff: "
                  f"{res.pools['migrated_requests']} migrations over "
                  f"{res.pools['kv_network']}, mean "
                  f"{res.pools['mean_kv_transfer_s'] * 1e3:.1f} ms)")

    print("\n--- capacity plan under the phase SLOs "
          "(fast interconnect) ---")
    plan = plan_capacity(
        lm, wl, ttft_slo_s=TTFT_SLO, tpot_slo_s=TPOT_SLO, slo_target=0.9,
        replicas=(4,), policies=("continuous",), routers=("least-loaded",),
        prefill_decode_splits=((3, 1), (2, 2)))
    print(plan_table(plan))

    print("\n--- lighter load, but the KV handoff crosses a slow link: "
          "transfer cost dominates and colocated wins ---")
    light = WorkloadSpec(rate=140, duration_s=4, prompt_tokens=64,
                         prompt_tokens_max=4096, output_tokens=2,
                         output_tokens_max=8, seed=6)
    slow = plan_capacity(
        lm, light, ttft_slo_s=TTFT_SLO, tpot_slo_s=TPOT_SLO, slo_target=0.9,
        replicas=(4,), policies=("continuous",), routers=("least-loaded",),
        prefill_decode_splits=((3, 1),), kv_network="4g")
    print(plan_table(slow))


if __name__ == "__main__":
    main()
