"""Memory-aware serving on a shared-prefix chat workload, on the port
(``repro_torch``).

Every session reuses a long system prompt/history (its first
``prefix_tokens`` prompt tokens), so with prefix caching on, a replica
prefills that prefix once per session and serves the rest from cached KV
blocks.  This example runs the same saturating chat workload three ways:

  1. prefix caching ON  — sustains the offered rate,
  2. prefix caching OFF — prefill-bound, backs up at the same budget,
  3. a long-generation turn of the same sessions against a tight budget —
     the batcher preempts (evict + recompute) instead of over-allocating,
     and every request still completes.

The KV-memory model and the cluster are simulated on the host, with the
reference's inputs, so the flow prints what
``examples/shared_prefix_chat.py`` prints.

Run:  PYTHONPATH=src python examples_torch/shared_prefix_chat.py
"""
import dataclasses

from repro_torch.core import (BenchmarkJobSpec, BenchmarkSession, ClusterSpec,
                              MemorySpec)
from repro_torch.core.analysis import memory_table
from repro_torch.serving.workload import WorkloadSpec

CHAT = WorkloadSpec(kind="poisson", rate=600, duration_s=3,
                    prompt_tokens=512, prefix_tokens=480,
                    output_tokens=2, output_tokens_max=4,
                    session_count=8, seed=0)
# follow-up turns: short prompts, long generations, tight KV budget
LONGGEN = dataclasses.replace(CHAT, rate=60, prompt_tokens=96,
                              prefix_tokens=64, output_tokens=128,
                              output_tokens_max=256)

CONFIGS = {
    "prefix-on": (CHAT, MemorySpec(block_tokens=16, prefix_caching=True)),
    "prefix-off": (CHAT, MemorySpec(block_tokens=16,
                                    prefix_caching=False)),
    "tight-budget": (LONGGEN, MemorySpec(block_tokens=16, hbm_gb=0.3)),
}


def main(argv=None) -> None:
    session = BenchmarkSession(n_workers=2)
    handles = {
        name: session.submit(BenchmarkJobSpec(
            job_id=f"chat-{name}", model={"name": "gemma2-2b"}, chips=4,
            slo_latency_s=0.25,
            software={"policy": "continuous", "max_batch": 16,
                      "max_prefill": 8},
            # sticky sessions keep a session's prefix blocks on one replica
            cluster=ClusterSpec(replicas=1, router="affinity", memory=mem),
            workload=wl))
        for name, (wl, mem) in CONFIGS.items()
    }
    session.run()

    for name, handle in handles.items():
        m = handle.result().metrics
        mem = handle.result().memory
        print(f"{name:>12}: thr={m['throughput_rps']:7.1f} rps  "
              f"p99={m['p99_s'] * 1e3:7.1f} ms  "
              f"hit={m['prefix_hit_rate']:5.1%}  "
              f"preempt={m['preemptions']:3d}  "
              f"peak_occ={m['kv_peak_occupancy']:5.1%}  "
              f"blocks={mem['total_blocks_per_replica']}")

    ratio = (handles["prefix-on"].result().metrics["throughput_rps"]
             / handles["prefix-off"].result().metrics["throughput_rps"])
    print(f"\nprefix caching sustains {ratio:.2f}x the cache-less throughput "
          "at the same HBM budget")
    print("\n" + memory_table(session.db))


if __name__ == "__main__":
    main()
