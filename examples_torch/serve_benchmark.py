"""Real-execution serving benchmark on the port (``repro_torch``): a model
behind the dynamic batcher, comparing the three batching policies under the
same Poisson workload (the paper's Fig. 11d/12).

The policies and the workload are declared once as ``BenchmarkJobSpec``s
(the same spec objects a ``BenchmarkSession`` schedules) and resolved into
runnable policies via ``resolve_policy``; both are the reference's.

Where the flow differs from ``examples/serve_benchmark.py``: the reference
serves a reduced gemma2-2b on the CPU.  The port serves gemma2-2b at full
width on the card (26 layers, random bf16 weights from seed 0 as
``run_server`` makes them), through the flash-attention kernel on every
prefill and the decode-attention kernel on every decode step; with
``--device cpu`` it serves the reference's reduced config on the kernels'
plain versions.  Each batch is a prefill of the 32-token prompts and 3
decode steps into a cache of 64 slots.

    PYTHONPATH=src python examples_torch/serve_benchmark.py [--device cpu]
"""
import argparse

from repro_torch.configs import get_config
from repro_torch.core import BenchmarkJobSpec, ModelRef, SweepSpec, resolve_policy
from repro_torch.launch.serve import run_server
from repro_torch.models import reduced
from repro_torch.serving.engine import serving_config
from repro_torch.serving.workload import WorkloadSpec

MAX_LEN, DECODE_STEPS = 64, 4

BASE = BenchmarkJobSpec(
    job_id="serve-real",
    model=ModelRef(name="gemma2-2b"),
    workload=WorkloadSpec(rate=40, duration_s=4.0, prompt_tokens=32, seed=0),
)
SWEEP = SweepSpec(BASE, axes={
    "software.policy": ["none", "tfs", "tris"],
    "software.max_batch": [8],
    "software.timeout_s": [0.02],
    "software.preferred": [(8, 4, 2, 1)],
})


def model_config(device: str):
    """Full-width gemma2-2b with its serving weights on the card; the
    reference's reduced config on the CPU."""
    cfg = get_config("gemma2-2b")
    return reduced(cfg) if device == "cpu" else serving_config(cfg)


def main(argv=None) -> list:
    """Print the per-policy table; return ``[(policy, run_server result)]``
    in the sweep's order."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    cfg = model_config(args.device)

    print(f"serving {cfg.name} (real execution, {BASE.workload.rate} req/s "
          "Poisson)\n")
    print(f"{'policy':14s} {'requests':>9} {'thr rps':>9} {'p50 ms':>9} "
          f"{'p99 ms':>9} {'avg batch':>10}")
    rows = []
    for spec in SWEEP.expand():
        policy = resolve_policy(spec.software)
        out = run_server(cfg, policy, spec.workload, max_len=MAX_LEN,
                         decode_steps=DECODE_STEPS, device=args.device)
        print(f"{policy.name:14s} {out['requests']:9d} "
              f"{out['throughput_rps']:9.1f} {out['p50_s']*1e3:9.2f} "
              f"{out['p99_s']*1e3:9.2f} {out['mean_batch']:10.2f}")
        rows.append((policy, out))
    print("\nNote the paper's finding: the TFS-style window batcher trades "
          "latency for batch size;\nthe TrIS-style eager batcher keeps p50 low "
          "at light load.")
    return rows


if __name__ == "__main__":
    main()
