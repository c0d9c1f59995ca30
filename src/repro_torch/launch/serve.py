"""End-to-end serving driver: REAL execution of a model behind the dynamic
batcher, driven by a generated workload trace; ported from
``repro.launch.serve``.

Requests arrive per the workload spec; the batcher groups them; the engine
runs actual prefill + decode steps on the card (or on the CPU when asked)
and wall-clock times are recorded per batch.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-2b \\
      --policy tris --rate 20 --duration 5
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, List

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.models import build_model, reduced
from repro_torch.serving.batching import QueuedRequest, make_policy
from repro_torch.serving.engine import (greedy_sample, make_decode_fn,
                                        make_prefill_fn)
from repro_torch.serving.workload import WorkloadSpec, generate


def run_server(cfg, policy, workload: WorkloadSpec, *,
               max_len: int = 192, decode_steps: int = 8,
               device=None) -> Dict:
    """Serve ``workload`` with ``policy`` on a model with random weights
    from seed 0, as the reference does.  ``max_len`` must cover prompt +
    decode_steps.  Returns the reference's result keys."""
    dev = resolve_device(device)
    model = build_model(cfg, dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    prefill = make_prefill_fn(model, max_len=max_len)
    decode = make_decode_fn(model)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def prompt(b):
        toks = torch.ones((b, workload.prompt_tokens), dtype=torch.int32, device=dev)
        lens = torch.full((b,), workload.prompt_tokens, dtype=torch.int32, device=dev)
        return toks, lens

    trace = generate(workload)
    # warm up (allocator, kernel builds) at the batch sizes the policy emits
    warm_sizes = sorted({1, getattr(policy, "max_batch", 1),
                         *getattr(policy, "preferred", (1,))})
    for b in warm_sizes:
        cache, logits = prefill(params, *prompt(b))
        decode(params, cache, greedy_sample(logits))
    sync()

    t_start = time.perf_counter()
    clock = lambda: time.perf_counter() - t_start
    queue: List[QueuedRequest] = []
    i, n = 0, len(trace)
    lat: List[float] = []
    batch_sizes: List[int] = []
    infer_times: List[float] = []
    while i < n or queue:
        now = clock()
        while i < n and trace[i].arrival_s <= now:
            queue.append(QueuedRequest(request=trace[i], enqueue_s=now))
            i += 1
        decision = policy.next_batch(queue, now, now)
        if decision is None:
            if i < n:
                time.sleep(max(trace[i].arrival_s - clock(), 0.0) + 1e-4)
            elif queue:
                time.sleep(1e-3)
            continue
        batch, _ = decision
        ids = {q.request.req_id for q in batch}
        queue = [q for q in queue if q.request.req_id not in ids]
        b = len(batch)
        toks, lens = prompt(b)
        t0 = time.perf_counter()
        cache, logits = prefill(params, toks, lens)
        nxt = greedy_sample(logits)
        for _ in range(decode_steps - 1):
            cache, logits = decode(params, cache, nxt)
            nxt = greedy_sample(logits)
        sync()
        dt = time.perf_counter() - t0
        done = clock()
        infer_times.append(dt)
        batch_sizes.append(b)
        for q in batch:
            lat.append(done - q.request.arrival_s)
    lat_arr = np.array(lat)
    return {
        "requests": len(lat),
        "throughput_rps": len(lat) / max(clock(), 1e-9),
        "p50_s": float(np.percentile(lat_arr, 50)) if len(lat) else 0.0,
        "p99_s": float(np.percentile(lat_arr, 99)) if len(lat) else 0.0,
        "mean_batch": float(np.mean(batch_sizes)) if batch_sizes else 0.0,
        "mean_infer_s": float(np.mean(infer_times)) if infer_times else 0.0,
    }


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2-2b")
    ap.add_argument("--policy", default="tris",
                    choices=["none", "tfs", "tris"])
    ap.add_argument("--rate", type=float, default=20.0)
    ap.add_argument("--duration", type=float, default=5.0)
    ap.add_argument("--prompt-tokens", type=int, default=32)
    ap.add_argument("--decode-steps", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    cfg = reduced(get_config(args.arch))
    policy = make_policy(args.policy, **(
        dict(max_batch=args.max_batch, timeout_s=0.01)
        if args.policy == "tfs" else
        dict(preferred=(args.max_batch, 4, 2, 1)) if args.policy == "tris"
        else {}))
    wl = WorkloadSpec(rate=args.rate, duration_s=args.duration,
                      prompt_tokens=args.prompt_tokens, seed=0)
    out = run_server(cfg, policy, wl, decode_steps=args.decode_steps,
                     device=args.device)
    print(f"arch={cfg.name} policy={args.policy} rate={args.rate} "
          f"device={args.device}")
    for k, v in out.items():
        print(f"  {k:16s} {v:.4f}" if isinstance(v, float) else f"  {k:16s} {v}")


if __name__ == "__main__":
    main()
