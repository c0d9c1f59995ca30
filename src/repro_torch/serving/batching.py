"""Dynamic-batching policies (paper §3.2 "Advanced Features"), a copy of
``repro.serving.batching``.

The paper's software tier compares TFS and Triton; what actually differs
between them is the batching policy, which we implement as composable
strategies over the same engine:

  NoBatching        — every request served alone (the CPU baseline).
  WindowBatcher     — TFS-style: wait up to ``timeout`` for ``max_batch``;
                      fires on full batch or timeout of the oldest request.
  PreferredBatcher  — TrIS-style: fire eagerly as soon as any preferred
                      size is reachable; pad-free, lowest queueing delay.
  ContinuousBatcher — Orca/vLLM-style token-level policy: decode slots
                      free per iteration and waiting requests join the
                      running batch at every iteration boundary.

A request-level policy sees the queue and the clock and decides
(batch, fire_time).  ``ContinuousBatcher`` is configuration only — the
simulator's iteration-level engine interprets it (requests are admitted
mid-batch, so there is no single "fire" event to decide).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

from repro_torch.serving.workload import Request


@dataclasses.dataclass(slots=True)
class QueuedRequest:
    request: Request
    enqueue_s: float
    # ---- preemption state (continuous engine + KV cache manager) ----------
    # a preempted request re-enters the queue carrying its progress: the
    # tokens it must re-prefill (prompt + generated so far, recomputed at
    # latency-model cost) and the decode tokens still owed
    remaining: Optional[int] = None     # None → derive from the request
    recompute_tokens: int = 0           # context to re-prefill on rejoin
    preemptions: int = 0
    # ---- disaggregated serving (prefill→decode migration) -----------------
    # the request was prefilled on the prefill pool and its KV transferred:
    # the decode engine admits it with KV already resident (no prefill
    # compute) unless a later preemption forces a recompute
    migrated: bool = False


class BatchPolicy:
    name = "base"

    def next_batch(self, queue: List[QueuedRequest], now: float,
                   server_free_at: float
                   ) -> Optional[Tuple[List[QueuedRequest], float]]:
        """Return (requests_to_serve, fire_time) or None to wait."""
        raise NotImplementedError

    def earliest_fire(self, queue: List[QueuedRequest]) -> Optional[float]:
        """Next time at which the policy might fire without new arrivals."""
        return None


class NoBatching(BatchPolicy):
    name = "none"

    def next_batch(self, queue, now, server_free_at):
        if not queue:
            return None
        t = max(now, server_free_at, queue[0].enqueue_s)
        return [queue[0]], t


@dataclasses.dataclass
class WindowBatcher(BatchPolicy):
    """TFS-style: fill up to max_batch, or flush on timeout."""
    max_batch: int = 8
    timeout_s: float = 0.005
    name: str = "tfs-window"

    def next_batch(self, queue, now, server_free_at):
        if not queue:
            return None
        t_free = max(now, server_free_at)
        if len(queue) >= self.max_batch:
            batch = queue[:self.max_batch]
            return batch, max(t_free, batch[-1].enqueue_s)
        deadline = queue[0].enqueue_s + self.timeout_s
        if t_free >= deadline:
            return list(queue), t_free
        return None

    def earliest_fire(self, queue):
        if not queue:
            return None
        return queue[0].enqueue_s + self.timeout_s


@dataclasses.dataclass
class PreferredBatcher(BatchPolicy):
    """TrIS-style: serve eagerly at the largest reachable preferred size."""
    preferred: Sequence[int] = (8, 4, 2, 1)
    max_queue_delay_s: float = 0.002
    name: str = "tris-preferred"

    def next_batch(self, queue, now, server_free_at):
        if not queue:
            return None
        t_free = max(now, server_free_at)
        for size in sorted(self.preferred, reverse=True):
            if len(queue) >= size:
                batch = queue[:size]
                return batch, max(t_free, batch[-1].enqueue_s)
        deadline = queue[0].enqueue_s + self.max_queue_delay_s
        if t_free >= deadline:      # don't hold a partial batch forever
            return list(queue[:max(self.preferred)]), t_free
        return None

    def earliest_fire(self, queue):
        if not queue:
            return None
        return queue[0].enqueue_s + self.max_queue_delay_s


@dataclasses.dataclass
class ContinuousBatcher(BatchPolicy):
    """Orca/vLLM-style iteration-level batching configuration.

    ``max_batch`` caps concurrent decode slots; ``max_prefill`` caps how
    many queued requests are prefilled (joined) per iteration boundary.
    The policy holds no queue logic itself — the simulator's continuous
    engine admits requests into free slots every iteration.
    """
    max_batch: int = 16
    max_prefill: int = 8
    name: str = "continuous"

    def __post_init__(self):
        if self.max_batch < 1 or self.max_prefill < 1:
            raise ValueError("ContinuousBatcher needs max_batch >= 1 "
                             "and max_prefill >= 1")

    def next_batch(self, queue, now, server_free_at):
        raise TypeError(
            "ContinuousBatcher is iteration-level; it is interpreted by "
            "the simulator's continuous engine, not via next_batch()")


def make_policy(name: str, **kw) -> BatchPolicy:
    if name in ("none", "nobatch"):
        return NoBatching()
    if name in ("tfs", "window", "tfs-window"):
        return WindowBatcher(**kw)
    if name in ("tris", "preferred", "tris-preferred"):
        return PreferredBatcher(**kw)
    if name in ("continuous", "orca", "vllm"):
        return ContinuousBatcher(**kw)
    raise ValueError(name)
