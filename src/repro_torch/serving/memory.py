"""Paged KV-cache accounting, prefix caching, and preemption bookkeeping.

Real LLM serving is capacity-capped by KV-cache memory, not compute: a
replica holds only as many concurrent sequences as its HBM holds KV
blocks (the PagedAttention argument).  This module gives the cluster
simulator that constraint:

  ``MemorySpec``     — serving-memory configuration (block size, HBM
                       budget, prefix cache on/off, preemption victim
                       policy), plumbed through ``ClusterSpec``.
  ``KVCacheManager`` — per-replica block-granular allocator with a
                       ref-counted per-session prefix cache (LRU eviction
                       of unreferenced prefix blocks) plus occupancy /
                       hit-rate / preemption accounting.
  ``resolve_memory`` — derive the block budget from the hardware catalog
                       (``repro_torch.hw``) and the model KV footprint
                       (``repro_torch.analysis.memory_model``) for any latency
                       oracle.

The continuous engine consumes the manager at every iteration boundary:
block allocation on join (prefix-cache hits shrink the prefill), one
block extension per decoded token crossing a block boundary, and
recompute-style preemption (victim freed and requeued; its re-prefill is
clocked by the latency model) when extension fails.  Request-level
engines bound each batch's transient working set against the same
budget.

A copy of ``repro.serving.memory``, importing only ``repro_torch``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

GiB = 1024 ** 3
DEFAULT_MAX_MODEL_LEN = 8192

VICTIM_POLICIES = ("youngest", "largest")


class KVBudgetError(ValueError):
    """A grounded KV budget cannot serve the given workload (e.g. it
    cannot hold even one sequence).  Distinct from plain ValueError so
    callers sweeping configurations (the planner) can reject the
    candidate without masking genuine configuration mistakes."""


@dataclasses.dataclass(frozen=True)
class MemorySpec:
    """Serving-memory configuration (``ClusterSpec.memory``).

    ``hbm_gb``/``kv_bytes_per_token``/``max_model_len`` default to 0 =
    "derive from the latency oracle": HBM capacity × chips from the
    hardware catalog minus resident weights, the per-token KV footprint
    from the model config, and the model's ``max_seq_len``.  Fitted
    profiles carry no model config, so profile-driven jobs must set
    ``hbm_gb`` and ``kv_bytes_per_token`` explicitly.  ``num_blocks``
    bypasses byte math entirely (tests / what-if analyses).
    """
    block_tokens: int = 16          # KV tokens per page
    hbm_gb: float = 0.0             # KV budget per replica; 0 → derive
    kv_bytes_per_token: float = 0.0  # 0 → derive from the model config
    util_fraction: float = 0.9      # usable fraction of HBM (frag. slack)
    prefix_caching: bool = True
    preemption: str = "youngest"    # victim selection: youngest | largest
    max_model_len: int = 0          # context cap; 0 → model max_seq_len
    num_blocks: int = 0             # explicit block count (overrides bytes)

    def __post_init__(self):
        if self.block_tokens < 1:
            raise ValueError("MemorySpec.block_tokens must be >= 1")
        if self.preemption not in VICTIM_POLICIES:
            raise ValueError(f"unknown preemption policy "
                             f"{self.preemption!r} "
                             f"(expected one of {VICTIM_POLICIES})")
        if not 0.0 < self.util_fraction <= 1.0:
            raise ValueError("MemorySpec.util_fraction must be in (0, 1]")

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "MemorySpec":
        return cls(**dict(d))


def scaled_memory_spec(spec: Optional[MemorySpec],
                       mode) -> Optional[MemorySpec]:
    """A :class:`MemorySpec` adjusted for serving under a
    :class:`~repro_torch.serving.latency_model.SpeedMode`.

    Only an *explicitly set* ``kv_bytes_per_token`` needs rescaling
    (quantized KV entries are smaller, so the same HBM budget holds
    more tokens); oracle-derived footprints flow through the oracle's
    own speed-mode-scaled ``kv_bytes_per_token``/``weight_bytes`` hooks.
    An explicit ``num_blocks`` is a byte-free what-if knob and is left
    untouched.
    """
    if spec is None or mode is None:
        return spec
    scale = getattr(mode, "kv_bytes_scale", 1.0)
    if scale == 1.0 or spec.kv_bytes_per_token <= 0:
        return spec
    return dataclasses.replace(
        spec, kv_bytes_per_token=spec.kv_bytes_per_token * scale)


def oracle_kv_bytes_per_token(oracle) -> float:
    """Per-token KV footprint of a latency oracle, or 0.0 when the oracle
    carries no model config (fitted calibration profiles).  Shared by the
    KV budget resolution here and the disaggregated prefill→decode
    transfer sizing in ``repro_torch.serving.cluster``."""
    fn = getattr(oracle, "kv_bytes_per_token", None)
    if fn is None:
        return 0.0
    return float(fn())


@dataclasses.dataclass(frozen=True)
class ResolvedMemory:
    """A MemorySpec grounded against one oracle: concrete block budget."""
    total_blocks: int
    kv_bytes_per_token: float
    max_model_len: int
    budget_bytes: float


def resolve_memory(spec: MemorySpec, oracle) -> ResolvedMemory:
    """Ground a MemorySpec against a latency oracle's model + hardware."""
    cfg = getattr(oracle, "cfg", None)
    kv_b = spec.kv_bytes_per_token
    if kv_b <= 0:
        kv_b = oracle_kv_bytes_per_token(oracle)
        if kv_b <= 0:
            if spec.num_blocks > 0:
                kv_b = 0.0  # block count given directly; bytes cosmetic
            else:
                raise ValueError(
                    "MemorySpec.kv_bytes_per_token must be set explicitly "
                    "for latency oracles without a model config (e.g. "
                    "fitted calibration profiles)")
    max_len = spec.max_model_len or getattr(cfg, "max_seq_len", 0) \
        or DEFAULT_MAX_MODEL_LEN
    if spec.num_blocks > 0:
        total = spec.num_blocks
        budget = float(total * spec.block_tokens * kv_b)
    else:
        if spec.hbm_gb > 0:
            budget = spec.hbm_gb * GiB
        else:
            weight_fn = getattr(oracle, "weight_bytes", None)
            if weight_fn is None:
                raise ValueError(
                    "MemorySpec.hbm_gb must be set explicitly for latency "
                    "oracles without a parameter count (e.g. fitted "
                    "calibration profiles)")
            from repro_torch.analysis.memory_model import serving_hbm_headroom
            budget = serving_hbm_headroom(oracle.hw, oracle.chips,
                                          weight_fn(), spec.util_fraction)
        total = int(budget // (spec.block_tokens * kv_b))
    if total < 1:
        raise ValueError(
            f"KV budget of {budget / GiB:.2f} GiB holds zero "
            f"{spec.block_tokens}-token blocks at "
            f"{kv_b:.0f} B/token — the model's weights alone exhaust HBM")
    return ResolvedMemory(total_blocks=total, kv_bytes_per_token=kv_b,
                          max_model_len=max_len, budget_bytes=budget)


def validate_budget_for_requests(spec: MemorySpec, resolved: ResolvedMemory,
                                 requests, continuous: bool) -> None:
    """Reject a grounded budget that cannot hold the workload's largest
    single request — below that there is no victim to preempt and the
    sequence could never run.  Shared by the flat cluster path and every
    pool of a heterogeneous fleet (any request may route to any pool, so
    each pool's budget must clear the same bar)."""
    worst = 0
    for r in requests:
        out = r.output_tokens
        if continuous:
            if r.prompt_tokens >= resolved.max_model_len:
                # previously clamped to a 1-token sentinel, silently
                # validating a sequence the engine would then decode
                # past the context limit
                raise KVBudgetError(
                    f"request {r.req_id}: prompt of {r.prompt_tokens} "
                    f"tokens leaves no room to decode within "
                    f"max_model_len={resolved.max_model_len}; raise "
                    "MemorySpec.max_model_len or shrink the workload's "
                    "prompts")
            out = max(1, min(out, resolved.max_model_len - r.prompt_tokens))
        worst = max(worst, r.prompt_tokens + out)
    bt = spec.block_tokens
    need = -(-worst // bt)
    if need > resolved.total_blocks:
        raise KVBudgetError(
            f"KV budget of {resolved.total_blocks} blocks "
            f"({resolved.budget_bytes / 1024**3:.2f} GiB at "
            f"{bt} tok/block) cannot hold one {worst}-token sequence "
            f"({need} blocks); raise hbm_gb/num_blocks or shrink the "
            "workload's prompt/output lengths")


@dataclasses.dataclass
class _Alloc:
    """Blocks one live request references."""
    private_blocks: int
    shared_blocks: int              # blocks referenced inside a prefix entry
    session: Optional[int]
    tokens: int


@dataclasses.dataclass
class _PrefixEntry:
    """Cached prefix blocks of one session (radix-path equivalent: with
    whole-session sharing the trie degenerates to one path per session)."""
    blocks: int
    refs: int
    last_used: float


class KVCacheManager:
    """Block-granular KV allocator for one replica.

    All bookkeeping is in block *counts* (the simulator never materializes
    tensors); the invariant maintained is ``resident_blocks <=
    total_blocks`` at all times, where resident = privately allocated +
    prefix-cached blocks.
    """

    def __init__(self, spec: MemorySpec, resolved: ResolvedMemory):
        self.spec = spec
        self.block_tokens = spec.block_tokens
        self.total_blocks = resolved.total_blocks
        self.kv_bytes_per_token = resolved.kv_bytes_per_token
        self.max_model_len = resolved.max_model_len
        self.budget_bytes = resolved.budget_bytes
        self.free_blocks = resolved.total_blocks
        # bumped on every free(): engines compare versions to detect
        # "KV blocks were released since my admission got blocked", which
        # re-attributes the wait from batching policy to memory pressure
        self.version = 0
        self._allocs: Dict[int, _Alloc] = {}
        self._cache: Dict[int, _PrefixEntry] = {}
        # ---- accounting ----
        self.peak_blocks = 0
        self.hit_tokens = 0
        self.miss_tokens = 0
        self.preemptions = 0
        self.evictions = 0
        self._occ_integral = 0.0        # ∫ resident_blocks dt
        self._last_t = 0.0

    # ---- gauges -----------------------------------------------------------
    @property
    def resident_blocks(self) -> int:
        """Blocks occupying HBM right now (allocated + prefix-cached)."""
        return self.total_blocks - self.free_blocks

    def referenced_blocks(self) -> int:
        """Blocks referenced by live requests (excludes idle cache)."""
        private = sum(a.private_blocks for a in self._allocs.values())
        shared = sum(e.blocks for e in self._cache.values() if e.refs > 0)
        return private + shared

    def blocks_for(self, tokens: int) -> int:
        return -(-max(int(tokens), 0) // self.block_tokens)

    # ---- time accounting --------------------------------------------------
    def touch(self, now: float) -> None:
        """Advance the occupancy integral to ``now``."""
        if now > self._last_t:
            self._occ_integral += self.resident_blocks * (now - self._last_t)
            self._last_t = now

    def _bump_peak(self) -> None:
        self.peak_blocks = max(self.peak_blocks, self.resident_blocks)

    # ---- allocation -------------------------------------------------------
    def _reclaim(self, need: int) -> bool:
        """Evict idle (refs == 0) prefix entries, LRU-first, until ``need``
        free blocks exist.  Returns whether the reclaim succeeded."""
        if need <= self.free_blocks:
            return True
        idle = sorted(((e.last_used, sid) for sid, e in self._cache.items()
                       if e.refs == 0))
        for _, sid in idle:
            entry = self._cache.pop(sid)
            self.free_blocks += entry.blocks
            self.evictions += 1
            if need <= self.free_blocks:
                return True
        return need <= self.free_blocks

    def allocate(self, req_id: int, context_tokens: int, now: float, *,
                 session_id: Optional[int] = None,
                 prefix_tokens: int = 0) -> Optional[int]:
        """Allocate blocks covering ``context_tokens`` for a joining
        request.  Returns the number of prefix-cache-hit tokens (0 when
        cold), or None when the budget cannot hold the request — the
        caller leaves it queued.
        """
        if req_id in self._allocs:
            raise ValueError(f"request {req_id} already holds KV blocks")
        self.touch(now)
        total_needed = self.blocks_for(context_tokens)
        shared_target = hit_blocks = 0
        entry = None
        if self.spec.prefix_caching and session_id is not None \
                and prefix_tokens > 0:
            # only whole blocks are shareable (page-aligned prefix)
            shared_target = min(prefix_tokens, context_tokens) \
                // self.block_tokens
            entry = self._cache.get(session_id)
            if entry is not None:
                hit_blocks = min(entry.blocks, shared_target)
        need = (shared_target - hit_blocks) \
            + (total_needed - shared_target)
        # pin the session's own entry: the LRU reclaim must not evict the
        # blocks this allocation is about to hit (refs is 0 until commit)
        if entry is not None:
            entry.refs += 1
        ok = self._reclaim(need)
        if entry is not None:
            entry.refs -= 1
        if not ok:
            if entry is not None and entry.refs == 0:
                # the pin itself may be what starves us: sacrifice the
                # session's idle prefix and retry cold — with an empty
                # replica this always succeeds (budget holds any single
                # request by construction), so the engine cannot stall on
                # a head-of-line request whose own cache blocks the way
                self._cache.pop(session_id)
                self.free_blocks += entry.blocks
                self.evictions += 1
                return self.allocate(req_id, context_tokens, now,
                                     session_id=session_id,
                                     prefix_tokens=prefix_tokens)
            return None
        self.free_blocks -= need
        if shared_target > 0:
            if entry is None:
                entry = _PrefixEntry(blocks=0, refs=0, last_used=now)
                self._cache[session_id] = entry
            entry.blocks = max(entry.blocks, shared_target)
            entry.refs += 1
            entry.last_used = now
        cached_tokens = hit_blocks * self.block_tokens
        self.hit_tokens += cached_tokens
        self.miss_tokens += max(context_tokens - cached_tokens, 0)
        self._allocs[req_id] = _Alloc(
            private_blocks=total_needed - shared_target,
            shared_blocks=shared_target,
            session=session_id if shared_target > 0 else None,
            tokens=context_tokens)
        self._bump_peak()
        return cached_tokens

    def extend(self, req_id: int, context_tokens: int, now: float) -> bool:
        """Grow a live request's KV to ``context_tokens``.  Returns False
        when no block can be allocated (caller preempts a victim)."""
        a = self._allocs[req_id]
        need = self.blocks_for(context_tokens) \
            - (a.private_blocks + a.shared_blocks)
        if need <= 0:
            a.tokens = context_tokens
            return True
        self.touch(now)
        if not self._reclaim(need):
            return False
        self.free_blocks -= need
        a.private_blocks += need
        a.tokens = context_tokens
        self._bump_peak()
        return True

    def free(self, req_id: int, now: float, *,
             preempted: bool = False) -> None:
        """Release a request's private blocks; its prefix blocks stay
        cached (refs-decremented) for future session hits."""
        self.touch(now)
        self.version += 1
        a = self._allocs.pop(req_id)
        self.free_blocks += a.private_blocks
        if a.session is not None:
            entry = self._cache[a.session]
            entry.refs -= 1
            entry.last_used = now
        if preempted:
            self.preemptions += 1

    # ---- request-level (whole-batch) engines ------------------------------
    def charge_span(self, blocks: int, start: float, end: float) -> None:
        """Account a transient whole-batch working set held over
        [start, end] (request-level policies allocate and free at batch
        granularity, so no per-token paging is simulated)."""
        self._occ_integral += blocks * max(end - start, 0.0)
        self.peak_blocks = max(self.peak_blocks,
                               self.resident_blocks + blocks)

    # ---- reporting --------------------------------------------------------
    def stats(self, duration_s: float) -> Dict[str, Any]:
        self.touch(duration_s)
        denom = self.total_blocks * duration_s
        served = self.hit_tokens + self.miss_tokens
        return {
            "total_blocks": self.total_blocks,
            "block_tokens": self.block_tokens,
            "budget_bytes": self.budget_bytes,
            "peak_blocks": self.peak_blocks,
            "peak_occupancy": self.peak_blocks / self.total_blocks,
            "mean_occupancy": self._occ_integral / denom if denom else 0.0,
            "prefix_hit_tokens": self.hit_tokens,
            "prefix_hit_rate": self.hit_tokens / served if served else 0.0,
            "preemptions": self.preemptions,
            "evictions": self.evictions,
            "resident_blocks_end": self.resident_blocks,
            "referenced_blocks_end": self.referenced_blocks(),
        }
