"""Vocab-chunked cross-entropy, ported from ``repro.training.losses``.

For 256k-vocab models the (B, S, V) logits tensor alone would be tens of
GB; chunking the head projection over the sequence keeps the live logits at
(B, chunk, V), and each chunk runs under ``torch.utils.checkpoint`` (the
reference's ``jax.checkpoint`` of its scan body), so no chunk's logits
outlive it: the backward recomputes them chunk by chunk.  Under a device
mesh with the vocab sharded, each rank picks the gold logits in its own
slice of the vocab and the picks are summed over the ranks, as XLA
partitions the reference's gather.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.utils.checkpoint import checkpoint

from repro_torch.dist.sharding import coordinate, local_call
from repro_torch.kernels.ref import _softcap


def _gold(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """logits (B, S, V) at ``labels`` (B, S) → (B, S)."""
    if not isinstance(logits, DTensor):
        return logits.gather(-1, labels.long()[..., None])[..., 0]
    mesh = logits.device_mesh
    vocab = [i for i, p in enumerate(logits.placements) if p == Shard(2)]
    lead = [p if isinstance(p, Shard) and p.dim < 2 else Replicate()
            for p in logits.placements]

    def local(lg, lab):
        if not vocab:
            return lg.gather(-1, lab.long()[..., None])[..., 0]
        n = lg.shape[-1]
        v0 = coordinate(mesh, vocab) * n
        idx = lab.long() - v0
        mine = (idx >= 0) & (idx < n)
        got = lg.gather(-1, idx.clamp(0, n - 1)[..., None])[..., 0]
        return torch.where(mine, got, 0.0)

    in_lg = tuple(Shard(2) if i in vocab else p for i, p in enumerate(lead))
    out = tuple(Partial() if i in vocab else p for i, p in enumerate(lead))
    return local_call(local, mesh, (logits, labels), (in_lg, tuple(lead)), out)


def _chunk_nll(hidden, embed, labels, mask, logit_softcap: float):
    """(sum of the masked NLL, sum of the mask) over one chunk, in fp32."""
    logits = _softcap(hidden.float() @ embed.float().T, logit_softcap)
    lse = torch.logsumexp(logits, dim=-1)
    gold = _gold(logits, labels)
    return ((lse - gold) * mask).sum(), mask.sum()


def chunked_cross_entropy(hidden: torch.Tensor, embed: torch.Tensor,
                          labels: torch.Tensor, mask: torch.Tensor, *,
                          logit_softcap: float = 0.0, chunk: int = 512) -> torch.Tensor:
    """hidden: (B, S, D); embed: (V, D) tied head; labels/mask: (B, S) →
    the mean NLL over the masked positions (fp32 0-d).  As in the reference,
    a sequence that is no multiple of ``chunk`` runs as one chunk."""
    S = hidden.shape[1]
    chunk = min(chunk, S)
    if S % chunk:                      # fall back to one chunk if ragged
        chunk = S
    mask = mask.float()
    total = count = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for s0 in range(0, S, chunk):
        part = slice(s0, s0 + chunk)
        nll, n = checkpoint(_chunk_nll, hidden[:, part], embed, labels[:, part],
                            mask[:, part], logit_softcap, use_reentrant=False)
        total, count = total + nll, count + n
    return total / torch.clamp(count, min=1.0)
