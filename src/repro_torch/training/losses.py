"""Vocab-chunked cross-entropy, ported from ``repro.training.losses``.

For 256k-vocab models the (B, S, V) logits tensor alone would be tens of
GB; chunking the head projection over the sequence keeps the live logits at
(B, chunk, V), and each chunk runs under ``torch.utils.checkpoint`` (the
reference's ``jax.checkpoint`` of its scan body), so no chunk's logits
outlive it: the backward recomputes them chunk by chunk.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.ref import _softcap


def _chunk_nll(hidden, embed, labels, mask, logit_softcap: float):
    """(sum of the masked NLL, sum of the mask) over one chunk, in fp32."""
    logits = _softcap(hidden.float() @ embed.float().T, logit_softcap)
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.long()[..., None])[..., 0]
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
