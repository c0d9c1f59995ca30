"""Inference engine: prefill / decode steps and greedy generation, ported
from ``repro.serving.engine``.

``make_prefill_fn`` builds the cache inside the step and returns (cache,
last-token logits); ``make_decode_fn`` is the one-token step.  The reference
donates the cache so XLA aliases it; here the decode step writes the cache
in place.  PyTorch runs eagerly, so nothing is jitted, and the decode loop
of ``make_generate_fn`` is a Python loop where the reference scans.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.dist import sharding as shd
from repro_torch.models.config import ModelConfig


def serving_config(cfg: ModelConfig) -> ModelConfig:
    """Inference variant: bf16 params (or the config's serve dtype)."""
    return dataclasses.replace(cfg, param_dtype=cfg.serve_param_dtype)


def _new_cache(model, *args, **kw):
    """``model.init_cache(*args, **kw)``; under a mesh placed by the model's
    cache axes and the active rules, as the reference's prefill cell lays
    out its cache."""
    cache = model.init_cache(*args, **kw)
    ctx = shd._ACT_CTX[0]
    if ctx is not None:
        cache = shd.shard_tree(cache, model.cache_axes(), ctx[1], ctx[0])
    return cache


def make_prefill_fn(model, max_len: Optional[int] = None) -> Callable:
    """→ ``prefill_step(params, tokens, lengths, frames=None, patches=None)``.
    The cache holds ``max_len`` slots, or the padded prompt: S, plus P for a
    VLM's ``patches`` (B, P, D), which go in front of the text.  An
    encoder-decoder model needs its ``frames`` (B, S_enc, D), as in the
    reference, whose step reads ``frames.shape[1]``."""
    cfg = model.cfg

    def prefill_step(params, tokens, lengths, frames=None, patches=None):
        B, S = tokens.shape
        cache_len = max_len or (S + (patches.shape[1] if patches is not None else 0))
        if cfg.is_encdec:
            if frames is None:
                raise ValueError(f"{cfg.name}: an encoder-decoder prefill needs frames")
            cache = _new_cache(model, B, cache_len, enc_len=frames.shape[1])
            return model.prefill(params, cache, tokens, lengths, frames=frames)
        return model.prefill(params, _new_cache(model, B, cache_len), tokens, lengths,
                             prefix_embeds=patches)
    return prefill_step


def make_decode_fn(model) -> Callable:
    def decode_step(params, cache, tokens):
        return model.decode_step(params, cache, tokens)
    return decode_step


def greedy_sample(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits, dim=-1).to(torch.int32)


def make_generate_fn(model, steps: int, max_len: Optional[int] = None) -> Callable:
    """prefill + ``steps`` greedy decode steps → tokens (B, steps + 1).

    ``max_len`` sizes the cache.  It defaults to the padded prompt length,
    as in the reference, so a sequence that fills its prompt wraps the ring
    while decoding (an encoder-decoder's cache is no ring: past its last
    slot, a step drops its own k/v, as the reference's scatter does); pass
    prompt + steps to keep every position.  ``generate``'s keywords
    (``frames``, ``patches``) go to the prefill.
    """
    prefill = make_prefill_fn(model, max_len)
    decode = make_decode_fn(model)

    def generate(params, tokens, lengths, **kw):
        cache, logits = prefill(params, tokens, lengths, **kw)
        out = [greedy_sample(logits)]
        for _ in range(steps):
            cache, logits = decode(params, cache, out[-1])
            out.append(greedy_sample(logits))
        return torch.stack(out, dim=1)

    return generate
