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

from repro_torch.models.config import ModelConfig


def serving_config(cfg: ModelConfig) -> ModelConfig:
    """Inference variant: bf16 params (or the config's serve dtype)."""
    return dataclasses.replace(cfg, param_dtype=cfg.serve_param_dtype)


def make_prefill_fn(model, max_len: Optional[int] = None) -> Callable:
    def prefill_step(params, tokens, lengths):
        B, S = tokens.shape
        cache = model.init_cache(B, max_len or S)
        return model.prefill(params, cache, tokens, lengths)
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
    while decoding; pass prompt + steps to keep every position.
    """
    prefill = make_prefill_fn(model, max_len)
    decode = make_decode_fn(model)

    def generate(params, tokens, lengths):
        cache, logits = prefill(params, tokens, lengths)
        out = [greedy_sample(logits)]
        for _ in range(steps):
            cache, logits = decode(params, cache, out[-1])
            out.append(greedy_sample(logits))
        return torch.stack(out, dim=1)

    return generate
