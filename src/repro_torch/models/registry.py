"""Model construction and parameter accounting, ported from
``repro.models.registry``.

``param_shapes`` reads the parameter tree's shapes off the model
(``DecoderLM.param_shapes`` or ``EncDecLM.param_shapes``), which allocates
nothing; the counting rules are
the reference's: a leaf under a path key ``embed`` is skipped where
embeddings are excluded, and MoE expert weights count k/E of themselves
toward the active parameters.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Iterator, Tuple, Union

from repro_torch.models.config import ModelConfig
from repro_torch.models.encdec import EncDecLM
from repro_torch.models.transformer import DecoderLM


def build_model(cfg: ModelConfig, device=None) -> Union[DecoderLM, EncDecLM]:
    if cfg.is_encdec:
        return EncDecLM(cfg, device)
    return DecoderLM(cfg, device)


def param_shapes(model: Union[DecoderLM, EncDecLM]) -> Dict[str, Any]:
    """The parameter tree with each leaf's shape (no allocation)."""
    return model.param_shapes()


def _leaves(tree: Dict[str, Any], path: Tuple[str, ...] = ()
            ) -> Iterator[Tuple[Tuple[str, ...], Tuple[int, ...]]]:
    for key, node in tree.items():
        if isinstance(node, dict):
            yield from _leaves(node, path + (key,))
        else:
            yield path + (key,), tuple(node)


def count_params(tree: Dict[str, Any], exclude_embed: bool = False) -> int:
    return sum(math.prod(shape) for path, shape in _leaves(tree)
               if not (exclude_embed and "embed" in path))


def model_flops_per_token(cfg: ModelConfig) -> float:
    """MODEL_FLOPS/token = 6·N (dense) or 6·N_active (MoE), N excl. embeddings.

    Computed from the model's parameter tree so it tracks the implementation
    exactly; for MoE, the expert weights are scaled by k/E to get N_active.
    """
    shapes = param_shapes(build_model(cfg, "meta"))
    total = 0.0
    for keys, shape in _leaves(shapes):
        if "embed" in keys:
            continue
        n = float(math.prod(shape))
        if cfg.is_moe and any(k in ("wi", "wg", "wo") for k in keys) \
                and "ffn" in keys:
            n *= cfg.experts_per_token / cfg.num_experts
        total += n
    return 6.0 * total
