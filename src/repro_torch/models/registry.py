"""Model construction, ported from ``repro.models.registry.build_model``."""
from __future__ import annotations

from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import DecoderLM


def build_model(cfg: ModelConfig, device=None) -> DecoderLM:
    if cfg.is_encdec:
        raise NotImplementedError(
            f"{cfg.name}: encoder-decoder models come with ROADMAP M10")
    return DecoderLM(cfg, device)
