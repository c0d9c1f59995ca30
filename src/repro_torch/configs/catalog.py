"""The 10 architectures of the reference catalog, copied from
``repro.configs.catalog`` with the same values: the dense homogeneous
stacks, the MoE stacks, the RG-LRU hybrid, the attention-free RWKV6 stack,
the encoder-decoder whisper-tiny and the VLM llava-next-34b.  Each also
exists as its own module (``repro_torch.configs.<arch_id>``) exposing
``CONFIG``.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.models.config import (ATTN_GLOBAL, ATTN_LOCAL, RGLRU, RWKV6,
                                       ModelConfig)

# [arXiv:2212.04356] — enc-dec, conv frontend (stub)
WHISPER_TINY = ModelConfig(
    name="whisper-tiny", family="audio",
    num_layers=4, encoder_layers=4, d_model=384, num_heads=6, num_kv_heads=6,
    head_dim=64, d_ff=1536, vocab_size=51_865,
    frontend="audio_frames")

# [arXiv:2402.19427] — RG-LRU + local attn, 1 attention per 2 recurrent
RECURRENTGEMMA_9B = ModelConfig(
    name="recurrentgemma-9b", family="hybrid",
    num_layers=38, d_model=4096, num_heads=16, num_kv_heads=1, head_dim=256,
    d_ff=12_288, vocab_size=256_000,
    layer_pattern=(RGLRU, RGLRU, ATTN_LOCAL), local_window=2048,
    rglru_d_rnn=4096)

# [hf:ibm-granite/granite-3.0-1b-a400m-base family] — 40 experts top-8
GRANITE_MOE_3B = ModelConfig(
    name="granite-moe-3b-a800m", family="moe",
    num_layers=32, d_model=1536, num_heads=24, num_kv_heads=8, head_dim=64,
    d_ff=512, vocab_size=49_155, num_experts=40, experts_per_token=8)

# [hf:databricks/dbrx-base] — 16 experts top-4, fine-grained
DBRX_132B = ModelConfig(
    name="dbrx-132b", family="moe",
    num_layers=40, d_model=6144, num_heads=48, num_kv_heads=8, head_dim=128,
    d_ff=10_752, vocab_size=100_352, num_experts=16, experts_per_token=4)

# [arXiv:2408.00118] — local+global alternating, logit softcap
GEMMA2_2B = ModelConfig(
    name="gemma2-2b", family="dense",
    num_layers=26, d_model=2304, num_heads=8, num_kv_heads=4, head_dim=256,
    d_ff=9216, vocab_size=256_000,
    layer_pattern=(ATTN_LOCAL, ATTN_GLOBAL), local_window=4096,
    attn_logit_softcap=50.0, final_logit_softcap=30.0)

# [hf:ibm-granite/granite-3.0-2b-base] — GQA
GRANITE_3_2B = ModelConfig(
    name="granite-3-2b", family="dense",
    num_layers=40, d_model=2048, num_heads=32, num_kv_heads=8, head_dim=64,
    d_ff=8192, vocab_size=49_155)

# [arXiv:2405.04324] — llama-arch, code
GRANITE_8B = ModelConfig(
    name="granite-8b", family="dense",
    num_layers=36, d_model=4096, num_heads=32, num_kv_heads=8, head_dim=128,
    d_ff=14_336, vocab_size=49_152)

# [arXiv:2403.04652] — llama-arch GQA
YI_9B = ModelConfig(
    name="yi-9b", family="dense",
    num_layers=48, d_model=4096, num_heads=32, num_kv_heads=4, head_dim=128,
    d_ff=11_008, vocab_size=64_000)

# [arXiv:2404.05892] — Finch, data-dependent decay, attention-free
RWKV6_7B = ModelConfig(
    name="rwkv6-7b", family="ssm",
    num_layers=32, d_model=4096, num_heads=64, num_kv_heads=64, head_dim=64,
    d_ff=14_336, vocab_size=65_536,
    layer_pattern=(RWKV6,), rwkv_head_dim=64)

# [hf:llava-hf/llava-v1.6] backbone — anyres tiling stub frontend
LLAVA_NEXT_34B = ModelConfig(
    name="llava-next-34b", family="vlm",
    num_layers=60, d_model=7168, num_heads=56, num_kv_heads=8, head_dim=128,
    d_ff=20_480, vocab_size=64_000,
    frontend="vision_patches", num_frontend_tokens=2880)

ARCHS: Dict[str, ModelConfig] = {
    c.name: c for c in (
        WHISPER_TINY, RECURRENTGEMMA_9B, GRANITE_MOE_3B, DBRX_132B, GEMMA2_2B,
        GRANITE_3_2B, GRANITE_8B, YI_9B, RWKV6_7B, LLAVA_NEXT_34B)
}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]
