"""Decoder-only LM for homogeneous attention stacks, ported from
``repro.models.transformer.DecoderLM``.

The reference scans a stacked layer axis; here a Python loop walks the same
stacked parameters and cache.  Entry points, as in the reference:

  forward(params, tokens, lengths=None)    teacher-forced full-sequence pass
  prefill(params, cache, tokens, lengths)  fill the KV cache from prompts
  decode_step(params, cache, tokens)       one token per sequence

The cache is updated in place (the reference donates it instead) and
carries per-sequence ``lengths`` so ragged batching works.  Hybrid, RWKV,
MoE and encoder-decoder configs wait for later slices of the port.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models.config import ATTN_GLOBAL, ATTN_LOCAL, ModelConfig


class DecoderLM:
    """Dense GQA decoder; local layers use ``cfg.local_window``, global
    layers window 0 (the reference passes GLOBAL_WINDOW = 2**30 there)."""

    def __init__(self, cfg: ModelConfig, device=None):
        if (cfg.is_moe or cfg.is_encdec
                or not set(cfg.layer_pattern) <= {ATTN_GLOBAL, ATTN_LOCAL}):
            raise NotImplementedError(
                f"{cfg.name}: the port's DecoderLM runs homogeneous dense "
                "attention stacks only; hybrid, RWKV, MoE and encoder-decoder "
                "models come with ROADMAP M7-M10")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.kinds = cfg.layer_kinds()
        self.pdt = getattr(torch, cfg.param_dtype)
        self.windows = [cfg.local_window if k == ATTN_LOCAL else 0
                        for k in self.kinds]

    # ------------------------------------------------------------------ init
    def param_shapes(self) -> Dict[str, Any]:
        """The parameter tree's shapes, in the reference's layout."""
        c = self.cfg
        n, d, h, k, hd, f = (c.num_layers, c.d_model, c.num_heads,
                             c.num_kv_heads, c.head_dim, c.d_ff)
        return {
            "embed": (c.vocab_size, d),
            "final_norm": {"scale": (d,)},
            "layers": {
                "ln1": {"scale": (n, d)},
                "ln2": {"scale": (n, d)},
                "attn": {"wq": (n, d, h, hd), "wk": (n, d, k, hd),
                         "wv": (n, d, k, hd), "wo": (n, h, hd, d)},
                "ffn": {"wi": (n, d, f), "wg": (n, d, f), "wo": (n, f, d)},
            },
        }

    def init(self, generator: torch.Generator) -> Dict[str, Any]:
        """Random weights from ``generator`` (which must live on the model's
        device), with the reference's distributions."""
        c, dev, dt = self.cfg, self.device, self.pdt
        s = self.param_shapes()
        lay = s["layers"]
        fan_in = {"wq": c.d_model, "wk": c.d_model, "wv": c.d_model,
                  "wo": c.num_heads * c.head_dim}

        def ones(shape):
            return torch.ones(shape, dtype=dt, device=dev)

        return {
            "embed": L.embed_init(generator, c.vocab_size, c.d_model, dt, dev),
            "final_norm": {"scale": ones(s["final_norm"]["scale"])},
            "layers": {
                "ln1": {"scale": ones(lay["ln1"]["scale"])},
                "ln2": {"scale": ones(lay["ln2"]["scale"])},
                "attn": {name: L.dense_init(generator, shape, fan_in[name], dt, dev)
                         for name, shape in lay["attn"].items()},
                "ffn": {name: L.dense_init(generator, shape,
                                           c.d_ff if name == "wo" else c.d_model,
                                           dt, dev)
                        for name, shape in lay["ffn"].items()},
            },
        }

    def _layer(self, params, i: int) -> Dict[str, Dict[str, torch.Tensor]]:
        """Layer i's parameters in the activation dtype."""
        act = self.cfg.activation_dtype
        return {group: {name: t[i].to(act) for name, t in sub.items()}
                for group, sub in params["layers"].items()}

    # ------------------------------------------------------------- embeddings
    def _embed(self, params, tokens: torch.Tensor) -> torch.Tensor:
        act = self.cfg.activation_dtype
        x = params["embed"][tokens].to(act)
        # the scale is rounded to the activation dtype first, as in the reference
        return x * torch.tensor(math.sqrt(self.cfg.d_model), dtype=act,
                                device=x.device)

    def _logits(self, params, x: torch.Tensor) -> torch.Tensor:
        logits = x.float() @ params["embed"].float().T
        return L._softcap(logits, self.cfg.final_logit_softcap)

    # ---------------------------------------------------------------- blocks
    def _ffn_block(self, p, x):
        h = L.rmsnorm(p["ln2"], x, self.cfg.norm_eps)
        return x + L.mlp_apply(p["ffn"], h)

    def _attn_block(self, p, x, positions, window, lengths):
        c = self.cfg
        h = L.rmsnorm(p["ln1"], x, c.norm_eps)
        return x + L.attention_apply(
            p["attn"], h, positions, rope_theta=c.rope_theta, causal=True,
            window=window, softcap=c.attn_logit_softcap, lengths=lengths)

    def _positions(self, B: int, S: int) -> torch.Tensor:
        return torch.arange(S, device=self.device).expand(B, S)

    # --------------------------------------------------------------- forward
    def forward(self, params, tokens, *, lengths=None,
                return_hidden: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        """Teacher-forced pass → (logits (B, S, V), aux loss 0.0); with
        ``return_hidden`` the final-norm hidden states instead of logits."""
        B, S = tokens.shape
        x = self._embed(params, tokens)
        positions = self._positions(B, S)
        for i, w in enumerate(self.windows):
            p = self._layer(params, i)
            x = self._ffn_block(p, self._attn_block(p, x, positions, w, lengths))
        x = L.rmsnorm(params["final_norm"], x, self.cfg.norm_eps)
        aux = torch.zeros((), device=x.device)
        return (x if return_hidden else self._logits(params, x)), aux

    # ----------------------------------------------------------------- cache
    def _attn_cache_len(self, max_len: int) -> int:
        # a uniform cache length across layers, as in the reference: mixed
        # local/global stacks pay full length on local layers and apply the
        # window by mask; only all-local stacks get a ring of the window.
        if set(self.kinds) == {ATTN_LOCAL} and self.cfg.local_window:
            return min(self.cfg.local_window, max_len)
        return max_len

    def init_cache(self, batch: int, max_len: int, dtype=None) -> Dict[str, Any]:
        c = self.cfg
        dtype = dtype or getattr(torch, c.serve_param_dtype)
        W = self._attn_cache_len(max_len)
        shape = (c.num_layers, batch, W, c.num_kv_heads, c.head_dim)
        return {
            "lengths": torch.zeros((batch,), dtype=torch.int32, device=self.device),
            "layers": {
                "k": torch.zeros(shape, dtype=dtype, device=self.device),
                "v": torch.zeros(shape, dtype=dtype, device=self.device),
                "slot_pos": torch.full(shape[:3], -1, dtype=torch.int32,
                                       device=self.device),
            },
        }

    # --------------------------------------------------- cached attention ops
    def _attn_prefill(self, p, x, positions, window, lengths, lc):
        """Self-attention over the prompt, writing layer cache ``lc`` in place."""
        c = self.cfg
        h = L.rmsnorm(p["ln1"], x, c.norm_eps)
        y, (k, v) = L.attention_apply(
            p["attn"], h, positions, rope_theta=c.rope_theta, causal=True,
            window=window, softcap=c.attn_logit_softcap, lengths=lengths,
            return_kv=True)
        B, S = positions.shape
        W = lc["k"].shape[1]
        if W >= S:
            lc["k"][:, :S] = k
            lc["v"][:, :S] = v
            valid = positions < lengths[:, None]
            lc["slot_pos"][:, :S] = torch.where(valid, positions, -1)
        else:
            # Ring buffer: slot s must hold the *latest valid* position
            # p ≡ s (mod W).  A gather (one winner per slot):
            #   p(s) = len-1 − ((len-1−s) mod W)
            lens = lengths.clamp(max=S)[:, None]
            s_idx = torch.arange(W, device=x.device)[None, :]
            last = lens - 1 - ((lens - 1 - s_idx) % W)
            ok = (last >= 0) & (lens > 0)
            gidx = last.clamp(0, S - 1)
            b = torch.arange(B, device=x.device)[:, None]
            lc["k"].copy_(k[b, gidx])
            lc["v"].copy_(v[b, gidx])
            lc["slot_pos"].copy_(torch.where(ok, last, -1))
        return x + y

    def _attn_decode(self, p, x, q_pos, window, lc):
        """One-token attention against the cache; x: (B, 1, D).  Writes the
        new k/v into ``lc`` in place at slot q_pos % W."""
        c = self.cfg
        B = x.shape[0]
        h = L.rmsnorm(p["ln1"], x, c.norm_eps)
        q = L.rope(L.project(h, p["attn"]["wq"]), q_pos[:, None], c.rope_theta)
        k_new = L.rope(L.project(h, p["attn"]["wk"]), q_pos[:, None], c.rope_theta)
        v_new = L.project(h, p["attn"]["wv"])
        W = lc["k"].shape[1]
        slot = (q_pos % W).long()
        b = torch.arange(B, device=x.device)
        lc["k"][b, slot] = k_new[:, 0].to(lc["k"].dtype)
        lc["v"][b, slot] = v_new[:, 0].to(lc["v"].dtype)
        lc["slot_pos"][b, slot] = q_pos
        # round k/v to the cache dtype, then attend in q's dtype (as the
        # reference's kc.astype(q.dtype)).  Slots past q_pos are empty until
        # the ring wraps, so the scan stops at min(q_pos + 1, W).
        out = ops.decode_attention(
            q[:, 0], lc["k"].to(q.dtype).transpose(1, 2),
            lc["v"].to(q.dtype).transpose(1, 2),
            torch.clamp(q_pos + 1, max=W).to(torch.int32),
            softcap=c.attn_logit_softcap, window=window, q_pos=q_pos,
            slot_pos=lc["slot_pos"])
        return x + L.project_out(out[:, None], p["attn"]["wo"])

    def _layer_cache(self, cache, i: int) -> Dict[str, torch.Tensor]:
        return {name: t[i] for name, t in cache["layers"].items()}

    # ---------------------------------------------------------------- prefill
    def prefill(self, params, cache, tokens, lengths) -> Tuple[Dict, torch.Tensor]:
        """Process prompts (right-padded to S) → (cache, last-token logits)."""
        B, S = tokens.shape
        lengths = lengths.to(device=self.device, dtype=torch.int32)
        x = self._embed(params, tokens)
        positions = self._positions(B, S)
        for i, w in enumerate(self.windows):
            p = self._layer(params, i)
            x = self._attn_prefill(p, x, positions, w, lengths,
                                   self._layer_cache(cache, i))
            x = self._ffn_block(p, x)
        cache["lengths"] = lengths.clone()
        x = L.rmsnorm(params["final_norm"], x, self.cfg.norm_eps)
        # Gather the last valid hidden state *before* the vocab product: the
        # reference computes (B, S, V) logits and then gathers, the same
        # numbers at S times the memory (21 GB for gemma2-2b at B=4, S=5120).
        last = x[torch.arange(B, device=x.device), (lengths - 1).clamp(min=0).long()]
        return cache, self._logits(params, last)

    # ------------------------------------------------------------ decode step
    def decode_step(self, params, cache, tokens) -> Tuple[Dict, torch.Tensor]:
        """tokens: (B,) next input token per sequence → (cache, logits (B, V))."""
        x = self._embed(params, tokens[:, None])
        q_pos = cache["lengths"]
        for i, w in enumerate(self.windows):
            p = self._layer(params, i)
            x = self._attn_decode(p, x, q_pos, w, self._layer_cache(cache, i))
            x = self._ffn_block(p, x)
        cache["lengths"] = q_pos + 1
        x = L.rmsnorm(params["final_norm"], x, self.cfg.norm_eps)
        return cache, self._logits(params, x[:, 0])
