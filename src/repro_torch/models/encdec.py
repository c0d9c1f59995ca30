"""Whisper-style encoder-decoder, ported from ``repro.models.encdec.EncDecLM``.

The conv/mel frontend is a stub, as in the reference: callers hand the
encoder precomputed frame embeddings ``frames`` (B, S_enc, d_model).
Encoder layers are bidirectional self-attention + MLP; decoder layers are
causal self-attention + cross-attention + MLP.  Parameters keep the
reference's layout, each stack's leaves with a leading layer axis:

  embed, enc_layers {ln1, attn, ln2, ffn}, enc_norm,
  dec_layers {ln1, attn, lnx, xattn, ln2, ffn}, final_norm

The cache holds the decoder's self-attention k/v per layer (a full-length
cache, not a ring, with ``slot_pos``) and the cross-attention k/v
``cross_k``/``cross_v`` (L, B, S_enc, K, hd), which ``prefill`` replaces by
those of its ``frames``.  Attention goes through the port's kernels: the
encoder and the cross-attention over a sequence through flash attention
(not causal), decoding through decode attention.  Rounding follows the
reference: prefill attends with k, v and the cross k/v in the activation
dtype and stores them rounded to the cache dtype; decode reads the stored
copies back in the activation dtype.  With ``remat`` each decoder layer of
``forward`` runs under ``torch.utils.checkpoint``, as the reference's
``jax.checkpoint`` of its decoder scan body (the encoder is not
rematerialised there either).
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.dist.sharding import (constrain_act, embed_lookup, set_prefix, set_rows,
                                       take_rows)
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import _index, _split, stack_axes


class EncDecLM:
    def __init__(self, cfg: ModelConfig, device=None):
        if not cfg.is_encdec:
            raise ValueError(f"{cfg.name}: EncDecLM needs encoder_layers > 0")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.pdt = getattr(torch, cfg.param_dtype)

    # ------------------------------------------------------------------ init
    def _layer_shapes(self, n: int, cross: bool) -> Dict[str, Any]:
        c = self.cfg
        d, h, k, hd, f = c.d_model, c.num_heads, c.num_kv_heads, c.head_dim, c.d_ff
        attn = {"wq": (n, d, h, hd), "wk": (n, d, k, hd), "wv": (n, d, k, hd),
                "wo": (n, h, hd, d)}
        p: Dict[str, Any] = {"ln1": {"scale": (n, d)}, "attn": attn}
        if cross:
            p.update(lnx={"scale": (n, d)}, xattn=dict(attn))
        p.update(ln2={"scale": (n, d)},
                 ffn={"wi": (n, d, f), "wg": (n, d, f), "wo": (n, f, d)})
        return p

    def param_shapes(self) -> Dict[str, Any]:
        """The parameter tree's shapes, in the reference's layout."""
        c = self.cfg
        return {"embed": (c.vocab_size, c.d_model),
                "enc_layers": self._layer_shapes(c.encoder_layers, cross=False),
                "enc_norm": {"scale": (c.d_model,)},
                "dec_layers": self._layer_shapes(c.num_layers, cross=True),
                "final_norm": {"scale": (c.d_model,)}}

    def init(self, generator: torch.Generator) -> Dict[str, Any]:
        """Random weights from ``generator`` (which must live on the model's
        device), with the reference's distributions: norms at one, dense
        weights N(0, 1/fan_in), the embedding N(0, 0.02²)."""
        c, dev, dt = self.cfg, self.device, self.pdt
        fan_in = {"wq": c.d_model, "wk": c.d_model, "wv": c.d_model,
                  "wi": c.d_model, "wg": c.d_model}

        def group(name, sub):
            fans = {**fan_in, "wo": c.d_ff if name == "ffn" else c.num_heads * c.head_dim}
            return {leaf: torch.ones(shape, dtype=dt, device=dev) if leaf == "scale"
                    else L.dense_init(generator, shape, fans[leaf], dt, dev)
                    for leaf, shape in sub.items()}

        shapes = self.param_shapes()
        params = {"embed": L.embed_init(generator, c.vocab_size, c.d_model, dt, dev)}
        for stack in ("enc_layers", "dec_layers"):
            params[stack] = {name: group(name, sub) for name, sub in shapes[stack].items()}
        for norm in ("enc_norm", "final_norm"):
            params[norm] = group(norm, shapes[norm])
        return params

    def logical_axes(self) -> Dict[str, Any]:
        """Logical sharding axes of ``init``'s tree, keyed as the reference's."""
        enc = {"ln1": L.rmsnorm_axes(), "attn": L.attention_axes(),
               "ln2": L.rmsnorm_axes(), "ffn": L.mlp_axes()}
        dec = {"ln1": L.rmsnorm_axes(), "attn": L.attention_axes(),
               "lnx": L.rmsnorm_axes(), "xattn": L.attention_axes(),
               "ln2": L.rmsnorm_axes(), "ffn": L.mlp_axes()}
        return {"embed": ("vocab", "embed"), "enc_layers": stack_axes(enc),
                "enc_norm": L.rmsnorm_axes(), "dec_layers": stack_axes(dec),
                "final_norm": L.rmsnorm_axes()}

    def cache_axes(self) -> Dict[str, Any]:
        """Logical sharding axes of ``init_cache``'s tree."""
        kv = ("batch", "kv", "kv_heads", "head_dim")
        return {"lengths": ("batch",),
                "self": stack_axes({"k": kv, "v": kv, "slot_pos": ("batch", "kv")}),
                "cross_k": ("layers",) + kv, "cross_v": ("layers",) + kv}

    def _layer(self, params, stack: str, i: int):
        """Layer i of ``stack`` in the activation dtype."""
        return L.cast_layer_params(_index(params[stack], i), self.cfg.activation_dtype)

    def _positions(self, B: int, S: int) -> torch.Tensor:
        return torch.arange(S, device=self.device).expand(B, S)

    # ---------------------------------------------------------------- encode
    def encode(self, params, frames: torch.Tensor) -> torch.Tensor:
        """frames: (B, S_enc, d_model) stub-frontend embeddings → the encoder
        output, (B, S_enc, d_model) in the activation dtype."""
        c = self.cfg
        x = frames.to(device=self.device, dtype=c.activation_dtype)
        positions = self._positions(*x.shape[:2])
        for p in _split(params["enc_layers"]):
            p = L.cast_layer_params(p, c.activation_dtype)
            x = constrain_act(x, "batch", "seq", "act_embed")
            h = L.rmsnorm(p["ln1"], x, c.norm_eps)
            x = x + L.attention_apply(p["attn"], h, positions, rope_theta=c.rope_theta,
                                      causal=False)
            h = L.rmsnorm(p["ln2"], x, c.norm_eps)
            x = x + L.mlp_apply(p["ffn"], h)
        return L.rmsnorm(params["enc_norm"], x, c.norm_eps)

    def _embed(self, params, tokens: torch.Tensor) -> torch.Tensor:
        act = self.cfg.activation_dtype
        x = embed_lookup(params["embed"], tokens).to(act)
        # the scale is rounded to the activation dtype first, as in the reference
        return x * torch.tensor(math.sqrt(self.cfg.d_model), dtype=act, device=x.device)

    def _logits(self, params, x: torch.Tensor) -> torch.Tensor:
        # no final softcap here, unlike DecoderLM's
        return x.float() @ params["embed"].float().T

    def _cross_ffn(self, p, x, kv):
        """x + cross-attention to ``kv``, then + the MLP."""
        c = self.cfg
        h = L.rmsnorm(p["lnx"], x, c.norm_eps)
        x = x + L.cross_attention_apply(p["xattn"], h, kv)
        h = L.rmsnorm(p["ln2"], x, c.norm_eps)
        return x + L.mlp_apply(p["ffn"], h)

    # --------------------------------------------------------------- forward
    def _dec_layer(self, positions, lengths, enc_out, x, p):
        """One decoder layer over the full sequence, its weights ``p`` cast
        here."""
        c = self.cfg
        p = L.cast_layer_params(p, c.activation_dtype)
        x = constrain_act(x, "batch", "seq", "act_embed")
        h = L.rmsnorm(p["ln1"], x, c.norm_eps)
        x = x + L.attention_apply(p["attn"], h, positions, rope_theta=c.rope_theta,
                                  causal=True, lengths=lengths)
        return self._cross_ffn(p, x, L.cross_attention_kv(p["xattn"], enc_out))

    def forward(self, params, tokens, *, frames, lengths=None, remat: bool = False,
                return_hidden: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        """Teacher-forced pass: (frames, tokens) → (logits (B, S, V), fp32
        0.0); with ``return_hidden`` the final-norm hidden states instead;
        with ``remat`` each decoder layer is recomputed in the backward."""
        c = self.cfg
        if lengths is not None:
            lengths = lengths.to(device=self.device, dtype=torch.int32)
        enc_out = self.encode(params, frames)
        x = self._embed(params, tokens)
        body = functools.partial(self._dec_layer, self._positions(*x.shape[:2]), lengths,
                                 enc_out)
        for p in _split(params["dec_layers"]):
            x = checkpoint(body, x, p, use_reentrant=False) if remat else body(x, p)
        x = L.rmsnorm(params["final_norm"], x, c.norm_eps)
        aux = torch.zeros((), device=x.device)
        return (x if return_hidden else self._logits(params, x)), aux

    # ----------------------------------------------------------------- cache
    def init_cache(self, batch: int, max_len: int, dtype=None,
                   enc_len: int = 0) -> Dict[str, Any]:
        c, dev = self.cfg, self.device
        dtype = dtype or getattr(torch, c.serve_param_dtype)
        enc_len = enc_len or max_len
        n, K, hd = c.num_layers, c.num_kv_heads, c.head_dim
        return {
            "lengths": torch.zeros((batch,), dtype=torch.int32, device=dev),
            "self": {"k": torch.zeros((n, batch, max_len, K, hd), dtype=dtype, device=dev),
                     "v": torch.zeros((n, batch, max_len, K, hd), dtype=dtype, device=dev),
                     "slot_pos": torch.full((n, batch, max_len), -1, dtype=torch.int32,
                                            device=dev)},
            "cross_k": torch.zeros((n, batch, enc_len, K, hd), dtype=dtype, device=dev),
            "cross_v": torch.zeros((n, batch, enc_len, K, hd), dtype=dtype, device=dev),
        }

    # ---------------------------------------------------------------- prefill
    def prefill(self, params, cache, tokens, lengths, *,
                frames) -> Tuple[Dict, torch.Tensor]:
        """Encode ``frames``, compute the cross k/v, run the decoder over the
        prompts (right-padded to S) → (cache, last-token logits).  The cache's
        cross k/v are replaced by these frames' (their length is S_enc,
        whatever ``enc_len`` the cache was made with), as in the reference."""
        c = self.cfg
        lengths = lengths.to(device=self.device, dtype=torch.int32)
        enc_out = self.encode(params, frames)
        x = self._embed(params, tokens)
        B, S = x.shape[:2]
        W = cache["self"]["k"].shape[2]
        if W < S:
            raise ValueError(f"prefill: a cache of {W} slots cannot hold {S}-token prompts")
        positions = self._positions(B, S)
        slot_pos = torch.where(positions < lengths[:, None], positions, -1)
        cks, cvs = [], []
        for i in range(c.num_layers):
            p, lc = self._layer(params, "dec_layers", i), _index(cache["self"], i)
            x = constrain_act(x, "batch", "seq", "act_embed")
            h = L.rmsnorm(p["ln1"], x, c.norm_eps)
            y, (k, v) = L.attention_apply(p["attn"], h, positions, rope_theta=c.rope_theta,
                                          causal=True, lengths=lengths, return_kv=True)
            x = x + y
            set_prefix(lc["k"], k)
            set_prefix(lc["v"], v)
            set_prefix(lc["slot_pos"], slot_pos)
            ck, cv = L.cross_attention_kv(p["xattn"], enc_out)
            x = self._cross_ffn(p, x, (ck, cv))
            cks.append(ck)
            cvs.append(cv)
        dtype = cache["self"]["k"].dtype
        cache["cross_k"] = torch.stack(cks).to(dtype)
        cache["cross_v"] = torch.stack(cvs).to(dtype)
        cache["lengths"] = lengths.clone()
        x = L.rmsnorm(params["final_norm"], x, c.norm_eps)
        last = take_rows(x, (lengths - 1).clamp(min=0).long())
        return cache, self._logits(params, last)

    # ------------------------------------------------------------ decode step
    def decode_step(self, params, cache, tokens) -> Tuple[Dict, torch.Tensor]:
        """tokens: (B,) next input token per sequence → (cache, logits (B, V)).
        The new k/v go to slot q_pos; a row whose q_pos is past the cache's
        last slot drops its write (the reference's scatter drops an
        out-of-range index), so it attends to the slots it has."""
        c = self.cfg
        x = self._embed(params, tokens[:, None])
        q_pos = cache["lengths"]
        B = x.shape[0]
        W = cache["self"]["k"].shape[2]
        b = torch.arange(B, device=x.device)
        inside = q_pos < W
        slot = q_pos.clamp(max=W - 1).long()
        scan = torch.clamp(q_pos + 1, max=W).to(torch.int32)
        for i in range(c.num_layers):
            p, lc = self._layer(params, "dec_layers", i), _index(cache["self"], i)
            x = constrain_act(x, "batch", "seq", "act_embed")
            h = L.rmsnorm(p["ln1"], x, c.norm_eps)
            q = L.rope(L.project(h, p["attn"]["wq"]), q_pos[:, None], c.rope_theta)
            k_new = L.rope(L.project(h, p["attn"]["wk"]), q_pos[:, None], c.rope_theta)
            v_new = L.project(h, p["attn"]["wv"])
            # a masked read-modify-write: no host sync, no out-of-range index
            set_rows(lc["k"], b, slot, k_new[:, 0].to(lc["k"].dtype), inside)
            set_rows(lc["v"], b, slot, v_new[:, 0].to(lc["v"].dtype), inside)
            set_rows(lc["slot_pos"], b, slot, q_pos, inside)
            # not a ring: slots past q_pos are empty, so the scan stops at
            # min(q_pos + 1, W)
            out = ops.decode_attention(
                q[:, 0], lc["k"].to(q.dtype).transpose(1, 2),
                lc["v"].to(q.dtype).transpose(1, 2), scan, q_pos=q_pos,
                slot_pos=lc["slot_pos"])
            x = x + L.project_out(out[:, None], p["attn"]["wo"])
            kv = (cache["cross_k"][i].to(x.dtype), cache["cross_v"][i].to(x.dtype))
            x = self._cross_ffn(p, x, kv)
        cache["lengths"] = q_pos + 1
        x = L.rmsnorm(params["final_norm"], x, c.norm_eps)
        return cache, self._logits(params, x[:, 0])
