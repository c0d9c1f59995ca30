"""Decoder-only LM for dense and MoE attention stacks, the RG-LRU hybrid and
the attention-free RWKV6 stack, ported from
``repro.models.transformer.DecoderLM``.

Parameters and caches keep the reference's layout: a homogeneous stack (all
attention, or all RWKV6) under ``layers`` with a leading layer axis; a
hybrid (RecurrentGemma's (rec, rec, local-attn) pattern) under ``periods``
(``l0``..``l{p-1}``, each with a leading period axis) plus an unstacked
``tail`` (``t0``..).  The
reference scans the stacked axes; here a Python loop walks every layer.
Entry points, as in the reference:

  forward(params, tokens, lengths=None, remat=False)
                                           teacher-forced full-sequence pass
  prefill(params, cache, tokens, lengths)  fill the KV cache from prompts
  decode_step(params, cache, tokens)       one token per sequence

The cache is updated in place (the reference donates it instead) and
carries per-sequence ``lengths`` so ragged batching works.  An MoE config
(``cfg.is_moe``) gives every layer's FFN the capacity-based top-k experts of
``models/moe.py``; ``forward`` returns their load-balancing loss summed over
layers, which ``prefill`` and ``decode_step`` discard, as the reference
does.  A VLM (llava-next-34b) hands ``forward`` and ``prefill`` its stub
frontend's patch embeddings as ``prefix_embeds`` (B, P, D): they go in front
of the text, unscaled, and positions and ``lengths`` count patches plus text.
With ``remat`` each layer of ``forward`` runs under
``torch.utils.checkpoint``: its activations are recomputed in the backward
instead of kept, as the reference's ``jax.checkpoint`` of its scan body.
Encoder-decoder configs are ``models/encdec.py``'s ``EncDecLM``.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict, List, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.dist.sharding import (constrain_act, copy_into, embed_lookup, set_prefix,
                                       set_rows, take_rows)
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import moe, rglru, rwkv6
from repro_torch.models.config import (ATTN_GLOBAL, ATTN_LOCAL, RGLRU, RWKV6,
                                       ModelConfig)


def _index(node: Dict[str, Any], j: int) -> Dict[str, Any]:
    """Entry j of every stacked leaf of ``node`` (views of the leaves)."""
    return {k: _index(v, j) if isinstance(v, dict) else v[j] for k, v in node.items()}


def _split(node: Dict[str, Any]) -> List[Dict[str, Any]]:
    """``node``'s stacked leaves taken apart along the leading axis, once:
    one subtree per entry (views).  Under autograd the backward of each
    ``unbind`` stacks that leaf's gradient once, where indexing entry by
    entry backs every entry up into a zero-filled tensor the size of the
    whole leaf."""
    parts = {k: _split(v) if isinstance(v, dict) else v.unbind(0) for k, v in node.items()}
    n = len(next(iter(parts.values())))
    return [{k: part[j] for k, part in parts.items()} for j in range(n)]


def _write(dst: Dict[str, Any], src: Dict[str, Any]) -> None:
    """Copy every leaf of ``src`` into the same leaf of ``dst``, in place."""
    for k, v in src.items():
        _write(dst[k], v) if isinstance(v, dict) else copy_into(dst[k], v)


def stack_axes(axes_tree):
    """Every axes leaf with the stacked "layers" axis in front."""
    if isinstance(axes_tree, dict):
        return {k: stack_axes(v) for k, v in axes_tree.items()}
    return ("layers",) + tuple(axes_tree)


class DecoderLM:
    """Dense or MoE GQA decoder, RG-LRU hybrid or RWKV6 stack; local layers
    use ``cfg.local_window``, global layers window 0 (the reference passes
    GLOBAL_WINDOW = 2**30 there)."""

    def __init__(self, cfg: ModelConfig, device=None):
        if cfg.is_encdec:
            raise ValueError(f"{cfg.name}: an encoder-decoder config is "
                             "models/encdec.py's EncDecLM (build_model chooses)")
        pattern = set(cfg.layer_pattern)
        if RWKV6 in pattern and pattern != {RWKV6}:
            raise ValueError(
                f"{cfg.name}: a layer pattern that mixes RWKV6 with other kinds "
                f"{sorted(pattern)} has no working counterpart in the reference "
                "(its hybrid path gives RWKV6 layers no state)")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.kinds = cfg.layer_kinds()
        self.pdt = getattr(torch, cfg.param_dtype)
        self.windows = [cfg.local_window if k == ATTN_LOCAL else 0
                        for k in self.kinds]
        # homogeneous stacks (all attention, or all RWKV6) under ``layers``;
        # hybrid layout: full periods stacked + the remainder unstacked
        self.homogeneous = pattern <= {ATTN_GLOBAL, ATTN_LOCAL} or pattern == {RWKV6}
        self.stack_kind = RWKV6 if pattern == {RWKV6} else ATTN_GLOBAL
        self.period_len = len(cfg.layer_pattern)
        self.n_periods = cfg.num_layers // self.period_len
        self.tail_kinds = self.kinds[self.n_periods * self.period_len:]

    def _at(self, tree: Dict[str, Any], i: int) -> Dict[str, Any]:
        """Layer i's subtree of a parameter or cache tree, stacked leaves
        indexed: views, so writes into a cache land in the tree."""
        if self.homogeneous:
            return _index(tree["layers"], i)
        p, j = divmod(i, self.period_len)
        if p < self.n_periods:
            return _index(tree["periods"][f"l{j}"], p)
        return tree["tail"][f"t{i - self.n_periods * self.period_len}"]

    def _stacked(self, per_layer) -> Dict[str, Any]:
        """The reference's layer layout of ``per_layer(kind, lead)``, which
        gives one layer's tree with leading axes ``lead``."""
        if self.homogeneous:
            return {"layers": per_layer(self.stack_kind, (self.cfg.num_layers,))}
        return {"periods": {f"l{j}": per_layer(kind, (self.n_periods,))
                            for j, kind in enumerate(self.cfg.layer_pattern)},
                "tail": {f"t{i}": per_layer(kind, ())
                         for i, kind in enumerate(self.tail_kinds)}}

    # ------------------------------------------------------------------ init
    def _layer_shapes(self, kind: str, lead) -> Dict[str, Any]:
        c = self.cfg
        d, h, k, hd, f = c.d_model, c.num_heads, c.num_kv_heads, c.head_dim, c.d_ff
        p: Dict[str, Any] = {"ln1": {"scale": lead + (d,)},
                             "ln2": {"scale": lead + (d,)}}
        if kind == RGLRU:
            p["rec"] = {name: lead + shape for name, shape
                        in rglru.rglru_shapes(d, c.rglru_d_rnn).items()}
        elif kind == RWKV6:
            p["tm_cm"] = {name: lead + shape for name, shape
                          in rwkv6.rwkv_shapes(d, f, c.rwkv_head_dim).items()}
        else:
            p["attn"] = {"wq": lead + (d, h, hd), "wk": lead + (d, k, hd),
                         "wv": lead + (d, k, hd), "wo": lead + (h, hd, d)}
        if kind != RWKV6:  # rwkv's channel-mix is its FFN
            ffn = (moe.moe_shapes(d, f, c.num_experts) if c.is_moe else
                   {"wi": (d, f), "wg": (d, f), "wo": (f, d)})
            p["ffn"] = {name: lead + shape for name, shape in ffn.items()}
        return p

    def param_shapes(self) -> Dict[str, Any]:
        """The parameter tree's shapes, in the reference's layout."""
        c = self.cfg
        return {"embed": (c.vocab_size, c.d_model),
                "final_norm": {"scale": (c.d_model,)},
                **self._stacked(self._layer_shapes)}

    def init(self, generator: torch.Generator) -> Dict[str, Any]:
        """Random weights from ``generator`` (which must live on the model's
        device), with the reference's distributions."""
        c, dev, dt = self.cfg, self.device, self.pdt
        fan_in = {("attn", "wq"): c.d_model, ("attn", "wk"): c.d_model,
                  ("attn", "wv"): c.d_model, ("attn", "wo"): c.num_heads * c.head_dim,
                  ("ffn", "wi"): c.d_model, ("ffn", "wg"): c.d_model,
                  ("ffn", "wo"): c.d_ff}

        def group_init(group, sub, lead):
            if group == "rec":
                return rglru.rglru_init(generator, c.d_model, c.rglru_d_rnn, dt, dev, lead)
            if group == "tm_cm":
                return rwkv6.rwkv_init(generator, c.d_model, c.d_ff, c.rwkv_head_dim,
                                       dt, dev, lead)
            if group == "ffn" and c.is_moe:
                return moe.moe_init(generator, c.d_model, c.d_ff, c.num_experts, dt, dev,
                                    lead)
            return {name: torch.ones(shape, dtype=dt, device=dev) if name == "scale"
                    else L.dense_init(generator, shape, fan_in[group, name], dt, dev)
                    for name, shape in sub.items()}

        def layer(kind, lead):
            return {group: group_init(group, sub, lead)
                    for group, sub in self._layer_shapes(kind, lead).items()}

        return {"embed": L.embed_init(generator, c.vocab_size, c.d_model, dt, dev),
                "final_norm": {"scale": torch.ones((c.d_model,), dtype=dt, device=dev)},
                **self._stacked(layer)}

    # ------------------------------------------------------------------ axes
    def _layer_axes(self, kind: str, lead) -> Dict[str, Any]:
        p: Dict[str, Any] = {"ln1": L.rmsnorm_axes(), "ln2": L.rmsnorm_axes()}
        if kind == RGLRU:
            p["rec"] = rglru.rglru_axes()
        elif kind == RWKV6:
            p["tm_cm"] = rwkv6.rwkv_axes()
        else:
            p["attn"] = L.attention_axes()
        if kind != RWKV6:
            p["ffn"] = moe.moe_axes() if self.cfg.is_moe else L.mlp_axes()
        return stack_axes(p) if lead else p

    def logical_axes(self) -> Dict[str, Any]:
        """Logical sharding axes of ``init``'s tree (``repro_torch.dist``),
        keyed as the reference's."""
        return {"embed": ("vocab", "embed"), "final_norm": L.rmsnorm_axes(),
                **self._stacked(self._layer_axes)}

    def _layer_cache_axes(self, kind: str, lead) -> Dict[str, Any]:
        if kind == RGLRU:
            p = {"s": ("batch", "rnn"), "conv": ("batch", None, "rnn")}
        elif kind == RWKV6:
            p = {"tm": {"shift": ("batch", "act_embed"),
                        "wkv": ("batch", "heads", None, None)},
                 "cm": ("batch", "act_embed")}
        else:
            p = {"k": ("batch", "kv", "kv_heads", "head_dim"),
                 "v": ("batch", "kv", "kv_heads", "head_dim"),
                 "slot_pos": ("batch", "kv")}
        return stack_axes(p) if lead else p

    def cache_axes(self) -> Dict[str, Any]:
        """Logical sharding axes of ``init_cache``'s tree."""
        return {"lengths": ("batch",), **self._stacked(self._layer_cache_axes)}

    def _layer_params(self, params) -> List[Dict[str, Any]]:
        """Every layer's subtree of ``params``, in order, each stacked leaf
        taken apart once (``_split``): the full-sequence pass's view."""
        if self.homogeneous:
            return _split(params["layers"])
        periods = [_split(params["periods"][f"l{j}"]) for j in range(self.period_len)]
        return [periods[j][p] for p in range(self.n_periods) for j in range(self.period_len)] \
            + [params["tail"][f"t{i}"] for i in range(len(self.tail_kinds))]

    def _layer(self, params, i: int) -> Dict[str, Dict[str, torch.Tensor]]:
        """Layer i's parameters in the activation dtype (fp32 leaves kept)."""
        return L.cast_layer_params(self._at(params, i), self.cfg.activation_dtype)

    # ------------------------------------------------------------- embeddings
    def _embed(self, params, tokens: torch.Tensor, prefix_embeds=None) -> torch.Tensor:
        """Scaled token embeddings, after ``prefix_embeds`` (B, P, D) cast to
        the activation dtype and left unscaled, as in the reference."""
        act = self.cfg.activation_dtype
        x = embed_lookup(params["embed"], tokens).to(act)
        # the scale is rounded to the activation dtype first, as in the reference
        x = x * torch.tensor(math.sqrt(self.cfg.d_model), dtype=act, device=x.device)
        if prefix_embeds is not None:
            x = torch.cat([prefix_embeds.to(device=x.device, dtype=act), x], dim=1)
        return constrain_act(x, "batch", "seq", "act_embed")

    def _logits(self, params, x: torch.Tensor) -> torch.Tensor:
        logits = x.float() @ params["embed"].float().T
        return L._softcap(logits, self.cfg.final_logit_softcap)

    # ---------------------------------------------------------------- blocks
    def _ffn_block(self, p, x, aux: bool = False):
        """→ (x + FFN(norm(x)), the block's load-balancing aux loss): an MoE
        block's when ``aux`` is asked (forward), else None (prefill and
        decode discard it, as the reference does, so it is not computed)."""
        c = self.cfg
        h = L.rmsnorm(p["ln2"], x, c.norm_eps)
        if not c.is_moe:
            return x + L.mlp_apply(p["ffn"], h), None
        out = moe.moe_apply(p["ffn"], h, num_experts=c.num_experts,
                            k=c.experts_per_token,
                            capacity_factor=c.moe_capacity_factor, return_aux=aux)
        return (x + out[0], out[1]) if aux else (x + out, None)

    def _attn_block(self, p, x, positions, window, lengths):
        c = self.cfg
        h = L.rmsnorm(p["ln1"], x, c.norm_eps)
        return x + L.attention_apply(
            p["attn"], h, positions, rope_theta=c.rope_theta, causal=True,
            window=window, softcap=c.attn_logit_softcap, lengths=lengths)

    def _positions(self, B: int, S: int) -> torch.Tensor:
        return torch.arange(S, device=self.device).expand(B, S)

    # --------------------------------------------------------------- forward
    def _layer_seq(self, kind: str, window: int, positions, lengths, x, p):
        """One layer over the full sequence from zero recurrent state, its
        weights ``p`` cast here → (x, the MoE block's aux loss or None)."""
        c = self.cfg
        p = L.cast_layer_params(p, c.activation_dtype)
        x = constrain_act(x, "batch", "seq", "act_embed")
        B = x.shape[0]
        # as in the reference: each recurrent layer starts from a zero state
        # and the recurrence does not mask padding
        if kind == RWKV6:
            state = rwkv6.init_state(B, c.d_model, c.rwkv_head_dim, x.dtype, x.device)
            return self._rwkv_seq(p, x, state)[0], None
        if kind == RGLRU:
            h = L.rmsnorm(p["ln1"], x, c.norm_eps)
            state = rglru.init_state(B, c.rglru_d_rnn, x.dtype, x.device)
            x = x + rglru.rglru_block_seq(p["rec"], h, state)[0]
        else:
            x = self._attn_block(p, x, positions, window, lengths)
        return self._ffn_block(p, x, aux=True)

    def forward(self, params, tokens, *, prefix_embeds=None, lengths=None,
                remat: bool = False,
                return_hidden: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        """Teacher-forced pass → (logits (B, S, V), aux loss: the MoE blocks'
        load-balancing losses summed over layers, fp32 0.0 without MoE); with
        ``return_hidden`` the final-norm hidden states instead of logits.
        With ``prefix_embeds`` S counts the prefix too; with ``remat`` each
        layer is recomputed in the backward."""
        c = self.cfg
        x = self._embed(params, tokens, prefix_embeds)
        B, S = x.shape[:2]
        positions = self._positions(B, S)
        aux = torch.zeros((), device=x.device)
        for i, p in enumerate(self._layer_params(params)):
            body = functools.partial(self._layer_seq, self.kinds[i], self.windows[i],
                                     positions, lengths)
            x, a = checkpoint(body, x, p, use_reentrant=False) if remat else body(x, p)
            if a is not None:
                aux = aux + a
        x = L.rmsnorm(params["final_norm"], x, c.norm_eps)
        return (x if return_hidden else self._logits(params, x)), aux

    # ----------------------------------------------------------------- cache
    def _attn_cache_len(self, kind: str, max_len: int) -> int:
        # As in the reference: a hybrid gives each local layer a ring of the
        # window; a homogeneous stack keeps one length across layers, so
        # mixed local/global stacks pay full length on local layers and apply
        # the window by mask, and only all-local stacks get the ring.
        local = (set(self.kinds) == {ATTN_LOCAL} if self.homogeneous
                 else kind == ATTN_LOCAL)
        if local and self.cfg.local_window:
            return min(self.cfg.local_window, max_len)
        return max_len

    def init_cache(self, batch: int, max_len: int, dtype=None) -> Dict[str, Any]:
        c, dev = self.cfg, self.device
        dtype = dtype or getattr(torch, c.serve_param_dtype)

        def layer_cache(kind, lead):
            if kind == RGLRU:
                return rglru.init_state(batch, c.rglru_d_rnn, dtype, dev, lead)
            if kind == RWKV6:
                return rwkv6.init_state(batch, c.d_model, c.rwkv_head_dim, dtype, dev, lead)
            shape = lead + (batch, self._attn_cache_len(kind, max_len),
                            c.num_kv_heads, c.head_dim)
            return {"k": torch.zeros(shape, dtype=dtype, device=dev),
                    "v": torch.zeros(shape, dtype=dtype, device=dev),
                    "slot_pos": torch.full(shape[:-2], -1, dtype=torch.int32,
                                           device=dev)}

        return {"lengths": torch.zeros((batch,), dtype=torch.int32, device=dev),
                **self._stacked(layer_cache)}

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
            set_prefix(lc["k"], k)
            set_prefix(lc["v"], v)
            valid = positions < lengths[:, None]
            set_prefix(lc["slot_pos"], torch.where(valid, positions, -1))
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
            copy_into(lc["k"], k[b, gidx])
            copy_into(lc["v"], v[b, gidx])
            copy_into(lc["slot_pos"], torch.where(ok, last, -1))
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
        set_rows(lc["k"], b, slot, k_new[:, 0].to(lc["k"].dtype))
        set_rows(lc["v"], b, slot, v_new[:, 0].to(lc["v"].dtype))
        set_rows(lc["slot_pos"], b, slot, q_pos)
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

    # ------------------------------------------------- cached RG-LRU ops
    def _rec_prefill(self, p, x, valid, lc):
        """The recurrent block over the prompt from state ``lc``, which it
        overwrites in place with the state at each sequence's length."""
        h = L.rmsnorm(p["ln1"], x, self.cfg.norm_eps)
        y, new = rglru.rglru_block_seq(p["rec"], h, lc, valid=valid)
        _write(lc, new)
        return x + y

    def _rec_decode(self, p, x, lc):
        """One recurrent step; x: (B, 1, D).  Updates ``lc`` in place."""
        h = L.rmsnorm(p["ln1"], x, self.cfg.norm_eps)
        y, new = rglru.rglru_block_step(p["rec"], h[:, 0], lc)
        _write(lc, new)
        return x + y[:, None]

    # -------------------------------------------------------- RWKV6 ops
    def _rwkv_seq(self, p, x, state, valid=None):
        """Time-mix and channel-mix over a sequence from ``state`` →
        (x, new state); ``state`` is not modified."""
        c = self.cfg
        h = L.rmsnorm(p["ln1"], x, c.norm_eps)
        h, tm = rwkv6.time_mix_seq(p["tm_cm"], h, c.rwkv_head_dim, state["tm"], valid)
        x = x + h
        h = L.rmsnorm(p["ln2"], x, c.norm_eps)
        h, cm = rwkv6.channel_mix_seq(p["tm_cm"], h, state["cm"], valid)
        return x + h, {"tm": tm, "cm": cm}

    def _rwkv_decode(self, p, x, lc):
        """One RWKV6 step; x: (B, 1, D).  Updates ``lc`` in place."""
        c = self.cfg
        h = L.rmsnorm(p["ln1"], x, c.norm_eps)
        h, tm = rwkv6.time_mix_step(p["tm_cm"], h[:, 0], c.rwkv_head_dim, lc["tm"])
        x = x + h[:, None]
        h = L.rmsnorm(p["ln2"], x, c.norm_eps)
        h, cm = rwkv6.channel_mix_step(p["tm_cm"], h[:, 0], lc["cm"])
        _write(lc, {"tm": tm, "cm": cm})
        return x + h[:, None]

    # ---------------------------------------------------------------- prefill
    def prefill(self, params, cache, tokens, lengths,
                prefix_embeds=None) -> Tuple[Dict, torch.Tensor]:
        """Process prompts (right-padded to S) → (cache, last-token logits);
        with ``prefix_embeds`` (B, P, D) in front, ``lengths`` count the
        prefix and the text."""
        lengths = lengths.to(device=self.device, dtype=torch.int32)
        x = self._embed(params, tokens, prefix_embeds)
        B, S = x.shape[:2]
        positions = self._positions(B, S)
        valid = positions < lengths[:, None]
        for i, kind in enumerate(self.kinds):
            p, lc = self._layer(params, i), self._at(cache, i)
            x = constrain_act(x, "batch", "seq", "act_embed")
            if kind == RWKV6:
                x, new = self._rwkv_seq(p, x, lc, valid)
                _write(lc, new)
                continue
            if kind == RGLRU:
                x = self._rec_prefill(p, x, valid, lc)
            else:
                x = self._attn_prefill(p, x, positions, self.windows[i], lengths, lc)
            x = self._ffn_block(p, x)[0]
        cache["lengths"] = lengths.clone()
        x = L.rmsnorm(params["final_norm"], x, self.cfg.norm_eps)
        # Gather the last valid hidden state *before* the vocab product: the
        # reference computes (B, S, V) logits and then gathers, the same
        # numbers at S times the memory (21 GB for gemma2-2b at B=4, S=5120).
        last = take_rows(x, (lengths - 1).clamp(min=0).long())
        return cache, self._logits(params, last)

    # ------------------------------------------------------------ decode step
    def decode_step(self, params, cache, tokens) -> Tuple[Dict, torch.Tensor]:
        """tokens: (B,) next input token per sequence → (cache, logits (B, V))."""
        x = self._embed(params, tokens[:, None])
        q_pos = cache["lengths"]
        for i, kind in enumerate(self.kinds):
            p, lc = self._layer(params, i), self._at(cache, i)
            x = constrain_act(x, "batch", "seq", "act_embed")
            if kind == RWKV6:
                x = self._rwkv_decode(p, x, lc)
                continue
            if kind == RGLRU:
                x = self._rec_decode(p, x, lc)
            else:
                x = self._attn_decode(p, x, q_pos, self.windows[i], lc)
            x = self._ffn_block(p, x)[0]
        cache["lengths"] = q_pos + 1
        x = L.rmsnorm(params["final_norm"], x, self.cfg.norm_eps)
        return cache, self._logits(params, x[:, 0])
