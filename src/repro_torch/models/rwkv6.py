"""RWKV6 ("Finch") block: time-mix with data-dependent decay + channel-mix,
ported from ``repro.models.rwkv6``.

The WKV recurrence per head (state S ∈ R^{N×N}, N = head dim):

    S_t = diag(w_t) · S_{t-1} + k_t v_tᵀ
    o_t = r_tᵀ (diag(u) k_t v_tᵀ + S_{t-1})

with per-channel data-dependent decay  w_t = exp(−exp(w0 + tanh(x Wa) Wb)).
Sequence mode runs the recurrence through ``ops.wkv6`` (the K4 kernel on
the card) from the carried state; the reference's jnp path computes the same
function with its chunked algorithm (``wkv_chunked``), which this port does
not copy.  Decode is the one-step recurrence in plain PyTorch
(``wkv_step``), as in the reference.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.dist.sharding import local_call, take_rows
from repro_torch.kernels import ops
from repro_torch.models.layers import dense_init

DECAY_LORA = 64
GROUP_NORM_EPS = 1e-5
MIX = ("mu_r", "mu_k", "mu_v", "mu_g", "mu_w", "mu_cr", "mu_ck")


def rwkv_shapes(d: int, d_ff: int, head_dim: int) -> Dict[str, Tuple[int, ...]]:
    """One layer's time-mix and channel-mix parameter shapes, in the
    reference's layout (``tm_cm``)."""
    shapes = {name: (d,) for name in MIX}
    shapes.update({name: (d, d) for name in ("w_r", "w_k", "w_v", "w_g", "w_o", "w_cr")})
    shapes.update({"decay_w0": (d,), "decay_a": (d, DECAY_LORA),
                   "decay_b": (DECAY_LORA, d), "bonus_u": (d // head_dim, head_dim),
                   "ln_out": (d,), "w_ck": (d, d_ff), "w_cv": (d_ff, d)})
    return shapes


def rwkv_axes() -> Dict:
    """Logical sharding axes of one layer's parameters, as the reference's."""
    e, f = "embed", "ffn"
    return {
        "mu_r": (e,), "mu_k": (e,), "mu_v": (e,), "mu_g": (e,), "mu_w": (e,),
        "w_r": (e, "embed_out"), "w_k": (e, "embed_out"), "w_v": (e, "embed_out"),
        "w_g": (e, "embed_out"), "w_o": ("embed_out", e),
        "decay_w0": (e,), "decay_a": (e, None), "decay_b": (None, e),
        "bonus_u": ("heads", None), "ln_out": (e,),
        "mu_cr": (e,), "mu_ck": (e,),
        "w_cr": (e, "embed_out"), "w_ck": (e, f), "w_cv": (f, e),
    }


def rwkv_init(gen: torch.Generator, d: int, d_ff: int, head_dim: int, dtype, device,
              lead: Tuple[int, ...] = ()) -> Dict[str, torch.Tensor]:
    """Random layer parameters with the reference's distributions (not its
    numbers), each with leading axes ``lead`` (a stack of layers): token-mix
    coefficients uniform on [0, 1), projections N(0, 1/fan_in), the decay
    LoRA's second factor N(0, 0.01²), ``decay_w0`` −1 and ``bonus_u``
    N(0, 0.1²), both fp32."""
    out = {}
    for name, shape in rwkv_shapes(d, d_ff, head_dim).items():
        shape = lead + shape
        if name in MIX:
            out[name] = torch.rand(shape, generator=gen, device=device).to(dtype)
        elif name == "decay_w0":
            out[name] = torch.full(shape, -1.0, dtype=torch.float32, device=device)
        elif name == "decay_b":
            out[name] = (0.01 * torch.randn(shape, generator=gen, device=device)).to(dtype)
        elif name == "bonus_u":
            out[name] = 0.1 * torch.randn(shape, generator=gen, device=device)
        elif name == "ln_out":
            out[name] = torch.ones(shape, dtype=dtype, device=device)
        else:
            out[name] = dense_init(gen, shape, shape[-2], dtype, device)
    return out


def init_state(batch: int, d: int, head_dim: int, dtype, device,
               lead: Tuple[int, ...] = ()) -> Dict:
    """Zero layer state {"tm": {"shift": (B, D), "wkv": (B, H, N, N) fp32},
    "cm": (B, D)}, with leading axes ``lead`` (a stack of layers)."""
    H = d // head_dim
    return {"tm": {"shift": torch.zeros(lead + (batch, d), dtype=dtype, device=device),
                   "wkv": torch.zeros(lead + (batch, H, head_dim, head_dim),
                                      dtype=torch.float32, device=device)},
            "cm": torch.zeros(lead + (batch, d), dtype=dtype, device=device)}


def wkv_step(r, k, v, logw, u, state0) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decode step.  r/k/v/logw: (B, H, N); state0: (B, H, N, N) fp32.
    On DTensors it runs on the local blocks, batch and heads as sharded."""
    if isinstance(r, DTensor):
        mesh = r.device_mesh
        pl = tuple(p if isinstance(p, Shard) and p.dim < 2 else Replicate()
                   for p in r.placements)
        u_pl = tuple(Shard(0) if p == Shard(1) else Replicate() for p in pl)
        return local_call(wkv_step, mesh, (r, k, v, logw, u, state0),
                          (pl,) * 4 + (u_pl, pl), (pl, pl))
    rr, kk, vv = r.float(), k.float(), v.float()
    o = (torch.einsum("bhd,bhde->bhe", rr, state0)
         + (rr * u.float() * kk).sum(-1, keepdim=True) * vv)
    new_state = (torch.exp(logw.float())[..., None] * state0
                 + kk[..., :, None] * vv[..., None, :])
    return o.to(r.dtype), new_state


def _group_norm(x: torch.Tensor, scale: torch.Tensor, H: int) -> torch.Tensor:
    """Per-head LayerNorm on the WKV output, in fp32.  x: (..., D)."""
    shp = x.shape
    xh = x.reshape(*shp[:-1], H, shp[-1] // H).float()
    mean = xh.mean(-1, keepdim=True)
    var = xh.var(-1, keepdim=True, correction=0)
    xh = (xh - mean) * torch.rsqrt(var + GROUP_NORM_EPS)
    return (xh.reshape(shp) * scale.float()).to(x.dtype)


def _shift(x: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """Token shift: x_{t-1}, with ``prev`` (B, D) feeding position 0."""
    return torch.cat([prev.to(x.dtype)[:, None], x[:, :-1]], dim=1)


def _last_valid(x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """x at each row's last valid position (position 0 for an empty row)."""
    lens = valid.sum(dim=1)
    return take_rows(x, (lens - 1).clamp(min=0))


def _log_decay(p: Dict, xw: torch.Tensor) -> torch.Tensor:
    """logw = −exp(w0 + tanh(x Wa) Wb), in fp32 from an fp32 upcast of the
    LoRA weights (as the reference)."""
    lora = torch.tanh(xw.float() @ p["decay_a"].float()) @ p["decay_b"].float()
    return -torch.exp(p["decay_w0"] + lora)


def time_mix_seq(p: Dict, x: torch.Tensor, head_dim: int, state: Dict,
                 valid: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, Dict]:
    """x: (B, S, D); state = {"shift": (B, D), "wkv": (B, H, N, N) fp32}.

    ``valid`` (B, S) masks right padding: pad steps leave the WKV state and
    shift untouched (k → 0, logw → 0, shift gathered at the last valid
    position).  Returns (out, new state); ``state`` is not modified.
    """
    B, S, D = x.shape
    H = D // head_dim
    xp = _shift(x, state["shift"])

    def mix(mu):
        return x + (xp - x) * mu

    r = mix(p["mu_r"]) @ p["w_r"]
    k = mix(p["mu_k"]) @ p["w_k"]
    v = mix(p["mu_v"]) @ p["w_v"]
    g = mix(p["mu_g"]) @ p["w_g"]
    logw = _log_decay(p, mix(p["mu_w"]))
    if valid is not None:
        vm = valid[..., None]
        k = k * vm.to(k.dtype)
        logw = logw * vm.to(logw.dtype)
    heads = (B, S, H, head_dim)
    out, wkv = ops.wkv6(r.reshape(heads), k.reshape(heads), v.reshape(heads),
                        logw.reshape(heads), p["bonus_u"], state["wkv"])
    out = _group_norm(out.reshape(B, S, D), p["ln_out"], H) * F.silu(g)
    shift = x[:, -1] if valid is None else _last_valid(x, valid)
    return out @ p["w_o"], {"shift": shift, "wkv": wkv}


def time_mix_step(p: Dict, x: torch.Tensor, head_dim: int,
                  state: Dict) -> Tuple[torch.Tensor, Dict]:
    """One decode token.  x: (B, D)."""
    B, D = x.shape
    H = D // head_dim
    xp = state["shift"].to(x.dtype)

    def mix(mu):
        return x + (xp - x) * mu

    r = mix(p["mu_r"]) @ p["w_r"]
    k = mix(p["mu_k"]) @ p["w_k"]
    v = mix(p["mu_v"]) @ p["w_v"]
    g = mix(p["mu_g"]) @ p["w_g"]
    logw = _log_decay(p, mix(p["mu_w"]))
    heads = (B, H, head_dim)
    out, wkv = wkv_step(r.reshape(heads), k.reshape(heads), v.reshape(heads),
                        logw.reshape(heads), p["bonus_u"], state["wkv"])
    out = _group_norm(out.reshape(B, D), p["ln_out"], H) * F.silu(g)
    return out @ p["w_o"], {"shift": x, "wkv": wkv}


def channel_mix_seq(p: Dict, x: torch.Tensor, state: torch.Tensor,
                    valid: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D); state: the shift (B, D) → (out, new shift)."""
    xp = _shift(x, state)
    xr = x + (xp - x) * p["mu_cr"]
    xk = x + (xp - x) * p["mu_ck"]
    rr = torch.sigmoid(xr @ p["w_cr"])
    kk = torch.square(torch.relu(xk @ p["w_ck"]))
    shift = x[:, -1] if valid is None else _last_valid(x, valid)
    return rr * (kk @ p["w_cv"]), shift


def channel_mix_step(p: Dict, x: torch.Tensor,
                     state: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decode token.  x: (B, D); state: the shift (B, D)."""
    xp = state.to(x.dtype)
    xr = x + (xp - x) * p["mu_cr"]
    xk = x + (xp - x) * p["mu_ck"]
    rr = torch.sigmoid(xr @ p["w_cr"])
    kk = torch.square(torch.relu(xk @ p["w_ck"]))
    return rr * (kk @ p["w_cv"]), x
