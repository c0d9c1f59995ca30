"""RG-LRU recurrent block (RecurrentGemma / Griffin), ported from
``repro.models.rglru``.

Block = [x-branch: linear → causal depthwise conv(4) → RG-LRU] ⊙ gelu(y-branch),
then output projection.  The RG-LRU is a gated diagonal linear recurrence

    r_t = σ(W_a h_x + b_a)          (recurrence gate)
    i_t = σ(W_x h_x + b_x)          (input gate)
    a_t = exp(c · r_t · log σ(Λ))   (per-channel data-dependent decay, c = 8)
    s_t = a_t ⊙ s_{t-1} + sqrt(1 − a_t²) ⊙ (i_t ⊙ h_x)

Sequence mode runs the recurrence through ``ops.rglru_scan`` (the K3 kernel
on the card) from the carried state, where the reference folds the state
into the first step and runs an associative scan: the same function.
Decode is the one-step recurrence in plain PyTorch, as in the reference.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.dist.sharding import pointwise
from repro_torch.kernels import ops
from repro_torch.models.layers import dense_init

C_CONST = 8.0
CONV_WIDTH = 4


def rglru_shapes(d: int, r: int) -> Dict[str, Tuple[int, ...]]:
    """One block's parameter shapes, in the reference's layout."""
    return {"w_x_in": (d, r), "w_y_in": (d, r), "conv": (CONV_WIDTH, r),
            "w_a": (r, r), "w_i": (r, r), "b_a": (r,), "b_i": (r,),
            "lam": (r,), "w_out": (r, d)}


def rglru_axes() -> Dict:
    """Logical sharding axes of one block's parameters, as the reference's."""
    return {
        "w_x_in": ("embed", "rnn"), "w_y_in": ("embed", "rnn"),
        "conv": (None, "rnn"),
        "w_a": ("rnn", "rnn_in"), "w_i": ("rnn", "rnn_in"),
        "b_a": ("rnn",), "b_i": ("rnn",), "lam": ("rnn",),
        "w_out": ("rnn", "embed"),
    }


def rglru_init(gen: torch.Generator, d: int, r: int, dtype, device,
               lead: Tuple[int, ...] = ()) -> Dict[str, torch.Tensor]:
    """Random block parameters with the reference's distributions (not its
    numbers), each with leading axes ``lead`` (a stack of layers).  Λ is
    drawn so that σ(Λ) ∈ (0.9, 0.999) — the Griffin init — and stays fp32."""
    fan_in = {"w_x_in": d, "w_y_in": d, "conv": CONV_WIDTH, "w_a": r,
              "w_i": r, "w_out": r}
    out = {}
    for name, shape in rglru_shapes(d, r).items():
        shape = lead + shape
        if name == "lam":
            u = 0.9 + 0.099 * torch.rand(shape, generator=gen, device=device)
            out[name] = torch.log(u / (1 - u))
        elif name in ("b_a", "b_i"):
            out[name] = torch.zeros(shape, dtype=dtype, device=device)
        else:
            out[name] = dense_init(gen, shape, fan_in[name], dtype, device)
    return out


def _gates(p: Dict, hx: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-step decay a_t and input branch, both fp32.  hx: (..., R).  The
    weights arrive rounded to the activation dtype and are upcast here, as
    the reference's cast-then-upcast does."""
    h32 = hx.float()
    r_gate = torch.sigmoid(h32 @ p["w_a"].float() + p["b_a"].float())
    i_gate = torch.sigmoid(h32 @ p["w_i"].float() + p["b_i"].float())
    log_a = C_CONST * r_gate * pointwise(F.logsigmoid, p["lam"].float())
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    return a, beta * (i_gate * h32)


def _conv(w: torch.Tensor, full: torch.Tensor, S: int) -> torch.Tensor:
    """Depthwise causal conv over ``full`` (B, S + 3, R) → (B, S, R)."""
    out = full[:, 0:S] * w[0]
    for i in range(1, CONV_WIDTH):
        out = out + full[:, i:i + S] * w[i]
    return out


def rglru_block_seq(p: Dict, x: torch.Tensor, state: Dict,
                    valid: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, Dict]:
    """Full Griffin recurrent block over a sequence.

    x: (B, S, D); state = {"s": (B, R) fp32, "conv": (B, 3, R)}.  ``valid``
    (B, S) masks right-padding: masked steps leave the recurrent and conv
    states untouched so a later decode resumes exactly.  Returns (out, new
    state); ``state`` is not modified.
    """
    S = x.shape[1]
    hx = x @ p["w_x_in"]
    hy = x @ p["w_y_in"]
    if valid is not None:
        hx = hx * valid[..., None].to(hx.dtype)
    full = torch.cat([state["conv"].to(hx.dtype), hx], dim=1)
    a, b = _gates(p, _conv(p["conv"], full, S))
    if valid is None:
        conv_state = full[:, -(CONV_WIDTH - 1):]
    else:
        # conv state = inputs at positions len-3..len-1 → full[:, len:len+3]
        lens = valid.sum(dim=1)
        idx = lens[:, None] + torch.arange(CONV_WIDTH - 1, device=x.device)
        conv_state = torch.gather(full, 1, idx[..., None].expand(-1, -1, full.shape[2]))
        a = torch.where(valid[..., None], a, 1.0)   # pad steps: s ← 1·s + 0
        b = b * valid[..., None].float()
    s_seq, s_last = ops.rglru_scan(a, b, state["s"])
    y = s_seq.to(hx.dtype) * F.gelu(hy, approximate="tanh")
    return y @ p["w_out"], {"s": s_last, "conv": conv_state.to(state["conv"].dtype)}


def rglru_block_step(p: Dict, x: torch.Tensor, state: Dict) -> Tuple[torch.Tensor, Dict]:
    """One-token decode step.  x: (B, D) → (out (B, D), new state)."""
    hx = x @ p["w_x_in"]
    hy = x @ p["w_y_in"]
    conv_in = torch.cat([state["conv"].to(x.dtype), hx[:, None]], dim=1)
    a, b = _gates(p, _conv(p["conv"], conv_in, 1)[:, 0])
    s1 = a * state["s"] + b
    y = s1.to(x.dtype) * F.gelu(hy, approximate="tanh")
    return y @ p["w_out"], {"s": s1, "conv": conv_in[:, 1:].to(state["conv"].dtype)}


def init_state(batch: int, r: int, dtype, device,
               lead: Tuple[int, ...] = ()) -> Dict[str, torch.Tensor]:
    """Zero recurrent state {"s": fp32 (B, R), "conv": (B, 3, R)}, with
    leading axes ``lead`` (a stack of layers)."""
    return {"s": torch.zeros(lead + (batch, r), dtype=torch.float32, device=device),
            "conv": torch.zeros(lead + (batch, CONV_WIDTH - 1, r), dtype=dtype,
                                device=device)}
