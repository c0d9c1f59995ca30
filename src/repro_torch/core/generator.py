"""Canonical model generator (paper §4.2.2), ported from
``repro.core.generator``.

Builds parameterised micro-models from the paper's four block families —
FC, residual CNN, LSTM, transformer — across swept hyper-parameters (layer
count, width/neurons, batch size), as ``nn.Module``s in fp32 on an explicit
device.  These run for real on the card, so the sensitivity heat maps and
generated-model rooflines use measured numbers.

The modules keep the reference's parameter layout (``in``, ``layers`` stacked
on a leading layer axis, ``out``; conv weights HWIO) and its input layouts
(the CNN takes NHWC and permutes inside).  The reference seeds its weights
with ``hash(spec.name)``, which Python salts per process, so its weights
change from run to run; the port seeds from a stable digest of the name, and
``params_from_jax`` carries the reference's own parameters across.
"""
from __future__ import annotations

import dataclasses
import hashlib
import math
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import resolve_device

FAMILIES = ("fc", "cnn", "lstm", "transformer")

# the stacked per-layer leaves of each family's ``layers`` (None: one array)
LAYER_KEYS = {"fc": None, "cnn": None, "lstm": ("wx", "wh"),
              "transformer": ("wq", "wk", "wv", "wo", "w1", "w2")}


@dataclasses.dataclass(frozen=True)
class GeneratedSpec:
    family: str
    layers: int = 4
    width: int = 256          # neurons / channels / hidden / d_model
    batch: int = 1
    seq: int = 64             # lstm/transformer sequence, cnn spatial 32²
    num_classes: int = 100

    @property
    def name(self) -> str:
        return f"{self.family}-L{self.layers}-W{self.width}"


def seed_of(name: str) -> int:
    """A seed that is the same in every process (unlike ``hash``)."""
    return int.from_bytes(hashlib.sha256(name.encode()).digest()[:8], "little") % (2 ** 31)


def _dense(gen: torch.Generator, i: int, o: int) -> torch.Tensor:
    return torch.randn((i, o), generator=gen) / math.sqrt(i)


def _conv_w(gen: torch.Generator, ci: int, co: int) -> torch.Tensor:
    return torch.randn((3, 3, ci, co), generator=gen) / math.sqrt(9 * ci)


def _channels(spec: GeneratedSpec) -> int:
    return max(spec.width // 16, 8)


def _init_params(spec: GeneratedSpec, gen: torch.Generator) -> Dict[str, torch.Tensor]:
    """fp32 CPU weights under the module's parameter names, with the
    reference's distributions (not its numbers)."""
    W, L = spec.width, spec.layers
    if spec.family == "fc":
        return {"w_in": _dense(gen, W, W),
                "layers": torch.stack([_dense(gen, W, W) for _ in range(L)]),
                "w_out": _dense(gen, W, spec.num_classes)}
    if spec.family == "cnn":
        C = _channels(spec)
        return {"w_in": _conv_w(gen, 3, C),
                "layers": torch.stack([_conv_w(gen, C, C) for _ in range(L)]),
                "w_out": _dense(gen, C, spec.num_classes)}
    if spec.family == "lstm":
        return {"w_in": _dense(gen, W, W),
                "wx": torch.stack([_dense(gen, W, 4 * W) for _ in range(L)]),
                "wh": torch.stack([_dense(gen, W, 4 * W) for _ in range(L)]),
                "w_out": _dense(gen, W, spec.num_classes)}
    if spec.family == "transformer":
        shapes = {"wq": (W, W), "wk": (W, W), "wv": (W, W), "wo": (W, W),
                  "w1": (W, 4 * W), "w2": (4 * W, W)}
        return {"w_in": _dense(gen, W, W),
                **{k: torch.stack([_dense(gen, *shape) for _ in range(L)])
                   for k, shape in shapes.items()},
                "w_out": _dense(gen, W, spec.num_classes)}
    raise ValueError(spec.family)


class GeneratedModel(nn.Module):
    """One generated model; ``forward`` is the family's."""

    def __init__(self, spec: GeneratedSpec, params: Mapping[str, torch.Tensor]):
        super().__init__()
        self.spec = spec
        for name, value in params.items():
            self.register_parameter(name, nn.Parameter(value, requires_grad=False))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return getattr(self, f"_{self.spec.family}")(x)

    def _fc(self, x):
        h = torch.tanh(x @ self.w_in)
        for w in self.layers:
            h = torch.tanh(h @ w)
        return h @ self.w_out

    def _cnn(self, x):
        # NHWC in, as the reference; HWIO weights → OIHW; "SAME" for a
        # 3×3 stride-1 kernel is one pixel of zeros on each side
        h = x.permute(0, 3, 1, 2)
        h = F.relu(F.conv2d(h, self.w_in.permute(3, 2, 0, 1), padding=1))
        for w in self.layers:
            h = F.relu(F.conv2d(h, w.permute(3, 2, 0, 1), padding=1)) + h   # residual
        return h.mean(dim=(2, 3)) @ self.w_out

    def _lstm(self, x):
        # the reference's own cell: one wx and one wh, no bias, gates i, f, g, o
        hs = torch.tanh(x @ self.w_in).transpose(0, 1)       # (S, B, W)
        for wx, wh in zip(self.wx, self.wh):
            xz = hs @ wx
            h = c = hs.new_zeros(hs.shape[1:])
            out = []
            for t in range(hs.shape[0]):
                i, f, g, o = (xz[t] + h @ wh).chunk(4, dim=-1)
                c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
                h = torch.sigmoid(o) * torch.tanh(c)
                out.append(h)
            hs = torch.stack(out)
        return hs[-1] @ self.w_out

    def _transformer(self, x):
        W = self.spec.width
        H = max(W // 64, 1)
        h = x @ self.w_in
        B, S, _ = h.shape
        causal = torch.ones((S, S), dtype=torch.bool, device=h.device).tril()
        for wq, wk, wv, wo, w1, w2 in zip(self.wq, self.wk, self.wv, self.wo,
                                          self.w1, self.w2):
            q = (h @ wq).reshape(B, S, H, W // H)
            k = (h @ wk).reshape(B, S, H, W // H)
            v = (h @ wv).reshape(B, S, H, W // H)
            logits = torch.einsum("bshd,bthd->bhst", q, k) / math.sqrt(W // H)
            a = torch.softmax(logits.masked_fill(~causal, -1e30), dim=-1)
            o = torch.einsum("bhst,bthd->bshd", a, v).reshape(B, S, W)
            h = h + o @ wo
            h = h + F.relu(h @ w1) @ w2
        return h[:, -1] @ self.w_out


def example_inputs(spec: GeneratedSpec, device=None) -> Tuple[torch.Tensor, ...]:
    """The example input batch for a spec, on ``device`` (the card unless
    ``device="cpu"``) — separate from ``build`` so latency sweeps can vary
    (batch, seq) without re-initializing params (which depend only on
    family/layers/width)."""
    dev = resolve_device(device)
    if spec.family == "fc":
        shape: Tuple[int, ...] = (spec.batch, spec.width)
    elif spec.family == "cnn":
        shape = (spec.batch, 32, 32, 3)
    elif spec.family in ("lstm", "transformer"):
        shape = (spec.batch, spec.seq, spec.width)
    else:
        raise ValueError(spec.family)
    return (torch.ones(shape, dtype=torch.float32, device=dev),)


def build(spec: GeneratedSpec, device=None) -> Tuple[GeneratedModel, Tuple[torch.Tensor, ...]]:
    """Returns (model, example_inputs) on ``device`` (the card unless
    ``device="cpu"``).  Weights are drawn on the CPU from ``seed_of(name)``
    and then moved, so every device gets the same values."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed_of(spec.name))
    model = GeneratedModel(spec, _init_params(spec, gen)).to(dev)
    return model, example_inputs(spec, dev)


def params_from_jax(family: str, tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The reference's parameter tree for ``family`` (``in``/``layers``/
    ``out``, leaves as numpy arrays) → a state dict for ``GeneratedModel``."""
    if family not in LAYER_KEYS:
        raise ValueError(family)
    layers, keys = tree["layers"], LAYER_KEYS[family]
    if keys is None:
        flat = {"layers": layers}
    elif isinstance(layers, Mapping) and set(layers) == set(keys):
        flat = dict(layers)
    else:
        raise ValueError(f"{family}: layers must hold {keys}")
    flat.update(w_in=tree["in"], w_out=tree["out"])
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in flat.items()}


def flops_estimate(spec: GeneratedSpec) -> float:
    """Analytic inference FLOPs per example (for roofline intensity)."""
    W, L, S = spec.width, spec.layers, spec.seq
    if spec.family == "fc":
        return 2 * W * W * (L + 1) + 2 * W * spec.num_classes
    if spec.family == "cnn":
        C = _channels(spec)
        return 2 * 9 * C * C * 32 * 32 * L + 2 * 9 * 3 * C * 32 * 32
    if spec.family == "lstm":
        return S * L * 2 * (W * 4 * W * 2)
    if spec.family == "transformer":
        return S * L * (2 * 4 * W * W + 2 * 8 * W * W) + 4 * S * S * W * L
    raise ValueError(spec.family)


def param_bytes(model: nn.Module) -> float:
    return float(sum(p.numel() * p.element_size() for p in model.parameters()))
