"""The work and traffic of each kernel call, from its shapes.

One formula per kernel, read by two callers: ``chip_smoke.py``'s kernel
table, whose ``bound_ms`` is the larger of ``flops`` over the card's peak
rate for ``peak`` and ``bytes`` over its memory rate, and the cost pass
(``launch/costing.py``), which counts a kernel call on meta tensors by its
formula (``kernels/meta.py``) and never by running its plain version.

``flops`` counts the operations the function needs, ``bytes`` each input
read once and each output written once, ``transcendentals`` the exps (and
softcap tanhs) it evaluates.  Where the work depends on the data (ragged
lengths, a sparse decode mask) the caller passes the live count (``pairs``,
``live``); meta tensors hold no data, so there every position a shape holds
is live.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np


class Cost(NamedTuple):
    flops: float
    bytes: float
    transcendentals: float
    peak: str            # the rate the operations run at: "bf16", "fp32" or "int8"


def _peak(itemsize: int) -> str:
    return "bf16" if itemsize == 2 else "fp32"


def attention_pairs(Sq: int, Skv: int, *, causal: bool = True, window: int = 0,
                    lengths: Optional[Sequence[int]] = None,
                    padded_rows: bool = True) -> int:
    """Live (query, key) pairs over a batch: key j < length (Skv without
    ``lengths``, one sequence), j ≤ i when ``causal``, j > i − window when
    ``window``.  ``padded_rows`` False leaves out the query rows at or past
    a sequence's length, whose output the model discards."""
    i = np.arange(Sq, dtype=np.int64)
    total = 0
    for n in (Skv,) if lengths is None else lengths:
        n = min(int(n), Skv)
        hi = np.minimum(i + 1, n) if causal else np.full_like(i, n)
        lo = np.maximum(i - window + 1, 0) if window else np.zeros_like(i)
        live = np.maximum(hi - lo, 0)
        total += int(live[:n].sum() if not padded_rows else live.sum())
    return total


def flash_attention(B: int, H: int, K: int, Sq: int, Skv: int, d: int, itemsize: int, *,
                    causal: bool = True, window: int = 0, softcap: float = 0.0,
                    pairs: Optional[int] = None) -> Cost:
    """K1: 4·d operations a live pair and head (Q·Kᵀ and P·V); q, k, v read
    and out written once; an exp a live pair and head (a tanh beside it
    under a softcap).  ``pairs`` over the batch, without the heads."""
    if pairs is None:
        pairs = B * attention_pairs(Sq, Skv, causal=causal, window=window)
    return Cost(4.0 * d * H * pairs, itemsize * d * B * (2.0 * H * Sq + 2.0 * K * Skv),
                (2.0 if softcap else 1.0) * H * pairs, _peak(itemsize))


def flash_attention_bwd(B: int, H: int, K: int, Sq: int, Skv: int, d: int, itemsize: int, *,
                        causal: bool = True, window: int = 0, softcap: float = 0.0,
                        pairs: Optional[int] = None) -> Cost:
    """K1′: 5 products of 2·d operations a live pair and head (S, dP, dV,
    dK, dQ); q, dO read and dq written, k, v read and dk, dv written once;
    P's exps formed again."""
    if pairs is None:
        pairs = B * attention_pairs(Sq, Skv, causal=causal, window=window)
    return Cost(5 * 2.0 * d * H * pairs,
                itemsize * d * (3.0 * B * H * Sq + 4.0 * B * K * Skv),
                (2.0 if softcap else 1.0) * H * pairs, _peak(itemsize))


def decode_attention(B: int, H: int, K: int, T: int, d: int, itemsize: int, *,
                     window: int = 0, softcap: float = 0.0,
                     live: Optional[int] = None) -> Cost:
    """K2: 4·d operations a head and live slot; the live K/V rows, q and
    out once; an exp a head and live slot.  ``live`` slots over the batch;
    by default every row holds T positions, of which a window keeps its
    last ``window``."""
    if live is None:
        live = B * (min(T, window) if window else T)
    return Cost(4.0 * d * H * live, itemsize * (2.0 * live * K * d + 2.0 * B * H * d),
                (2.0 if softcap else 1.0) * H * live, _peak(itemsize))


def rglru_scan(B: int, S: int, R: int, itemsize: int) -> Cost:
    """K3: two fp32 operations an element; a and b read and seq written in
    their dtype, s0 read and last written in fp32."""
    return Cost(2.0 * B * S * R, itemsize * 3.0 * B * S * R + 4.0 * 2 * B * R, 0.0, "fp32")


def rglru_scan_bwd(B: int, S: int, R: int, itemsize: int) -> Cost:
    """K3′: five fp32 operations an element (the state, then ds, da and the
    carry); a, b, g read and da, db written once, s0, g_last and ds0 beside."""
    return Cost(5.0 * B * S * R, itemsize * 5.0 * B * S * R + 4.0 * 3 * B * R, 0.0, "fp32")


def wkv6(B: int, S: int, H: int, N: int, itemsize: int) -> Cost:
    """K4: 5N² + 4N fp32 operations a (b, s, h) step; r, k, v read and out
    written in their dtype, logw once in fp32, u once, the state in and
    out; an exp of logw an element."""
    return Cost((5.0 * N * N + 4.0 * N) * B * S * H,
                itemsize * 4.0 * B * S * H * N
                + 4.0 * (B * S * H * N + H * N + 2 * B * H * N * N),
                1.0 * B * S * H * N, "fp32")


def wkv6_bwd(B: int, S: int, H: int, N: int, itemsize: int) -> Cost:
    """K4′: 14N² + 16N fp32 operations a (b, s, h) step at the unpadded N
    (the state recomputed, the gradient carried, dr, dk, dv and dlogw each
    an N × N contraction, the bonus terms); r, k, v, do read and dr, dk,
    dv written in their dtype, logw read and dlogw written in fp32, u and
    du, state0, dS and dstate0 once; the decays' exps formed again."""
    return Cost((14.0 * N * N + 16.0 * N) * B * S * H,
                itemsize * 7.0 * B * S * H * N + 4.0 * 2 * B * S * H * N
                + 4.0 * 2 * H * N + 4.0 * 3 * B * H * N * N,
                1.0 * B * S * H * N, "fp32")


def int8_matmul(M: int, K: int, N: int) -> Cost:
    """K5: 2·M·N·K int8 operations; x and w read once in int8, the scales
    once and out written once in fp32."""
    return Cost(2.0 * M * N * K, M * K + K * N + 4.0 * (M + N + M * N), 0.0, "int8")
