"""Hopper-kernel calibration backend (measure → model, hardware edition),
ported from ``repro.calibrate.kernel_bench``.

The backend clocks the port's hand-written CUDA kernels
(``repro_torch.kernels``) over a (batch × seq × dtype) grid and feeds the
results into the same fit → profile pipeline, so a latency model is
anchored to the code the serving engine runs on the card.

Per grid point one ``kind="calibration"`` record is emitted carrying
``backend="hopper-kernel"`` provenance plus the kernel name and dtype.
Each (kernel, dtype) is first run once at the smallest grid shape through
``repro_torch.kernels.ops`` and checked against its plain reference
(``repro_torch.kernels.ref``), so every record is backed by a verified
kernel; one that fails to build, launch or agree raises.  What is clocked
follows ``target``: ``"reference"`` clocks the references on either device,
``"kernel"`` the kernels on the card only (on the CPU it raises), and
``"auto"``, the default, follows the device:

  * **card** (the default) — the kernels (mode ``"kernel"``).
  * **CPU** (only with ``device="cpu"``) — the references (mode
    ``"reference"``); ``ops`` runs the kernels' plain versions there, which
    is what the verification compares.

Inputs come from numpy's ``default_rng(seed)`` and are placed on the device,
so the CPU and the card see the same values.  Per-kernel coefficients are
fit with the least-squares designs of :func:`repro_torch.calibrate.fit.fit_phase`:
sequence kernels (flash attention, wkv6, rglru, int8 matmul) use the prefill
design ``t = c0 + c1·(b·s) + c2·(b·s²)``; decode attention uses the decode
design ``t = c0 + α·b + β·(b·T)``.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import ieee_fp32, resolve_device
from repro_torch.calibrate.fit import fit_phase
from repro_torch.calibrate.profile import CalibrationProfile

BACKEND = "hopper-kernel"

#: allclose tolerance per dtype for the kernel-vs-reference check, scaled by
#: the output's magnitude (the reference's, from tests/test_kernels.py)
VERIFY_TOL = {"float32": 2e-5, "bfloat16": 2e-2, "int8": 2e-5}

DEFAULT_BATCHES = (1, 2, 4)
DEFAULT_SEQS = (64, 128, 256)
DEFAULT_DTYPES = ("float32", "bfloat16")

TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class KernelCase:
    """One benchable kernel: how to build inputs and which fit design its
    latencies follow.

    Attributes:
        name: registry key ("flash_attention", ...).
        phase: fit design — "prefill" (cost grows with b·s and b·s²)
            or "decode" (cost grows with b and b·context).
        dtypes: dtypes this kernel sweeps (int8 matmul is int8-only).
        make: ``make(batch, seq, dtype, seed, device)`` → (args, kwargs)
            for both the kernel and its reference.
        kernel_fn: the ``repro_torch.kernels.ops`` entry point.
        ref_fn: the plain reference it must match.
    """
    name: str
    phase: str
    dtypes: Sequence[str]
    make: Callable[[int, int, str, int, torch.device], tuple]
    kernel_fn: Callable
    ref_fn: Callable


def _normal(rng, shape, dtype: str, device, scale: float = 1.0) -> torch.Tensor:
    x = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32) * scale)
    return x.to(dtype=TORCH_DTYPES[dtype]).to(device)


def _make_flash(batch: int, seq: int, dtype: str, seed: int, device):
    heads, kv_heads, d = 4, 2, 64
    rng = np.random.default_rng(seed)
    q = _normal(rng, (batch, heads, seq, d), dtype, device)
    k = _normal(rng, (batch, kv_heads, seq, d), dtype, device)
    v = _normal(rng, (batch, kv_heads, seq, d), dtype, device)
    return (q, k, v), {"causal": True}


def _make_decode(batch: int, context: int, dtype: str, seed: int, device):
    heads, kv_heads, d = 8, 2, 64
    rng = np.random.default_rng(seed)
    q = _normal(rng, (batch, heads, d), dtype, device)
    k = _normal(rng, (batch, kv_heads, context, d), dtype, device)
    v = _normal(rng, (batch, kv_heads, context, d), dtype, device)
    lengths = torch.full((batch,), context, dtype=torch.int32, device=device)
    return (q, k, v, lengths), {}


def _make_wkv6(batch: int, seq: int, dtype: str, seed: int, device):
    """The reference draws logw and u in the swept dtype and its kernel
    widens them to fp32; here they are drawn the same way and handed over as
    fp32, the same values."""
    heads, n = 2, 32
    rng = np.random.default_rng(seed)
    r = _normal(rng, (batch, seq, heads, n), dtype, device)
    k = _normal(rng, (batch, seq, heads, n), dtype, device)
    v = _normal(rng, (batch, seq, heads, n), dtype, device)
    logw = (-torch.nn.functional.softplus(_normal(rng, (batch, seq, heads, n), "float32",
                                                  "cpu"))
            ).to(TORCH_DTYPES[dtype]).float().to(device)
    u = _normal(rng, (heads, n), dtype, "cpu").float().to(device)
    s0 = _normal(rng, (batch, heads, n, n), "float32", device)
    return (r, k, v, logw, u, s0), {}


def _make_rglru(batch: int, seq: int, dtype: str, seed: int, device):
    width = 256
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(0.2 + 0.7 * rng.random((batch, seq, width), dtype=np.float32))
    a = a.to(dtype=TORCH_DTYPES[dtype]).to(device)
    b = _normal(rng, (batch, seq, width), dtype, device)
    s0 = _normal(rng, (batch, width), "float32", device)
    return (a, b, s0), {}


def _make_int8_matmul(batch: int, seq: int, dtype: str, seed: int, device):
    """Quantized on the CPU, then placed on the device."""
    from repro_torch.kernels.ops import quantize_rowwise
    d_in, d_out = 512, 512
    m = batch * seq
    rng = np.random.default_rng(seed)
    x = _normal(rng, (m, d_in), "float32", "cpu")
    w = _normal(rng, (d_in, d_out), "float32", "cpu")
    x_q, sx = quantize_rowwise(x)
    w_q_t, sw = quantize_rowwise(w.T)
    return tuple(t.contiguous().to(device) for t in (x_q, w_q_t.T, sx, sw)), {}


def _registry() -> Dict[str, KernelCase]:
    from repro_torch.kernels import ops, ref
    return {
        "flash_attention": KernelCase(
            "flash_attention", "prefill", DEFAULT_DTYPES, _make_flash,
            ops.flash_attention,
            lambda q, k, v, **kw: ref.mha_reference(
                q, k, v, causal=kw.get("causal", True),
                window=kw.get("window", 0),
                softcap=kw.get("softcap", 0.0))),
        "decode_attention": KernelCase(
            "decode_attention", "decode", DEFAULT_DTYPES, _make_decode,
            ops.decode_attention,
            lambda q, k, v, lengths, **kw: ref.decode_attention_reference(
                q, k, v, lengths)),
        "wkv6": KernelCase(
            "wkv6", "prefill", DEFAULT_DTYPES, _make_wkv6,
            ops.wkv6,
            lambda r, k, v, logw, u, s0, **kw: ref.wkv6_reference(
                r, k, v, logw, u, s0)),
        "rglru_scan": KernelCase(
            "rglru_scan", "prefill", DEFAULT_DTYPES, _make_rglru,
            ops.rglru_scan,
            lambda a, b, s0, **kw: ref.rglru_reference(a, b, s0)),
        "int8_matmul": KernelCase(
            "int8_matmul", "prefill", ("int8",), _make_int8_matmul,
            ops.int8_matmul,
            lambda x_q, w_q, sx, sw, **kw: ref.int8_matmul_reference(
                x_q, w_q, sx, sw)),
    }


@functools.lru_cache(maxsize=1)
def kernel_registry() -> Dict[str, KernelCase]:
    """Name → :class:`KernelCase` for every benchable Hopper kernel."""
    return _registry()


def _first_leaf(out):
    return out[0] if isinstance(out, tuple) else out


def _verify(case: KernelCase, dtype: str, batch: int, seq: int, seed: int,
            device) -> float:
    """Run the real ops entry point vs the reference at one shape; return
    the max abs error (raises if outside tolerance)."""
    args, kwargs = case.make(batch, seq, dtype, seed, device)
    got = _first_leaf(case.kernel_fn(*args, **kwargs)).double()
    with ieee_fp32():
        want = _first_leaf(case.ref_fn(*args, **kwargs)).double()
    err = float((got - want).abs().max())
    # scale by output magnitude: kernels that accumulate over a long
    # contraction (int8 matmul) have proportionally larger abs error
    tol = VERIFY_TOL.get(dtype, 2e-2) * max(1.0, float(want.abs().max()))
    if not err <= tol:
        raise AssertionError(
            f"kernel {case.name!r} ({dtype}) disagrees with its reference "
            f"at batch={batch} seq={seq}: max_err={err:.3e} > tol={tol:g}")
    return err


TARGETS = ("auto", "kernel", "reference")


def resolve_target(device=None, target: str = "auto") -> str:
    """Which implementation the sweep clocks on ``device``: with ``"auto"``
    the kernel ("kernel") on the card and the reference ("reference") on
    the CPU; ``"reference"`` anywhere; ``"kernel"`` on the card only — on
    the CPU it raises, it never falls back."""
    if target not in TARGETS:
        raise ValueError(f"unknown kernel target {target!r} (expected one of {TARGETS})")
    on_card = resolve_device(device).type == "cuda"
    if target == "kernel" and not on_card:
        raise RuntimeError("kernel target 'kernel' needs the card; the CPU has only "
                           "the kernels' plain versions (target 'reference' or 'auto')")
    if target == "auto":
        return "kernel" if on_card else "reference"
    return target


def kernel_records(kernels: Optional[Sequence[str]] = None, *,
                   batches: Sequence[int] = DEFAULT_BATCHES,
                   seqs: Sequence[int] = DEFAULT_SEQS,
                   dtypes: Optional[Sequence[str]] = None,
                   repeats: int = 3, target: str = "auto", seed: int = 0,
                   meta: Optional[Dict[str, Any]] = None,
                   device=None) -> List[Dict[str, Any]]:
    """Wall-clock the kernel grid on ``device`` (the card unless
    ``device="cpu"``; raises without one); one record per point.  ``target``
    picks what is clocked, as in :func:`resolve_target`.

    Records look like the model-sweep calibration records (``phase``,
    ``batch``, ``tokens``, ``result.latency_s``) so the same fitter
    consumes them, plus ``kernel``, ``dtype`` and ``backend="hopper-kernel"``
    provenance, ``result.mode`` ``"kernel-cuda"`` or ``"reference-cpu"``,
    and ``result.max_err_vs_ref`` from the (kernel, dtype)'s verification.
    """
    from repro_torch.serving.latency_model import MeasuredLatency

    dev = resolve_device(device)
    reg = kernel_registry()
    names = list(kernels) if kernels else sorted(reg)
    unknown = [n for n in names if n not in reg]
    if unknown:
        raise KeyError(f"unknown kernels {unknown} (known: {sorted(reg)})")
    mode = resolve_target(dev, target)
    meta = dict(meta or {})
    records: List[Dict[str, Any]] = []
    for name in names:
        case = reg[name]
        sweep_dtypes = tuple(dtypes) if dtypes else tuple(case.dtypes)
        sweep_dtypes = tuple(d for d in sweep_dtypes if d in case.dtypes) \
            or tuple(case.dtypes)
        for dt in sweep_dtypes:
            max_err = _verify(case, dt, min(batches), min(seqs), seed, dev)
            for b in batches:
                for s in seqs:
                    args, kwargs = case.make(b, s, dt, seed, dev)
                    fn = case.kernel_fn if mode == "kernel" else case.ref_fn
                    clock = MeasuredLatency(functools.partial(fn, **kwargs),
                                            warmup=1, iters=max(repeats, 1),
                                            reducer="min")
                    lat = clock.measure(*args)
                    rec = dict(meta, kind="calibration", phase=case.phase,
                               batch=int(b), tokens=int(s),
                               kernel=name, dtype=dt, backend=BACKEND,
                               result={"latency_s": float(lat),
                                       "mode": f"{mode}-{dev.type}",
                                       "max_err_vs_ref": max_err})
                    records.append(rec)
    return records


def fit_kernel_records(records: Iterable[Dict[str, Any]]
                       ) -> Dict[str, Dict[str, Any]]:
    """Per-(kernel, dtype) least-squares fits from kernel records.

    Returns ``{"<kernel>/<dtype>": {coef, n_points, mean_rel_err, ...,
    phase, backend, max_err_vs_ref}}`` — the dict stored under
    ``CalibrationProfile.kernels``.
    """
    groups: Dict[tuple, List[tuple]] = {}
    errs: Dict[tuple, float] = {}
    for rec in records:
        if rec.get("backend") != BACKEND:
            continue
        key = (rec["kernel"], rec.get("dtype", "float32"), rec["phase"])
        res = rec.get("result", {})
        groups.setdefault(key, []).append(
            (float(rec["batch"]), float(rec["tokens"]),
             float(res["latency_s"])))
        if "max_err_vs_ref" in res:
            errs[key] = max(errs.get(key, 0.0),
                            float(res["max_err_vs_ref"]))
    fits: Dict[str, Dict[str, Any]] = {}
    for (kernel, dtype, phase), pts in sorted(groups.items()):
        fit = fit_phase(pts, phase)
        d = fit.to_dict()
        d.update(phase=phase, backend=BACKEND, kernel=kernel, dtype=dtype)
        if (kernel, dtype, phase) in errs:
            d["max_err_vs_ref"] = errs[(kernel, dtype, phase)]
        fits[f"{kernel}/{dtype}"] = d
    return fits


def _measured_int8_compute_scale(repeats: int = 3, seed: int = 0,
                                 device=None) -> float:
    """Measured dequant overhead: the int8 kernel against an fp32 product
    of the same dequantized operands, at the calibration's (2·128, 512) ×
    (512, 512).  Clamped to [1.0, 1.5] so scheduler noise cannot produce an
    absurd scale.  A kernel that fails raises."""
    from repro_torch.kernels import ops
    from repro_torch.serving.latency_model import MeasuredLatency
    dev = resolve_device(device)
    (x_q, w_q, sx, sw), _ = _make_int8_matmul(2, 128, "int8", seed, dev)
    x = x_q.float() * sx[:, None]
    w = w_q.float() * sw[None, :]
    t_i8 = MeasuredLatency(ops.int8_matmul, warmup=1, iters=repeats,
                           reducer="min").measure(x_q, w_q, sx, sw)
    with ieee_fp32():
        t_fp = MeasuredLatency(torch.matmul, warmup=1, iters=repeats,
                               reducer="min").measure(x, w)
    return float(min(max(t_i8 / t_fp, 1.0), 1.5))


def derive_speed_modes(kernel_fits: Optional[Dict[str, Dict[str, Any]]]
                       = None, *, measure_compute_scale: bool = False,
                       repeats: int = 3, device=None) -> Dict[str, Dict[str, Any]]:
    """Speed-mode parameter dicts for ``CalibrationProfile.speed_modes``.

    Byte scales are exact dtype arithmetic (int8 weights + KV are half of
    bf16) and need no measurement; the int8 ``compute_scale`` —
    quant/dequant overhead — optionally comes from clocking the int8 kernel
    against plain float32 on ``device``.  Speculative parameters are
    workload properties, so the conventional defaults ship.
    """
    from repro_torch.serving.latency_model import SPEED_MODES
    modes = {name: mode.to_dict() for name, mode in SPEED_MODES.items()}
    if measure_compute_scale:
        modes["int8"]["compute_scale"] = _measured_int8_compute_scale(
            repeats=repeats, device=device)
    return modes


def attach_kernel_calibration(profile: CalibrationProfile,
                              records: Iterable[Dict[str, Any]], *,
                              measure_compute_scale: bool = False,
                              device=None) -> CalibrationProfile:
    """Return ``profile`` with kernel fits + derived speed modes merged in
    (existing fields untouched)."""
    fits = fit_kernel_records(records)
    modes = derive_speed_modes(
        fits, measure_compute_scale=measure_compute_scale, device=device)
    return dataclasses.replace(profile, kernels=fits or None,
                               speed_modes=modes)
