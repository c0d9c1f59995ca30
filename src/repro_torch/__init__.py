"""PyTorch/CUDA port of ``repro`` for one NVIDIA H100.

The JAX package ``repro`` is the reference; this package keeps its module
names and layout and imports nothing of it.  Every entry point runs on
``cuda`` unless the caller passes ``device="cpu"``.
"""
import contextlib
import threading

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for another.  Raises when a card is wanted and none is present — the
    port never falls back to the CPU on its own."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    return dev


_ieee_lock = threading.Lock()
_ieee_depth = 0
_ieee_saved = None


@contextlib.contextmanager
def ieee_fp32():
    """fp32 products in full IEEE fp32 (no TF32) inside the block.  The
    flags are process-wide, so blocks may overlap across threads (measured
    jobs on concurrent followers): the first to enter saves the caller's
    settings and the last to leave restores them."""
    global _ieee_depth, _ieee_saved
    with _ieee_lock:
        if _ieee_depth == 0:
            _ieee_saved = (torch.get_float32_matmul_precision(),
                           torch.backends.cudnn.allow_tf32)
            torch.set_float32_matmul_precision("highest")
            torch.backends.cudnn.allow_tf32 = False
        _ieee_depth += 1
    try:
        yield
    finally:
        with _ieee_lock:
            _ieee_depth -= 1
            if _ieee_depth == 0:
                torch.set_float32_matmul_precision(_ieee_saved[0])
                torch.backends.cudnn.allow_tf32 = _ieee_saved[1]
