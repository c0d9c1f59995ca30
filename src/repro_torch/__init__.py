"""PyTorch/CUDA port of ``repro`` for one NVIDIA H100.

The JAX package ``repro`` is the reference; this package keeps its module
names and layout and imports nothing of it.  Every entry point runs on
``cuda`` unless the caller passes ``device="cpu"``.
"""
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
