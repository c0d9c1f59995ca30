"""Turn the reference's parameter tree into the port's parameters.

The input is the pytree of ``repro.models.transformer.DecoderLM.init`` or
``repro.models.encdec.EncDecLM.init`` with every leaf already turned into a
numpy array (``np.asarray`` on the JAX side), so this module needs no JAX.
The port keeps the reference's layouts — the stacked leading ``layers``
axis, or a hybrid's stacked ``periods`` and unstacked ``tail``, an
encoder-decoder's stacked ``enc_layers`` and ``dec_layers`` (with ``xattn``),
``wq``/``wk``/``wv`` as (D, heads, hd) and ``wo`` as (H, hd, D), an MoE
block's ``router`` (D, E) and experts ``wi``/``wg`` (E, D, F) and ``wo``
(E, F, D) — so conversion checks every key and shape against the model's
``param_shapes`` and copies the values; a tree with another expert count,
or a decoder layer without cross-attention, is refused.
"""
from __future__ import annotations

from typing import Any, Dict, Union

import numpy as np
import torch

from repro_torch.models.encdec import EncDecLM
from repro_torch.models.layers import F32_LEAVES
from repro_torch.models.transformer import DecoderLM


def _tensor(arr: np.ndarray, dtype, device) -> torch.Tensor:
    if arr.dtype.name == "bfloat16":      # ml_dtypes' bfloat16: same bits
        t = torch.from_numpy(np.array(arr).view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))
    return t.to(device=device, dtype=dtype)


def params_from_reference(tree: Dict[str, Any],
                          model: Union[DecoderLM, EncDecLM]) -> Dict[str, Any]:
    """numpy pytree of the reference model → the port's parameter dict, in
    the model's parameter dtype on its device; ``F32_LEAVES`` stay fp32, as
    the reference keeps them."""
    def conv(node, shape, path):
        if isinstance(shape, dict):
            if not isinstance(node, dict) or set(node) != set(shape):
                got = sorted(node) if isinstance(node, dict) else type(node).__name__
                raise ValueError(f"{'/'.join(path) or 'params'}: keys {got}, "
                                 f"want {sorted(shape)}")
            return {k: conv(node[k], shape[k], path + (k,)) for k in shape}
        arr = np.asarray(node)
        if arr.shape != tuple(shape):
            raise ValueError(f"{'/'.join(path)}: shape {arr.shape}, want {shape}")
        dtype = torch.float32 if path[-1] in F32_LEAVES else model.pdt
        return _tensor(arr, dtype, model.device)
    return conv(tree, model.param_shapes(), ())
