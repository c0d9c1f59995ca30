"""Assigned input-shape set (applies to every architecture).

A copy of ``repro.configs.shapes``, importing only ``repro_torch``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

TRAIN = "train"
PREFILL = "prefill"
DECODE = "decode"


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                 # train | prefill | decode
    long_context: bool = False


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, TRAIN),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, PREFILL),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, DECODE),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, DECODE, long_context=True),
}


def applicable(shape: ShapeSpec, cfg) -> bool:
    """long_500k only runs for sub-quadratic archs (SSM / hybrid)."""
    if shape.long_context:
        return cfg.sub_quadratic
    return True
