"""Assigned input shapes (`repro/configs/shapes.py`).

``train_*`` shapes are a training step's; ``prefill_*`` a serving
prefill's; ``decode_*`` / ``long_*`` one new token against a KV/SSM cache
of ``seq_len``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: Dict[str, InputShape] = {
    s.name: s
    for s in [
        InputShape("train_4k", 4_096, 256, "train"),
        InputShape("prefill_32k", 32_768, 32, "prefill"),
        InputShape("decode_32k", 32_768, 128, "decode"),
        InputShape("long_500k", 524_288, 1, "decode"),
    ]
}


def get_shape(name: str) -> InputShape:
    if name not in SHAPES:
        raise KeyError(f"unknown shape {name!r}; have {sorted(SHAPES)}")
    return SHAPES[name]
