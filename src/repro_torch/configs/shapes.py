"""Assigned input shapes (public pool) for the dry-run matrix."""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class InputShape:
    name: str
    kind: str        # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", "train", 4_096, 256),
    "prefill_32k": InputShape("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": InputShape("decode_32k", "decode", 32_768, 128),
    "long_500k": InputShape("long_500k", "decode", 524_288, 1),
}


def get_shape(name: str) -> InputShape:
    return SHAPES[name]
