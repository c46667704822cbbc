"""Input-shape presets (port of ``repro/configs/shapes.py``), as data:
the reference's dry-run grid of (seq_len, global_batch, kind) cells.
The dry run itself lowers XLA programs over a 512-device mesh and has
no twin on one card (ROADMAP A14's note); ``launch/steps.input_specs``
gives a cell's input shapes."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

# long_500k needs sub-quadratic sequence mixing: the SSM/hybrid state is
# O(1), mixtral's sliding window needs only a window-sized rolling
# cache; the full-attention archs skip it.
LONG_CONTEXT_ARCHS = ("mamba2-130m", "zamba2-2.7b", "mixtral-8x7b")


def cells_for(arch: str) -> list[str]:
    cells = ["train_4k", "prefill_32k", "decode_32k"]
    if arch in LONG_CONTEXT_ARCHS:
        cells.append("long_500k")
    return cells
