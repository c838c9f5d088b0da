"""The assigned input-shape suites (one set, shared by all LM archs).

``decode_*`` / ``long_*`` lower ``serve_step`` (one new token against a KV
cache of seq_len), NOT ``train_step``.  ``long_500k`` requires
sub-quadratic attention: it runs only for the SSM/hybrid archs
(recurrentgemma-2b, xlstm-1.3b) and is skipped for pure full-attention
archs (documented in DESIGN.md / EXPERIMENTS.md).
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ShapeSuite:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSuite("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSuite("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSuite("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSuite("long_500k", 524_288, 1, "decode"),
}


def applicable(arch_cfg, shape: ShapeSuite) -> bool:
    """long_500k only for sub-quadratic archs (dense 512k KV decode is a
    memory-capacity non-starter; assignment says skip + document)."""
    if shape.name == "long_500k":
        return arch_cfg.is_subquadratic
    return True
