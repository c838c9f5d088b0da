"""recurrentgemma-2b — RG-LRU + local attention hybrid, pattern 1:2
[arXiv:2402.19427; hf].

26L d_model=2560 10H (MQA kv=1) d_ff=7680 vocab=256000, window 2048.
Pattern: (rglru, rglru, local) — two recurrent blocks per local-attention
block (Griffin).  Sub-quadratic: runs the long_500k shape.
"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    d_ff=7680,
    vocab=256000,
    block_pattern=("rglru", "rglru", "local"),
    window=2048,
    d_rnn=2560,
    act="gelu",
    dtype="bfloat16",
)
