"""olmo-1b — dense, non-parametric LayerNorm [arXiv:2402.00838; hf].

16L d_model=2048 16H (GQA kv=16 = MHA) d_ff=8192 vocab=50304.
"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="olmo-1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab=50304,
    block_pattern=("attn",),
    norm="nonparam_ln",  # OLMo's non-parametric LN
    act="silu",
    dtype="bfloat16",
)
