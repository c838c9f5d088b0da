"""granite-moe-3b-a800m — MoE, 40 experts top-8
[hf:ibm-granite/granite-3.0-1b-a400m-base family; hf].

32L d_model=1536 24H (GQA kv=8) d_ff=512/expert vocab=49155.
40 experts do not divide the 16-way model axis; EP pads to 48 virtual
experts (8 idle) — see repro.models.moe; MoE is not in
the port yet.
"""
from ..models.config import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    d_ff=512,
    vocab=49155,
    block_pattern=("moe",),
    moe=MoEConfig(n_experts=40, top_k=8),
    dtype="bfloat16",
)
