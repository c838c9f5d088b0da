"""musicgen-large — decoder-only over EnCodec tokens [arXiv:2306.05284; hf].

48L d_model=2048 32H (GQA kv=32 = MHA) d_ff=8192 vocab=2048.
The EnCodec frontend is a STUB: input_specs() provides precomputed frame
embeddings (B, S, d_model); the backbone predicts codebook tokens.
"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-large",
    family="audio",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab=2048,
    block_pattern=("attn",),
    embedded_inputs=True,
    act="gelu",
    dtype="bfloat16",
)
