"""llava-next-34b — VLM backbone, anyres tiling
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified].

60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000.
Per the assignment, the modality frontend is a STUB: input_specs()
provides precomputed patch embeddings (B, S, d_model); only the
transformer backbone is modeled (see repro_torch.models.stubs).
"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="llava-next-34b",
    family="vlm",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=20480,
    vocab=64000,
    block_pattern=("attn",),
    embedded_inputs=True,  # patch embeddings precomputed by the stub
    dtype="bfloat16",
)
