"""xlstm-1.3b — sLSTM + mLSTM blocks [arXiv:2405.04517; unverified].

48L d_model=2048 4H d_ff=0 vocab=50304.  xLSTM[7:1]: seven mLSTM blocks
per sLSTM block (48 = 6 super-blocks).  No FFN (d_ff = 0): the xLSTM
blocks carry the capacity.  Sub-quadratic: runs the long_500k shape.
"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab=50304,
    block_pattern=("mlstm",) * 7 + ("slstm",),
    dtype="bfloat16",
)
