from .ops import fused_agg_cmb
from .ref import fused_ref
