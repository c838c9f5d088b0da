from .ops import DATAFLOWS, gemm, tile_sizes
from .ref import gemm_ref
