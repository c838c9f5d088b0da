from .ops import DATAFLOWS, Plan, gemm, plan, tma_ok
from .ref import gemm_ref
