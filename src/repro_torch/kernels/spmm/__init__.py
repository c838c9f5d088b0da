from .ops import spmm, spmm_streamed
from .ref import spmm_ref
