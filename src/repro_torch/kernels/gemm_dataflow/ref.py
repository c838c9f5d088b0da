"""Plain PyTorch version of the dataflow GEMM (the kernel's oracle)."""
from ..common import row_matmul


def gemm_ref(x, w):
    """x (V, F) @ w (F, G) in float32, cast back to x's dtype.  Like the
    kernel's float32 route, each row's result does not depend on how many
    rows the call has (:func:`~repro_torch.kernels.common.row_matmul`)."""
    return row_matmul(x.float(), w.float()).to(x.dtype)
