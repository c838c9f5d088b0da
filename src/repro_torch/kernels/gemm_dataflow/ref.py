"""Plain PyTorch version of the dataflow GEMM (the kernel's oracle)."""
import torch


def gemm_ref(x, w):
    """x (V, F) @ w (F, G) in float32, cast back to x's dtype."""
    return (x.float() @ w.float()).to(x.dtype)
