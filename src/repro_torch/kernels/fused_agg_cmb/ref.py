"""Plain PyTorch version of the fused SP-Optimized aggregation+combination
(the kernel's oracle)."""
import torch

from ..common import row_matmul


def fused_ref(indices, weights, x, w):
    v_pad, d = indices.shape
    gathered = x.index_select(0, indices.reshape(-1)).reshape(v_pad, d, x.shape[1])
    h = torch.einsum("vd,vdf->vf", weights.float(), gathered.float())
    return row_matmul(h, w.float()).to(x.dtype)
