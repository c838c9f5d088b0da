"""Plain PyTorch version of the ELL SpMM (the kernel's oracle)."""
import torch


def spmm_ref(indices, weights, x):
    v_pad, d = indices.shape
    gathered = x.index_select(0, indices.reshape(-1)).reshape(v_pad, d, x.shape[1])
    return torch.einsum(
        "vd,vdf->vf", weights.float(), gathered.float()
    ).to(x.dtype)
