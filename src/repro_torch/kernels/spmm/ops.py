"""Wrapper for the ELL SpMM aggregation kernel (``spmm.cu``).

A CPU tensor goes to the plain version (:func:`spmm_ref`); a CUDA tensor
launches the kernel or raises.  ``block_v`` / ``block_f`` keep the
reference wrapper's signature: they are schedule knobs, and the kernel
picks its own CTA shape (every output element is reduced over the ELL
slots in order, so the result does not depend on it).
"""
import ctypes
from pathlib import Path

import numpy as np
import torch

from ..common import DTYPE_CODES, CudaLibrary, check_operands
from .ref import spmm_ref

_P, _I = ctypes.c_void_p, ctypes.c_int
LIBRARY = CudaLibrary(
    Path(__file__).with_name("spmm.cu"),
    {"spmm_ell_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P]},
)


def spmm(indices, weights, x, block_v=128, block_f=128):
    """out[v] = sum_d weights[v, d] * x[indices[v, d]]  — (V_pad, F)."""
    check_operands("spmm", indices, weights, x)
    if x.device.type == "cpu":
        return spmm_ref(indices, weights, x)
    if x.device.type != "cuda":
        raise ValueError(f"spmm: no kernel for device {x.device}")
    v_pad, d = indices.shape
    v, f = x.shape
    out = torch.empty((v_pad, f), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    lib = LIBRARY.load()
    with torch.cuda.device(x.device):
        code = lib.spmm_ell_launch(
            indices.data_ptr(), weights.data_ptr(), x.data_ptr(),
            out.data_ptr(), v_pad, d, v, f, DTYPE_CODES[x.dtype],
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    LIBRARY.check(code, "spmm_ell launch")
    spmm.launches += 1
    return out


#: kernel launches since the last reset (a plain count, set to 0 by callers).
spmm.launches = 0


def spmm_streamed(indices, weights, x, *, block_rows=4096,
                  block_v=128, block_f=128):
    """Row-streamed SpMM for feature tables too large to stage at once.

    Splits the ELL rows into ``block_rows`` slabs; each slab gathers only
    the feature rows it references (the halo gather) and runs :func:`spmm`
    on the compact table, so the per-call working set is bounded by the
    slab's closure instead of the full V x F matrix.  Rows are independent
    and the kernel reduces each row in a fixed order, so the concatenated
    result is bit-identical to ``spmm(indices, weights, x)``.
    """
    v_pad = indices.shape[0]
    if v_pad <= block_rows:
        return spmm(indices, weights, x, block_v=block_v, block_f=block_f)
    idx_h = indices.cpu().numpy()
    outs = []
    for s in range(0, v_pad, block_rows):
        blk = idx_h[s:s + block_rows]
        uniq, inv = np.unique(blk, return_inverse=True)
        outs.append(spmm(
            torch.as_tensor(
                inv.reshape(blk.shape).astype(np.int32), device=indices.device
            ),
            weights[s:s + block_rows],
            x.index_select(0, torch.as_tensor(uniq, device=x.device)),
            block_v=block_v,
            block_f=block_f,
        ))
    return torch.cat(outs, dim=0)
