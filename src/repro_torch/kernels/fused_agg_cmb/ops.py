"""Wrapper for the fused SP-Optimized kernel (``fused_agg_cmb.cu``).

A CPU tensor goes to the plain version (:func:`fused_ref`); a CUDA tensor
launches the kernel or raises.  ``band_size`` (the schedule's T_V) and
``block_f`` (T_F) keep the reference wrapper's signature: the kernel walks
F in its own chunks inside one launch and masks the ragged edge, so
neither shapes the CTA, and rows are independent.
"""
import ctypes
from pathlib import Path

import torch

from ..common import DTYPE_CODES, CudaLibrary, check_operands
from .ref import fused_ref

_P, _I = ctypes.c_void_p, ctypes.c_int
LIBRARY = CudaLibrary(
    Path(__file__).with_name("fused_agg_cmb.cu"),
    {"fused_agg_cmb_launch": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]},
)


def fused_agg_cmb(indices, weights, x, w, band_size=128, block_f=None):
    """out[v] = (sum_d weights[v, d] * x[indices[v, d]]) @ w  — (V_pad, G)."""
    check_operands("fused_agg_cmb", indices, weights, x, w)
    if x.device.type == "cpu":
        return fused_ref(indices, weights, x, w)
    if x.device.type != "cuda":
        raise ValueError(f"fused_agg_cmb: no kernel for device {x.device}")
    v_pad, d = indices.shape
    v, f = x.shape
    g = w.shape[1]
    out = torch.empty((v_pad, g), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    lib = LIBRARY.load()
    with torch.cuda.device(x.device):
        code = lib.fused_agg_cmb_launch(
            indices.data_ptr(), weights.data_ptr(), x.data_ptr(),
            w.data_ptr(), out.data_ptr(), v_pad, d, v, f, g,
            DTYPE_CODES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream,
        )
    LIBRARY.check(code, "fused_agg_cmb launch")
    fused_agg_cmb.launches += 1
    return out


#: kernel launches since the last reset (a plain count, set to 0 by callers).
fused_agg_cmb.launches = 0
