"""Wrapper for the dataflow-configurable GEMM kernel (``gemm_dataflow.cu``).

``gemm`` keeps the reference op's signature.  The three dataflows are
three loop orders of one tiled product, each keeping its named operand
tile resident in shared memory across the inner loop (see the kernel's
source note).  A CPU tensor goes to the plain version (:func:`gemm_ref`);
a CUDA tensor launches the kernel or raises.

``block_v`` / ``block_g`` / ``block_f`` are the paper's tile sizes T_V,
T_G, T_F.  The kernel uses them as its tiles, clipped by
:func:`tile_sizes`: T_V and T_G to 128 (the CTA's register tile), T_F to
what fits in shared memory beside them.
"""
import ctypes
from pathlib import Path

import torch

from ..common import DTYPE_CODES, CudaLibrary, cdiv
from .ref import gemm_ref

DATAFLOWS = ("output_stationary", "weight_stationary", "input_stationary")

#: the CTA's register tile: 256 threads x (8 x 8) outputs each.
MAX_BLOCK_VG = 128
#: shared memory one CTA may use on Hopper (227 KB).
SMEM_BYTES = 232448

_P, _I = ctypes.c_void_p, ctypes.c_int
LIBRARY = CudaLibrary(
    Path(__file__).with_name("gemm_dataflow.cu"),
    {"gemm_dataflow_launch": [_P, _P, _P, _P] + [_I] * 8 + [_P]},
)


def tile_sizes(v, f, g, block_v=128, block_g=128, block_f=128):
    """The (T_V, T_G, T_F) the kernel runs: the requested tiles, clipped to
    the matrix, to the register tile and to shared memory (f32 tiles of
    x, T_V x (T_F + 1), and of w, T_F x T_G, with T_V and T_G rounded up
    to 16)."""
    bv = max(1, min(block_v, v, MAX_BLOCK_VG))
    bg = max(1, min(block_g, g, MAX_BLOCK_VG))
    bf = max(1, min(block_f, f))
    rv, rg = cdiv(bv, 16) * 16, cdiv(bg, 16) * 16
    while bf > 1 and (rv * (bf + 1) + bf * rg) * 4 > SMEM_BYTES:
        bf -= 1
    return bv, bg, bf


def gemm(x, w, dataflow="output_stationary", block_v=128, block_g=128,
         block_f=128):
    """x (V, F) @ w (F, G) accumulated in float32, returned in x's dtype."""
    if dataflow not in DATAFLOWS:
        raise ValueError(f"dataflow must be one of {DATAFLOWS}")
    if x.dtype not in DTYPE_CODES or w.dtype != x.dtype:
        raise TypeError(f"gemm: x and w must share float32 or bfloat16, got "
                        f"{x.dtype} and {w.dtype}")
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"gemm: shapes {tuple(x.shape)} @ {tuple(w.shape)}")
    if x.device != w.device:
        raise ValueError("gemm: operands on several devices")
    if x.device.type == "cpu":
        return gemm_ref(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"gemm: no kernel for device {x.device}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("gemm: operands must be contiguous")
    (v, f), g = x.shape, w.shape[1]
    out = torch.empty((v, g), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    if f == 0:
        return out.zero_()
    bv, bg, bf = tile_sizes(v, f, g, block_v, block_g, block_f)
    # weight- and input-stationary sum F tiles into an f32 workspace owned
    # by one CTA per element; a float32 output is its own workspace
    ws = out
    if dataflow != "output_stationary" and x.dtype != torch.float32:
        ws = torch.empty((v, g), dtype=torch.float32, device=x.device)
    lib = LIBRARY.load()
    with torch.cuda.device(x.device):
        code = lib.gemm_dataflow_launch(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), ws.data_ptr(),
            v, f, g, bv, bg, bf, DATAFLOWS.index(dataflow),
            DTYPE_CODES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream,
        )
    LIBRARY.check(code, "gemm_dataflow launch")
    gemm.launches += 1
    return out


#: kernel launches since the last reset (a plain count, set to 0 by callers).
gemm.launches = 0
