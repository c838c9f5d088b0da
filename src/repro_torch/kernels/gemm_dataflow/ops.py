"""Wrapper for the dataflow-configurable GEMM kernel (``gemm_dataflow.cu``).

``gemm`` keeps the reference op's signature.  The three dataflows are
three loop orders of one tiled product, each keeping its named operand
resident in shared memory across the temporal loop (see the kernel's
source note).  A CPU tensor goes to the plain version (:func:`gemm_ref`);
a CUDA tensor launches the kernel or raises.

``block_v`` / ``block_g`` / ``block_f`` are the paper's tile sizes T_V,
T_G, T_F and stay at the signature.  How a CTA covers the work is the
kernel's choice, made by :func:`plan` from the shapes, the dtype and the
operands' alignment: bf16 whose rows TMA can take runs on the tensor cores
(128 x 128 CTA tiles, 64-deep K steps); float32, and bf16 that TMA refuses,
runs on CUDA cores (16 x 16 CTA tiles, lanes split over F).
"""
import ctypes
import functools
from pathlib import Path
from typing import NamedTuple

import torch

from ..common import DTYPE_CODES, CudaLibrary, cdiv, refuse_grad
from ...trace import count_launch
from .ref import gemm_ref

DATAFLOWS = ("output_stationary", "weight_stationary", "input_stationary")

#: SMs of an H100 SXM: the default for planning without a card.
H100_SMS = 132
#: tensor-core route: CTA tile (V, G), K step, resident tiles per CTA.
TC_TILE, TC_BK, TC_MAX_RESIDENT = 128, 64, 9
#: CUDA-core route: CTA tile (V and G), F rows of a resident slab, CTAs per SM.
CC_TILE, CC_SLAB, CC_CTAS_PER_SM = 16, 1536, 2
ROUTES = ("cuda_cores", "tensor_cores")

_P, _I = ctypes.c_void_p, ctypes.c_int
LIBRARY = CudaLibrary(
    Path(__file__).with_name("gemm_dataflow.cu"),
    {"gemm_dataflow_launch": [_P, _P, _P, _P] + [_I] * 10 + [_P]},
)


class Plan(NamedTuple):
    """How the kernel covers one product (all counts in CTA tiles)."""

    route: str       # "tensor_cores" or "cuda_cores"
    tile_v: int      # output rows of a CTA tile
    tile_g: int      # output columns of a CTA tile
    slab: int        # F rows resident (or, output-stationary, walked) at once
    nslab: int       # slabs over F; > 1 sums partials in an f32 workspace
    split: int       # CTAs along the temporal range (weight / input)
    grid: tuple      # (grid_x, grid_y)


def tma_ok(v: int, f: int, g: int, x_ptr: int = 0, w_ptr: int = 0) -> bool:
    """Whether TMA takes bf16 x (V, F) and w (F, G), row-major: each row a
    multiple of 16 bytes and each base 16-byte aligned."""
    return f % 8 == 0 and g % 8 == 0 and x_ptr % 16 == 0 and w_ptr % 16 == 0


def plan(v: int, f: int, g: int, dtype, dataflow: str, *, sms: int = H100_SMS,
         x_ptr: int = 0, w_ptr: int = 0) -> Plan:
    """The route, CTA tiles, slabs and grid for one ``gemm`` launch."""
    if dataflow not in DATAFLOWS:
        raise ValueError(f"dataflow must be one of {DATAFLOWS}")
    df = DATAFLOWS.index(dataflow)
    if dtype == torch.bfloat16 and tma_ok(v, f, g, x_ptr, w_ptr):
        nv, ng, nk = cdiv(v, TC_TILE), cdiv(g, TC_TILE), cdiv(f, TC_BK)
        if df == 0:  # persistent over the (V tile, G tile) list
            return Plan("tensor_cores", TC_TILE, TC_TILE, f, 1, 1,
                        (min(nv * ng, sms), 1))
        slab_tiles = min(nk, TC_MAX_RESIDENT)
        nslab = cdiv(nk, slab_tiles)
        if df == 1:  # a G block resident, V tiles walked
            split = max(1, min(nv, sms // ng))
            grid = (split, ng)
        else:        # a V block resident, G tiles walked
            split = max(1, min(ng, sms // nv))
            grid = (nv, split)
        return Plan("tensor_cores", TC_TILE, TC_TILE, slab_tiles * TC_BK, nslab,
                    split, grid)
    nr, ng = cdiv(v, CC_TILE), cdiv(g, CC_TILE)
    slab = min(f, CC_SLAB)
    nslab = cdiv(f, slab)
    slots = CC_CTAS_PER_SM * sms
    if df == 0:  # one row group per CTA, the accumulator kept across slabs
        return Plan("cuda_cores", CC_TILE, CC_TILE, slab, nslab, nr, (nr, ng))
    if df == 1:
        split = max(1, min(nr, cdiv(slots, ng)))
        return Plan("cuda_cores", CC_TILE, CC_TILE, slab, nslab, split, (split, ng))
    split = max(1, min(ng, cdiv(slots, nr)))
    return Plan("cuda_cores", CC_TILE, CC_TILE, slab, nslab, split, (nr, split))


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


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
    if min(block_v, block_g, block_f) < 1:
        raise ValueError("gemm: block sizes must be positive")
    if x.device != w.device:
        raise ValueError("gemm: operands on several devices")
    refuse_grad("gemm", x, w)
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
    p = plan(v, f, g, x.dtype, dataflow, sms=_sm_count(x.device), x_ptr=x.data_ptr(),
             w_ptr=w.data_ptr())
    # slab partials go to an f32 workspace owned by one CTA per element; a
    # float32 output is its own workspace
    ws = out
    if p.nslab > 1 and x.dtype != torch.float32:
        ws = torch.empty((v, g), dtype=torch.float32, device=x.device)
    lib = LIBRARY.load()
    with torch.cuda.device(x.device):
        code = lib.gemm_dataflow_launch(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), ws.data_ptr(),
            v, f, g, DATAFLOWS.index(dataflow), DTYPE_CODES[x.dtype],
            ROUTES.index(p.route), p.slab, p.split, *p.grid,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    LIBRARY.check(code, "gemm_dataflow launch")
    count_launch(gemm)
    return out


#: kernel launches since the last reset (a plain count, set to 0 by callers).
gemm.launches = 0

