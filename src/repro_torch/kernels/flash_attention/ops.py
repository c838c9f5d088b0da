"""Wrappers for the flash-attention kernel (``flash_attention.cu``).

Two entry points launch the one kernel:

- :func:`flash_attention` keeps the reference op's signature and layout:
  q (B, Hq, Sq, D), k/v (B, Hkv, Sk, D), a causal mask on indices.
- :func:`attend` is the model's route (``models/attention.py``): q
  (B, Sq, Hq, D), k/v (B, Sk, Hkv, D) in the model's own layout, masked on
  the int32 position vectors the caller passes, as ``_attend_chunked``
  masks them.

The kernel reads through strides, so neither layout is copied, and reads
KV head ``h // (Hq // Hkv)`` for query head ``h`` (GQA without repeating
K/V).  A CPU tensor goes to the plain version (``ref.py``); a CUDA tensor
launches the kernel or raises.  :func:`route` picks the kernel's route:
tensor cores for bf16 whose strides TMA takes, CUDA cores otherwise.
``block_q`` / ``block_k`` / ``chunk`` are schedule knobs of the reference:
the kernel walks its own 64 x 64 tiles, and keys are visited in
increasing order whatever the tiling.
"""
import ctypes
import functools
from pathlib import Path

import numpy as np
import torch

from torch.utils.flop_counter import register_flop_formula

from ..common import DTYPE_CODES, CudaLibrary, refuse_grad
from ...trace import count, count_launch
from .ref import attend_chunked, flash_attention_ref

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
LIBRARY = CudaLibrary(
    Path(__file__).with_name("flash_attention.cu"),
    {"flash_attention_launch":
        [_P] * 6 + [_I] * 8 + [ctypes.c_float] + [_L] * 12 + [_I, _I, _P],
     "flash_attention_occupancy": [_I, _P]},
)
ROUTES = ("cuda_cores", "tensor_cores")
#: the kernel's tile: 64 queries by 64 keys (both routes)
TILE = 64
#: the widest head the kernel takes (recurrentgemma-2b's local blocks: 256)
MAX_HEAD_DIM = 256
#: head dims the tensor-core route runs on the pingpong schedule (128-row q
#: tiles on two consumer warpgroups); 64 and below, and past 128, keep the
#: 64-row kernel
PINGPONG_HEAD_DIMS = range(72, 129)


def route(dtype, views, ptrs) -> str:
    """The kernel's route for q, k, v and out, each given as the (shape,
    element strides) of its (B, H, S, D) view (``views``) and its data
    pointer (``ptrs``).
    Tensor cores need bf16 whose q, k and v TMA can address: every stride
    that steps (an extent above 1) a positive multiple of 16 bytes, bases
    16-byte aligned; and an output written in bf16 pairs (even strides,
    4-byte aligned).  Everything else takes the CUDA-core route."""
    if dtype != torch.bfloat16:
        return "cuda_cores"
    *ins, out = views
    *in_ptrs, out_ptr = ptrs
    for (shape, strides), ptr in zip(ins, in_ptrs):
        if ptr % 16:
            return "cuda_cores"
        for n, st in zip(shape[:3], strides[:3]):
            if n > 1 and (st <= 0 or (2 * st) % 16):
                return "cuda_cores"
    shape, strides = out
    if out_ptr % 4 or any(n > 1 and st % 2 for n, st in zip(shape[:3], strides[:3])):
        return "cuda_cores"
    return "tensor_cores"


def _check(name, q, k, v):
    """The operand contract (raises on anything else); q, k, v are 4-D
    (B, H, S, D) views here."""
    if q.dtype not in DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"{name}: q, k, v must share one dtype of float32 or bfloat16, "
            f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"{name}: bad shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, hq, _, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or hq % k.shape[1] != 0:
        raise ValueError(
            f"{name}: k/v {tuple(k.shape)} do not match q {tuple(q.shape)} "
            "(same batch and head_dim, Hq a multiple of Hkv)")
    if len({q.device, k.device, v.device}) != 1:
        raise ValueError(f"{name}: operands on several devices")


def _launch(q, k, v, out, q_pos, k_pos, causal: bool, window: int):
    """Launch on (B, H, S, D) views of any strides (unit stride in D)."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if d % 8 or not 8 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head_dim must be a multiple of 8 "
                         f"in [8, {MAX_HEAD_DIM}], got {d}")
    if any(t.stride(-1) != 1 for t in (q, k, v, out)):
        raise ValueError("flash_attention: head_dim must have unit stride")
    if out.numel() == 0:
        return out
    r = route(q.dtype, [(t.shape, t.stride()) for t in (q, k, v, out)],
              [t.data_ptr() for t in (q, k, v, out)])
    lib = LIBRARY.load()
    with torch.cuda.device(q.device):
        code = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            q_pos.data_ptr(), k_pos.data_ptr(),
            b, hq, hkv, sq, sk, d, int(causal), int(window),
            float(1.0 / np.sqrt(d)),
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
            DTYPE_CODES[q.dtype], ROUTES.index(r),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    LIBRARY.check(code, "flash_attention launch")
    count_launch(flash_attention)
    if r == "tensor_cores" and d in PINGPONG_HEAD_DIMS:
        count("flash.tc_pingpong_launches")
    return out


def occupancy(head_dim: int) -> int:
    """CTAs of the tensor-core kernel for ``head_dim`` that one SM holds at
    once (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``; needs a card)."""
    ctas = ctypes.c_int(0)
    LIBRARY.check(LIBRARY.load().flash_attention_occupancy(head_dim, ctypes.byref(ctas)),
                  "flash_attention occupancy")
    return ctas.value


@functools.lru_cache(maxsize=64)
def _arange(n: int, device: torch.device):
    """Positions 0..n-1 as int32 on ``device`` (kept: the op's mask on
    indices passes them on every call)."""
    return torch.arange(n, dtype=torch.int32, device=device)


def _positions(pos, n, device, name):
    pos = pos.to(device=device, dtype=torch.int32).contiguous()
    if pos.shape != (n,):
        raise ValueError(f"{name} must be ({n},), got {tuple(pos.shape)}")
    return pos


def flash_attention(q, k, v, causal=False, block_q=128, block_k=128):
    """q: (B, Hq, Sq, D); k/v: (B, Hkv, Sk, D) with Hq % Hkv == 0.
    Returns (B, Hq, Sq, D) in q's dtype."""
    _check("flash_attention", q, k, v)
    refuse_grad("flash_attention", q, k, v)
    sq, sk = q.shape[2], k.shape[2]
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal, block_k)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    return _launch(q, k, v, out, _arange(sq, q.device), _arange(sk, q.device), causal, 0)


#: kernel launches since the last reset (a plain count, set to 0 by callers).
flash_attention.launches = 0


def attend(q, k, v, q_pos, k_pos, window: int = 0, chunk: int = 512):
    """Causal attention in the model's layout: q (B, Sq, Hq, D), k/v
    (B, Sk, Hkv, D); key ``j`` is seen by query ``i`` when
    ``k_pos[j] <= q_pos[i]`` (and ``k_pos[j] > q_pos[i] - window`` when
    ``window``).  Returns (B, Sq, Hq, D).

    A CUDA tensor launches the kernel through the custom op
    ``repro_torch::flash_attend``; a ``meta`` (or fake) tensor goes to the
    same op, whose fake implementation gives the output's shape and
    computes nothing (the dry-run's traces, ``launch/dryrun.py``), and
    whose registered FLOP formula (:func:`attend_flops`) counts the tiles
    the kernel computes."""
    _check("attend", q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    refuse_grad("attend", q, k, v)
    if q.device.type == "cpu":
        return attend_chunked(q, k, v, q_pos, k_pos, window, chunk)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"attend: no kernel for device {q.device}")
    qp = _positions(q_pos, q.shape[1], q.device, "q_pos")
    kp = _positions(k_pos, k.shape[1], q.device, "k_pos")
    return flash_attend(q, k, v, qp, kp, int(window))


@torch.library.custom_op("repro_torch::flash_attend", mutates_args=(), device_types="cuda")
def flash_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 q_pos: torch.Tensor, k_pos: torch.Tensor, window: int) -> torch.Tensor:
    """The kernel on the model's layout (see :func:`attend`, which checks
    the operands first)."""
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            out.transpose(1, 2), q_pos, k_pos, True, window)
    return out


@flash_attend.register_fake
def _(q, k, v, q_pos, k_pos, window):
    return torch.empty_like(q, memory_format=torch.contiguous_format)


def attend_flops(q_shape, k_shape, window: int) -> int:
    """FLOPs of the tiles the kernel computes for :func:`attend` on the
    model's positions (``q_pos = 0 .. Sq - 1``, ``k_pos = 0 .. Sk - 1``,
    as every caller passes them): a 64-query by 64-key tile is computed
    unless the causal mask (or the window) hides every pair of it, and a
    computed tile costs ``QK^T`` and ``PV``, 2 x 2 x 64 x 64 x D FLOPs.
    Partly masked tiles count whole, as the kernel computes them whole."""
    b, sq, hq, d = q_shape
    sk = k_shape[1]
    q0 = np.arange(0, sq, TILE)[:, None]
    k0 = np.arange(0, sk, TILE)[None, :]
    seen = k0 <= np.minimum(q0 + TILE, sq) - 1
    if window > 0:
        seen &= np.minimum(k0 + TILE, sk) - 1 > q0 - window
    tiles = int(seen.sum())
    return 4 * TILE * TILE * d * tiles * b * hq


@register_flop_formula(torch.ops.repro_torch.flash_attend)
def _flash_attend_flop(q_shape, k_shape, v_shape, q_pos_shape, k_pos_shape, window,
                       *args, out_shape=None, **kwargs) -> int:
    return attend_flops(q_shape, k_shape, window)
