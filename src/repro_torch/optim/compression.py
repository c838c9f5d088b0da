"""Error-feedback int8 gradient compression.

The port of :mod:`repro.optim.compression`: quantize each gradient leaf
to int8 with a per-leaf scale, keep the quantization residual and add it
back the next step (error feedback makes the compression unbiased over
time).  As in the reference's trainer, the round trip acts on the
gradient after the data-parallel reduction (it is not an int8 collective):
on a mesh the leaves are DTensors and each scale is the whole leaf's
absolute maximum.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..tree import leaves, tree_map, unflatten


class EFState(NamedTuple):
    residual: Any  # tree congruent with grads


def init_error_feedback(grads_like) -> EFState:
    return EFState(tree_map(
        lambda g: torch.zeros_like(g, dtype=torch.float32), grads_like,
    ))


def quantize_int8(x: torch.Tensor):
    """Symmetric per-tensor int8 quantization -> (q, scale)."""
    xf = x.float()
    scale = torch.clamp(xf.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_grads(grads, ef: EFState):
    """Quantize grads+residual; returns (quantized tree of (q, scale),
    new residual)."""

    def one(g, r):
        gf = g.float() + r
        q, s = quantize_int8(gf)
        return (q, s), gf - dequantize_int8(q, s)

    pairs = [one(g, r) for g, r in zip(leaves(grads), leaves(ef.residual))]
    return (unflatten(grads, [p[0] for p in pairs]),
            EFState(unflatten(grads, [p[1] for p in pairs])))


def decompress_grads(qtree):
    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, tuple) and len(node) == 2 and isinstance(node[0], torch.Tensor):
            return dequantize_int8(*node)
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return node

    return walk(qtree)
