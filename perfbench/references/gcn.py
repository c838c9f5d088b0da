"""Plain PyTorch reference of the two-layer GCN the benchmark runs.

Kipf & Welling (ICLR 2017): each layer is ``relu(Â H W + b)`` with
``Â = D^-1/2 (A + I) D^-1/2``.  One departure from the paper, kept
because it is the function the program computes: the last layer takes the
ReLU too (the paper ends in a softmax, which the loss applies here).

It imports nothing of the program and takes nothing the program made: it
builds ``Â`` again from the raw edge lists the benchmark generated, and
reads only the inputs and weights the benchmark made.  The readout, the
loss and the SGD steps are ``references.common``'s.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from references.common import matmul, precision


def dims(model: dict) -> list[tuple[int, int]]:
    """``(F_in, F_out)`` of each layer: hidden width between, classes last."""
    out, f = [], model["f_in"]
    for i in range(model["n_layers"]):
        g = model["n_classes"] if i == model["n_layers"] - 1 else model["hidden"]
        out.append((f, g))
        f = g
    return out


def init_params(model: dict, gen: torch.Generator, device, dtype) -> list[dict]:
    """Weights ``N(0, 1/F)`` and biases ``N(0, 0.1^2)`` for each layer,
    drawn on ``device`` from ``gen``, in the program's layout."""
    out = []
    for f, g in dims(model):
        w = torch.randn((f, g), generator=gen, device=device, dtype=dtype) / math.sqrt(f)
        b = torch.randn((g,), generator=gen, device=device, dtype=dtype) * 0.1
        out.append({"w": w, "b": b})
    return out


def _entries(n: int, src, dst) -> np.ndarray:
    """The keys ``row * n + col`` of ``A + I``, duplicates merged."""
    loops = np.arange(n, dtype=np.int64)
    return np.unique(np.concatenate([
        np.asarray(src, np.int64) * n + np.asarray(dst, np.int64), loops * n + loops]))


class Adjacency:
    """``Â`` of one graph as COO entries on ``device``, from raw edges."""

    def __init__(self, n: int, src, dst, device):
        keys = _entries(n, src, dst)
        rows = torch.as_tensor(keys // n, device=device)
        cols = torch.as_tensor(keys % n, device=device)
        deg = torch.zeros(n, dtype=torch.float32, device=device)
        deg.index_add_(0, rows, torch.ones(rows.numel(), dtype=torch.float32, device=device))
        dinv = deg.rsqrt()
        self.n, self.rows, self.cols = n, rows, cols
        self.vals = dinv[rows] * dinv[cols]

    def __matmul__(self, h: torch.Tensor) -> torch.Tensor:
        out = torch.zeros((self.n, h.shape[1]), dtype=h.dtype, device=h.device)
        return out.index_add_(0, self.rows, self.vals[:, None] * h[self.cols])


def graph(n: int, src, dst, device) -> Adjacency:
    return Adjacency(n, src, dst, device)


def forward(params, adj: Adjacency, x: torch.Tensor, prec: str = "float32") -> torch.Tensor:
    """Node outputs ``(V, classes)``: each layer ``relu(Â (H W) + b)``."""
    h = x
    with precision(prec):
        for layer in params:
            h = torch.relu(adj @ matmul(h, layer["w"], prec) + layer["b"])
    return h


def flops(model: dict, n: int, src, dst) -> float:
    """Model FLOPs of one forward on one graph: per layer the
    combination's 2 V F G and the aggregation's 2 nnz min(F, G) over the
    non-zeros of ``A + I``, the cheaper order, so that the count does not
    depend on the dataflow the program runs."""
    nnz = int(_entries(n, src, dst).size)
    return float(sum(2 * nnz * min(f, g) + 2 * n * f * g for f, g in dims(model)))
