"""A plain GraphSAGE reference in the port's parameter layout, for the
test that a configuration of a second kind of model runs by new files
alone.  Each layer is ``relu(H W_top + Â (H W_bottom) + b)``, the paper's
Sec.-6 split of ``concat(H, Â H) W``, with ``Â`` the GCN-normalised
``A + I`` that the program's graphs carry."""
from __future__ import annotations

import math

import torch

from references import gcn
from references.common import matmul, precision

dims = gcn.dims
graph = gcn.graph


def init_params(model: dict, gen: torch.Generator, device, dtype) -> list[dict]:
    out = []
    for f, g in dims(model):
        top = torch.randn((f, g), generator=gen, device=device, dtype=dtype) / math.sqrt(f)
        bottom = torch.randn((f, g), generator=gen, device=device, dtype=dtype) / math.sqrt(f)
        b = torch.randn((g,), generator=gen, device=device, dtype=dtype) * 0.1
        out.append({"w_top": top, "w_bottom": bottom, "b": b})
    return out


def forward(params, adj, x: torch.Tensor, prec: str = "float32") -> torch.Tensor:
    h = x
    with precision(prec):
        for layer in params:
            h = torch.relu(matmul(h, layer["w_top"], prec)
                           + adj @ matmul(h, layer["w_bottom"], prec) + layer["b"])
    return h


def flops(model: dict, n: int, src, dst) -> float:
    return gcn.flops(model, n, src, dst) + float(sum(2 * n * f * g for f, g in dims(model)))
