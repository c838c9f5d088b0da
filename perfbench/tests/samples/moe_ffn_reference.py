"""A plain mixture-of-experts FFN layer, for the test that a cell of a new
kind of job is added by new files alone: a float32 softmax router, each
token's top ``k`` experts with their weights renormalised, and each
expert's SwiGLU ``(silu(x W_gate) * (x W_up)) W_down`` summed by those
weights, one expert at a time, in float32.  ``prec="float8_e4m3fn"``, the
control, rounds the expert products' operands to that type first."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from references.common import precision

#: the precisions ``forward`` computes in: float32, and the control's
ROUND_TO = {"float32": None, "float8_e4m3fn": torch.float8_e4m3fn}


def init_params(model: dict, gen: torch.Generator, device) -> dict:
    """The router in float32 and the experts in the configuration's type,
    in the port's layout (``models.moe``)."""
    d, f, e = model["hidden_size"], model["expert_width"], model["n_experts"]
    dtype = getattr(torch, model["dtype"])

    def normal(shape, fan_in, to):
        return (torch.randn(shape, generator=gen, device=device) / math.sqrt(fan_in)).to(to)
    return {"router": normal((d, e), d, torch.float32),
            "experts_gate": normal((e, d, f), d, dtype),
            "experts_up": normal((e, d, f), d, dtype),
            "experts_down": normal((e, f, d), f, dtype)}


def forward(params: dict, x: torch.Tensor, top_k: int, prec: str = "float32") -> torch.Tensor:
    to = ROUND_TO[prec]
    rnd = (lambda t: t) if to is None else (lambda t: t.to(to).float())  # noqa: E731
    x2d = x.reshape(-1, x.shape[-1]).float()
    with precision("float32"):
        probs, ids = torch.topk(torch.softmax(x2d @ params["router"].float(), -1), top_k, -1)
        probs = probs / probs.sum(-1, keepdim=True)
        out = torch.zeros_like(x2d)
        for e in range(params["router"].shape[1]):
            tok, slot = torch.nonzero(ids == e, as_tuple=True)
            xe = rnd(x2d[tok])
            gate, up, down = (rnd(params[k][e].float())
                              for k in ("experts_gate", "experts_up", "experts_down"))
            h = F.silu(xe @ gate) * (xe @ up)
            out.index_add_(0, tok, probs[tok, slot, None] * (rnd(h) @ down))
    return out.reshape(x.shape)


def flops(model: dict, tokens: int) -> float:
    """Router and the top-k experts' three products, multiply-adds as two."""
    d, f = model["hidden_size"], model["expert_width"]
    return 2.0 * tokens * d * (model["n_experts"] + 3 * model["top_k"] * f)
