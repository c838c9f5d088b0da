"""What every plain reference shares: the precision of the matrix
products, the readouts, the masked softmax cross-entropy and the SGD loop.

A reference module (``references/<model>.py``, named by a configuration's
``reference``) defines ``init_params(model, gen, device, dtype)``,
``graph(n, src, dst, device)``, ``forward(params, graph, x, prec)`` and
``flops(model, n, src, dst)``; the readout, the loss and the optimiser
steps here take it as ``ref``.  Nothing here imports the program.

Float32 with TF32 off is ``"float32"``; ``CONTROL`` gives each stated type
the nearest precision below it, the control's: on a card TF32 matrix
products, off the card the same rounding of the products' operands to
TF32's 10-bit mantissa.
"""
from __future__ import annotations

import contextlib

import torch

PRECISIONS = ("float32", "tf32")
#: the configuration's stated type -> the precision the control computes in
CONTROL = {"float32": "tf32"}
#: the configuration's stated type -> the torch type the inputs are made in
DTYPES = {"float32": torch.float32}


@contextlib.contextmanager
def precision(name: str):
    """Set the matrix products' precision for the block (restored after)."""
    if name not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {name!r}")
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = name == "tf32"
    torch.backends.cudnn.allow_tf32 = name == "tf32"
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to TF32 (10 mantissa bits, to nearest, ties to even),
    still stored as float32."""
    i = t.contiguous().view(torch.int32)
    lsb = (i >> 13) & 1
    return ((i + 0xFFF + lsb) & ~0x1FFF).view(torch.float32)


def _rounded(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to TF32 going forward; the gradient passes unrounded."""
    return t + (round_tf32(t.detach()) - t.detach())


def matmul(a: torch.Tensor, b: torch.Tensor, prec: str) -> torch.Tensor:
    """``a @ b``; in TF32 off the card, of the operands rounded to TF32 (the
    backward's products stay float32 there)."""
    if prec == "tf32" and a.device.type != "cuda":
        a, b = _rounded(a), _rounded(b)
    return a @ b


#: the readouts the program offers a batched run (``Program.run(readout=...)``)
READOUTS = {"mean": lambda h: h.mean(dim=0), "sum": lambda h: h.sum(dim=0),
            "max": lambda h: h.amax(dim=0)}


def readout(h: torch.Tensor, how: str) -> torch.Tensor:
    """One graph's readout of its node outputs ``(V, F)``."""
    return READOUTS[how](h)


def loss(ref, params, graph, x, labels, mask, prec: str = "float32") -> torch.Tensor:
    """Softmax cross-entropy of the labelled nodes (``mask`` 1), averaged."""
    logp = torch.log_softmax(ref.forward(params, graph, x, prec), dim=-1)
    nll = -logp.gather(1, labels.long()[:, None])[:, 0]
    return (nll * mask).sum() / mask.sum()


def sgd(ref, params, graph, x, labels, mask, lr: float, steps: int, prec: str = "float32"):
    """``steps`` SGD steps from ``params``: the loss of each step, the
    gradient of the first (per layer, per name), and the parameters after
    each step."""
    losses, first_grad, states = [], None, []
    p = [{k: v.detach().clone() for k, v in layer.items()} for layer in params]
    for _ in range(steps):
        leaves = [v.requires_grad_() for layer in p for v in layer.values()]
        with torch.enable_grad(), precision(prec):
            value = loss(ref, p, graph, x, labels, mask, prec)
            grads = torch.autograd.grad(value, leaves)
        g = iter(grads)
        grad = [{k: next(g).detach() for k in layer} for layer in p]
        if first_grad is None:
            first_grad = grad
        p = [{k: (layer[k] - lr * gl[k]).detach() for k in layer}
             for layer, gl in zip(p, grad)]
        losses.append(float(value.detach()))
        states.append(p)
    return losses, first_grad, states
