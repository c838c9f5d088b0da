"""AdamW with decoupled weight decay on trees of tensors.

The port of :mod:`repro.optim.adamw`.  State is a tree congruent with the
parameters (``m``, ``v`` per leaf, float32); parameters keep their dtype,
and every update is computed in float32 as in the reference.  On a device
mesh the leaves are DTensors and the moments take each parameter's
placements (as ``init_opt(params)`` under ``jit`` does in the reference's
trainer); the global norm sums every shard.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from ..tree import leaves, tree_map, unflatten


class AdamWState(NamedTuple):
    step: torch.Tensor
    m: Any
    v: Any


def _step_zero(params) -> torch.Tensor:
    """The int32 step counter, on the parameters' device."""
    first = next(iter(leaves(params)), None)
    dev = first.device if isinstance(first, torch.Tensor) else None
    return torch.zeros((), dtype=torch.int32, device=dev)


def adamw(
    lr: float | Callable[[torch.Tensor], torch.Tensor] = 1e-3,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    grad_clip_norm: float | None = 1.0,
):
    """Returns (init_fn, update_fn)."""

    def init(params) -> AdamWState:
        zeros = lambda p: tree_map(  # noqa: E731
            lambda x: torch.zeros_like(x, dtype=torch.float32), p
        )
        return AdamWState(_step_zero(params), zeros(params), zeros(params))

    def update(grads, state: AdamWState, params):
        step = state.step + 1
        lr_t = lr(step) if callable(lr) else torch.tensor(
            lr, dtype=torch.float32, device=step.device)

        if grad_clip_norm is not None:
            gnorm = global_norm(grads)
            scale = torch.clamp(
                grad_clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
            # a bf16 leaf times the f32 scale is f32, as in jnp
            grads = tree_map(lambda g: g.float() * scale, grads)

        b1t = 1.0 - torch.pow(b1, step.float())
        b2t = 1.0 - torch.pow(b2, step.float())

        def upd(g, m, v, p):
            gf = g.float()
            m_new = b1 * m + (1.0 - b1) * gf
            v_new = b2 * v + (1.0 - b2) * gf * gf
            mh = m_new / b1t
            vh = v_new / b2t
            delta = mh / (torch.sqrt(vh) + eps) + weight_decay * p.float()
            return (p.float() - lr_t * delta).to(p.dtype), m_new, v_new

        out = [
            upd(g, m, v, p)
            for g, m, v, p in zip(leaves(grads), leaves(state.m),
                                  leaves(state.v), leaves(params))
        ]
        new_p = unflatten(params, [o[0] for o in out])
        new_m = unflatten(params, [o[1] for o in out])
        new_v = unflatten(params, [o[2] for o in out])
        return new_p, AdamWState(step, new_m, new_v)

    return init, update


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(l.float())) for l in leaves(tree)))


def sgd(lr: float = 0.1):
    def init(params):
        return AdamWState(_step_zero(params), None, None)

    def update(grads, state, params):
        new_p = tree_map(
            lambda p, g: (p.float() - lr * g.float()).to(p.dtype), params, grads
        )
        return new_p, AdamWState(state.step + 1, None, None)

    return init, update
