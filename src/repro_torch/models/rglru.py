"""RG-LRU recurrent block (Griffin / RecurrentGemma, arXiv:2402.19427).

The port of :mod:`repro.models.rglru`.  The block: x -> {input branch
(linear -> causal conv -> RG-LRU), gate branch (linear -> GeLU)} ->
elementwise product -> output linear.

RG-LRU recurrence (per channel):
    r_t = sigmoid(W_a x_t + b_a)          (recurrence gate)
    i_t = sigmoid(W_x x_t + b_x)          (input gate)
    a_t = a^(c * r_t),  a = sigmoid(lambda)  (c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The reference runs the linear recurrence with ``lax.associative_scan``;
here it is a log-depth doubling scan over S in plain PyTorch
(ceil(log2 S) steps of ``(a, b) <- (a * a_shift, a * b_shift + b)``),
which composes the same affine maps.  Gates and the recurrence run in
float32.  Decode is an O(1) state update.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from .config import ArchConfig
from .layers import normal, torch_dtype
from .sharding import on_shards, shard

_C = 8.0


def init_rglru(cfg: ArchConfig, generator: torch.Generator, device=None) -> dict:
    d, r = cfg.d_model, cfg.rnn_width
    dev, dt = resolve_device(device), torch_dtype(cfg)
    s = 1.0 / np.sqrt(d)
    return {
        "rg_in": normal(generator, (d, r), s, dt, dev),
        "rg_gate": normal(generator, (d, r), s, dt, dev),
        "rg_out": normal(generator, (r, d), 1.0 / np.sqrt(r), dt, dev),
        "conv_w": normal(generator, (cfg.conv_width, r), 0.1, dt, dev),
        "w_a": normal(generator, (r, r), 0.1 / np.sqrt(r), dt, dev),
        "w_x": normal(generator, (r, r), 0.1 / np.sqrt(r), dt, dev),
        "b_a": torch.zeros((r,), dtype=dt, device=dev),
        "b_x": torch.zeros((r,), dtype=dt, device=dev),
        # lambda init so that a = sigmoid(lambda) ~ 0.9..0.999
        "lam": torch.as_tensor(np.linspace(2.2, 6.9, r)).to(dt).to(dev),
    }


class RGLRUState(NamedTuple):
    h: torch.Tensor  # (B, R) recurrent state
    conv: torch.Tensor  # (B, W-1, R) causal-conv tail

    @classmethod
    def zeros(cls, cfg: ArchConfig, batch: int, device=None):
        r = cfg.rnn_width
        dev, dt = resolve_device(device), torch_dtype(cfg)
        return cls(torch.zeros((batch, r), dtype=dt, device=dev),
                   torch.zeros((batch, cfg.conv_width - 1, r), dtype=dt, device=dev))


def _gates(p: dict, u: torch.Tensor):
    """u: (B, [S,] R) post-conv activations -> (a_t, gated input), float32.
    On a mesh each gate's product is reduced onto u's channel placement."""
    uf = u.float()
    lead = ("batch",) + (None,) * (u.dim() - 2)
    r_t = torch.sigmoid(shard(uf @ p["w_a"].float(), *lead, "d_ff") + p["b_a"].float())
    i_t = torch.sigmoid(shard(uf @ p["w_x"].float(), *lead, "d_ff") + p["b_x"].float())
    log_a = -_C * r_t * F.softplus(-p["lam"].float())
    a_t = torch.exp(log_a)
    b_t = torch.sqrt(torch.clamp_min(1.0 - a_t**2, 1e-12)) * (i_t * uf)
    return a_t, b_t


def _causal_conv(p: dict, x: torch.Tensor, tail: torch.Tensor | None = None):
    """Depthwise causal conv, width W.  x: (B, S, R).  Returns (out, the
    last W-1 inputs as the next call's tail)."""
    w = p["conv_w"].float()  # (W, R)
    width = w.shape[0]
    xf = x.float()
    if tail is None:
        pad = torch.zeros((x.shape[0], width - 1, x.shape[2]), dtype=torch.float32,
                          device=x.device)
    else:
        pad = tail.float()
    xp = torch.cat([pad, xf], dim=1)  # (B, S+W-1, R)
    out = sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(width))
    return out.to(x.dtype), xp[:, -(width - 1):].to(x.dtype)


def _linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t from h_{-1} = 0 along dim 1, by recursive
    doubling: after the step of offset o, (a_t, b_t) is the composition of
    the maps t-2o+1 .. t.  Every product is of factors in (0, 1]."""
    s = a.shape[1]
    offset = 1
    while offset < s:
        a_prev, b_prev = a[:, :-offset], b[:, :-offset]
        b = torch.cat([b[:, :offset], a[:, offset:] * b_prev + b[:, offset:]], dim=1)
        a = torch.cat([a[:, :offset], a[:, offset:] * a_prev], dim=1)
        offset *= 2
    return b


def rglru_block(cfg: ArchConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    """Full-sequence forward (training / prefill), a log-depth scan over S.
    On a mesh the scan runs on each rank's rows and channels."""
    u = shard(x @ p["rg_in"], "batch", None, "d_ff")
    g = shard(x @ p["rg_gate"], "batch", None, "d_ff")
    u, _ = _causal_conv(p, u)
    a_t, b_t = _gates(p, u)
    h = on_shards(_linear_scan, shard(a_t, "batch", None, "d_ff"),
                  shard(b_t, "batch", None, "d_ff"))
    out = F.gelu(g.float(), approximate="tanh") * h
    return shard(out.to(x.dtype) @ p["rg_out"], "batch", "sequence", None)


def rglru_decode(cfg: ArchConfig, p: dict, x: torch.Tensor,
                 state: RGLRUState) -> tuple[torch.Tensor, RGLRUState]:
    """One-token decode. x: (B, 1, d).  Returns (out, new state)."""
    u = x @ p["rg_in"]  # (B, 1, R)
    g = x @ p["rg_gate"]
    u, tail = _causal_conv(p, u, state.conv)
    a_t, b_t = _gates(p, u[:, 0])
    h = a_t * state.h.float() + b_t
    out = F.gelu(g[:, 0].float(), approximate="tanh") * h
    out = (out.to(x.dtype) @ p["rg_out"])[:, None]
    return out, RGLRUState(h.to(state.h.dtype), tail)
