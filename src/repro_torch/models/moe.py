"""Mixture-of-Experts FFN — the paper's sparse/dense multiphase chain at LM
scale.

The port of :mod:`repro.models.moe`.  Dispatch (sparse scatter by router
choice) -> expert GEMMs (dense) -> combine (sparse gather + weighted sum)
is structurally SpMM -> GEMM -> SpMM.  Two of the reference's three paths:

  * ``dense``  — every expert processes every token, outputs masked (the
                 Seq baseline/oracle; E/k x FLOP overhead).
  * ``ragged`` — sort tokens by expert, then one grouped GEMM per expert
                 over its sorted segment (SP-Optimized flavour: no
                 capacity padding, no drops).

The reference's ``ragged_dot`` is an XLA operation, not a Pallas kernel,
so the grouped product here is plain PyTorch: one ``torch.matmul`` per
expert and projection, with the per-expert counts read to the host once a
layer.  That is the launch-heavy first form (3 E products a layer).

The combine sums each token's ``top_k`` weighted expert outputs after
un-sorting them into (T, k, d), never with ``index_add_``: its atomics
would make the bits vary from run to run on the card, and a resumed
training run must equal a straight one bit for bit.

The reference's expert-parallel ``ep`` path needs a device mesh; it waits
for the sharding item (ROADMAP Queue 1 item 6), and ``policy="auto"``
picks ``ragged`` since the port has no mesh.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from .config import ArchConfig
from .layers import _act, normal, torch_dtype


def init_moe(cfg: ArchConfig, generator: torch.Generator, device=None) -> dict:
    d, ff, e = cfg.d_model, cfg.d_ff, cfg.moe.n_experts
    dev, dt = resolve_device(device), torch_dtype(cfg)
    s_in, s_out = 1.0 / np.sqrt(d), 1.0 / np.sqrt(ff)
    return {
        "router": normal(generator, (d, e), s_in, torch.float32, dev),
        "experts_gate": normal(generator, (e, d, ff), s_in, dt, dev),
        "experts_up": normal(generator, (e, d, ff), s_in, dt, dev),
        "experts_down": normal(generator, (e, ff, d), s_out, dt, dev),
    }


def _route(cfg: ArchConfig, p: dict, x2d: torch.Tensor):
    """Router: returns (probs (T,k), ids (T,k), aux_loss).  ``torch.topk``
    on the float32 gates, as ``lax.top_k``."""
    logits = x2d.float() @ p["router"].float()  # (T, E)
    gates = torch.softmax(logits, dim=-1)
    probs, ids = torch.topk(gates, cfg.moe.top_k, dim=-1)
    probs = probs / torch.clamp_min(probs.sum(-1, keepdim=True), 1e-9)
    # Switch-style load-balance auxiliary loss
    e = cfg.moe.n_experts
    me = gates.mean(dim=0)  # mean router prob per expert
    ce = torch.bincount(ids.reshape(-1), minlength=e).float() / ids.numel()
    aux = e * torch.sum(me * ce) * cfg.moe.router_aux_weight
    return probs, ids, aux


def moe_dense(cfg: ArchConfig, p: dict, x: torch.Tensor):
    """Every expert on every token, masked (the oracle)."""
    b, s, d = x.shape
    x2d = x.reshape(-1, d)
    probs, ids, aux = _route(cfg, p, x2d)
    e = cfg.moe.n_experts
    g = torch.einsum("td,edf->etf", x2d, p["experts_gate"])
    u = torch.einsum("td,edf->etf", x2d, p["experts_up"])
    y = torch.einsum("etf,efd->etd", _act(cfg, g) * u, p["experts_down"])  # (E, T, d)
    mask = F.one_hot(ids, e).to(y.dtype) * probs[..., None].to(y.dtype)
    comb = mask.sum(dim=1)  # (T, E)
    out = torch.einsum("te,etd->td", comb, y)
    return out.reshape(b, s, d), aux


def moe_ragged(cfg: ArchConfig, p: dict, x: torch.Tensor):
    """Sort (token, choice) pairs by expert, one product per expert over
    its segment, weight, un-sort and sum each token's ``top_k`` rows."""
    b, s, d = x.shape
    k, e = cfg.moe.top_k, cfg.moe.n_experts
    x2d = x.reshape(-1, d)
    t = x2d.shape[0]
    probs, ids, aux = _route(cfg, p, x2d)
    flat_e = ids.reshape(-1)  # (T*k,)
    order = torch.argsort(flat_e, stable=True)
    xs = x2d[order // k]  # (T*k, d) gathered, expert-sorted
    counts = torch.bincount(flat_e, minlength=e).tolist()  # one host read a layer
    ys, start = [], 0
    for j, n in enumerate(counts):
        seg = xs[start:start + n]
        h = _act(cfg, seg @ p["experts_gate"][j]) * (seg @ p["experts_up"][j])
        ys.append(h @ p["experts_down"][j])
        start += n
    y = torch.cat(ys)  # (T*k, d), expert-sorted
    w = probs.reshape(-1)[order].to(y.dtype)
    # un-sort: sorted slot i holds flat pair order[i] = (token, choice)
    unsorted = torch.empty_like(y)
    unsorted[order] = y * w[:, None]
    out = unsorted.reshape(t, k, d).sum(dim=1)
    return out.reshape(b, s, d), aux


def moe_ffn(cfg: ArchConfig, p: dict, x: torch.Tensor, policy: str = "auto"):
    """Dispatch to the right MoE path.  ``"auto"`` is ``"ragged"``: the port
    has no device mesh, which the reference's ``"ep"`` needs."""
    if policy in ("auto", "ragged"):
        return moe_ragged(cfg, p, x)
    if policy == "dense":
        return moe_dense(cfg, p, x)
    if policy == "ep":
        raise NotImplementedError(
            "expert-parallel MoE needs a device mesh, which waits for the "
            "sharding item (ROADMAP Queue 1 item 6)")
    raise ValueError(policy)
