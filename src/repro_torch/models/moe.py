"""Mixture-of-Experts FFN — the paper's sparse/dense multiphase chain at LM
scale.

The port of :mod:`repro.models.moe`.  Dispatch (sparse scatter by router
choice) -> expert GEMMs (dense) -> combine (sparse gather + weighted sum)
is structurally SpMM -> GEMM -> SpMM.  The reference's three paths:

  * ``dense``  — every expert processes every token, outputs masked (the
                 Seq baseline/oracle; E/k x FLOP overhead).
  * ``ragged`` — sort tokens by expert, then one grouped GEMM per expert
                 over its sorted segment (SP-Optimized flavour: no
                 capacity padding, no drops).
  * ``ep``     — expert parallelism on a device mesh: activations are
                 replicated across the rules' ``experts`` ("model") axis,
                 so each shard dispatches into a capacity buffer for *its
                 own* experts, runs one batched expert product, combines,
                 and one all-reduce over the model axis merges the
                 per-shard contributions (Mixtral-style EP).  The
                 reference's ``shard_map`` island is ``DTensor.to_local``
                 / ``from_local`` around plain PyTorch, the merge a
                 ``Partial`` placement made ``Replicate`` (or, under
                 sequence parallelism, ``Shard`` on the sequence: a
                 reduce-scatter after the gathered input).

The reference's ``ragged_dot`` is an XLA operation, not a Pallas kernel,
so the grouped product here is plain PyTorch: one ``torch.matmul`` per
expert and projection, with the per-expert counts read to the host once a
layer.  That is the launch-heavy first form (3 E products a layer).

Both ``ragged`` and ``ep`` combine by summing each token's ``top_k``
weighted expert outputs after un-sorting them into (T, k, d) (choice
order), never with ``index_add_``: its atomics would make the bits vary
from run to run on the card, and a resumed training run must equal a
straight one bit for bit.  ``policy="auto"`` is ``ep`` under a mesh whose
rules name ``experts``, ``ragged`` otherwise, as in the reference.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from .config import ArchConfig
from .layers import _act, normal, torch_dtype
from .sharding import axis_size, current_mesh, current_rules, shard


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


# ---------------------------------------------------------------------------
# Expert-parallel (the mesh path)
# ---------------------------------------------------------------------------


def _local_capacity(cfg: ArchConfig, tokens_local: int) -> int:
    c = tokens_local * cfg.moe.top_k * cfg.moe.capacity_factor / cfg.moe.n_experts
    return max(8, int(-(-c // 8) * 8))  # round up to 8


def _ep_local(cfg: ArchConfig, x_loc, router, w_gate, w_up, w_down, lo: int):
    """One shard's EP step on plain tensors: route every local token,
    dispatch the (token, choice) pairs owned by experts ``lo ..
    lo + e_loc - 1`` into an (e_loc, cap, d) buffer (stable order within an
    expert, pairs past ``cap`` dropped), one batched gated FFN, combine in
    choice order.  Returns (this shard's part of the output in float32,
    local aux)."""
    bl, s, d = x_loc.shape
    k, e_loc = cfg.moe.top_k, w_gate.shape[0]
    x2d = x_loc.reshape(-1, d)
    t = x2d.shape[0]
    probs, ids, aux = _route(cfg, {"router": router}, x2d)
    cap = _local_capacity(cfg, t)
    flat_e, flat_p = ids.reshape(-1), probs.reshape(-1)
    mine = (flat_e >= lo) & (flat_e < lo + e_loc)
    local_e = torch.where(mine, flat_e - lo, e_loc)  # e_loc = drop row
    # position within each local expert (stable order)
    order = torch.argsort(torch.where(mine, local_e, e_loc + 1), stable=True)
    sorted_e = local_e[order]
    counts = torch.bincount(sorted_e, minlength=e_loc + 1)
    start = torch.cumsum(counts, 0) - counts  # first sorted slot of each expert
    pos_in_e = torch.arange(t * k, device=x2d.device) - start[sorted_e]
    keep = (sorted_e < e_loc) & (pos_in_e < cap)
    dest = torch.where(keep, sorted_e * cap + pos_in_e, e_loc * cap)
    tok = order // k
    buf = torch.zeros((e_loc * cap + 1, d), dtype=x2d.dtype, device=x2d.device)
    # every dropped pair writes zeros to the extra row e_loc * cap
    buf = buf.index_put((dest,), torch.where(keep[:, None], x2d[tok], 0.0))
    h = buf[: e_loc * cap].reshape(e_loc, cap, d)
    g = _act(cfg, torch.bmm(h, w_gate)) * torch.bmm(h, w_up)
    y = torch.bmm(g, w_down).reshape(e_loc * cap, d)
    y_flat = torch.cat([y, torch.zeros((1, d), dtype=y.dtype, device=y.device)])
    w = torch.where(keep, flat_p[order], 0.0).to(y.dtype)
    gathered = y_flat[dest] * w[:, None]
    # un-sort: sorted slot i holds flat pair order[i] = (token, choice)
    unsorted = torch.empty_like(gathered).index_put((order,), gathered)
    out = unsorted.reshape(t, k, d).float().sum(dim=1)
    return out.reshape(bl, s, d), aux


def moe_ep(cfg: ArchConfig, p: dict, x: torch.Tensor, mesh, rules):
    """Expert-parallel MoE over the mesh's ``experts`` axis."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    model_axis = rules.experts
    mi = mesh.mesh_dim_names.index(model_axis)
    n_shards = axis_size(mesh, model_axis)
    e = cfg.moe.n_experts
    # pad to a shardable expert count with never-routed dummy experts
    # (e.g. 40 experts on a 16-way axis -> 48 virtual, 8 idle)
    e_loc = -(-e // n_shards)
    e_pad = e_loc * n_shards
    ws = []
    for name in ("experts_gate", "experts_up", "experts_down"):
        w = p[name]
        if e_pad != e:
            w = w.full_tensor() if isinstance(w, DTensor) else w
            w = torch.cat([w, torch.zeros((e_pad - e, *w.shape[1:]), dtype=w.dtype,
                                          device=w.device)])
        ws.append(shard(w, "experts", None, None))  # each shard its local experts
    router = shard(p["router"], None, None)  # every shard routes to all experts
    # the tokens, replicated over the model axis (under sequence
    # parallelism gathered over the sequence, the result reduce-scattered)
    x = shard(x, "batch", None, None)
    x_pl = list(x.placements)
    # mesh dims whose shards see different tokens or experts: the local
    # gradients of replicated inputs there are partial sums
    differs = [i == mi or isinstance(pl, Shard) for i, pl in enumerate(x_pl)]
    part = [Partial() if dif else Replicate() for dif in differs]
    x_loc = x.to_local(grad_placements=[Partial() if i == mi else pl
                                        for i, pl in enumerate(x_pl)])
    r_loc = router.to_local(grad_placements=part)
    w_loc = [w.to_local(grad_placements=[Shard(0) if i == mi else pl
                                         for i, pl in enumerate(part)]) for w in ws]
    lo = mesh.get_local_rank(model_axis) * e_loc
    out_loc, aux_loc = _ep_local(cfg, x_loc, r_loc, *w_loc, lo)
    out = DTensor.from_local(out_loc, mesh, [Partial() if i == mi else pl
                                             for i, pl in enumerate(x_pl)],
                             run_check=False)
    # the merge over the model axis, in float32 and rounded once after it:
    # one shard (one rounding of each token's sum, as ``ragged``) and many
    # give the same bits but for the f32 sum order
    out = shard(out, "batch", "sequence", None).to(x.dtype)
    # aux averaged over the model and data shards.  Every model shard routed
    # the same tokens, so its aux is the same: one all-reduce over the data
    # shards gives every rank the same mean, and only model shard 0 passes
    # aux's gradient to the router (whose gradient sums over model shards)
    if mesh.get_local_rank(model_axis) != 0:
        aux_loc = aux_loc.detach()
    n_data = 1
    for i, pl in enumerate(x_pl):
        n_data *= mesh.size(i) if isinstance(pl, Shard) else 1
    aux_pl = [Partial() if isinstance(pl, Shard) else Replicate() for pl in x_pl]
    aux = DTensor.from_local(aux_loc / n_data, mesh, aux_pl, run_check=False)
    return out, aux.redistribute(mesh, [Replicate()] * mesh.ndim)


def moe_ffn(cfg: ArchConfig, p: dict, x: torch.Tensor, policy: str = "auto"):
    """Dispatch to the right MoE path.  ``"auto"``: EP when a mesh is
    active and its rules name ``experts``, ragged grouped-GEMM otherwise."""
    mesh, rules = current_mesh(), current_rules()
    if policy == "auto":
        policy = "ep" if (mesh is not None and rules is not None and rules.experts) else "ragged"
    if policy == "ragged":
        return moe_ragged(cfg, p, x)
    if policy == "dense":
        return moe_dense(cfg, p, x)
    if policy == "ep":
        if mesh is None or rules is None or not rules.experts:
            raise ValueError("moe_ep needs a device mesh whose rules name an "
                             "experts axis: run under use_sharding(mesh, rules)")
        return moe_ep(cfg, p, x, mesh, rules)
    raise ValueError(policy)
