"""Attention: the LM-scale instance of the paper's multiphase taxonomy.

The port of :mod:`repro.models.attention`.  QKᵀ -> softmax -> PV is a
dependent GEMM-GEMM chain.  ``attn_policy`` selects the inter-phase
dataflow:

  * ``seq``    — materialize the (S x S) score matrix (paper Seq), plain
                 PyTorch as in the reference.
  * ``sp_opt`` — online softmax over key blocks: score tiles are produced
                 and consumed on chip, never stored (paper SP-Optimized ==
                 flash attention).  On a CUDA tensor this launches the
                 hand-written kernel (:mod:`repro_torch.kernels.flash_attention`);
                 on a CPU tensor it runs the kernel's plain version, the
                 port of the reference's ``_attend_chunked``.

Supports GQA (n_kv_heads < n_heads, grouped einsums — no KV repetition),
sliding-window masks, and single-token decode against a (possibly
ring-buffered) KV cache.  Decode stays plain PyTorch, as the reference
computes it outside any kernel.

On a device mesh (:mod:`.sharding`) the heads shard over the rules'
``heads`` axis, after the reference's tensor-parallel head alignment
(:func:`head_alignment`, sized by the mesh).  The attention itself — the
flash kernel, its plain version, decode against the cache — runs on each
rank's own heads and batch rows through ``local_map``: the kernel never
sees a DTensor.  q, k and v always share their head placement, so a
shard's query heads find their KV heads on the same rank.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..kernels.flash_attention import attend
# the SP-Optimized online softmax over KV chunks in plain PyTorch: the
# flash kernel's plain version, kept beside the kernel
from ..kernels.flash_attention.ref import attend_chunked as _attend_chunked
from .config import ArchConfig
from .layers import normal, rope, torch_dtype
from .sharding import axis_size, current_mesh, current_rules, on_shards, shard

NEG_INF = -1e30
INT32_MAX = int(np.iinfo(np.int32).max)


def init_attention(cfg: ArchConfig, generator: torch.Generator,
                   device=None) -> dict:
    d, hd = cfg.d_model, cfg.head_dim
    dev, dt = resolve_device(device), torch_dtype(cfg)
    s = 1.0 / np.sqrt(d)
    return {
        "wq": normal(generator, (d, cfg.n_heads * hd), s, dt, dev),
        "wk": normal(generator, (d, cfg.n_kv_heads * hd), s, dt, dev),
        "wv": normal(generator, (d, cfg.n_kv_heads * hd), s, dt, dev),
        "wo": normal(generator, (cfg.n_heads * hd, d), 1.0 / np.sqrt(d), dt, dev),
    }


def _tp_size() -> int:
    """The tensor-parallel size: the mesh's ``heads`` axes, 1 without a
    mesh."""
    rules, mesh = current_rules(), current_mesh()
    if rules is None or mesh is None or rules.heads is None:
        return 1
    return axis_size(mesh, rules.heads)


def head_alignment(cfg: ArchConfig, ts: int | None = None):
    """TP head alignment: (kv_rep, g_new, aligned?).

    When the tensor-parallel size ``ts`` (default: the current mesh's, 1
    without one) does not divide the head counts, pad the per-KV query
    groups and *replicate* KV heads so both head dims divide the TP axis.
    Replication preserves semantics exactly (each real query head still
    attends its original KV head; padded query slots have zero wq columns
    and zero wo rows, so they contribute nothing).  Applied only when the
    FLOP overhead is <= 2x.
    """
    ts = _tp_size() if ts is None else ts
    hkv = cfg.n_kv_heads
    g = cfg.n_heads // hkv
    if ts <= 1 or (hkv % ts == 0 and cfg.n_heads % ts == 0):
        return 1, g, ts > 1
    rep = math.lcm(hkv, ts) // hkv
    g_new = -(-g // rep)
    if (hkv * rep * g_new) / (hkv * g) > 2.0:
        return 1, g, False
    return rep, g_new, True


def aligned_kv_heads(cfg: ArchConfig, ts: int | None = None) -> int:
    rep, _, _ = head_alignment(cfg, ts)
    return cfg.n_kv_heads * rep


def _align_weights(cfg: ArchConfig, p: dict):
    """Runtime-padded projection weights for TP alignment (the weights
    themselves when already aligned).  On a mesh the padding is computed
    on the whole weights and the result resharded over the heads."""
    rep, g_new, _ = head_alignment(cfg)
    hd, hkv = cfg.head_dim, cfg.n_kv_heads
    g = cfg.n_heads // hkv
    if rep == 1 and g_new == g:
        return p["wq"], p["wk"], p["wv"], p["wo"]
    full = [t.full_tensor() if hasattr(t, "full_tensor") else t
            for t in (p["wq"], p["wk"], p["wv"], p["wo"])]
    d = full[0].shape[0]
    gp = rep * g_new
    wq = F.pad(full[0].reshape(d, hkv, g, hd), (0, 0, 0, gp - g))
    wq = wq.reshape(d, hkv * rep, g_new, hd).reshape(d, -1)
    wk = torch.repeat_interleave(full[1].reshape(d, hkv, hd), rep, dim=1).reshape(d, -1)
    wv = torch.repeat_interleave(full[2].reshape(d, hkv, hd), rep, dim=1).reshape(d, -1)
    wo = F.pad(full[3].reshape(hkv, g, hd, d), (0, 0, 0, 0, 0, gp - g))
    wo = wo.reshape(hkv * rep, g_new, hd, d).reshape(-1, d)
    return (shard(wq, None, "heads"), shard(wk, None, "heads"),
            shard(wv, None, "heads"), shard(wo, "heads", None))


def _heads_axis(cfg: ArchConfig) -> str | None:
    """``"heads"`` where the mesh divides both aligned head counts, else
    None (attention then runs on every head on each rank): q, k, v and the
    KV cache take the same head placement, so a rank's query heads find
    their KV heads on that rank."""
    ts = _tp_size()
    rep, g_new, _ = head_alignment(cfg, ts)
    hkv = cfg.n_kv_heads * rep
    return "heads" if hkv % ts == 0 and (hkv * g_new) % ts == 0 else None


def _project_qkv(cfg: ArchConfig, p: dict, x: torch.Tensor, positions):
    b, s, _ = x.shape
    hd = cfg.head_dim
    rep, g_new, _ = head_alignment(cfg)
    hkv = cfg.n_kv_heads * rep
    hq = hkv * g_new
    heads = _heads_axis(cfg)
    wq, wk, wv, _ = _align_weights(cfg, p)

    def heads_of(w, n):
        # the projection takes the heads' placement before the view: where
        # the heads are not sharded (alignment refused) a column-sharded
        # product cannot be viewed as (heads, head_dim), so it is gathered
        # over the model axis first, as GSPMD reshards there
        return shard(shard(x @ w, "batch", None, heads).reshape(b, s, n, hd),
                     "batch", None, heads, None)

    q, k, v = heads_of(wq, hq), heads_of(wk, hkv), heads_of(wv, hkv)
    return rope(q, positions, cfg.rope_theta), rope(k, positions, cfg.rope_theta), v


def _group(q: torch.Tensor, n_kv: int) -> torch.Tensor:
    """(B, S, H, D) -> (B, S, Hkv, G, D) for grouped-query einsums."""
    b, s, h, d = q.shape
    return q.reshape(b, s, n_kv, h // n_kv, d)


def _attend_seq(q, k, v, q_pos, k_pos, window: int) -> torch.Tensor:
    """Materialized-score attention (the Seq baseline)."""
    qg = _group(q, k.shape[2]).float()
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float())
    scores = scores / np.sqrt(q.shape[-1])
    qp, kp = q_pos.long()[:, None], k_pos.long()[None, :]
    mask = kp <= qp
    if window > 0:
        mask &= kp > qp - window
    scores = torch.where(mask[None, None, None], scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    b, s = q.shape[:2]
    return out.reshape(b, s, -1, q.shape[-1]).to(q.dtype)


def attention(
    cfg: ArchConfig,
    p: dict,
    x: torch.Tensor,
    positions: torch.Tensor,
    *,
    window: int = 0,
    use_kernels: bool = True,
) -> torch.Tensor:
    """Full-sequence (training / prefill) attention.

    ``sp_opt`` goes through :func:`repro_torch.kernels.flash_attention.attend`
    (the kernel on a CUDA tensor, its plain version on a CPU tensor);
    ``use_kernels=False`` asks for the plain version on any device, which
    is how a caller builds the plain twin of a run on the card.
    """
    b, s, _ = x.shape
    q, k, v = _project_qkv(cfg, p, x, positions)
    pos1 = positions[0] if positions.dim() > 1 else positions
    if cfg.attn_policy == "seq":
        core = _attend_seq
    elif use_kernels:
        core = attend
    else:
        core = _attend_chunked
    extra = (pos1, pos1, window) + ((cfg.attn_chunk,) if core is not _attend_seq else ())
    out = on_shards(core, q, k, v, extra=extra)
    _, _, _, wo = _align_weights(cfg, p)
    return shard(out.reshape(b, s, -1) @ wo, "batch", "sequence", None)


# ---------------------------------------------------------------------------
# Decode with KV cache
# ---------------------------------------------------------------------------


class KVCache(NamedTuple):
    k: torch.Tensor  # (B, S_cache, Hkv, D) — ring buffer when windowed
    v: torch.Tensor

    @classmethod
    def zeros(cls, cfg: ArchConfig, batch: int, length: int, window: int = 0,
              device=None):
        size = min(length, window) if window > 0 else length
        # TP-aligned KV head count (replicated KV under tensor parallelism)
        shape = (batch, size, aligned_kv_heads(cfg), cfg.head_dim)
        dev, dt = resolve_device(device), torch_dtype(cfg)
        return cls(torch.zeros(shape, dtype=dt, device=dev),
                   torch.zeros(shape, dtype=dt, device=dev))


def decode_attention(
    cfg: ArchConfig,
    p: dict,
    x: torch.Tensor,  # (B, 1, d)
    cache: KVCache,
    cur_index: int,  # absolute position of this token
    *,
    window: int = 0,
) -> tuple[torch.Tensor, KVCache]:
    """One-token decode against the cache; returns (out, cache).

    Unlike the reference, which returns a new cache, this writes the new
    key and value into ``cache``'s tensors in place and returns the same
    cache (a whole-cache copy per token would dominate decode)."""
    b = x.shape[0]
    cur_index = int(cur_index)
    positions = torch.full((b, 1), cur_index, dtype=torch.int32, device=x.device)
    q, k_new, v_new = _project_qkv(cfg, p, x, positions)
    size = cache.k.shape[1]
    slot = cur_index % size if window > 0 else cur_index
    seq_dim = _sequence_dim(cache.k)
    if seq_dim is not None:
        out = _decode_over_slots(cfg, q, k_new, v_new, cache, cur_index, slot, window,
                                 seq_dim)
        _, _, _, wo = _align_weights(cfg, p)
        return shard(out.reshape(b, 1, -1) @ wo, "batch", None, None), cache

    # absolute positions held by each cache slot
    slots = torch.arange(size, dtype=torch.int64, device=x.device)
    live = _live_slots(slots, size, slot, cur_index, window)

    def attend_cache(q, k_new, v_new, ck, cv):
        # this rank's batch rows and heads; the slot is written in place
        # into the cache's own storage
        ck[:, slot] = k_new[:, 0]
        cv[:, slot] = v_new[:, 0]
        qg = _group(q, ck.shape[2]).float() / np.sqrt(cfg.head_dim)
        s = torch.einsum("bqhgd,bkhd->bhgqk", qg, ck.float())
        s = torch.where(live, s, NEG_INF)
        pattn = torch.softmax(s, dim=-1)
        out = torch.einsum("bhgqk,bkhd->bqhgd", pattn, cv.float())
        return out.reshape(q.shape).to(q.dtype)

    out = on_shards(attend_cache, q, k_new, v_new, cache.k, cache.v)
    _, _, _, wo = _align_weights(cfg, p)
    return shard(out.reshape(b, 1, -1) @ wo, "batch", None, None), cache


def _live_slots(slots, size: int, slot: int, cur_index: int, window: int):
    """Which cache ``slots`` (global slot numbers) hold a position this
    token attends, shaped to mask (B, H, G, 1, slots) scores."""
    if window > 0:
        # ring buffer: slot s holds the most recent position p with
        # p % size == s and p <= cur_index
        k_pos = cur_index - (slot - slots) % size
    else:
        k_pos = slots
    valid = (k_pos <= cur_index) & (k_pos >= 0)
    if window > 0:
        valid &= k_pos > cur_index - window
    k_pos = torch.where(valid, k_pos, INT32_MAX)
    return (k_pos <= cur_index)[None, None, None, None]


def _sequence_dim(cache_k):
    """The mesh dim a layer's cache (B, S, H, D) shards its sequence over
    (``launch.specs.cache_shardings``' placement), else None (the heads'
    placement of ``init_cache``, or no mesh)."""
    from torch.distributed.tensor import Shard

    for i, pl in enumerate(getattr(cache_k, "placements", ())):
        if isinstance(pl, Shard) and pl.dim == 1:
            return i
    return None


def _decode_over_slots(cfg: ArchConfig, q, k_new, v_new, cache: KVCache, cur_index: int,
                       slot: int, window: int, dim: int):
    """Decode against a cache whose sequence is sharded over mesh dim
    ``dim`` (flash-decoding): each rank of that dim attends its own slice
    of slots with every query head, keeping its running max, sum and
    unnormalised output; the ranks combine them with an all-reduce max, a
    rescale and one all-reduce sum.  Only the rank that holds ``slot``
    writes the new key and value (``slot`` is a host int, so this is a
    branch each rank takes or not).  Returns the output (B, 1, Hq, D) on
    the heads' placement that ``wo`` expects."""
    from torch.distributed import _functional_collectives as funcol

    mesh = cache.k.device_mesh
    group = mesh.get_group(dim)
    per = cache.k.shape[1] // mesh.size(dim)
    lo = mesh.get_local_rank(dim) * per
    # every query head, and every KV head of the new slot, on each rank
    q, k_new, v_new = (shard(t, "batch", None, None, None) for t in (q, k_new, v_new))
    slots = torch.arange(lo, lo + per, dtype=torch.int64, device=q.device)
    live = _live_slots(slots, cache.k.shape[1], slot, cur_index, window)

    def attend_slots(q, k_new, v_new, ck, cv):
        if lo <= slot < lo + per:
            ck[:, slot - lo] = k_new[:, 0]
            cv[:, slot - lo] = v_new[:, 0]
        qg = _group(q, ck.shape[2]).float() / np.sqrt(cfg.head_dim)
        s = torch.where(live, torch.einsum("bqhgd,bkhd->bhgqk", qg, ck.float()), NEG_INF)
        m = s.amax(dim=-1)
        pexp = torch.where(live, torch.exp(s - m[..., None]), 0.0)
        m_all = funcol.all_reduce(m, "max", group)
        scale = torch.exp(m - m_all)
        o = torch.einsum("bhgqk,bkhd->bhgqd", pexp, cv.float()) * scale[..., None]
        ol = funcol.all_reduce(torch.cat([o, (pexp.sum(dim=-1) * scale)[..., None]], dim=-1),
                               "sum", group)
        out = ol[..., :-1] / ol[..., -1:]
        return out.permute(0, 3, 1, 2, 4).reshape(q.shape).to(q.dtype)

    out = on_shards(attend_slots, q, k_new, v_new, cache.k, cache.v)
    return shard(out, "batch", None, _heads_axis(cfg), None)
