"""xLSTM blocks (arXiv:2405.04517): chunkwise-parallel mLSTM + sLSTM.

The port of :mod:`repro.models.xlstm`.  mLSTM is a matrix-memory linear
recurrence with exponential gating:

    m_t = max(log f_t + m_{t-1}, i_t)
    C_t = e^{log f_t + m_{t-1} - m_t} C_{t-1} + e^{i_t - m_t} v_t k_t^T
    n_t = e^{log f_t + m_{t-1} - m_t} n_{t-1} + e^{i_t - m_t} k_t
    h_t = (C_t q_t) / max(|n_t . q_t|, e^{-m_t})

Training uses the chunkwise-parallel form: within a chunk of length L the
contribution of steps s <= t is an attention-like masked GEMM, and only the
(C, n, m) state crosses chunk boundaries — SP-Generic pipelining of a
two-phase chain in the paper's taxonomy.  The reference's ``lax.scan``
over chunks is a Python loop here (a :class:`~.loops.TimeLoop`, which the
dry-run traces a few steps of and scales).  Decode is the O(1) recurrence.

sLSTM keeps scalar memories with a nonlinear recurrent connection
(block-diagonal R acting on h_{t-1}), so it is sequential: one loop step a
position (host-bound on the card: a dozen launches a step).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from .config import ArchConfig
from .layers import normal, torch_dtype
from .loops import TimeLoop
from .sharding import local_param, on_shards, shard

# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


def init_mlstm(cfg: ArchConfig, generator: torch.Generator, device=None) -> dict:
    d, h = cfg.d_model, cfg.n_heads
    dev, dt = resolve_device(device), torch_dtype(cfg)
    s = 1.0 / np.sqrt(d)
    return {
        "lstm_qkv": normal(generator, (d, 3 * d), s, dt, dev),
        "lstm_out": normal(generator, (d, d), s, dt, dev),
        "w_if": normal(generator, (d, 2 * h), s, dt, dev),
        "b_i": torch.zeros((h,), dtype=dt, device=dev),
        # forget bias > 0 so f ~ sigmoid(3) ~ 0.95 at init
        "b_f": torch.full((h,), 3.0, dtype=dt, device=dev),
        "w_o": normal(generator, (d, d), s, dt, dev),
    }


class MLSTMState(NamedTuple):
    c: torch.Tensor  # (B, H, Dv, Dk)
    n: torch.Tensor  # (B, H, Dk)
    m: torch.Tensor  # (B, H)

    @classmethod
    def zeros(cls, cfg: ArchConfig, batch: int, device=None):
        h, hd = cfg.n_heads, cfg.head_dim
        dev = resolve_device(device)
        return cls(torch.zeros((batch, h, hd, hd), dtype=torch.float32, device=dev),
                   torch.zeros((batch, h, hd), dtype=torch.float32, device=dev),
                   torch.full((batch, h), -1e30, dtype=torch.float32, device=dev))


def _mlstm_qkv_gates(cfg: ArchConfig, p: dict, x: torch.Tensor):
    b, s, d = x.shape
    h, hd = cfg.n_heads, cfg.head_dim
    q, k, v = torch.split(x @ p["lstm_qkv"], d, dim=-1)
    q = q.reshape(b, s, h, hd).float()
    k = k.reshape(b, s, h, hd).float() / np.sqrt(hd)
    v = v.reshape(b, s, h, hd).float()
    gif = (x @ p["w_if"]).reshape(b, s, 2, h).float()
    i_raw = gif[:, :, 0] + p["b_i"].float()
    f_raw = gif[:, :, 1] + p["b_f"].float()
    log_f = -F.softplus(-f_raw)  # log sigmoid
    # the output gate on the model axis as ``lstm_out``'s rows, which it
    # feeds: left to DTensor, its product is reduced onto rows, and the
    # backward's cost model then reads every row on the host (a train
    # trace of minutes)
    o = torch.sigmoid(shard(x @ p["w_o"], "batch", None, "heads").float())
    return q, k, v, i_raw, log_f, o


def _mlstm_chunk(q, k, v, i_raw, log_f, state: MLSTMState, state_out: bool = True):
    """One chunk (B, L, H, ...) given incoming state; returns (h, state),
    the state None with ``state_out=False`` (the last chunk's, which
    nothing reads)."""
    l = q.shape[1]
    # per-position cumulative decay within the chunk
    b_cum = torch.cumsum(log_f, dim=1)  # (B, L, H)
    a = i_raw - b_cum  # a_s = i_s - b_s
    run_max = torch.cummax(a, dim=1).values  # M_t
    mbar = torch.maximum(state.m[:, None], run_max)  # (B, L, H)
    m_t = b_cum + mbar  # true stabilizer (for the denominator floor)

    # intra-chunk masked attention-like term: weight[t, s] = exp(a_s -
    # mbar_t) for s <= t (the b_t decay cancels into the row stabilizer)
    scores = torch.einsum("blhd,bshd->bhls", q, k)  # (B, H, L, L)
    a_s = a.transpose(1, 2)[:, :, None, :]  # (B, H, 1, L)
    mb_t = mbar.transpose(1, 2)[:, :, :, None]  # (B, H, L, 1)
    w = torch.exp(a_s - mb_t)
    mask = torch.tril(torch.ones((l, l), dtype=torch.bool, device=q.device))
    w = torch.where(mask, w, 0.0)
    sw = scores * w
    intra_num = torch.einsum("bhls,bshd->blhd", sw, v)
    intra_den = sw.sum(dim=-1).transpose(1, 2)  # (B, L, H)

    # inter-chunk (incoming state) term
    scale_in = torch.exp(state.m[:, None] - mbar)  # (B, L, H)
    inter_num = torch.einsum("blhd,bhed->blhe", q, state.c) * scale_in[..., None]
    inter_den = torch.einsum("blhd,bhd->blh", q, state.n) * scale_in

    num = intra_num + inter_num
    den = intra_den + inter_den
    floor = torch.exp(-m_t)
    h_out = num / torch.maximum(den.abs(), floor)[..., None]
    if not state_out:
        return h_out, None

    # state update
    big_b = b_cum[:, -1]  # (B, H)
    mbar_l = mbar[:, -1]
    m_out = big_b + mbar_l
    decay_state = torch.exp(state.m - mbar_l)  # (B, H)
    wk = torch.exp(a - mbar_l[:, None])  # (B, L, H)
    c_out = state.c * decay_state[..., None, None] + torch.einsum(
        "bshd,bshe,bsh->bhde", v, k, wk)
    n_out = state.n * decay_state[..., None] + torch.einsum("bshd,bsh->bhd", k, wk)
    return h_out, MLSTMState(c_out, n_out, m_out)


def _mlstm_scan(q, k, v, i_raw, log_f, chunk: int):
    """The chunkwise mLSTM over (B, S, H, ...) from a zero state; returns
    h (B, S, H * D): the heads are flattened on each rank's own shard, never
    on a DTensor whose model axis does not divide them."""
    b, s, h, hd = q.shape
    chunk = min(chunk, s)
    n_chunks = -(-s // chunk)
    pad = n_chunks * chunk - s
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
        i_raw = F.pad(i_raw, (0, 0, 0, pad), value=-1e30)
        log_f = F.pad(log_f, (0, 0, 0, pad))
    zeros = lambda *shape: torch.zeros(shape, dtype=torch.float32, device=q.device)  # noqa: E731
    state = MLSTMState(zeros(b, h, hd, hd), zeros(b, h, hd),
                       torch.full((b, h), -1e30, dtype=torch.float32, device=q.device))
    hs = []
    loop = TimeLoop(n_chunks)
    for c in loop:
        blk = slice(c * chunk, (c + 1) * chunk)
        *ins, st_c, st_n, st_m = loop.enter(c, q[:, blk], k[:, blk], v[:, blk],
                                            i_raw[:, blk], log_f[:, blk], *state)
        last = c == loop.runs - 1  # its outgoing state is never read
        h_out, state = _mlstm_chunk(*ins, MLSTMState(st_c, st_n, st_m), state_out=not last)
        if not last:
            h_out, *state = loop.leave(c, h_out, *state)
            state = MLSTMState(*state)
        hs.append(h_out)
    return loop.full(torch.cat(hs, dim=1), dim=1)[:, :s].flatten(2)


def mlstm_block(cfg: ArchConfig, p: dict, x: torch.Tensor, chunk: int = 256) -> torch.Tensor:
    """Full-sequence mLSTM (training/prefill), chunk by chunk; on a mesh
    on each rank's rows and heads."""
    q, k, v, i_raw, log_f, o = _mlstm_qkv_gates(cfg, p, x)
    per_head = [shard(t, "batch", None, "heads", None) for t in (q, k, v)]
    gates = [shard(t, "batch", None, "heads") for t in (i_raw, log_f)]
    hs = on_shards(_mlstm_scan, *per_head, *gates, extra=(chunk,))
    out = (o * hs).to(x.dtype)
    return shard(out @ p["lstm_out"], "batch", "sequence", None)


def mlstm_decode(cfg: ArchConfig, p: dict, x: torch.Tensor,
                 state: MLSTMState) -> tuple[torch.Tensor, MLSTMState]:
    """One-token decode: the O(1) recurrence.  x: (B, 1, d)."""
    b = x.shape[0]
    q, k, v, i_raw, log_f, o = _mlstm_qkv_gates(cfg, p, x)
    q, k, v = q[:, 0], k[:, 0], v[:, 0]  # (B, H, D)
    i_raw, log_f = i_raw[:, 0], log_f[:, 0]  # (B, H)
    m_new = torch.maximum(log_f + state.m, i_raw)
    decay = torch.exp(log_f + state.m - m_new)
    inp = torch.exp(i_raw - m_new)
    c = (state.c * decay[..., None, None]
         + torch.einsum("bhd,bhe->bhde", v, k) * inp[..., None, None])
    n = state.n * decay[..., None] + k * inp[..., None]
    num = torch.einsum("bhde,bhe->bhd", c, q)
    den = torch.maximum(torch.einsum("bhd,bhd->bh", n, q).abs(), torch.exp(-m_new))
    h = num / den[..., None]
    out = (o[:, 0] * h.reshape(b, -1)).to(x.dtype)[:, None]
    return shard(out @ p["lstm_out"], "batch", None, None), MLSTMState(c, n, m_new)


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


def init_slstm(cfg: ArchConfig, generator: torch.Generator, device=None) -> dict:
    d, h, hd = cfg.d_model, cfg.n_heads, cfg.head_dim
    dev, dt = resolve_device(device), torch_dtype(cfg)
    s = 1.0 / np.sqrt(d)
    bias = torch.cat([torch.zeros(d), torch.full((d,), 3.0), torch.zeros(2 * d)])
    return {
        "lstm_w": normal(generator, (d, 4 * d), s, dt, dev),
        # block-diagonal recurrent weights, one block per head
        "lstm_r": normal(generator, (h, hd, 4 * hd), 0.5 / np.sqrt(hd), dt, dev),
        "lstm_out": normal(generator, (d, d), s, dt, dev),
        "bias": bias.to(dt).to(dev),
    }


class SLSTMState(NamedTuple):
    c: torch.Tensor  # (B, D)
    n: torch.Tensor  # (B, D)
    h: torch.Tensor  # (B, D)
    m: torch.Tensor  # (B, D)

    @classmethod
    def zeros(cls, cfg: ArchConfig, batch: int, device=None):
        shape, dev = (batch, cfg.d_model), resolve_device(device)

        def z():
            return torch.zeros(shape, dtype=torch.float32, device=dev)

        return cls(z(), z(), z(), torch.full(shape, -1e30, dtype=torch.float32, device=dev))


def _slstm_step(cfg: ArchConfig, p: dict, wx_t: torch.Tensor, state: SLSTMState):
    """wx_t: (B, 4D) precomputed input projection for this step."""
    b = wx_t.shape[0]
    h_heads, hd = cfg.n_heads, cfg.head_dim
    h_prev = state.h.reshape(b, h_heads, hd)
    rh = torch.einsum("bhd,hde->bhe", h_prev, p["lstm_r"].float())
    rh = rh.reshape(b, h_heads, 4, hd).transpose(1, 2).reshape(b, 4 * cfg.d_model)
    pre = wx_t.float() + rh + p["bias"].float()
    i_raw, f_raw, z_raw, o_raw = torch.chunk(pre, 4, dim=-1)
    log_f = -F.softplus(-f_raw)
    m_new = torch.maximum(log_f + state.m, i_raw)
    decay = torch.exp(log_f + state.m - m_new)
    inp = torch.exp(i_raw - m_new)
    c = decay * state.c + inp * torch.tanh(z_raw)
    n = decay * state.n + inp
    h = torch.sigmoid(o_raw) * c / torch.maximum(n, torch.exp(-m_new))
    return SLSTMState(c, n, h, m_new)


def _slstm_scan(cfg: ArchConfig, wx: torch.Tensor, lstm_r, bias) -> torch.Tensor:
    """The sLSTM recurrence over wx (B, S, 4D) from a zero state; returns
    h (B, S, D) in float32."""
    p = {"lstm_r": lstm_r, "bias": bias}
    state = SLSTMState.zeros(cfg, wx.shape[0], wx.device)
    hs = []
    loop = TimeLoop(wx.shape[1])
    for t in loop:
        wx_t, *state = loop.enter(t, wx[:, t], *state)
        state = SLSTMState(*loop.leave(t, *_slstm_step(cfg, p, wx_t, SLSTMState(*state))))
        hs.append(state.h)
    return loop.full(torch.stack(hs, dim=1), dim=1)


def slstm_block(cfg: ArchConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    """Full-sequence sLSTM: one recurrence step a position.

    The recurrence is pinned to batch-only sharding, as in the reference:
    any model-axis sharding on the carry would put a collective inside the
    loop over positions."""
    wx = shard(x @ p["lstm_w"], "batch", None, None)  # (B, S, 4D)
    hs = on_shards(lambda w, r, bias: _slstm_scan(cfg, w, r, bias), wx,
                   extra=(local_param(p["lstm_r"], wx), local_param(p["bias"], wx)))
    return shard(hs.to(x.dtype) @ p["lstm_out"], "batch", "sequence", None)


def slstm_decode(cfg: ArchConfig, p: dict, x: torch.Tensor,
                 state: SLSTMState) -> tuple[torch.Tensor, SLSTMState]:
    wx = (x @ p["lstm_w"])[:, 0]
    state = _slstm_step(cfg, p, wx, state)
    out = state.h.to(x.dtype)[:, None] @ p["lstm_out"]
    return shard(out, "batch", None, None), state
