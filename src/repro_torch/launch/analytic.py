"""Analytic FLOP/byte accounting per (arch x shape) cell.

The port of :mod:`repro.launch.analytic`: pure arithmetic on
:class:`ArchConfig` and :class:`ShapeSuite`, the same numbers as the
reference's.  The reference's roofline uses these counts because XLA's
``cost_analysis`` counts a scanned layer stack's body once; here they give
the bounds that ``chip_smoke.py`` holds each LM family's prefill against
(FLOPs over the card's dense bf16 peak).

  * ``cell_flops`` — every GEMM, attention-score and recurrence op of one
    step of the cell (global, all devices);
  * ``cell_hbm_floor_bytes`` — a per-device floor of parameter, optimizer,
    cache and activation traffic.
"""
from __future__ import annotations

from ..configs.shapes import ShapeSuite
from ..models.config import ArchConfig

BF16 = 2
F32 = 4


def _attn_proj_macs(cfg: ArchConfig) -> float:
    hd = cfg.head_dim
    return cfg.d_model * hd * (cfg.n_heads + 2 * cfg.n_kv_heads) + (
        cfg.n_heads * hd * cfg.d_model
    )


def layer_macs_per_token(cfg: ArchConfig, kind: str, ctx: float) -> float:
    """Forward MACs per token for one block of the given kind.

    ``ctx`` is the average attended context length (S/2 for causal
    training, min(window, S) for local attention, the cache length for
    decode)."""
    d, hd, h = cfg.d_model, cfg.head_dim, cfg.n_heads
    if kind in ("attn", "local", "moe"):
        macs = _attn_proj_macs(cfg)
        macs += 2.0 * h * hd * ctx  # QK^T + PV
        if kind == "moe":
            macs += d * cfg.moe.n_experts  # router
            macs += 3.0 * d * cfg.d_ff * cfg.moe.top_k  # active experts
        else:
            macs += 3.0 * d * cfg.d_ff
        return macs
    if kind == "rglru":
        r = cfg.rnn_width
        macs = 3.0 * d * r  # in / gate / out projections
        macs += cfg.conv_width * r + 2.0 * r * r  # conv + gate matrices
        macs += 3.0 * d * cfg.d_ff
        return macs
    if kind == "mlstm":
        # qkv (3d^2) + output gate (d^2) + out proj (d^2) + state ops
        chunk = 256.0
        state = 3.0 * h * hd * hd  # C update + C q + n ops
        intra = h * hd * min(ctx, chunk)  # chunkwise scores+pv average
        return 5.0 * d * d + state + intra
    if kind == "slstm":
        return 4.0 * d * d + 4.0 * d * hd + d * d  # W + block-diag R + out
    raise KeyError(kind)


def cell_flops(cfg: ArchConfig, shape: ShapeSuite) -> float:
    """Total analytic FLOPs (global, all chips) for one step of the cell."""
    s, b = shape.seq_len, shape.global_batch
    if shape.kind == "decode":
        tokens = float(b)
        full_ctx = float(s)
    else:
        tokens = float(b) * s
        full_ctx = s / 2.0  # causal average

    macs = 0.0
    for kind in cfg.layer_kinds:
        ctx = full_ctx
        if kind == "local":
            ctx = min(float(cfg.window), full_ctx)
        macs += layer_macs_per_token(cfg, kind, ctx)
    macs += float(cfg.d_model) * cfg.vocab  # logits head
    fwd_flops = 2.0 * macs * tokens
    if shape.kind == "train":
        # fwd + bwd(2x) + remat recompute (~1x fwd) = 4x forward
        mult = 4.0 if cfg.remat else 3.0
        return fwd_flops * mult
    return fwd_flops


def cell_hbm_floor_bytes(cfg: ArchConfig, shape: ShapeSuite, n_chips: int,
                         model_shards: int) -> float:
    """Per-device HBM traffic floor for one step."""
    n = float(cfg.param_count())
    s, b = shape.seq_len, shape.global_batch
    p_dev = n / model_shards  # TP-sharded params, replicated across DP
    if shape.kind == "train":
        # params r/w (bf16), grads r/w (bf16), adam m/v r/w (f32, ZeRO-1)
        opt_dev = n / n_chips
        traffic = p_dev * (2 * BF16) + p_dev * (2 * BF16) + opt_dev * (4 * F32)
        # activations: ~8 d-wide tensors per layer saved + reread
        tok_dev = b * s / max(n_chips / model_shards, 1)
        traffic += tok_dev * cfg.d_model * cfg.n_layers * 2 * BF16 * 2
        return traffic
    if shape.kind == "prefill":
        tok_dev = b * s / max(n_chips / model_shards, 1)
        return p_dev * BF16 + tok_dev * cfg.d_model * cfg.n_layers * 2 * BF16
    # decode: all params + the whole KV cache are read for one token
    cache = 0.0
    for kind in cfg.layer_kinds:
        if kind in ("attn", "moe"):
            cache += 2.0 * b * s * cfg.n_kv_heads * cfg.head_dim * BF16
        elif kind == "local":
            cache += 2.0 * b * min(cfg.window, s) * cfg.n_kv_heads * cfg.head_dim * BF16
        elif kind == "rglru":
            cache += b * cfg.rnn_width * (cfg.conv_width + 1) * BF16
        elif kind == "mlstm":
            cache += b * cfg.n_heads * cfg.head_dim**2 * F32
        elif kind == "slstm":
            cache += 4.0 * b * cfg.d_model * F32
    return p_dev * BF16 + cache / n_chips
