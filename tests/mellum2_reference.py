"""A plain Mellum2-12B-A2.5B forward, written from the published
``config.json`` (JetBrains/Mellum2-12B-A2.5B-Instruct) in float32.

Each layer is ``x += attn(rmsnorm(x))`` then ``x += moe(rmsnorm(x))``:

- attention: GQA (``num_attention_heads`` query heads share
  ``num_key_value_heads`` key/value heads in groups), head width
  ``head_dim``, no bias; RoPE by layer type (``rope_parameters``), rotating
  the halves ``x[..., :D/2]`` and ``x[..., D/2:]``; causal, and on
  ``sliding_attention`` layers a key is seen only within ``sliding_window``
  positions (``q - W < k <= q``); softmax in float32, materialised in
  blocks of queries;
- RoPE ``default``: ``theta^(-2i/D)``; ``yarn``: those frequencies blended
  with ``factor``-times-slower ones by a linear ramp between the
  correction dimensions of ``beta_fast`` and ``beta_slow`` in
  ``original_max_position_embeddings`` positions, cos and sin times
  ``attention_factor``;
- MoE: a float32 softmax router over ``num_experts``, each token's top
  ``num_experts_per_tok`` weights renormalised (``norm_topk_prob``), each
  expert ``(silu(x W_gate) * (x W_up)) W_down`` of width
  ``moe_intermediate_size``, one expert at a time;
- RMSNorm with ``rms_norm_eps``; the head untied, applied at the
  positions asked for.

The weights are held as the port lays them out (``embeddings``,
``final_norm``, ``scanned``: one stack a position of the layer pattern,
``remainder``), in the configuration's type, and each layer is upcast to
float32 when it runs, so that the reference fits beside them on one card.
Departures from the published model: a norm's scale is ``1 + w`` (the
port's convention; the published weight is ``w`` itself), and the
multi-token-prediction head some descriptions name is left out, as
``config.json`` declares none.

``prec="float8_e4m3fn"`` (the control) rounds both operands of every
matrix product through that type first.  Matrix products never run in
TF32 here.  This file imports neither JAX nor the port.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

#: the precisions ``forward`` computes in: float32, and the control's
ROUND_TO = {"float32": None, "float8_e4m3fn": torch.float8_e4m3fn}
#: queries a block of the materialised attention
QUERY_BLOCK = 512


@contextlib.contextmanager
def no_tf32():
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def pattern(model: dict) -> list[str]:
    """The shortest repeating unit of ``layer_types`` (the port stacks one
    set of weights for each of its positions)."""
    types = model["layer_types"]
    for p in range(1, len(types) + 1):
        if all(t == types[i % p] for i, t in enumerate(types)):
            return types[:p]
    return types


def init_params(model: dict, gen: torch.Generator, device) -> dict:
    """Weights drawn from ``gen`` on its device, placed on ``device`` in
    the configuration's type (the router in float32), laid out as the
    port's ``init_params`` lays them: ``N(0, 1/fan_in)`` matrices, the
    embedding ``N(0, 0.02^2)``, norm scales ``N(0, 0.1^2)``."""
    d, hq, hkv, hd = (model[k] for k in ("hidden_size", "num_attention_heads",
                                          "num_key_value_heads", "head_dim"))
    e, f, v = model["num_experts"], model["moe_intermediate_size"], model["vocab_size"]
    dtype = getattr(torch, model["dtype"])
    period = len(pattern(model))
    reps, rem = divmod(model["num_hidden_layers"], period)

    def normal(shape, scale, to=dtype):
        x = torch.randn(shape, generator=gen, device=gen.device).mul_(scale)
        return x.to(device=device, dtype=to)

    def layers(lead):
        return {"ln1": normal((*lead, d), 0.1),
                "attn": {"wq": normal((*lead, d, hq * hd), d ** -0.5),
                         "wk": normal((*lead, d, hkv * hd), d ** -0.5),
                         "wv": normal((*lead, d, hkv * hd), d ** -0.5),
                         "wo": normal((*lead, hq * hd, d), (hq * hd) ** -0.5)},
                "ln2": normal((*lead, d), 0.1),
                "moe": {"router": normal((*lead, d, e), d ** -0.5, torch.float32),
                        "experts_gate": normal((*lead, e, d, f), d ** -0.5),
                        "experts_up": normal((*lead, e, d, f), d ** -0.5),
                        "experts_down": normal((*lead, e, f, d), f ** -0.5)}}

    return {"embeddings": {"embed": normal((v, d), 0.02),
                           "lm_head": normal((d, v), d ** -0.5)},
            "final_norm": normal((d,), 0.1),
            "scanned": [layers((reps,)) if reps else None for _ in range(period)],
            "remainder": [layers(()) for _ in range(rem)]}


def layer_params(params: dict, model: dict, layer: int) -> dict:
    """Layer ``layer``'s weights, upcast to float32."""
    period = len(pattern(model))
    reps = model["num_hidden_layers"] // period
    if layer < reps * period:
        tree = params["scanned"][layer % period]
        pick = lambda t: t[layer // period]  # noqa: E731
    else:
        tree = params["remainder"][layer - reps * period]
        pick = lambda t: t  # noqa: E731

    def up(t):
        return {k: up(v) for k, v in t.items()} if isinstance(t, dict) else pick(t).float()
    return up(tree)


def inv_freq(head_dim: int, rope: dict) -> torch.Tensor:
    """The rotary inverse frequencies of one layer type, in float64."""
    base = float(rope["rope_theta"])
    pos_freqs = base ** (torch.arange(0, head_dim, 2, dtype=torch.float64) / head_dim)
    extra = 1.0 / pos_freqs
    if rope.get("rope_type", "default") == "default":
        return extra
    factor, length = float(rope["factor"]), rope["original_max_position_embeddings"]

    def corr(rotations):
        return head_dim * math.log(length / (rotations * 2 * math.pi)) / (2 * math.log(base))
    low = max(math.floor(corr(rope["beta_fast"])), 0)
    high = min(math.ceil(corr(rope["beta_slow"])), head_dim - 1)
    ramp = ((torch.arange(head_dim // 2, dtype=torch.float64) - low)
            / (high - low if high != low else 0.001)).clamp(0, 1)
    return extra / factor * ramp + extra * (1 - ramp)


def rotary(x: torch.Tensor, positions: torch.Tensor, rope: dict) -> torch.Tensor:
    """x (B, S, H, D) rotated by the layer type's RoPE at ``positions``."""
    half = x.shape[-1] // 2
    ang = positions.double()[:, None] * inv_freq(x.shape[-1], rope).to(x.device)
    scale = float(rope.get("attention_factor", 1.0)) if rope.get("rope_type") == "yarn" else 1.0
    cos = (torch.cos(ang) * scale).float()[:, None, :]
    sin = (torch.sin(ang) * scale).float()[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps) * (1.0 + w)


def attention(x, p, model, layer_type, positions, rnd, mm):
    """Materialised masked softmax attention, a block of queries at a time
    over the keys its rows can see."""
    b, s, _ = x.shape
    hq, hkv, hd = (model[k] for k in ("num_attention_heads", "num_key_value_heads", "head_dim"))
    rope = model["rope_parameters"][layer_type]
    window = model["sliding_window"] if layer_type == "sliding_attention" else 0
    q = rotary(mm(x, p["wq"]).reshape(b, s, hq, hd), positions, rope)
    k = rotary(mm(x, p["wk"]).reshape(b, s, hkv, hd), positions, rope)
    v = mm(x, p["wv"]).reshape(b, s, hkv, hd)
    q = rnd(q.reshape(b, s, hkv, hq // hkv, hd) / math.sqrt(hd))
    k, v = rnd(k), rnd(v)
    out = torch.empty_like(q)
    for q0 in range(0, s, QUERY_BLOCK):
        q1 = min(q0 + QUERY_BLOCK, s)
        k0 = max(0, q0 - window + 1) if window else 0
        scores = torch.einsum("bqhgd,bkhd->bhgqk", q[:, q0:q1], k[:, k0:q1])
        qp, kp = positions[q0:q1, None], positions[None, k0:q1]
        seen = kp <= qp
        if window:
            seen &= kp > qp - window
        probs = torch.softmax(scores.masked_fill(~seen, float("-inf")), dim=-1)
        out[:, q0:q1] = torch.einsum("bhgqk,bkhd->bqhgd", rnd(probs), v[:, k0:q1])
    return mm(out.reshape(b, s, hq * hd), p["wo"])


def moe(x, p, model, mm):
    """The routed experts, one at a time, summed by the renormalised
    top-k weights."""
    shape = x.shape
    x2d = x.reshape(-1, shape[-1])
    gates = torch.softmax(mm(x2d, p["router"]), dim=-1)
    probs, ids = torch.topk(gates, model["num_experts_per_tok"], dim=-1)
    if model["norm_topk_prob"]:
        probs = probs / probs.sum(dim=-1, keepdim=True)
    out = torch.zeros_like(x2d)
    for e in range(model["num_experts"]):
        tok, slot = torch.nonzero(ids == e, as_tuple=True)
        if tok.numel() == 0:
            continue
        xe = x2d[tok]
        h = F.silu(mm(xe, p["experts_gate"][e])) * mm(xe, p["experts_up"][e])
        out.index_add_(0, tok, probs[tok, slot, None] * mm(h, p["experts_down"][e]))
    return out.reshape(shape)


def forward(params: dict, model: dict, tokens: torch.Tensor, rows,
            prec: str = "float32") -> torch.Tensor:
    """Logits (B, len(rows), vocab) in float32 at the positions ``rows`` of
    the prompts ``tokens`` (B, S), which start at position 0."""
    to = ROUND_TO[prec]
    rnd = (lambda t: t) if to is None else (lambda t: t.to(to).float())  # noqa: E731

    def mm(a, b):
        return rnd(a) @ rnd(b)

    eps = model["rms_norm_eps"]
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    with no_tf32(), torch.no_grad():
        x = params["embeddings"]["embed"][tokens].float()
        for layer, layer_type in enumerate(model["layer_types"]):
            p = layer_params(params, model, layer)
            x = x + attention(rmsnorm(x, p["ln1"], eps), p["attn"], model, layer_type,
                              positions, rnd, mm)
            x = x + moe(rmsnorm(x, p["ln2"], eps), p["moe"], model, mm)
            del p
        h = rmsnorm(x[:, list(rows)], params["final_norm"].float(), eps)
        return mm(h, params["embeddings"]["lm_head"].float())


def attended_pairs(seq_len: int, window: int) -> int:
    """(query, key) pairs a causal prompt of ``seq_len`` attends, within
    ``window`` when it is positive."""
    if not window or window >= seq_len:
        return seq_len * (seq_len + 1) // 2
    return window * (window + 1) // 2 + (seq_len - window) * window


def flops(model: dict, batch: int, seq_len: int) -> float:
    """Model FLOPs of a prefill of ``batch`` prompts of ``seq_len`` tokens
    that returns the logits at every position, multiply-adds as two: the
    projections, the attended pairs' QK and PV, the router, each token's
    top-k experts and the head."""
    d, hq, hkv, hd = (model[k] for k in ("hidden_size", "num_attention_heads",
                                          "num_key_value_heads", "head_dim"))
    e, k, f = model["num_experts"], model["num_experts_per_tok"], model["moe_intermediate_size"]
    total = 0.0
    for layer_type in model["layer_types"]:
        window = model["sliding_window"] if layer_type == "sliding_attention" else 0
        total += 2.0 * seq_len * d * (2 * hq * hd + 2 * hkv * hd)
        total += 4.0 * attended_pairs(seq_len, window) * hq * hd
        total += 2.0 * seq_len * d * e + 2.0 * seq_len * k * 3 * d * f
    total += 2.0 * seq_len * d * model["vocab_size"]
    return total * batch
