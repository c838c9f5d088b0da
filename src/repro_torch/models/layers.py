"""Shared LM layers: norms, rotary embeddings, gated MLPs, heads.

The port of :mod:`repro.models.layers`, with the reference's ``shard(...)``
annotations (:mod:`.sharding`): without a device mesh the annotations are
the identity.  Initialisers draw from an explicit ``torch.Generator`` on
the generator's own device and place the result on ``device``.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from .config import ArchConfig, YarnConfig
from .sharding import shard

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(cfg: ArchConfig) -> torch.dtype:
    """The compute dtype named by ``cfg.dtype``."""
    if cfg.dtype not in _DTYPES:
        raise ValueError(f"dtype must be one of {tuple(_DTYPES)}, got {cfg.dtype!r}")
    return _DTYPES[cfg.dtype]


def normal(generator: torch.Generator, shape, scale: float, dtype, device):
    """``N(0, 1) * scale`` drawn in float32 from ``generator``, cast to
    ``dtype`` and placed on ``device`` (the reference's init recipe).  On
    the ``meta`` device only the shape and dtype are made (nothing is
    drawn): the reference's ``jax.eval_shape`` of an init."""
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    x = torch.randn(shape, generator=generator, device=generator.device)
    return (x * scale).to(dtype).to(device)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor | None, eps: float = 1e-6):
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    if scale is not None:
        out = out * (1.0 + scale.float())
    return out.to(x.dtype)


def nonparam_layernorm(x: torch.Tensor, eps: float = 1e-5):
    """OLMo-style non-parametric LayerNorm (no scale/bias)."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype)


def norm(cfg: ArchConfig, x: torch.Tensor, scale: torch.Tensor | None):
    if cfg.norm == "nonparam_ln":
        return nonparam_layernorm(x)
    return rmsnorm(x, scale)


def init_norm_scale(cfg: ArchConfig, device=None) -> torch.Tensor:
    dev = resolve_device(device)
    if cfg.norm == "nonparam_ln":
        return torch.zeros((1,), dtype=torch_dtype(cfg), device=dev)  # unused leaf
    return torch.zeros((cfg.d_model,), dtype=torch_dtype(cfg), device=dev)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=16)
def _rope_freqs(d: int, theta: float, device: torch.device,
                yarn: YarnConfig | None = None) -> torch.Tensor:
    """The rotary frequencies, built once per (d, theta, yarn, device): a
    fresh host-to-device copy in every call would make the host wait for
    the device twice per layer of each decode step."""
    if yarn is not None:
        return torch.as_tensor(yarn_inv_freq(d, theta, yarn), dtype=torch.float32,
                               device=device)
    freqs = 1.0 / (theta ** (np.arange(0, d // 2, dtype=np.float32) * 2.0 / d))
    return torch.as_tensor(freqs, dtype=torch.float32, device=device)


def yarn_correction_range(d: int, theta: float, yarn: YarnConfig) -> tuple[int, int]:
    """The dimensions (``low``, ``high``) between which YaRN's ramp runs:
    where a frequency turns ``beta_fast`` and ``beta_slow`` times in the
    original context, floored and ceiled, clamped to ``[0, d - 1]``."""
    def corr(rotations):
        return (d * math.log(yarn.original_max_position_embeddings / (rotations * 2 * math.pi))
                / (2 * math.log(theta)))
    low, high = math.floor(corr(yarn.beta_fast)), math.ceil(corr(yarn.beta_slow))
    return max(low, 0), min(high, d - 1)


def yarn_inv_freq(d: int, theta: float, yarn: YarnConfig) -> np.ndarray:
    """YaRN's inverse frequencies in float32: the original ones
    ``theta^(-2i/d)`` past ``high``, those ``factor`` times slower below
    ``low``, blended linearly between."""
    pos_freqs = theta ** (np.arange(0, d, 2, dtype=np.float32) / np.float32(d))
    extra, inter = 1.0 / pos_freqs, 1.0 / (np.float32(yarn.factor) * pos_freqs)
    low, high = yarn_correction_range(d, theta, yarn)
    span = high - low if high != low else 0.001
    ramp = np.clip((np.arange(d // 2, dtype=np.float32) - low) / np.float32(span), 0, 1)
    return (inter * ramp + extra * (1 - ramp)).astype(np.float32)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
         yarn: YarnConfig | None = None) -> torch.Tensor:
    """x: (..., S, H, D); positions: (..., S).  Frequencies are built in
    numpy float32 and the rotation computed in float32, as the reference
    does.  With ``yarn`` the frequencies are YaRN's and cos and sin are
    scaled by its ``attention_factor`` (so q . k by its square)."""
    d = x.shape[-1]
    half = d // 2
    # a meta tensor (the dry-run's traces) is free to make, and a cached one
    # would carry one trace's fake tensors into the next
    freqs = (_rope_freqs.__wrapped__ if x.device.type == "meta" else _rope_freqs)(
        d, theta, x.device, yarn)
    ang = positions[..., None].float() * freqs  # (..., S, half)
    sin = torch.sin(ang)[..., None, :]  # broadcast over heads
    cos = torch.cos(ang)[..., None, :]
    if yarn is not None:
        sin, cos = sin * yarn.attention_factor, cos * yarn.attention_factor
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Gated MLP (SwiGLU / GeGLU)
# ---------------------------------------------------------------------------


def init_mlp(cfg: ArchConfig, generator: torch.Generator, device=None) -> dict:
    d, ff = cfg.d_model, cfg.d_ff
    dev, dt = resolve_device(device), torch_dtype(cfg)
    s_in, s_out = 1.0 / np.sqrt(d), 1.0 / np.sqrt(ff)
    return {
        "w_gate": normal(generator, (d, ff), s_in, dt, dev),
        "w_up": normal(generator, (d, ff), s_in, dt, dev),
        "w_down": normal(generator, (ff, d), s_out, dt, dev),
    }


def _act(cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return F.silu(x) if cfg.act == "silu" else F.gelu(x, approximate="tanh")


def mlp(cfg: ArchConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    g = shard(x @ p["w_gate"], "batch", None, "d_ff")
    u = shard(x @ p["w_up"], "batch", None, "d_ff")
    h = _act(cfg, g) * u
    # sequence-parallel residual stream: reduce-scatter instead of
    # all-reduce when rules.sequence is set (Megatron-SP)
    return shard(h @ p["w_down"], "batch", "sequence", None)


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------


def init_embeddings(cfg: ArchConfig, generator: torch.Generator,
                    device=None) -> dict:
    dev, dt = resolve_device(device), torch_dtype(cfg)
    out = {}
    if not cfg.embedded_inputs:
        out["embed"] = normal(generator, (cfg.vocab, cfg.d_model), 0.02, dt, dev)
    if not cfg.tie_embeddings or cfg.embedded_inputs:
        out["lm_head"] = normal(generator, (cfg.d_model, cfg.vocab),
                                1.0 / np.sqrt(cfg.d_model), dt, dev)
    return out


def embed_tokens(cfg: ArchConfig, params: dict, tokens: torch.Tensor):
    tokens = shard(tokens, "batch", *(None,) * (tokens.dim() - 1))
    w = params["embed"]
    h = _sharded_lookup(w, tokens) if hasattr(w, "placements") else w[tokens]
    return shard(h, "batch", "sequence", None)


def _sharded_lookup(w, tokens):
    """``w[tokens]`` for a DTensor table, on each rank's own rows: where the
    vocab is sharded (Megatron's vocab-parallel embedding) each rank looks
    up the tokens in its block of rows and zeros the rest, and the result
    is a partial sum over those mesh dims.  (DTensor's own rules for this
    gather differ between PyTorch versions; this is one plain gather.)"""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    w = shard(w, "vocab", None)
    mesh = w.device_mesh
    vocab_dims = [i for i, pl in enumerate(w.placements) if pl.is_shard(0)]
    # the table's gradient: its own rows on vocab dims, a partial sum where
    # ranks saw different tokens
    w_grad = [pl if i in vocab_dims else
              (Partial() if tokens.placements[i].is_shard() else Replicate())
              for i, pl in enumerate(w.placements)]
    w_loc = w.to_local(grad_placements=w_grad)
    tok = tokens.to_local()
    if vocab_dims:
        rows, block = w_loc.shape[0], 0
        for i in vocab_dims:  # this rank's block of rows, row-major over the dims
            block = block * mesh.size(i) + mesh.get_local_rank(i)
        tok = tok - block * rows
        mine = (tok >= 0) & (tok < rows)
        h = w_loc[torch.where(mine, tok, 0)] * mine[..., None].to(w_loc.dtype)
    else:
        h = w_loc[tok]
    out_pl = [Partial() if i in vocab_dims else pl for i, pl in enumerate(tokens.placements)]
    return DTensor.from_local(h, mesh, out_pl, run_check=False)


def logits_head(cfg: ArchConfig, params: dict, h: torch.Tensor) -> torch.Tensor:
    w = params.get("lm_head")
    if w is None:  # tied
        w = params["embed"].T
    return shard(h @ w, "batch", None, "vocab")
