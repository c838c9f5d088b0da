"""Model assembly: block pattern -> stacked layers -> LM steps.

The port of :mod:`repro.models.transformer`.  The parameter tree keeps the
reference's layout (``embeddings``, ``final_norm``, ``scanned`` — one
stack per pattern position, every leaf with a leading layer axis — and
``remainder``), so weights carry across with :func:`params_from_numpy`.
The reference's ``lax.scan`` over the stacks is a Python loop over the
layer index here.

Only the ``attn`` block kind is ported so far; ``local``, ``moe``,
``rglru``, ``mlstm`` and ``slstm`` raise :class:`NotImplementedError`.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..tree import leaves
from .attention import KVCache, attention, decode_attention, init_attention
from .config import ArchConfig
from .layers import (
    embed_tokens,
    init_embeddings,
    init_mlp,
    init_norm_scale,
    logits_head,
    mlp,
    norm,
    torch_dtype,
)

PORTED_KINDS = ("attn",)


def _check_kind(kind: str) -> None:
    if kind not in PORTED_KINDS:
        raise NotImplementedError(
            f"block kind {kind!r} is not ported yet (the port runs {PORTED_KINDS}; "
            "see ROADMAP Queue 1 item 5)")


# ---------------------------------------------------------------------------
# Per-kind block init / apply / decode
# ---------------------------------------------------------------------------


def init_block(cfg: ArchConfig, kind: str, generator: torch.Generator,
               device=None) -> dict:
    _check_kind(kind)
    return {
        "ln1": init_norm_scale(cfg, device),
        "attn": init_attention(cfg, generator, device),
        "ln2": init_norm_scale(cfg, device),
        "mlp": init_mlp(cfg, generator, device),
    }


def apply_block(cfg: ArchConfig, kind: str, p: dict, x, positions, *,
                use_kernels: bool = True):
    """Full-sequence block application. Returns (x, aux_loss)."""
    _check_kind(kind)
    h = norm(cfg, x, p["ln1"])
    x = x + attention(cfg, p["attn"], h, positions, use_kernels=use_kernels)
    x = x + mlp(cfg, p["mlp"], norm(cfg, x, p["ln2"]))
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def init_block_state(cfg: ArchConfig, kind: str, batch: int, max_len: int,
                     device=None):
    _check_kind(kind)
    return KVCache.zeros(cfg, batch, max_len, device=device)


def decode_block(cfg: ArchConfig, kind: str, p: dict, x, state, index):
    """One-token block application. Returns (x, state); the KV cache is
    updated in place (see :func:`decode_attention`)."""
    _check_kind(kind)
    a, state = decode_attention(cfg, p["attn"], norm(cfg, x, p["ln1"]), state, index)
    x = x + a
    x = x + mlp(cfg, p["mlp"], norm(cfg, x, p["ln2"]))
    return x, state


# ---------------------------------------------------------------------------
# Whole-model parameters: stacked groups + remainder
# ---------------------------------------------------------------------------


def _layer_plan(cfg: ArchConfig) -> tuple[int, tuple[str, ...], tuple[str, ...]]:
    """(#stacked super-blocks, pattern, remainder kinds)."""
    pat = cfg.block_pattern
    reps = cfg.n_layers // len(pat)
    rem = cfg.layer_kinds[reps * len(pat):]
    return reps, pat, rem


def _stack(trees: list):
    """Stack a list of identical parameter trees along a new leading axis."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    if isinstance(first, tuple):  # KVCache
        return type(first)(*(_stack([t[i] for t in trees]) for i in range(len(first))))
    return torch.stack(trees)


def _index(tree, i: int):
    """Layer ``i`` of a stacked tree (views, no copy)."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return type(tree)(*(_index(v, i) for v in tree))
    return tree[i]


def init_params(cfg: ArchConfig, generator: torch.Generator, device=None) -> dict:
    """Random parameters drawn from ``generator`` (on the generator's
    device) and placed on ``device``: embeddings first, then each pattern
    position's layers, then the remainder."""
    dev = resolve_device(device)
    for kind in cfg.block_pattern:
        _check_kind(kind)
    reps, pat, rem = _layer_plan(cfg)
    embeddings = init_embeddings(cfg, generator, dev)
    scanned = [
        _stack([init_block(cfg, kind, generator, dev) for _ in range(reps)])
        if reps else None
        for kind in pat
    ]
    remainder = [init_block(cfg, kind, generator, dev) for kind in rem]
    return {
        "embeddings": embeddings,
        "final_norm": init_norm_scale(cfg, dev),
        "scanned": scanned,
        "remainder": remainder,
    }


def params_from_numpy(params, device=None):
    """A parameter tree of numpy arrays (e.g. ``repro``'s ``init_params``
    passed through ``np.asarray``, in the same nested structure) as tensors
    on ``device``: both packages then compute from the same weights.
    bfloat16 leaves are carried as float32 and cast back."""
    dev = resolve_device(device)

    def conv(a):
        if a is None:
            return None
        if isinstance(a, dict):
            return {k: conv(v) for k, v in a.items()}
        if isinstance(a, (list, tuple)):
            return [conv(v) for v in a]
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            return torch.tensor(a.astype(np.float32), device=dev).to(torch.bfloat16)
        return torch.tensor(a, device=dev)

    return conv(params)


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int32, device=device).expand(b, s)


def _embed(cfg: ArchConfig, params: dict, inputs: torch.Tensor) -> torch.Tensor:
    if cfg.embedded_inputs:
        return inputs.to(torch_dtype(cfg))
    return embed_tokens(cfg, params["embeddings"], inputs)


def forward(cfg: ArchConfig, params: dict, inputs: torch.Tensor, positions=None,
            *, use_kernels: bool = True):
    """Training/prefill forward.  ``inputs``: (B, S) int tokens, or
    (B, S, d) embeddings for the VLM/audio stub frontends.
    Returns (logits, aux_loss).  ``use_kernels=False`` runs the plain
    version of every kernel, on any device."""
    b, s = inputs.shape[:2]
    h = _embed(cfg, params, inputs)
    if positions is None:
        positions = _positions(b, s, h.device)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    reps, pat, rem = _layer_plan(cfg)
    for i in range(reps):
        for pos, kind in enumerate(pat):
            h, a = apply_block(cfg, kind, _index(params["scanned"][pos], i), h,
                               positions, use_kernels=use_kernels)
            aux = aux + a
    for kind, p in zip(rem, params["remainder"]):
        h, a = apply_block(cfg, kind, p, h, positions, use_kernels=use_kernels)
        aux = aux + a
    h = norm(cfg, h, params["final_norm"])
    return logits_head(cfg, params["embeddings"], h), aux


def init_cache(cfg: ArchConfig, batch: int, max_len: int, device=None):
    """Decode-state tree matching the stacked/remainder structure."""
    dev = resolve_device(device)
    reps, pat, rem = _layer_plan(cfg)
    scanned = [
        _stack([init_block_state(cfg, kind, batch, max_len, dev)
                for _ in range(reps)]) if reps else None
        for kind in pat
    ]
    remainder = [init_block_state(cfg, kind, batch, max_len, dev) for kind in rem]
    return {"scanned": scanned, "remainder": remainder}


def decode_step(cfg: ArchConfig, params: dict, cache, tokens: torch.Tensor, index):
    """One decode step for the whole model.

    ``tokens``: (B, 1) ints (or (B, 1, d) embeddings); ``index``: the
    position.  Returns (logits (B, 1, vocab), cache); the cache's tensors
    are updated in place (each layer's KV slot ``index`` is written)."""
    h = _embed(cfg, params, tokens)
    reps, pat, rem = _layer_plan(cfg)
    for i in range(reps):
        for pos, kind in enumerate(pat):
            h, _ = decode_block(cfg, kind, _index(params["scanned"][pos], i), h,
                                _index(cache["scanned"][pos], i), index)
    for kind, p, st in zip(rem, params["remainder"], cache["remainder"]):
        h, _ = decode_block(cfg, kind, p, h, st, index)
    h = norm(cfg, h, params["final_norm"])
    return logits_head(cfg, params["embeddings"], h), cache


def prefill(cfg: ArchConfig, params: dict, inputs: torch.Tensor, *,
            use_kernels: bool = True):
    """Prefill: the full forward for the logits, then the decode cache built
    by replaying each prompt position through :func:`decode_step`."""
    b, s = inputs.shape[:2]
    logits, _ = forward(cfg, params, inputs, use_kernels=use_kernels)
    cache = init_cache(cfg, b, s, inputs.device)
    for i in range(s):
        _, cache = decode_step(cfg, params, cache, inputs[:, i:i + 1], i)
    return logits, cache


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------


def lm_loss(cfg: ArchConfig, params: dict, batch: dict) -> torch.Tensor:
    """Causal LM loss.  batch: {"inputs": (B,S) or (B,S,d), "labels": (B,S)}.

    The forward runs the plain versions (``use_kernels=False``): the
    reference's training forward is its chunked jnp attention, and the
    flash kernel has no backward.  The log-softmax is taken in float32."""
    logits, aux = forward(cfg, params, batch["inputs"], use_kernels=False)
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, batch["labels"].long()[..., None])[..., 0]
    return nll.mean() + aux


def count_params(params) -> int:
    return sum(int(np.prod(t.shape)) for t in leaves(params))
