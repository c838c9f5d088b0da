"""Model assembly: block pattern -> stacked layers -> LM steps.

The port of :mod:`repro.models.transformer`.  The parameter tree keeps the
reference's layout (``embeddings``, ``final_norm``, ``scanned`` — one
stack per pattern position, every leaf with a leading layer axis — and
``remainder``), so weights carry across with :func:`params_from_numpy`.
The reference's ``lax.scan`` over the stacks is a Python loop over the
layer index here.  Every block kind of the reference is ported: ``attn``,
``local`` (``attn`` under ``cfg.window``), ``moe``, ``rglru``, ``mlstm``
and ``slstm``.

Decode updates the cache in place: each layer's state is a view into the
stacked cache, so a KV slot is written and a recurrent state is copied
into its view (``copy_``), never rebound.  On a device mesh the cache is
made of DTensors (batch over the data axes, KV heads over the model axis
where it divides them; or, as the dry-run places it, the KV sequence over
the model axis, which decode attends flash-decoding style); each write
lands in the rank's own slice, after the new state is redistributed to the
slice's placements.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..tree import leaves
from .attention import (
    KVCache,
    _heads_axis,
    attention,
    decode_attention,
    init_attention,
)
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
from .moe import init_moe, moe_ffn
from .sharding import shard, to_dtensor
from .rglru import RGLRUState, init_rglru, rglru_block, rglru_decode
from .xlstm import (
    MLSTMState,
    SLSTMState,
    init_mlstm,
    init_slstm,
    mlstm_block,
    mlstm_decode,
    slstm_block,
    slstm_decode,
)


# ---------------------------------------------------------------------------
# Per-kind block init / apply / decode
# ---------------------------------------------------------------------------


def init_block(cfg: ArchConfig, kind: str, generator: torch.Generator,
               device=None) -> dict:
    p = {"ln1": init_norm_scale(cfg, device)}
    if kind in ("attn", "local", "moe"):
        p["attn"] = init_attention(cfg, generator, device)
        p["ln2"] = init_norm_scale(cfg, device)
        if kind == "moe":
            p["moe"] = init_moe(cfg, generator, device)
        else:
            p["mlp"] = init_mlp(cfg, generator, device)
    elif kind == "rglru":
        p["rg"] = init_rglru(cfg, generator, device)
        p["ln2"] = init_norm_scale(cfg, device)
        p["mlp"] = init_mlp(cfg, generator, device)
    elif kind == "mlstm":
        p["mlstm"] = init_mlstm(cfg, generator, device)
    elif kind == "slstm":
        p["slstm"] = init_slstm(cfg, generator, device)
    else:
        raise KeyError(kind)
    return p


def apply_block(cfg: ArchConfig, kind: str, p: dict, x, positions, *,
                use_kernels: bool = True):
    """Full-sequence block application. Returns (x, aux_loss)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = norm(cfg, x, p["ln1"])
    if kind in ("attn", "local", "moe"):
        win = cfg.window if kind == "local" else 0
        x = x + attention(cfg, p["attn"], h, positions, window=win,
                          use_kernels=use_kernels)
        h2 = norm(cfg, x, p["ln2"])
        if kind == "moe":
            ff, aux = moe_ffn(cfg, p["moe"], h2)
            x = x + ff
        else:
            x = x + mlp(cfg, p["mlp"], h2)
    elif kind == "rglru":
        x = x + rglru_block(cfg, p["rg"], h)
        x = x + mlp(cfg, p["mlp"], norm(cfg, x, p["ln2"]))
    elif kind == "mlstm":
        x = x + mlstm_block(cfg, p["mlstm"], h)
    elif kind == "slstm":
        x = x + slstm_block(cfg, p["slstm"], h)
    else:
        raise KeyError(kind)
    return x, aux


def init_block_state(cfg: ArchConfig, kind: str, batch: int, max_len: int,
                     device=None):
    if kind in ("attn", "moe"):
        return KVCache.zeros(cfg, batch, max_len, device=device)
    if kind == "local":
        return KVCache.zeros(cfg, batch, max_len, window=cfg.window, device=device)
    if kind == "rglru":
        return RGLRUState.zeros(cfg, batch, device)
    if kind == "mlstm":
        return MLSTMState.zeros(cfg, batch, device)
    if kind == "slstm":
        return SLSTMState.zeros(cfg, batch, device)
    raise KeyError(kind)


def _write(state, new):
    """Copy a recurrent state's new tensors into ``state``'s (views into
    the stacked cache); returns ``state``.  A DTensor view is written
    through its local slice, with the new state first redistributed to the
    view's placements (never copied onto a view of another layout)."""
    for dst, src in zip(state, new):
        if hasattr(dst, "placements"):
            src = to_dtensor(src, dst.device_mesh)
            if src.placements != dst.placements:
                src = src.redistribute(dst.device_mesh, dst.placements)
            dst.to_local().copy_(src.to_local())
        else:
            dst.copy_(src)
    return state


def decode_block(cfg: ArchConfig, kind: str, p: dict, x, state, index):
    """One-token block application. Returns (x, state); ``state`` is updated
    in place (the KV cache by :func:`decode_attention`, a recurrent state
    by copying the new one into it)."""
    h = norm(cfg, x, p["ln1"])
    if kind in ("attn", "local", "moe"):
        win = cfg.window if kind == "local" else 0
        a, state = decode_attention(cfg, p["attn"], h, state, index, window=win)
        x = x + a
        h2 = norm(cfg, x, p["ln2"])
        if kind == "moe":
            ff, _ = moe_ffn(cfg, p["moe"], h2)
            x = x + ff
        else:
            x = x + mlp(cfg, p["mlp"], h2)
    elif kind == "rglru":
        r, new = rglru_decode(cfg, p["rg"], h, state)
        x = x + r
        x = x + mlp(cfg, p["mlp"], norm(cfg, x, p["ln2"]))
        state = _write(state, new)
    elif kind == "mlstm":
        m, new = mlstm_decode(cfg, p["mlstm"], h, state)
        x = x + m
        state = _write(state, new)
    elif kind == "slstm":
        s, new = slstm_decode(cfg, p["slstm"], h, state)
        x = x + s
        state = _write(state, new)
    else:
        raise KeyError(kind)
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
    h = shard(_embed(cfg, params, inputs), "batch", "sequence", None)
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


def init_cache(cfg: ArchConfig, batch: int, max_len: int, device=None, *,
               place: bool = True):
    """Decode-state tree matching the stacked/remainder structure, placed
    by :func:`place_cache`; with ``place=False`` the states stay plain
    tensors (KV heads still aligned to the mesh), for a caller that places
    them itself (the dry-run, by ``launch.specs.cache_shardings``)."""
    dev = resolve_device(device)
    reps, pat, rem = _layer_plan(cfg)
    cache = {
        "scanned": [_stack([init_block_state(cfg, kind, batch, max_len, dev)
                            for _ in range(reps)]) if reps else None for kind in pat],
        "remainder": [init_block_state(cfg, kind, batch, max_len, dev) for kind in rem],
    }
    return place_cache(cfg, cache) if place else cache


def place_cache(cfg: ArchConfig, cache: dict) -> dict:
    """``cache`` placed as the serving and training paths place it: on a
    mesh every state is sharded over the batch, and KV heads as the
    attention projections shard them; the identity without a mesh."""
    _, pat, rem = _layer_plan(cfg)
    return {"scanned": [_shard_state(cfg, kind, st, stacked=True) if st is not None else None
                        for kind, st in zip(pat, cache["scanned"])],
            "remainder": [_shard_state(cfg, kind, st)
                          for kind, st in zip(rem, cache["remainder"])]}


def _shard_state(cfg: ArchConfig, kind: str, state, stacked: bool = False):
    """A block's decode state placed on the current mesh (as it is without
    one): KV (B, S, H, D) over batch and heads, recurrent states over the
    batch only, as the reference pins them."""
    lead = (None,) if stacked else ()
    if kind in ("attn", "local", "moe"):
        spec = lead + ("batch", None, _heads_axis(cfg), None)
        return type(state)(*(shard(t, *spec) for t in state))
    return type(state)(*(shard(t, *lead, "batch", *(None,) * (t.dim() - len(lead) - 1))
                         for t in state))


def decode_step(cfg: ArchConfig, params: dict, cache, tokens: torch.Tensor, index):
    """One decode step for the whole model.

    ``tokens``: (B, 1) ints (or (B, 1, d) embeddings); ``index``: the
    position.  Returns (logits (B, 1, vocab), cache); the cache's tensors
    are updated in place (each layer's KV slot ``index`` is written, each
    recurrent state overwritten)."""
    h = shard(_embed(cfg, params, tokens), "batch", None, None)
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
