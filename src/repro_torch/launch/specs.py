"""Shape-and-dtype stand-ins for every model input (no allocation) plus
the in/out sharding assignments for each step kind.

The port of :mod:`repro.launch.specs`.  The reference's
``jax.ShapeDtypeStruct`` / ``jax.eval_shape`` are tensors on the ``meta``
device here, and its ``NamedSharding`` / ``PartitionSpec`` the port's
:class:`~repro_torch.models.sharding.NamedSharding` and spec tuples.  The
functions read a mesh only through its axis sizes, so any object with a
``.shape`` mapping (``{"data": 16, "model": 16}``) stands in for a
256-device mesh.

The port's trainer keeps the optimizer state on the parameters'
placements, as the reference's trainer does; :func:`opt_shardings` (ZeRO-1
over the data axes) is what the reference's dry-run assigns.
"""
from __future__ import annotations

import torch

from ..configs.shapes import ShapeSuite
from ..models import ShardingRules, init_cache, init_params, param_shardings
from ..models.config import ArchConfig
from ..models.layers import torch_dtype
from ..models.sharding import NamedSharding, axis_size
from ..optim import AdamWState, adamw
from ..tree import leaves, tree_map

META = torch.device("meta")


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def batch_specs(cfg: ArchConfig, shape: ShapeSuite) -> dict:
    """Training/prefill batch as meta tensors."""
    b, s = shape.global_batch, shape.seq_len
    if cfg.embedded_inputs:
        inputs = _meta((b, s, cfg.d_model), torch_dtype(cfg))
    else:
        inputs = _meta((b, s), torch.int32)
    out = {"inputs": inputs}
    if shape.kind == "train":
        out["labels"] = _meta((b, s), torch.int32)
    return out


def decode_specs(cfg: ArchConfig, shape: ShapeSuite) -> dict:
    """Decode step inputs: one token + the full KV/state cache (plain
    tensors, KV heads aligned to the current mesh; :func:`cache_shardings`
    places it)."""
    b, s = shape.global_batch, shape.seq_len
    if cfg.embedded_inputs:
        tokens = _meta((b, 1, cfg.d_model), torch_dtype(cfg))
    else:
        tokens = _meta((b, 1), torch.int32)
    return {"tokens": tokens, "cache": init_cache(cfg, b, s, META, place=False),
            "index": _meta((), torch.int32)}


def abstract_params(cfg: ArchConfig):
    return init_params(cfg, torch.Generator(), META)


def abstract_opt_state(cfg: ArchConfig, params_abs):
    init_opt, _ = adamw()
    return init_opt(params_abs)


# ---------------------------------------------------------------------------
# Sharding assignments
# ---------------------------------------------------------------------------


def _dp(rules: ShardingRules):
    return rules.batch


def batch_shardings(cfg, shape, mesh, rules: ShardingRules):
    dp = _dp(rules)
    if cfg.embedded_inputs:
        inp = NamedSharding(mesh, (dp, None, None))
    else:
        inp = NamedSharding(mesh, (dp, None))
    out = {"inputs": inp}
    if shape.kind == "train":
        out["labels"] = NamedSharding(mesh, (dp, None))
    return out


def _zero1_spec(spec: tuple, shape: tuple, mesh, rules: ShardingRules) -> tuple:
    """ZeRO-1: additionally shard optimizer-state leaves over the data
    axes on the first dimension that is unsharded and divisible."""
    dp = _dp(rules)
    if dp is None:
        return spec
    dp_size = axis_size(mesh, dp)
    specs = list(spec) + [None] * (len(shape) - len(spec))
    for i, (dim, s) in enumerate(zip(shape, specs)):
        if s is None and dim % dp_size == 0 and dim >= dp_size:
            specs[i] = dp
            return tuple(specs)
    return spec


def opt_shardings(cfg, params_abs, opt_abs, mesh, rules: ShardingRules):
    """Optimizer-state shardings: params' TP sharding + ZeRO-1 over DP."""
    pshard = param_shardings(params_abs, mesh, rules)

    def zero1(ns: NamedSharding, leaf):
        return NamedSharding(mesh, _zero1_spec(ns.spec, tuple(leaf.shape), mesh, rules))

    m_shard = tree_map(zero1, pshard, params_abs)
    return AdamWState(step=NamedSharding(mesh, ()), m=m_shard, v=m_shard)


def cache_shardings(cfg, cache_abs, mesh, rules: ShardingRules):
    """KV/state cache shardings.

    KV caches (stacked (L, B, S, H, D)): batch over the DP axes; the
    sequence dim over the model axis (flash-decoding style partial
    attention — kv heads may be fewer than the model-axis size, sequence
    always divides it).  Recurrent states (B, ...): batch over DP only.
    """
    dp = _dp(rules)
    model = rules.heads
    dp_size = axis_size(mesh, dp)

    def one(leaf):
        shp = tuple(leaf.shape)
        if len(shp) == 5:  # stacked KV: (L, B, S, H, D)
            spec = [None] * 5
            if dp and shp[1] % dp_size == 0:
                spec[1] = dp
            m = axis_size(mesh, model) if model else 0
            if model and shp[2] % m == 0 and shp[2] >= m:
                spec[2] = model
            return NamedSharding(mesh, tuple(spec))
        if len(shp) >= 2:  # stacked recurrent state: (L, B, ...)
            spec = [None] * len(shp)
            if dp and shp[1] % dp_size == 0:
                spec[1] = dp
            return NamedSharding(mesh, tuple(spec))
        return NamedSharding(mesh, ())

    return tree_map(one, cache_abs)


def local_bytes_of(tree, shardings) -> int:
    """Bytes one device holds of ``tree`` (tensors or meta stand-ins)
    placed by ``shardings`` (a tree of :class:`NamedSharding` of the same
    structure): each leaf with every sharded dim divided by the size of
    its mesh axes."""
    total = 0
    for leaf, ns in zip(leaves(tree), leaves(shardings)):
        n = leaf.numel() * leaf.element_size()
        for ax in ns.spec:
            n //= axis_size(ns.mesh, ax)
        total += n
    return total
