"""Logical-axis sharding rules (MaxText-style) for the LM substrate.

The port of :mod:`repro.models.sharding`.  Model code annotates
activations with *logical* axis names; the rules map them to mesh axes.
With no mesh active every annotation is the identity, so the same model
code runs on one device and on a ``(data, model)`` mesh unchanged.

The reference's ``PartitionSpec`` is a plain tuple here (one mesh-axis
name, a tuple of names, or ``None`` per tensor dim), its ``NamedSharding``
the small dataclass below, and GSPMD's propagation is PyTorch's
``DTensor``: a mesh is a ``torch.distributed.device_mesh.DeviceMesh``
with named dims, and :func:`NamedSharding.placements` turns a spec into
DTensor placements (a tensor dim over ``("pod", "data")`` is ``Shard(i)``
on both mesh dims).  :func:`shard` is the reference's
``with_sharding_constraint``: it redistributes a DTensor to the spec (a
plain tensor counts as replicated, as every JAX array is global), and
:func:`distribute` is ``jax.device_put`` for a tree.

While a mesh is active, plain tensors that meet DTensors in one op (the
rotary tables, positions, scalars) count as replicated
(``implicit_replication``), as constants do under ``jit``.
"""
from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass, replace

import torch

from ..tree import leaf_paths, tree_map, unflatten


@dataclass(frozen=True)
class ShardingRules:
    """Logical axis -> mesh axis (or tuple of mesh axes, or None)."""

    batch: tuple[str, ...] | str | None = None  # e.g. ("pod", "data")
    sequence: str | None = None  # sequence parallelism (long context)
    heads: str | None = None  # TP over attention heads
    d_ff: str | None = None  # TP over MLP hidden
    experts: str | None = None  # EP over MoE experts
    vocab: str | None = None  # TP over vocab/logits
    d_model: str | None = None  # rarely sharded (all-gather heavy)

    def spec(self, *logical: str | None) -> tuple:
        return tuple(getattr(self, ax) if ax else None for ax in logical)


#: Production rules for the (pod, data, model) / (data, model) meshes.
def production_rules(multi_pod: bool = False) -> ShardingRules:
    dp = ("pod", "data") if multi_pod else ("data",)
    return ShardingRules(
        batch=dp,
        sequence=None,
        heads="model",
        d_ff="model",
        experts="model",
        vocab="model",
    )


def tuned_rules(arch: str, multi_pod: bool = False) -> ShardingRules:
    """The reference's tuned rules: baseline TP plus Megatron-style
    sequence parallelism (the residual stream shards on seq over the model
    axis; per-layer all-reduces become reduce-scatter/all-gather pairs).
    The sLSTM recurrence stays batch-only inside the model itself."""
    return replace(production_rules(multi_pod), sequence="model")


_STATE = threading.local()


def current_rules() -> ShardingRules | None:
    return getattr(_STATE, "rules", None)


def current_mesh():
    return getattr(_STATE, "mesh", None)


@contextlib.contextmanager
def use_sharding(mesh, rules: ShardingRules | None):
    """Make ``mesh`` and ``rules`` current on this thread.  With a mesh,
    plain tensors meeting DTensors count as replicated for the duration."""
    prev = (current_mesh(), current_rules())
    _STATE.mesh, _STATE.rules = mesh, rules
    try:
        if mesh is None:
            yield
        else:
            from torch.distributed.tensor.experimental import implicit_replication

            with implicit_replication():
                yield
    finally:
        _STATE.mesh, _STATE.rules = prev


def _axes(ax) -> tuple:
    if ax is None:
        return ()
    return ax if isinstance(ax, tuple) else (ax,)


def axis_size(mesh, ax) -> int:
    """The product of the sizes of the mesh axes ``ax`` names, on a
    ``DeviceMesh`` (by its dim names) or on any object with a ``.shape``
    mapping, as a JAX mesh has."""
    names = getattr(mesh, "mesh_dim_names", None)
    sizes = dict(zip(names, tuple(mesh.shape))) if names is not None else dict(mesh.shape)
    n = 1
    for a in _axes(ax):
        n *= int(sizes[a])
    return n


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the reference's ``jax.sharding.NamedSharding``)."""

    mesh: object
    spec: tuple

    def placements(self) -> tuple:
        """One DTensor placement per mesh dim: ``Shard(i)`` where tensor dim
        ``i``'s spec names the mesh dim, else ``Replicate()``."""
        from torch.distributed.tensor import Replicate, Shard

        names = self.mesh.mesh_dim_names
        out = [Replicate()] * len(names)
        for i, ax in enumerate(self.spec):
            axes = _axes(ax)
            idx = [names.index(a) for a in axes]
            if idx != sorted(idx):
                raise ValueError(
                    f"spec {self.spec} splits dim {i} over mesh axes {axes} out "
                    f"of the mesh's order {names}")
            for j in idx:
                out[j] = Shard(i)
        return tuple(out)


def to_dtensor(x: torch.Tensor, mesh):
    """``x`` as a DTensor on ``mesh``: a DTensor as it is, a plain tensor
    (the same on every rank, as every JAX array is global) replicated
    without communication."""
    from torch.distributed.tensor import DTensor, Replicate

    if isinstance(x, DTensor):
        return x
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim, run_check=False)


def shard(x: torch.Tensor, *logical: str | None) -> torch.Tensor:
    """Annotate an activation with logical axes; the identity without a
    mesh.  Axes the mesh does not divide are dropped (e.g. 56 q-heads on a
    16-way model axis) rather than sharding unevenly."""
    rules, mesh = current_rules(), current_mesh()
    if rules is None or mesh is None:
        return x
    spec = _divisible(rules.spec(*logical), tuple(x.shape), mesh)
    x = to_dtensor(x, mesh)
    want = NamedSharding(mesh, spec).placements()
    if tuple(x.placements) == want:
        return x
    return x.redistribute(mesh, want)


# ---------------------------------------------------------------------------
# Parameter shardings by tree-path pattern
# ---------------------------------------------------------------------------

_PARAM_RULES: tuple[tuple[str, tuple[str | None, ...]], ...] = (
    # name-fragment -> logical axes per dim (matched right-aligned);
    # first match wins, so lm_head must precede the "embed" fragment
    ("lm_head", (None, "vocab")),
    ("embed", ("vocab", None)),
    ("wq", (None, "heads")),
    ("wk", (None, "heads")),
    ("wv", (None, "heads")),
    ("wo", ("heads", None)),
    ("w_gate", (None, "d_ff")),
    ("w_up", (None, "d_ff")),
    ("w_down", ("d_ff", None)),
    ("router", (None, "experts")),
    # expert weights shard over the expert (EP) axis only — d_ff is small
    # per expert and the EP axis already consumes the mesh's model axis
    ("experts_gate", ("experts", None, None)),
    ("experts_up", ("experts", None, None)),
    ("experts_down", ("experts", None, None)),
    ("rg_in", (None, "d_ff")),
    ("rg_gate", (None, "d_ff")),
    ("rg_out", ("d_ff", None)),
    ("lstm_qkv", (None, "heads")),
    ("lstm_out", ("heads", None)),
)


def spec_for_param(path: str, ndim: int, rules: ShardingRules) -> tuple:
    for frag, logical in _PARAM_RULES:
        if frag in path:
            axes = [None] * ndim
            # right-align the logical axes onto the trailing dims
            lg = logical[-ndim:] if ndim <= len(logical) else logical
            axes[-len(lg):] = [getattr(rules, a) if a else None for a in lg]
            # stacked-layer leading dim stays unsharded
            return tuple(axes)
    return ()  # replicate (norms, biases, gates)


def _divisible(spec: tuple, shape: tuple, mesh) -> tuple:
    """Drop sharding on dims the mesh axis does not divide (e.g. the
    49,155-row granite-moe vocab on a 16-way axis -> replicate)."""
    out = []
    for i, ax in enumerate(spec):
        if ax is None:
            out.append(None)
            continue
        size = axis_size(mesh, ax)
        out.append(ax if (i < len(shape) and shape[i] % size == 0) else None)
    return tuple(out)


def param_shardings(params, mesh, rules: ShardingRules):
    """A tree of :class:`NamedSharding`, one per parameter leaf."""
    shardings = []
    for path, leaf in leaf_paths(params):
        spec = spec_for_param("/".join(str(k) for k in path), leaf.ndim, rules)
        shardings.append(NamedSharding(mesh, _divisible(spec, tuple(leaf.shape), mesh)))
    return unflatten(params, shardings)


def distribute(tree, shardings):
    """Each tensor leaf of ``tree`` (the same full value on every rank)
    placed on its sharding's mesh: the reference's ``jax.device_put`` of a
    tree.  Each rank keeps its own slice; nothing is sent."""
    from torch.distributed.tensor import distribute_tensor

    def one(x, s):
        if s is None:
            return x
        return distribute_tensor(x, s.mesh, s.placements(), src_data_rank=None)

    return tree_map(one, tree, shardings)


# ---------------------------------------------------------------------------
# shard_map islands
# ---------------------------------------------------------------------------


def on_shards(fn, *tensors, extra=()):
    """``fn(*local tensors, *extra)`` on each rank's own shards, the result
    placed as the first tensor is: the reference's ``shard_map`` island, as
    ``local_map`` (``fn`` itself when no mesh is active).  Each tensor is
    passed with its own placements, so the caller shards them to agree;
    ``extra`` (positions, flags, :func:`local_param` weights) goes in as it
    is.  A plain tensor among ``tensors`` under a mesh is an error: its
    writes (a decode cache) would not reach a sharded copy."""
    mesh = current_mesh()
    if mesh is None:
        return fn(*tensors, *extra)
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import local_map

    plain = [i for i, t in enumerate(tensors) if not isinstance(t, DTensor)]
    if plain:
        raise TypeError(f"on_shards: arguments {plain} are plain tensors under a "
                        "device mesh; make them DTensors (shard, init_cache) first")
    # a list of placements is one tensor's (a tuple would be one per output)
    places = tuple(list(t.placements) for t in tensors)
    return local_map(fn, out_placements=places[0],
                     in_placements=places + (None,) * len(extra),
                     device_mesh=mesh)(*tensors, *extra)


def local_param(p: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A weight, whole, as a plain tensor for an :func:`on_shards` island
    that runs on ``like``'s shards: its gradient there is a partial sum over
    every mesh dim ``like`` is sharded on (each rank saw its own rows)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    if current_mesh() is None or not isinstance(like, DTensor):
        return p
    p = shard(p, *(None,) * p.dim())
    return p.to_local(grad_placements=[Partial() if isinstance(pl, Shard) else Replicate()
                                       for pl in like.placements])
