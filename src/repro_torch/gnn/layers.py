"""GNN layers in PyTorch with explicit multiphase execution policies.

The port of :mod:`repro.gnn.layers`.  Each layer is a two-phase
sparse/dense chain (aggregation = SpMM over the padded-ELL adjacency,
combination = GEMM).  The inter-phase dataflow is a *program structure*:

  * ``seq``        — materialize the full V x F intermediate, then GEMM
                     (paper Seq: intermediate round-trips through memory).
  * ``sp_generic`` — a loop over row bands; each band's intermediate is
                     produced and consumed inside one step (paper
                     SP-Generic at row granularity).
  * ``sp_opt``     — the fused band step keeps the aggregated tile as the
                     immediate GEMM operand; on the card this is the fused
                     CUDA kernel (:mod:`repro_torch.kernels.fused_agg_cmb`),
                     eagerly its band loop (paper SP-Optimized).
  * ``pp``         — producer/consumer device groups, each on a CUDA
                     stream of its own (:mod:`repro_torch.gnn.pp`);
                     without a mesh, its SP-Generic fallback.

Phase order is a knob too: ``AC`` computes (A·X)·W, ``CA`` computes
A·(X·W) — same result, different cost (paper Sec. 3.3).

Each executable path registers itself in the kernel registry
(:mod:`repro_torch.core.registry`) keyed by the ExecSpec fields
``(policy, order, use_pallas)``; ``use_pallas`` keeps the reference's key
and means "the hand-written kernel tier".  Dense products give each row a
result that does not depend on the call's row count, so a row partition
and the whole graph agree bit for bit: on the kernel tier they run the
``gemm_dataflow`` kernel (:func:`kernel_matmul`), on the eager tier
:func:`repro_torch.kernels.common.row_matmul` (fixed row tiles, full
float32: the package turns TF32 off).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from .. import trace
from ..core.registry import lookup_kernel, register_kernel
from ..core.schedule import ExecSpec
from ..device import resolve_device
from ..graphs.csr import CSRGraph
from ..kernels.common import row_matmul
from ..kernels.fused_agg_cmb.ops import fused_agg_cmb
from ..kernels.gemm_dataflow.ops import gemm
from ..kernels.spmm.ops import spmm

POLICIES = ("seq", "sp_generic", "sp_opt", "pp")


@dataclass(frozen=True)
class EllAdjacency:
    """Device-side padded-ELL adjacency (see CSRGraph.to_ell).
    ``nonzero``, the slots whose weight is not zero, is counted on the
    host when the adjacency is built from a graph (None otherwise)."""

    indices: torch.Tensor  # (V_pad, D) int32
    weights: torch.Tensor  # (V_pad, D) f32 — zero on padded slots
    n_nodes: int
    nonzero: int | None = None

    @classmethod
    def from_csr(
        cls, g: CSRGraph, block_rows: int = 1, pad_to: int | None = None,
        device=None,
    ) -> "EllAdjacency":
        """``pad_to`` fixes the padded-ELL width D (>= the graph's max
        degree): batched serving pads every micro-batch of a bucket to the
        same D so rebinding never changes the device shapes."""
        if pad_to is not None and pad_to < g.max_degree:
            raise ValueError(
                f"pad_to={pad_to} is narrower than the graph's max degree "
                f"{g.max_degree}; neighbor lists would be truncated"
            )
        dev = resolve_device(device)
        idx, wts, _ = g.to_ell(block_rows, pad_to=pad_to)
        return cls(
            torch.as_tensor(np.ascontiguousarray(idx, np.int32), device=dev),
            torch.as_tensor(np.ascontiguousarray(wts, np.float32), device=dev),
            g.n_nodes,
            int(np.count_nonzero(wts)),
        )

    @classmethod
    def from_schedule(
        cls, g: CSRGraph, schedule, pad_to: int | None = None, device=None
    ) -> "EllAdjacency":
        """Build the adjacency with a ModelSchedule's lowered ELL block
        rows, so every layer's band loop walks aligned row groups."""
        return cls.from_csr(
            g, block_rows=schedule.ell_block_rows, pad_to=pad_to,
            device=device,
        )

    @property
    def v_pad(self) -> int:
        return self.indices.shape[0]


# ---------------------------------------------------------------------------
# Aggregation (SpMM) primitives
# ---------------------------------------------------------------------------


def aggregate_band(
    indices: torch.Tensor, weights: torch.Tensor, x: torch.Tensor
) -> torch.Tensor:
    """Aggregation for one row band: indices/weights (B, D).

    Each row sums its D weighted slots over a pairwise tree: the slots
    zero-padded to a power of two, then the upper half added onto the
    lower half until one is left.  Every step is an elementwise op, so a
    row's sum does not depend on the band's row count (a batched product
    may pick its reduction from it); and zero slots past a row's last
    real one only add exact zeros, so the sum does not depend on D either.

    It is differentiable: when autograd needs it, the same forward runs
    inside :class:`_AggregateBand`, whose backward scatters ``w * g`` back
    onto the gathered rows of ``x``; the forward's bits are the same
    either way.  The forward, and each backward product that walks the
    slots, counts its B x D slots on the ``agg.slots`` counter
    (:mod:`repro_torch.trace`).
    """
    if torch.is_grad_enabled() and (weights.requires_grad or x.requires_grad):
        return _AggregateBand.apply(indices, weights, x)
    return _aggregate_band(indices, weights, x)


def _aggregate_band(indices, weights, x) -> torch.Tensor:
    """The pairwise-tree forward of :func:`aggregate_band` (no autograd)."""
    b, d = indices.shape
    trace.count("agg.slots", b * d)
    dt = torch.promote_types(weights.dtype, x.dtype)
    width = 1 << max(d - 1, 0).bit_length()
    terms = torch.zeros((b, width, x.shape[1]), dtype=dt, device=x.device)
    torch.mul(
        weights.to(dt)[:, :, None],
        x.index_select(0, indices.reshape(-1)).reshape(b, d, x.shape[1]).to(dt),
        out=terms[:, :d],
    )
    while width > 1:
        width //= 2
        terms[:, :width] += terms[:, width:2 * width]
    return terms[:, 0]


class _AggregateBand(torch.autograd.Function):
    """:func:`aggregate_band` with a backward: ``dx[idx[v, d]] += w[v, d] *
    g[v]`` and ``dw[v, d] = g[v] . x[idx[v, d]]``.  ``dx`` sums each row's
    terms in slot order (a stable sort by row, then one segment sum a row),
    with no atomics: a step repeated on the card gives the same bits.

    A slot of weight zero adds ``0 * g = ±0``, which leaves a sum that
    starts at +0 unchanged wherever it lands; so it is keyed not to its
    index but to its flat slot position modulo ``x``'s rows.  Padded slots
    all point at row 0, and on the card ``segment_reduce`` walks each
    (segment, column) in one thread: keyed by index, row 0's segment would
    hold every padded slot of the band (10,400 terms at cora), keyed by
    position no row gets more than ⌈B·D / rows⌉ of them.  Only a
    non-finite ``g`` at such a slot tells the two apart: its NaN lands on
    the row the slot is keyed to, not on row 0.

    The backward reads nothing on the host, so a captured training step
    holds it: ``segment_reduce`` runs ``unsafe``, without its checks of
    ``lengths`` (a negative length, lengths that miss the row count), which
    read the device from the host; the lengths are counts of the keys, so
    they hold by construction."""

    @staticmethod
    def forward(ctx, indices, weights, x):
        ctx.save_for_backward(indices, weights, x)
        return _aggregate_band(indices, weights, x)

    @staticmethod
    def backward(ctx, g):
        indices, weights, x = ctx.saved_tensors
        b, d = indices.shape
        flat = indices.reshape(-1).long()
        gw = gx = None
        if ctx.needs_input_grad[1]:
            trace.count("agg.slots", b * d)
            rows = x.index_select(0, flat).reshape(b, d, -1).to(g.dtype)
            gw = (rows * g[:, None, :]).sum(-1).to(weights.dtype)
        if ctx.needs_input_grad[2]:
            trace.count("agg.slots", b * d)
            terms = (weights.to(g.dtype)[:, :, None] * g[:, None, :]).reshape(b * d, -1)
            spread = torch.arange(b * d, device=flat.device) % x.shape[0]
            key = torch.where(weights.reshape(-1) != 0, flat, spread)
            order = torch.argsort(key, stable=True)
            rows = torch.zeros(x.shape[0], dtype=torch.int64, device=flat.device)
            rows.scatter_add_(0, key, torch.ones_like(key))
            gx = torch.segment_reduce(terms[order], "sum", lengths=rows, axis=0,
                                      unsafe=True)
            gx = gx.to(x.dtype)
        return None, gw, gx


def aggregate_full(adj: EllAdjacency, x: torch.Tensor) -> torch.Tensor:
    """Whole-graph aggregation: out[v] = sum_d w[v,d] * x[idx[v,d]]."""
    return aggregate_band(adj.indices, adj.weights, x)


def _band_scan(
    adj: EllAdjacency,
    x: torch.Tensor,
    band_fn: Callable[[torch.Tensor], torch.Tensor],
    band_size: int,
) -> torch.Tensor:
    """Run ``band_fn`` on each band's aggregation, band by band (rows are
    independent, so the ragged last band needs no padding)."""
    return torch.cat([
        band_fn(aggregate_band(
            adj.indices[s:s + band_size], adj.weights[s:s + band_size], x
        ))
        for s in range(0, adj.v_pad, band_size)
    ])


# ---------------------------------------------------------------------------
# Registered executable paths (keyed by ExecSpec fields)
# ---------------------------------------------------------------------------


@register_kernel("seq", orders=("AC",))
def _seq_ac(adj, x, w, spec, mesh):
    """Seq/AC: materialize the full aggregated intermediate, then GEMM."""
    return row_matmul(aggregate_full(adj, x), w)[: adj.n_nodes]


@register_kernel("seq", orders=("CA",))
def _seq_ca(adj, x, w, spec, mesh):
    """Seq/CA: dense GEMM first, then whole-graph aggregation."""
    return aggregate_full(adj, row_matmul(x, w))[: adj.n_nodes]


def kernel_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The kernel tier's dense product: the hand-written ``gemm_dataflow``
    kernel (output-stationary, one launch), whose float32 route sums each
    output over F in an order set by F and G alone; on a CPU tensor its
    plain version, :func:`~repro_torch.kernels.common.row_matmul`.  Either
    way a row's result does not depend on the call's row count."""
    return gemm(x.contiguous(), w.contiguous())


def _tier_matmul(kw) -> Callable:
    """The dense product of a layer's tier, for the products outside the
    registered kernels (SAGE / GIN self terms, GIN's second product)."""
    spec = kw.get("spec")
    on_kernels = spec.use_pallas if spec is not None else bool(kw.get("use_pallas"))
    return kernel_matmul if on_kernels else row_matmul


@register_kernel("seq", pallas=(True,))
def _seq_kernel(adj, x, w, spec, mesh):
    """Seq on the card's kernels: the aggregation through the CUDA ELL
    SpMM, the combination through the ``gemm_dataflow`` kernel."""
    feats = kernel_matmul(x, w) if spec.order == "CA" else x
    h = spmm(
        adj.indices,
        adj.weights,
        feats,
        block_v=spec.band_size,
        block_f=spec.block_f or 128,
    )
    if spec.order == "CA":
        return h[: adj.n_nodes]
    return kernel_matmul(h, w)[: adj.n_nodes]


@register_kernel("sp_generic", orders=("AC",))
@register_kernel("sp_opt", orders=("AC",))
def _sp_ac(adj, x, w, spec, mesh):
    """SP/AC band loop: each band's intermediate lives inside one step and
    is consumed at once as the GEMM operand — the eager body of both
    SP-Generic and SP-Optimized."""
    return _band_scan(
        adj, x, lambda h: row_matmul(h, w), spec.band_size
    )[: adj.n_nodes]


@register_kernel("sp_generic", orders=("CA",))
@register_kernel("sp_opt", orders=("CA",))
def _sp_ca(adj, x, w, spec, mesh):
    """SP/CA: aggregate the combined features band by band."""
    return _band_scan(
        adj, row_matmul(x, w), lambda h: h, spec.band_size
    )[: adj.n_nodes]


@register_kernel("sp_opt", orders=("AC",), pallas=(True,))
def _sp_opt_fused(adj, x, w, spec, mesh):
    """SP-Optimized/AC on the card: the fused aggregation+combination
    kernel."""
    return fused_agg_cmb(
        adj.indices,
        adj.weights,
        x,
        w,
        band_size=spec.band_size,
        block_f=spec.block_f,
    )[: adj.n_nodes]


@register_kernel("pp")
def _pp(adj, x, w, spec, mesh):
    """Parallel Pipeline: producer/consumer device groups
    (:mod:`repro_torch.gnn.pp`)."""
    from .pp import pp_multiphase_matmul

    return pp_multiphase_matmul(
        adj, x, w, order=spec.order, mesh=mesh, band_size=spec.band_size,
        use_kernels=spec.use_pallas,
    )


# ---------------------------------------------------------------------------
# Two-phase execution under a multiphase policy
# ---------------------------------------------------------------------------


def multiphase_matmul(
    adj: EllAdjacency,
    x: torch.Tensor,
    w: torch.Tensor,
    policy: str | None = None,
    order: str | None = None,
    band_size: int | None = None,
    use_pallas: bool | None = None,
    mesh=None,
    block_f: int | None = None,
    spec: ExecSpec | None = None,
    kernel: Callable | None = None,
) -> torch.Tensor:
    """Execute aggregation + combination under an inter-phase policy.

    AC: (A @ X) @ W.  CA: A @ (X @ W).

    ``spec`` (an ExecSpec, the lowered form of a mapper-chosen
    LayerSchedule) is the single source of truth when one is provided:
    passing an explicit ``policy`` / ``order`` / ``band_size`` /
    ``block_f`` / ``use_pallas`` kwarg that disagrees with the spec raises
    :class:`ValueError` rather than being silently ignored.  Without a
    spec, the string knobs build one (defaults: ``sp_opt`` / ``AC`` /
    band 128), so both entry styles dispatch through the same registry.
    ``kernel`` is the registry entry already resolved for ``spec`` (a
    :class:`~repro_torch.api.Program` resolves its kernels once, when it
    builds an executable); without it the registry is consulted here.
    """
    if spec is not None:
        given = dict(
            policy=policy,
            order=order,
            band_size=band_size,
            block_f=block_f,
            use_pallas=use_pallas,
        )
        conflicts = {
            k: v
            for k, v in given.items()
            if v is not None and v != getattr(spec, k)
        }
        if conflicts:
            raise ValueError(
                f"multiphase_matmul got an ExecSpec plus conflicting explicit "
                f"kwargs {conflicts}; the spec has "
                f"{ {k: getattr(spec, k) for k in conflicts} } — pass one or "
                f"the other"
            )
    else:
        spec = ExecSpec(
            policy=policy if policy is not None else "sp_opt",
            order=order if order is not None else "AC",
            band_size=band_size if band_size is not None else 128,
            block_f=block_f,
            use_pallas=bool(use_pallas),
        )
    if kernel is None:
        kernel = lookup_kernel(spec.policy, spec.order, spec.use_pallas)
    return kernel(adj, x, w, spec, mesh)


# ---------------------------------------------------------------------------
# Segment-aware readout (batched serving)
# ---------------------------------------------------------------------------

READOUTS = ("sum", "mean", "max")


def _segment_sum(h, ids, valid, num_segments: int) -> torch.Tensor:
    """Per-segment sums of the valid rows of ``h``, each over a pairwise
    tree of its own rows in row order, zero-padded to a power of two.

    Padding a segment's rows with zeros to a longer power of two only adds
    exact ``+ 0`` steps at the top of its tree, so a segment's sum depends
    on its own rows alone: not on the other segments, the batch's row
    count or where the segment sits in it.  (``index_add_`` on the card
    sums with atomics, in an order that changes from run to run.)  Every
    step is an elementwise add, deterministic on any device.

    Every shape is static: each tree is as wide as ``h`` has rows, rounded
    up to a power of two (the widest a segment can be), whatever the
    segments hold, so nothing is read back to the host and a CUDA graph
    can capture the readout.  The rows are sorted by segment (stably, so
    each keeps its row order), invalid rows last in a segment of their own
    that is dropped.
    """
    n, f = h.shape
    width = 1 << max(n - 1, 0).bit_length()
    key = torch.where(valid, ids, num_segments)
    order = torch.sort(key, stable=True).indices
    seg = key[order]
    counts = torch.zeros(num_segments + 1, dtype=torch.long, device=h.device)
    counts.scatter_add_(0, key, torch.ones_like(key))
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(n, device=h.device) - starts[seg]
    tree = torch.zeros(((num_segments + 1) * width, f), dtype=h.dtype, device=h.device)
    tree.index_copy_(0, seg * width + pos, h[order])
    tree = tree.view(num_segments + 1, width, f)[:num_segments]
    while tree.shape[1] > 1:
        tree = tree[:, 0::2] + tree[:, 1::2]
    return tree[:, 0]


def segment_readout(
    h: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    reduce: str = "mean",
) -> torch.Tensor:
    """Per-graph readout over a block-diagonally batched node output.

    ``h`` is (V, F) node output of a batched forward pass and
    ``segment_ids[v]`` the member-graph index of row ``v``; returns the
    (num_segments, F) per-graph reduction.  Pad rows carry an id of
    ``num_segments`` (out of range): they are masked out explicitly here,
    since ``index_add_`` / ``scatter_reduce`` raise on that id.  An empty
    segment reads 0 for ``sum`` and ``mean`` and -inf for ``max``, as in
    the reference.  Sums are taken by :func:`_segment_sum`, in an order
    set by each segment's own rows alone (no atomics), so a graph's
    readout is the same bits whatever it is batched with.
    """
    if reduce not in READOUTS:
        raise ValueError(
            f"reduce must be one of {READOUTS}, got {reduce!r}"
        )
    n, f = h.shape
    ids = segment_ids.to(device=h.device, dtype=torch.long)
    valid = (ids >= 0) & (ids < num_segments)
    if num_segments == 0 or n == 0:
        fill = float("-inf") if reduce == "max" else 0.0
        return torch.full((num_segments, f), fill, dtype=h.dtype, device=h.device)
    # masked rows land on segment 0 carrying the reduction's identity
    safe = torch.where(valid, ids, 0)
    if reduce == "max":
        out = torch.full((num_segments, f), float("-inf"), dtype=h.dtype,
                         device=h.device)
        src = torch.where(valid[:, None], h, float("-inf"))
        return out.scatter_reduce(
            0, safe[:, None].expand(n, f), src, reduce="amax",
            include_self=True,
        )
    s = _segment_sum(h, ids, valid, num_segments)
    if reduce == "sum":
        return s
    counts = torch.zeros(num_segments, dtype=h.dtype, device=h.device)
    counts.index_add_(0, safe, valid.to(h.dtype))
    return s / counts.clamp(min=1.0)[:, None]


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------


def gcn_layer(params, adj, x, *, policy=None, order=None, **kw):
    """GCN: relu(Ã X W + b) with the multiphase policy."""
    out = multiphase_matmul(adj, x, params["w"], policy=policy, order=order, **kw)
    return torch.relu(out + params["b"])


def sage_layer(params, adj, x, *, policy=None, order=None, **kw):
    """GraphSAGE with the paper's Sec.-6 decomposition:

        concat(X, A·X) @ W  ==  X @ W_top + (A·X) @ W_bottom

    The GEMM-first form keeps X @ W_top independent of aggregation — the
    extra scheduling freedom the paper highlights.
    """
    self_term = _tier_matmul(kw)(x[: adj.n_nodes], params["w_top"])
    agg_term = multiphase_matmul(
        adj, x, params["w_bottom"], policy=policy, order=order, **kw
    )
    return torch.relu(self_term + agg_term + params["b"])


def gin_layer(params, adj, x, *, policy=None, order=None, **kw):
    """GIN: MLP((1 + eps) * x + sum-aggregate(x)).

    The sum aggregation is the same SpMM with unit weights; the first MLP
    matmul plays the combination role, so the multiphase policy applies.
    """
    eps = params["eps"]
    unit_adj = EllAdjacency(
        adj.indices, (adj.weights > 0).to(torch.float32), adj.n_nodes
    )
    agg = multiphase_matmul(unit_adj, x, params["w1"], policy=policy, order=order, **kw)
    matmul = _tier_matmul(kw)
    self_term = matmul((1.0 + eps) * x[: adj.n_nodes], params["w1"])
    h = torch.relu(agg + self_term + params["b1"])
    return torch.relu(matmul(h, params["w2"]) + params["b2"])


LAYER_FNS = {"gcn": gcn_layer, "sage": sage_layer, "gin": gin_layer}


def init_layer(
    kind: str, generator: torch.Generator, f_in: int, f_out: int, device=None
):
    """One layer's parameters, drawn on the CPU from ``generator`` (so the
    values do not depend on the device) and placed on ``device``."""
    dev = resolve_device(device)

    def normal(shape, scale):
        return (torch.randn(shape, generator=generator) * scale).to(dev)

    def zeros(shape):
        return torch.zeros(shape, device=dev)

    scale = 1.0 / np.sqrt(f_in)
    if kind == "gcn":
        return {"w": normal((f_in, f_out), scale), "b": zeros((f_out,))}
    if kind == "sage":
        return {
            "w_top": normal((f_in, f_out), scale),
            "w_bottom": normal((f_in, f_out), scale),
            "b": zeros((f_out,)),
        }
    if kind == "gin":
        return {
            "eps": zeros(()),
            "w1": normal((f_in, f_out), scale),
            "b1": zeros((f_out,)),
            "w2": normal((f_out, f_out), 1.0 / np.sqrt(f_out)),
            "b2": zeros((f_out,)),
        }
    raise KeyError(kind)


def params_from_numpy(params, device=None):
    """Layer parameters (a list of per-layer dicts of numpy arrays, e.g. a
    reference init passed through ``np.asarray``) as tensors on
    ``device``: both packages then compute from the same weights."""
    dev = resolve_device(device)
    return [
        {k: torch.tensor(np.asarray(v), device=dev) for k, v in layer.items()}
        for layer in params
    ]
