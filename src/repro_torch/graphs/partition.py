"""Spill-model-driven partitioning of beyond-capacity graphs.

The port of :mod:`repro.graphs.partition`: the planner and the closure
extraction are the reference's numpy code; the execution paths run on
torch.

A request whose staged V x F intermediate exceeds ``gb_capacity_bytes``
(or the serving admission caps) cannot be served as one monolithic
Program.  This module *chooses* an execution plan for it, pricing each
candidate with the same simulator the mapper uses:

- ``row_stream``   — stream L-hop halo closures of node blocks through
  the existing kernels, gathering halo features between blocks
  (NeuraChip-style decoupled aggregation, arXiv:2404.15510).  Own rows
  come first in every closure, so stitching the per-block ``[:n_own]``
  slices back together is bit-identical to the whole-graph forward: every
  row's reduction is independent of the rows beside it, in the kernels
  (fixed per-row summation orders) and in the eager products
  (:func:`repro_torch.kernels.common.row_matmul`).
- ``feature_chunk`` — keep all rows but materialize the intermediate one
  feature-column chunk at a time (columns of ``A @ X`` are independent;
  a narrow chunk's product may be summed in another order, so this path
  matches to <= 1 ulp rather than bitwise).
- ``pp_shard``     — hand the whole graph to the device-level
  pipeline-parallel path (:mod:`repro_torch.gnn.pp`) when a multi-device
  mesh is available.

Each candidate's per-layer compute is priced by
:func:`repro_torch.core.mapper.search_dataflows` on a representative
partition workload, and its inter-partition traffic by
:func:`repro_torch.core.simulator.partition_comm_cost` — the additive
communication term of Guirado et al. (arXiv:2103.10515) — so partitioned
plans rank on the same objective scale as monolithic ones.
"""
from __future__ import annotations

import math
from dataclasses import asdict, dataclass

import numpy as np
import torch

from ..core.cost_model import GNNLayerWorkload
from ..core.hw import AcceleratorConfig, DEFAULT_ACCEL
from ..core.registry import objective_value, register_kernel
from ..core.simulator import (
    PartitionCommStats,
    intermediate_footprint_bytes,
    partition_comm_cost,
)
from .batching import next_pow2
from .csr import CSRGraph

__all__ = [
    "Partition",
    "PlanCandidate",
    "PartitionPlan",
    "extract_row_partitions",
    "plan_partition",
    "row_stream_forward",
    "feature_chunk_forward",
    "pp_shard_forward",
]

#: Skeletons used to price a partition that fits in the global buffer.
FIT_NAMES = ("Seq-Nt", "SP-FsNt-Fs", "PP-Nt-Vt/sl")
#: Skeletons used to price a beyond-capacity monolithic run: only the
#: Seq family honestly stages the full V x F intermediate (Table 3);
#: pipelined/fused strategies assume a GB/RF-resident working set that a
#: beyond-capacity request cannot provide.
SPILL_NAMES = ("Seq-Nt", "Seq-Ns")
#: Skeletons for the device-level pipeline-parallel shard.
PP_NAMES = ("PP-Nt-Vt/sl", "PP-Ns-Vt/sl")

_MIN_BLOCK_ROWS = 32


# ---------------------------------------------------------------------------
# Row partitions: L-hop halo closures with own rows first
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Partition:
    """One node block plus its L-hop halo closure.

    ``nodes`` maps local row ids to global ids; the first ``n_own`` rows
    are the block's own nodes (in global order), the rest the halo.
    ``graph`` is the closure's locally-remapped CSR: rings ``0..L-1``
    keep their real adjacency, the outermost ring carries a zero-weight
    self-loop (feature-only halo — correct because ring ``r`` only needs
    valid values through layer ``L - r``).
    """

    graph: CSRGraph
    nodes: np.ndarray  # (n_sub,) local -> global node ids
    n_own: int

    @property
    def n_halo(self) -> int:
        return len(self.nodes) - self.n_own


def _rows_cols(g: CSRGraph, rows: np.ndarray) -> np.ndarray:
    """All column indices of the given rows, vectorized."""
    starts = g.row_ptr[rows].astype(np.int64)
    counts = (g.row_ptr[rows + 1] - g.row_ptr[rows]).astype(np.int64)
    total = int(counts.sum())
    if total == 0:
        return np.empty(0, dtype=g.col_idx.dtype)
    cum = np.cumsum(counts) - counts
    flat = np.repeat(starts - cum, counts) + np.arange(total, dtype=np.int64)
    return g.col_idx[flat]


def _closure_rings(
    g: CSRGraph, start: int, stop: int, n_hops: int
) -> tuple[list[np.ndarray], bool]:
    """BFS rings 0..n_hops around rows [start, stop); ring 0 first.

    The second return is ``closed``: True when the closure is
    neighbor-closed (BFS ran dry before ``n_hops``), in which case every
    ring keeps its real adjacency; otherwise the outermost ring is a
    frontier at exactly ``n_hops`` and becomes feature-only dummy rows.
    """
    seen = np.zeros(g.n_nodes, dtype=bool)
    ring0 = np.arange(start, stop, dtype=np.int64)
    seen[ring0] = True
    rings = [ring0]
    for _ in range(n_hops):
        nbrs = _rows_cols(g, rings[-1])
        fresh = np.unique(nbrs[~seen[nbrs]])
        if fresh.size == 0:
            return rings, True
        seen[fresh] = True
        rings.append(fresh.astype(np.int64))
    return rings, len(rings) == 1


def _interior(rings: list[np.ndarray], closed: bool) -> np.ndarray:
    """Rows that keep real adjacency (the rest carry zero self-loops)."""
    if closed or len(rings) == 1:
        return np.concatenate(rings)
    return np.concatenate(rings[:-1])


def _closure_partition(
    g: CSRGraph, rings: list[np.ndarray], closed: bool
) -> Partition:
    """Build the locally-remapped closure CSR for one set of BFS rings."""
    nodes = np.concatenate(rings)
    n_sub = len(nodes)
    lid = np.full(g.n_nodes, -1, dtype=np.int64)
    lid[nodes] = np.arange(n_sub)
    interior = _interior(rings, closed)
    n_int = len(interior)

    counts = np.ones(n_sub, dtype=np.int64)  # outer ring: 1 self-loop slot
    counts[:n_int] = g.nnz[interior]
    row_ptr = np.zeros(n_sub + 1, dtype=np.int64)
    np.cumsum(counts, out=row_ptr[1:])
    col = np.empty(row_ptr[-1], dtype=np.int32)
    val = np.zeros(row_ptr[-1], dtype=g.values.dtype)
    cols_int = _rows_cols(g, interior)
    vals_int = _row_values(g, interior)
    fill = np.repeat(row_ptr[:n_int], counts[:n_int]) + _within_row_offsets(
        counts[:n_int]
    )
    col[fill] = lid[cols_int].astype(np.int32)
    val[fill] = vals_int
    # outer-ring dummy rows: zero-weight self-loops (feature carriers only)
    col[row_ptr[n_int:-1]] = np.arange(n_int, n_sub, dtype=np.int32)
    return Partition(
        graph=CSRGraph(
            row_ptr=row_ptr.astype(np.int64),
            col_idx=col,
            values=val,
            n_nodes=n_sub,
        ),
        nodes=nodes,
        n_own=len(rings[0]),
    )


def _within_row_offsets(counts: np.ndarray) -> np.ndarray:
    total = int(counts.sum())
    cum = np.cumsum(counts) - counts
    return np.arange(total, dtype=np.int64) - np.repeat(cum, counts)


def _row_values(g: CSRGraph, rows: np.ndarray) -> np.ndarray:
    starts = g.row_ptr[rows].astype(np.int64)
    counts = (g.row_ptr[rows + 1] - g.row_ptr[rows]).astype(np.int64)
    total = int(counts.sum())
    if total == 0:
        return np.empty(0, dtype=g.values.dtype)
    cum = np.cumsum(counts) - counts
    flat = np.repeat(starts - cum, counts) + np.arange(total, dtype=np.int64)
    return g.values[flat]


def extract_row_partitions(
    g: CSRGraph, block_rows: int, n_hops: int
) -> list[Partition]:
    """Split ``g`` into row blocks of ``block_rows`` with L-hop closures.

    Every global row lands in exactly one partition's own block, in
    order, so concatenating the per-partition ``[:n_own]`` outputs
    reconstructs the whole-graph node ordering exactly.
    """
    if block_rows < 1:
        raise ValueError(f"block_rows must be >= 1, got {block_rows}")
    if n_hops < 1:
        raise ValueError(f"n_hops must be >= 1, got {n_hops}")
    parts = []
    for s in range(0, g.n_nodes, block_rows):
        e = min(s + block_rows, g.n_nodes)
        rings, closed = _closure_rings(g, s, e, n_hops)
        parts.append(_closure_partition(g, rings, closed))
    return parts


# ---------------------------------------------------------------------------
# Plan selection
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class PlanCandidate:
    """One priced execution-plan candidate (kept for evidence/telemetry)."""

    kind: str
    n_partitions: int
    feasible: bool
    layer_cycles: float = 0.0
    layer_energy_pj: float = 0.0
    comm_cycles: float = 0.0
    comm_energy_pj: float = 0.0
    objective_value: float = float("inf")
    note: str = ""

    def as_dict(self) -> dict:
        return asdict(self)


@dataclass(frozen=True)
class PartitionPlan:
    """The chosen plan plus the full ranked candidate list."""

    kind: str  # monolithic | row_stream | feature_chunk | pp_shard
    objective: str
    objective_value: float
    n_partitions: int
    block_rows: int = 0  # row_stream: own rows per block
    chunk_f: int = 0  # feature_chunk: feature columns per chunk
    n_hops: int = 0  # row_stream: halo depth (== model layers)
    halo_nodes: int = 0  # row_stream: total halo nodes across blocks
    footprint_bytes: int = 0  # monolithic V x f_max intermediate
    candidates: tuple[PlanCandidate, ...] = ()

    def as_dict(self) -> dict:
        d = asdict(self)
        d["candidates"] = [c.as_dict() for c in self.candidates]
        return d


def _row_stream_geometry(
    g: CSRGraph,
    f_max: int,
    hw: AcceleratorConfig,
    n_hops: int,
    max_partitions: int,
    max_block_rows: int | None,
):
    """Pick block_rows so every padded closure's features stay GB-resident.

    Returns ``(block_rows, n_parts, closure_max, halo_nodes, rep_nnz)``
    or ``None`` when no feasible block size exists.  ``rep_nnz`` is the
    largest closure's per-row nnz vector (used as the pricing workload).
    """
    cap = hw.gb_capacity_bytes
    if cap is not None:
        block = cap // (f_max * hw.bytes_per_elem)
    else:
        block = max_block_rows if max_block_rows is not None else g.n_nodes
    if max_block_rows is not None:
        block = min(block, max_block_rows)
    block = 1 << max(int(block).bit_length() - 1, 0)  # round down to pow2
    while block >= _MIN_BLOCK_ROWS:
        n_parts = math.ceil(g.n_nodes / block)
        if n_parts > max_partitions:
            return None  # shrinking further only adds partitions
        closure_max, halo_nodes, rep_nnz = 0, 0, None
        ok = True
        for s in range(0, g.n_nodes, block):
            rings, closed = _closure_rings(g, s, min(s + block, g.n_nodes), n_hops)
            n_sub = sum(len(r) for r in rings)
            halo_nodes += n_sub - len(rings[0])
            if n_sub > closure_max:
                closure_max = n_sub
                interior = _interior(rings, closed)
                rep_nnz = np.concatenate(
                    [g.nnz[interior], np.ones(n_sub - len(interior), dtype=np.int64)]
                )
            if (
                cap is not None
                and next_pow2(n_sub) * f_max * hw.bytes_per_elem > cap
            ):
                ok = False
                break
        if ok and n_parts > 1:
            return block, n_parts, closure_max, halo_nodes, rep_nnz
        block //= 2
    return None


def _layer_cost(
    workloads, hw, objective, names, mult=1.0
) -> tuple[float, float] | None:
    """Total (cycles, energy_pj) of the best mapping per layer, or None
    when no skeleton in ``names`` yields a legal tiling."""
    from ..core.mapper import search_dataflows

    cyc = en = 0.0
    for wl in workloads:
        res = search_dataflows(
            wl, hw=hw, objective=objective, names=names, pe_splits=(0.5,), top_k=1
        )
        if not res:
            return None
        cyc += res[0].stats.cycles * mult
        en += res[0].stats.energy_pj * mult
    return cyc, en


def plan_partition(
    g: CSRGraph,
    dims,
    hw: AcceleratorConfig = DEFAULT_ACCEL,
    *,
    objective: str = "edp",
    n_devices: int = 1,
    allow_monolithic: bool = True,
    max_partitions: int = 256,
    max_block_rows: int | None = None,
) -> PartitionPlan:
    """Choose an execution plan for ``g`` under ``hw``'s capacity.

    ``dims`` is the model's per-layer ``(f_in, f_out)`` list.  An
    :class:`~repro_torch.core.hw.HWGrid` collapses to its base config for
    planning.  ``max_block_rows`` caps row-stream blocks (the engine
    passes its admission ``max_nodes`` so partitions stay admissible).
    Raises ``ValueError`` when no candidate is feasible.
    """
    base = getattr(hw, "base", hw)
    dims = [tuple(d) for d in dims]
    if not dims:
        raise ValueError("dims must name at least one layer")
    f_max = max(max(fi, fo) for fi, fo in dims)
    f_in0 = dims[0][0]
    f_inter = sum(fi for fi, _ in dims)  # intermediate widths crossing cuts
    cap = base.gb_capacity_bytes
    v = g.n_nodes
    n_hops = len(dims)
    footprint = intermediate_footprint_bytes(v, f_max, base)
    fits = cap is None or footprint <= cap

    candidates: list[PlanCandidate] = []
    chosen_geo: dict[str, tuple] = {}

    def add(kind, n_parts, lc, comm: PartitionCommStats, note=""):
        if lc is None:
            candidates.append(
                PlanCandidate(kind, n_parts, False, note=note or "no legal tiling")
            )
            return
        cyc, en = lc
        candidates.append(
            PlanCandidate(
                kind,
                n_parts,
                True,
                layer_cycles=cyc,
                layer_energy_pj=en,
                comm_cycles=comm.cycles,
                comm_energy_pj=comm.energy_pj,
                objective_value=objective_value(
                    objective, cyc + comm.cycles, en + comm.energy_pj
                ),
                note=note,
            )
        )

    mono_wls = [
        GNNLayerWorkload(g.nnz, fi, fo, name=f"mono-l{i}")
        for i, (fi, fo) in enumerate(dims)
    ]
    if allow_monolithic:
        add(
            "monolithic",
            1,
            _layer_cost(mono_wls, base, objective, FIT_NAMES if fits else SPILL_NAMES),
            partition_comm_cost("monolithic", 1, v=v, f=f_max, hw=base),
            note="fits" if fits else "spills: priced on Seq family",
        )

    geo = _row_stream_geometry(g, f_max, base, n_hops, max_partitions, max_block_rows)
    if geo is None:
        candidates.append(
            PlanCandidate(
                "row_stream", 0, False, note="no block size keeps closures GB-resident"
            )
        )
    else:
        block, n_parts, closure_max, halo_nodes, rep_nnz = geo
        chosen_geo["row_stream"] = geo
        wls = [
            GNNLayerWorkload(rep_nnz, fi, fo, name=f"rs-l{i}")
            for i, (fi, fo) in enumerate(dims)
        ]
        add(
            "row_stream",
            n_parts,
            _layer_cost(wls, base, objective, FIT_NAMES, mult=n_parts),
            partition_comm_cost(
                "row_stream",
                n_parts,
                v=v,
                f=f_in0,
                hw=base,
                halo_elems=halo_nodes * f_in0,
            ),
            note=f"block_rows={block} closure_max={closure_max}",
        )

    if cap is None:
        candidates.append(
            PlanCandidate("feature_chunk", 0, False, note="no capacity to chunk against")
        )
    else:
        chunk_f = min(cap // (v * base.bytes_per_elem), f_max)
        n_chunks = math.ceil(f_max / chunk_f) if chunk_f >= 1 else 0
        if chunk_f < 1 or n_chunks > max_partitions:
            candidates.append(
                PlanCandidate(
                    "feature_chunk", 0, False, note="graph too tall to chunk columns"
                )
            )
        else:
            chosen_geo["feature_chunk"] = (int(chunk_f), n_chunks)
            # work is conserved across chunks and each chunk's intermediate
            # is GB-resident, so compute is priced spill-free on the full
            # workload; the chunk-boundary round-trips are the comm term.
            add(
                "feature_chunk",
                n_chunks,
                _layer_cost(mono_wls, base, objective, FIT_NAMES),
                partition_comm_cost(
                    "feature_chunk", n_chunks, v=v, f=f_inter, hw=base
                ),
                note=f"chunk_f={int(chunk_f)}",
            )

    if n_devices >= 2:
        add(
            "pp_shard",
            n_devices,
            _layer_cost(mono_wls, base, objective, PP_NAMES),
            partition_comm_cost("pp_shard", n_devices, v=v, f=f_inter, hw=base),
            note=f"{n_devices}-device phase mesh",
        )
    else:
        candidates.append(
            PlanCandidate("pp_shard", 0, False, note="needs >= 2 devices")
        )

    ranked = tuple(
        sorted(candidates, key=lambda c: (not c.feasible, c.objective_value))
    )
    best = ranked[0]
    if not best.feasible:
        raise ValueError(
            f"no feasible execution plan for V={v} under "
            f"gb_capacity_bytes={cap}: "
            + "; ".join(f"{c.kind}: {c.note}" for c in ranked)
        )
    plan = PartitionPlan(
        kind=best.kind,
        objective=objective,
        objective_value=best.objective_value,
        n_partitions=best.n_partitions,
        n_hops=n_hops if best.kind == "row_stream" else 0,
        footprint_bytes=footprint,
        candidates=ranked,
    )
    if best.kind == "row_stream":
        block, n_parts, _closure_max, halo_nodes, _ = chosen_geo["row_stream"]
        plan = PartitionPlan(
            **{
                **asdict(plan),
                "block_rows": int(block),
                "halo_nodes": int(halo_nodes),
                "candidates": ranked,
            }
        )
    elif best.kind == "feature_chunk":
        chunk_f, _ = chosen_geo["feature_chunk"]
        plan = PartitionPlan(
            **{**asdict(plan), "chunk_f": int(chunk_f), "candidates": ranked}
        )
    return plan


# ---------------------------------------------------------------------------
# Execution paths (functional; the engine drives row_stream through
# Programs, these are the reference/standalone implementations)
# ---------------------------------------------------------------------------


@register_kernel("feature_chunk", orders=("AC",))
def _feature_chunk_ac(adj, x, w, spec, mesh=None):
    """Seq/AC with the V x F intermediate built one column chunk at a
    time.  Columns of ``A @ X`` are independent per-row reductions, so
    the chunked concat matches the monolithic aggregate to <= 1 ulp (a
    narrow chunk may be reduced in another order)."""
    from ..gnn.layers import aggregate_full
    from ..kernels.common import row_matmul

    fc = spec.block_f or x.shape[1]
    cols = [aggregate_full(adj, x[:, c : c + fc]) for c in range(0, x.shape[1], fc)]
    return row_matmul(torch.cat(cols, dim=1), w)[: adj.n_nodes]


@register_kernel("feature_chunk", orders=("CA",))
def _feature_chunk_ca(adj, x, w, spec, mesh=None):
    from ..gnn.layers import aggregate_full
    from ..kernels.common import row_matmul

    fc = spec.block_f or w.shape[1]
    cols = [
        aggregate_full(adj, row_matmul(x, w[:, c : c + fc]))
        for c in range(0, w.shape[1], fc)
    ]
    return torch.cat(cols, dim=1)[: adj.n_nodes]


def _specs(policy, order, band_size, n_layers, block_f=None):
    from ..core.schedule import ExecSpec

    return [ExecSpec(policy, order, band_size, block_f)] * n_layers


def _device_of(params) -> torch.device:
    """Where the forward runs: the device the weights are on."""
    return next(iter(params[0].values())).device


def _readout(h: torch.Tensor, readout: str | None) -> np.ndarray:
    """The node output as numpy, or its one-segment ``readout`` vector."""
    from ..gnn.layers import segment_readout

    if readout is None:
        return h.cpu().numpy()
    seg = torch.zeros(h.shape[0], dtype=torch.int32, device=h.device)
    return segment_readout(h, seg, 1, reduce=readout)[0].cpu().numpy()


def row_stream_forward(
    g: CSRGraph,
    x,
    params,
    *,
    kind: str = "gcn",
    policy: str = "sp_opt",
    order: str = "AC",
    band_size: int = 128,
    block_rows: int,
    n_hops: int | None = None,
    readout: str | None = None,
):
    """Whole-model forward via row-streamed halo closures (reference
    implementation; bit-identical to the monolithic forward).  Runs the
    eager tier on the device the weights are on; the engine's partitioned
    lane streams closures through kernel-tier Programs."""
    from ..gnn.layers import EllAdjacency
    from ..gnn.model import forward_layers

    x = np.asarray(x)
    dev = _device_of(params)
    hops = n_hops if n_hops is not None else len(params)
    specs = _specs(policy, order, band_size, len(params))
    pad = g.max_degree  # same ELL width as the whole-graph adjacency
    outs = []
    for part in extract_row_partitions(g, block_rows, hops):
        adj = EllAdjacency.from_csr(part.graph, pad_to=pad, device=dev)
        h = forward_layers(
            kind, params, adj, torch.as_tensor(x[part.nodes], device=dev), specs
        )
        outs.append(h[: part.n_own])
    return _readout(torch.cat(outs, dim=0), readout)


def feature_chunk_forward(
    g: CSRGraph,
    x,
    params,
    *,
    kind: str = "gcn",
    order: str = "AC",
    chunk_f: int,
    band_size: int = 128,
    readout: str | None = None,
):
    """Whole-model forward with chunked feature columns."""
    from ..gnn.layers import EllAdjacency
    from ..gnn.model import forward_layers

    dev = _device_of(params)
    adj = EllAdjacency.from_csr(g, device=dev)
    specs = _specs("feature_chunk", order, band_size, len(params), block_f=chunk_f)
    h = forward_layers(
        kind, params, adj, torch.as_tensor(np.asarray(x), device=dev), specs
    )
    return _readout(h, readout)


def pp_shard_forward(
    g: CSRGraph,
    x,
    params,
    *,
    kind: str = "gcn",
    order: str = "AC",
    band_size: int = 128,
    n_devices: int | None = None,
    readout: str | None = None,
):
    """Whole-model forward on the device-level pipeline-parallel path.

    On one device this is :mod:`repro_torch.gnn.pp`'s ``mesh=None`` path,
    the reference's SP-Generic fallback.  A mesh of 2 or more devices
    raises in :func:`repro_torch.gnn.pp.pp_multiphase_matmul` (the
    two-stream pipeline is not ported yet).
    """
    from ..gnn.layers import EllAdjacency
    from ..gnn.model import forward_layers

    dev = _device_of(params)
    n_avail = torch.cuda.device_count() if dev.type == "cuda" else 1
    n = min(n_devices or n_avail, n_avail)
    mesh = None
    if n >= 2:
        mesh = [torch.device("cuda", i) for i in range(n)]
    adj = EllAdjacency.from_csr(g, device=dev)
    specs = _specs("pp", order, band_size, len(params))
    h = forward_layers(
        kind, params, adj, torch.as_tensor(np.asarray(x), device=dev), specs,
        mesh=mesh,
    )
    return _readout(h, readout)
