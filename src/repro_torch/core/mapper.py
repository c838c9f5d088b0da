"""Mapping optimizer over the multiphase dataflow space.

The paper (Sec. 6, "Mapping Optimizer") leaves automatic search as future
work; we implement it here on top of the taxonomy + simulator: take a
dataflow *skeleton* (loop orders + the paper's s/t/x binding constraints),
search power-of-two tile sizes and PP PE splits under the PE budget, and
rank by cycles / energy / EDP.

The search runs on the batched, cache-backed engine
(:func:`repro.core.simulator.simulate_batch`): the whole
(agg_tiling x cmb_tiling x pe_split) grid is scored as numpy array ops over
a per-workload :class:`~repro.core.cost_model.TileStats` cache, dominated
candidates are pruned from the (cycles, energy) Pareto front, and only the
returned top-k mappings are re-simulated through the scalar
:func:`~repro.core.simulator.simulate` oracle.  ``engine="scalar"`` keeps
the original one-candidate-at-a-time loop for cross-checking.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, replace

import numpy as np

from .cost_model import GNNLayerWorkload, TileStats
from .hw import AcceleratorConfig, DEFAULT_ACCEL, HWGrid
from .registry import get_objective, objective_names, objective_value
from .schedule import LayerSchedule, ModelSchedule
from .simulator import (
    BatchStats,
    ModelStats,
    RunStats,
    _GroupSpec,
    _eval_candidates,
    expand_hw_columns,
    simulate,
    simulate_batch,
    simulate_model,
    transition_cost,
    validate_workload_chain,
)
from .taxonomy import (
    Cons,
    DataflowSkeleton,
    GNNDataflow,
    Granularity,
    InterPhase,
    PhaseOrder,
    SKELETONS,
    SkeletonPhase,
    named_skeleton,
)


def _pow2_up_to(extent: int, cap: int) -> list[int]:
    """Tile-size candidates: powers of two plus 3*2^k (so non-power-of-two
    PE partitions like 384 = 3*128 can be filled exactly)."""
    lim = min(max(extent, 1) * 2 - 1, cap)
    out, t = [1], 2
    while t <= lim:
        out.append(t)
        if 3 * t // 2 <= lim and 3 * t // 2 not in out:
            out.append(3 * t // 2)
        t *= 2
    return sorted(out)


def _dim_candidates(
    phase: SkeletonPhase, dim: str, extent: int, budget: int
) -> list[int]:
    fx = phase.fixed_tile(dim)
    if fx:
        return [min(fx, budget)]
    c = phase.constraint(dim)
    full = _pow2_up_to(extent, budget)
    if c == Cons.T:
        return [1]
    if c == Cons.X:
        return full
    if c == Cons.S:
        return [t for t in full if t > 1] or [1]
    if c == Cons.S_HIGH:
        hi = [t for t in full if t >= max(2, budget // 8)]
        return hi or [t for t in full if t > 1][-1:] or [1]
    if c == Cons.S_LOW:
        return [t for t in full if t <= 8]
    if c == Cons.S_FULL:
        return [budget]  # the rigid-substrate case: all PEs on this dim
    raise AssertionError(c)


def _phase_tiling_grid(
    phase: SkeletonPhase,
    extents: dict[str, int],
    budget: int,
    min_fill: float = 0.25,
) -> np.ndarray:
    """(k, 3) int64 tile grid, columns aligned with ``phase.order``, in the
    itertools.product enumeration order.  Keeps tilings whose spatial
    footprint fits the PE budget, preferring ones that fill at least
    ``min_fill`` of it."""
    cands = [
        np.asarray(_dim_candidates(phase, d, extents[d], budget), dtype=np.int64)
        for d in phase.order
    ]
    mesh = np.meshgrid(*cands, indexing="ij")
    grid = np.stack([m.ravel() for m in mesh], axis=1)
    fp = grid.prod(axis=1)
    fits = fp <= budget
    filled = fits & (fp >= max(1, int(budget * min_fill)))
    return grid[filled if filled.any() else fits]


def _phase_tilings(
    phase: SkeletonPhase,
    extents: dict[str, int],
    budget: int,
    min_fill: float = 0.25,
) -> list[dict[str, int]]:
    """Dict view of :func:`_phase_tiling_grid` (kept for tests/callers)."""
    grid = _phase_tiling_grid(phase, extents, budget, min_fill)
    dims = list(phase.order)
    return [dict(zip(dims, map(int, row))) for row in grid]


@dataclass
class MappingResult:
    dataflow: GNNDataflow
    stats: RunStats
    skeleton: str = ""

    def objective(self, name: str) -> float:
        """Objective value (resolved via the objective registry; unknown
        names raise ``ValueError`` listing the valid ones)."""
        return objective_value(name, self.stats.cycles, self.stats.energy_pj)


# ---------------------------------------------------------------------------
# Candidate grid construction (arrays, no dataflow objects)
# ---------------------------------------------------------------------------


def _candidate_grid(
    skeleton: DataflowSkeleton,
    wl: GNNLayerWorkload,
    hw: AcceleratorConfig,
    pe_splits: tuple[float, ...],
    max_evals: int,
) -> dict[str, np.ndarray]:
    """All candidate (agg_tiling, cmb_tiling, pe_split) triples as column
    arrays, in the legacy scalar-search enumeration order (splits outer,
    agg x cmb pairs inner, linspace-subsampled per split to ``max_evals``)."""
    feat = wl.f_in if skeleton.order == PhaseOrder.AC else wl.g_out
    agg_ext = {"V": wl.v, "N": max(int(wl.nnz.max()), 1), "F": feat}
    cmb_ext = {"V": wl.v, "G": wl.g_out, "F": wl.f_in}
    splits = pe_splits if skeleton.inter == InterPhase.PP else (0.5,)
    a_ix = {d: skeleton.agg.order.index(d) for d in ("V", "N", "F")}
    c_ix = {d: skeleton.cmb.order.index(d) for d in ("V", "G", "F")}

    chunks: list[np.ndarray] = []  # (k, 7): 6 tile columns + split
    for split in splits:
        if skeleton.inter == InterPhase.PP:
            pe_first = max(1, int(round(hw.n_pes * split)))
            pe_second = max(1, hw.n_pes - pe_first)
            if skeleton.order == PhaseOrder.AC:
                b_agg, b_cmb = pe_first, pe_second
            else:
                b_agg, b_cmb = pe_second, pe_first
        else:
            b_agg = b_cmb = hw.n_pes

        agg_grid = _phase_tiling_grid(skeleton.agg, agg_ext, b_agg)
        if skeleton.sp_optimized:
            # SP-Optimized: temporal reduction (T_N = 1), combination tiles
            # tied to the aggregation tiles, T_G = 1.
            ag = agg_grid[agg_grid[:, a_ix["N"]] == 1]
            ag = ag[ag[:, a_ix["V"]] * ag[:, a_ix["F"]] <= b_cmb]
            at = ag
            ct = np.ones((len(ag), 3), dtype=np.int64)
            ct[:, c_ix["V"]] = ag[:, a_ix["V"]]
            ct[:, c_ix["F"]] = ag[:, a_ix["F"]]
        else:
            cmb_grid = _phase_tiling_grid(skeleton.cmb, cmb_ext, b_cmb)
            ka, kc = len(agg_grid), len(cmb_grid)
            at = agg_grid[np.repeat(np.arange(ka), kc)]
            ct = cmb_grid[np.tile(np.arange(kc), ka)]
        if len(at) > max_evals:
            idx = np.linspace(0, len(at) - 1, max_evals).astype(int)
            at, ct = at[idx], ct[idx]
        if len(at) == 0:
            continue
        cols = np.empty((len(at), 7), dtype=np.float64)
        cols[:, 0] = at[:, a_ix["V"]]
        cols[:, 1] = at[:, a_ix["N"]]
        cols[:, 2] = at[:, a_ix["F"]]
        cols[:, 3] = ct[:, c_ix["V"]]
        cols[:, 4] = ct[:, c_ix["G"]]
        cols[:, 5] = ct[:, c_ix["F"]]
        cols[:, 6] = split
        chunks.append(cols)

    if not chunks:
        return {}
    all_cols = np.concatenate(chunks, axis=0)
    cand = {
        "t_v_a": all_cols[:, 0].astype(np.int64),
        "t_n": all_cols[:, 1].astype(np.int64),
        "t_f_a": all_cols[:, 2].astype(np.int64),
        "t_v_c": all_cols[:, 3].astype(np.int64),
        "t_g": all_cols[:, 4].astype(np.int64),
        "t_f_c": all_cols[:, 5].astype(np.int64),
        "pe_split": all_cols[:, 6],
    }
    # Skeleton-concretized loops are temporal exactly when the tile is 1
    # (`SkeletonPhase.to_intra`), so bindings follow from the tile columns.
    cand["agg_n_temporal"] = cand["t_n"] == 1
    cand["cmb_f_temporal"] = cand["t_f_c"] == 1
    cand["sp_opt"] = _sp_opt_flags(skeleton, cand)
    return cand


def _sp_opt_flags(skeleton: DataflowSkeleton, cand: dict[str, np.ndarray]) -> np.ndarray:
    """Per-candidate `GNNDataflow.is_sp_optimized` from the tile columns."""
    n = len(cand["t_v_a"])
    if skeleton.inter != InterPhase.SP:
        return np.zeros(n, dtype=bool)
    spec = _GroupSpec(
        skeleton.inter, skeleton.order, skeleton.agg.order, skeleton.cmb.order
    )
    if spec.granularity != Granularity.ELEMENT:
        return np.zeros(n, dtype=bool)
    if skeleton.order == PhaseOrder.AC:
        return (
            (cand["t_n"] == 1)
            & (cand["t_g"] == 1)
            & (cand["t_v_a"] == cand["t_v_c"])
            & (cand["t_f_a"] == cand["t_f_c"])
        )
    return (
        (cand["t_v_a"] == 1)
        & (cand["t_f_c"] == 1)
        & (cand["t_n"] == cand["t_v_c"])
        & (cand["t_f_a"] == cand["t_g"])
    )


def _pareto_mask(cycles: np.ndarray, energy: np.ndarray, legal: np.ndarray) -> np.ndarray:
    """True where a legal candidate is not strictly dominated in
    (cycles, energy) — i.e. no other legal candidate is <= on both axes and
    < on at least one."""
    keep = np.zeros(len(cycles), dtype=bool)
    idx = np.flatnonzero(legal)
    if len(idx) == 0:
        return keep
    c, en = cycles[idx], energy[idx]
    order = np.lexsort((en, c))
    c_s, e_s = c[order], en[order]
    new_c = np.concatenate(([True], c_s[1:] > c_s[:-1]))
    starts = np.flatnonzero(new_c)
    gid = np.cumsum(new_c) - 1
    gmin = np.minimum.reduceat(e_s, starts)
    prev = np.concatenate(([np.inf], np.minimum.accumulate(gmin)[:-1]))
    keep_s = (e_s == gmin[gid]) & (e_s < prev[gid])
    keep[idx[order[keep_s]]] = True
    return keep


def _concretize_at(
    skeleton: DataflowSkeleton, cand: dict[str, np.ndarray], i: int
) -> GNNDataflow:
    at = {
        "V": int(cand["t_v_a"][i]),
        "N": int(cand["t_n"][i]),
        "F": int(cand["t_f_a"][i]),
    }
    ct = {
        "V": int(cand["t_v_c"][i]),
        "G": int(cand["t_g"][i]),
        "F": int(cand["t_f_c"][i]),
    }
    return skeleton.concretize(at, ct, pe_split=float(cand["pe_split"][i]))


# ---------------------------------------------------------------------------
# Search
# ---------------------------------------------------------------------------


def optimize_tiles_topk(
    skeleton: DataflowSkeleton,
    wl: GNNLayerWorkload,
    hw: AcceleratorConfig = DEFAULT_ACCEL,
    objective: str = "edp",
    pe_splits: tuple[float, ...] = (0.5,),
    max_evals: int = 4096,
    top_k: int = 1,
    tile_stats: TileStats | None = None,
) -> list[MappingResult]:
    """Search tile sizes (and PP PE splits) for a dataflow skeleton; return
    up to ``top_k`` mappings, best-``objective`` first.

    The grid is scored by the batched engine, then dominance-pruned: the
    ``top_k`` are drawn from the (cycles, energy) Pareto front — a mapping
    strictly dominated by another candidate is never returned, even if its
    objective value ranks among the k best — extending past the front only
    when it holds fewer than ``top_k`` points.  Returned mappings carry full
    :class:`RunStats` from the scalar ``simulate`` oracle.  ``top_k=1``
    always yields the global objective optimum (the front contains it).
    """
    cand = _candidate_grid(skeleton, wl, hw, pe_splits, max_evals)
    if not cand or len(cand["t_v_a"]) == 0:
        raise RuntimeError(f"no legal tiling found for {skeleton.name}")
    ts = tile_stats if tile_stats is not None else TileStats(wl.nnz)
    spec = _GroupSpec(
        skeleton.inter, skeleton.order, skeleton.agg.order, skeleton.cmb.order
    )
    res = _eval_candidates(spec, cand, wl, hw, ts)
    batch = BatchStats(
        cycles=res["cycles"],
        energy_pj=res["energy_pj"],
        legal=res["legal"],
        agg_cycles=res["agg_cycles"],
        cmb_cycles=res["cmb_cycles"],
        macs=res["macs"],
    )
    obj = batch.masked_objective(objective)
    if not np.isfinite(obj).any():
        raise RuntimeError(f"no legal tiling found for {skeleton.name}")

    keep = _pareto_mask(batch.cycles, batch.energy_pj, batch.legal)
    front = np.flatnonzero(keep)
    ranked = front[np.argsort(obj[front], kind="stable")]
    if len(ranked) < top_k:
        # Pareto front smaller than top_k: extend with the next-best
        # dominated candidates, then restore overall objective order.
        rest = np.flatnonzero(batch.legal & ~keep)
        rest = rest[np.argsort(obj[rest], kind="stable")]
        ranked = np.concatenate([ranked, rest])
    chosen = ranked[:top_k]
    chosen = chosen[np.argsort(obj[chosen], kind="stable")]
    out = []
    for i in chosen:
        df = _concretize_at(skeleton, cand, int(i))
        out.append(MappingResult(df, simulate(df, wl, hw), skeleton=skeleton.name))
    return out


def optimize_tiles(
    skeleton: DataflowSkeleton,
    wl: GNNLayerWorkload,
    hw: AcceleratorConfig = DEFAULT_ACCEL,
    objective: str = "edp",
    pe_splits: tuple[float, ...] = (0.5,),
    max_evals: int = 4096,
    tile_stats: TileStats | None = None,
    engine: str = "batch",
) -> MappingResult:
    """Best mapping for a dataflow skeleton (see :func:`optimize_tiles_topk`).

    ``engine="scalar"`` runs the original per-candidate loop over the scalar
    simulator — the reference oracle the batch engine is validated against.
    """
    if engine == "scalar":
        return _optimize_tiles_scalar(
            skeleton, wl, hw, objective, pe_splits, max_evals
        )
    if engine != "batch":
        raise ValueError(f"unknown engine {engine!r}; use 'batch' or 'scalar'")
    return optimize_tiles_topk(
        skeleton,
        wl,
        hw,
        objective=objective,
        pe_splits=pe_splits,
        max_evals=max_evals,
        top_k=1,
        tile_stats=tile_stats,
    )[0]


def _optimize_tiles_scalar(
    skeleton: DataflowSkeleton,
    wl: GNNLayerWorkload,
    hw: AcceleratorConfig,
    objective: str,
    pe_splits: tuple[float, ...],
    max_evals: int,
) -> MappingResult:
    """Reference search: one scalar `simulate` per candidate."""
    agg_ext = {
        "V": wl.v,
        "N": max(int(wl.nnz.max()), 1),
        "F": wl.f_in if skeleton.order == PhaseOrder.AC else wl.g_out,
    }
    cmb_ext = {"V": wl.v, "G": wl.g_out, "F": wl.f_in}
    splits = pe_splits if skeleton.inter == InterPhase.PP else (0.5,)

    best: MappingResult | None = None
    for split in splits:
        if skeleton.inter == InterPhase.PP:
            pe_first = max(1, int(round(hw.n_pes * split)))
            pe_second = max(1, hw.n_pes - pe_first)
            if skeleton.order == PhaseOrder.AC:
                b_agg, b_cmb = pe_first, pe_second
            else:
                b_agg, b_cmb = pe_second, pe_first
        else:
            b_agg = b_cmb = hw.n_pes

        agg_tilings = _phase_tilings(skeleton.agg, agg_ext, b_agg)
        if skeleton.sp_optimized:
            pairs = []
            for at in agg_tilings:
                if at.get("N", 1) != 1:
                    continue  # SP-Optimized: temporal reduction (T_N = 1)
                ct = {"V": at["V"], "F": at["F"], "G": 1}
                if at["V"] * at["F"] <= b_cmb:
                    pairs.append((at, ct))
        else:
            cmb_tilings = _phase_tilings(skeleton.cmb, cmb_ext, b_cmb)
            pairs = list(itertools.product(agg_tilings, cmb_tilings))
        if len(pairs) > max_evals:
            idx = np.linspace(0, len(pairs) - 1, max_evals).astype(int)
            pairs = [pairs[i] for i in idx]
        for at, ct in pairs:
            df = skeleton.concretize(at, ct, pe_split=split)
            try:
                stats = simulate(df, wl, hw)
            except ValueError:
                continue
            res = MappingResult(df, stats, skeleton=skeleton.name)
            if best is None or res.objective(objective) < best.objective(objective):
                best = res
    if best is None:
        raise RuntimeError(f"no legal tiling found for {skeleton.name}")
    return best


def sweep_pe_splits(
    skeleton: DataflowSkeleton,
    wl: GNNLayerWorkload,
    hw: AcceleratorConfig = DEFAULT_ACCEL,
    objective: str = "cycles",
    pe_splits: tuple[float, ...] = (0.25, 0.5, 0.75),
    max_evals: int = 4096,
    tile_stats: TileStats | None = None,
) -> dict[float, MappingResult]:
    """Best mapping *per PP PE split* from one batched evaluation of the
    whole (tiling x split) grid — the engine behind the paper's Fig. 12
    load-balancing study.  Splits with no legal tiling are omitted; non-PP
    skeletons collapse to the single ``0.5`` entry (their phases share all
    PEs)."""
    get_objective(objective)
    cand = _candidate_grid(skeleton, wl, hw, tuple(pe_splits), max_evals)
    if not cand or len(cand["t_v_a"]) == 0:
        raise RuntimeError(f"no legal tiling found for {skeleton.name}")
    ts = tile_stats if tile_stats is not None else TileStats(wl.nnz)
    spec = _GroupSpec(
        skeleton.inter, skeleton.order, skeleton.agg.order, skeleton.cmb.order
    )
    res = _eval_candidates(spec, cand, wl, hw, ts)
    obj = objective_value(objective, res["cycles"], res["energy_pj"])
    obj = np.asarray(obj, dtype=np.float64)
    obj[~res["legal"]] = np.inf
    out: dict[float, MappingResult] = {}
    for s in np.unique(cand["pe_split"]):
        rows = np.flatnonzero(cand["pe_split"] == s)
        if len(rows) == 0 or not np.isfinite(obj[rows]).any():
            continue
        i = int(rows[np.argmin(obj[rows])])
        df = _concretize_at(skeleton, cand, i)
        out[float(s)] = MappingResult(
            df, simulate(df, wl, hw), skeleton=skeleton.name
        )
    if not out:
        raise RuntimeError(f"no legal tiling found for {skeleton.name}")
    return out


#: The paper's Table 5 evaluation set.
TABLE5_NAMES = (
    "Seq-Nt",
    "Seq-Ns",
    "SP-FsNt-Fs",
    "SP-VsNt-Vs",
    "High-Vs-SP",
    "PP-Nt-Vt/sl",
    "PP-Ns-Vt/sl",
    "PP-Nt-Vsh",
    "PP-Ns-Vsh",
)


def search_dataflows(
    wl: GNNLayerWorkload,
    hw: AcceleratorConfig = DEFAULT_ACCEL,
    objective: str = "edp",
    names: tuple[str, ...] = TABLE5_NAMES,
    pe_splits: tuple[float, ...] = (0.25, 0.5, 0.75),
    top_k: int = 1,
    tile_stats: TileStats | None = None,
) -> list[MappingResult]:
    """Rank dataflow skeletons (default: the paper's Table 5 set) for a
    workload.  Returns up to ``top_k`` Pareto-optimal mappings per skeleton
    (see :func:`optimize_tiles_topk`), sorted by the objective — this is the
    workload-adaptive dataflow choice the paper argues flexible accelerators
    enable.  The :class:`TileStats` cache is shared across all skeletons, so
    the whole sweep costs one O(V log V) ladder build plus numpy grid
    math."""
    get_objective(objective)  # fail fast on unknown names, listing valid ones
    ts = tile_stats if tile_stats is not None else TileStats(wl.nnz)
    out: list[MappingResult] = []
    for n in names:
        try:
            out.extend(
                optimize_tiles_topk(
                    named_skeleton(n),
                    wl,
                    hw,
                    objective=objective,
                    pe_splits=pe_splits,
                    top_k=top_k,
                    tile_stats=ts,
                )
            )
        except (RuntimeError, ValueError):
            continue
    out.sort(key=lambda r: r.objective(objective))
    return out


def search_execution_plans(
    g,
    dims,
    hw: AcceleratorConfig = DEFAULT_ACCEL,
    objective: str = "edp",
    **kwargs,
):
    """Rank whole-graph execution plans — monolithic vs partitioned.

    Extends :func:`search_dataflows` above the single-layer level: each
    candidate's per-layer compute is priced by ``search_dataflows`` and
    its inter-partition traffic by
    :func:`repro_torch.core.simulator.partition_comm_cost`, so
    beyond-capacity graphs can be ranked against (spill-priced) monolithic
    execution on the same objective scale.  Returns a
    :class:`repro_torch.graphs.partition.PartitionPlan`; see
    :func:`repro_torch.graphs.partition.plan_partition` for the knobs.
    """
    from ..graphs.partition import plan_partition  # local: graphs imports core

    return plan_partition(g, dims, hw, objective=objective, **kwargs)


# ---------------------------------------------------------------------------
# Model-level search: DP over per-layer candidates with transition costs
# ---------------------------------------------------------------------------


def _tile_stats_cache(caches: dict[int, TileStats] | None = None):
    """Per-graph :class:`TileStats` memo shared by the multi-workload
    searches: one ladder per distinct degree vector, keyed by ``id(nnz)``
    (layers of one model alias the same array).  Returns a ``ts_for(wl)``
    lookup; pass an existing dict to share ladders across calls (the
    hw-grid sweeps do)."""
    store = caches if caches is not None else {}

    def ts_for(wl: GNNLayerWorkload) -> TileStats:
        key = id(wl.nnz)
        if key not in store:
            store[key] = TileStats(wl.nnz)
        return store[key]

    return ts_for


def _dp_assign(
    layer_dfs: list[list[GNNDataflow]],
    layer_obj: list[np.ndarray],
    workloads: list[GNNLayerWorkload],
    hw: AcceleratorConfig,
    objective: str,
) -> tuple[list[int], float]:
    """Exact dynamic program over per-layer candidate dataflows.

    ``layer_obj[i][j]`` is layer *i* candidate *j*'s additive objective;
    edges between consecutive layers are priced by
    :func:`~repro.core.simulator.transition_cost`.  Returns the chosen
    candidate index per layer and the end-to-end objective — equal to
    brute-force enumeration over the same candidate lists
    (``tests/test_schedule.py`` pins this).
    """
    prev_cost = np.asarray(layer_obj[0], dtype=np.float64)
    back: list[np.ndarray] = []
    for i in range(1, len(layer_dfs)):
        cur = np.asarray(layer_obj[i], dtype=np.float64)
        trans = np.empty((len(prev_cost), len(cur)), dtype=np.float64)
        for j, a in enumerate(layer_dfs[i - 1]):
            for k, b in enumerate(layer_dfs[i]):
                trans[j, k] = transition_cost(
                    a, b, v=workloads[i].v, f=workloads[i].f_in, hw=hw
                ).objective(objective)
        tot = prev_cost[:, None] + trans
        arg = tot.argmin(axis=0)
        back.append(arg)
        prev_cost = tot[arg, np.arange(len(cur))] + cur
    end = int(prev_cost.argmin())
    total = float(prev_cost[end])
    idx = [end]
    for arg in reversed(back):
        idx.append(int(arg[idx[-1]]))
    return idx[::-1], total


def search_model(
    workloads: list[GNNLayerWorkload],
    hw: AcceleratorConfig = DEFAULT_ACCEL,
    objective: str = "cycles",
    names: tuple[str, ...] = TABLE5_NAMES,
    pe_splits: tuple[float, ...] = (0.25, 0.5, 0.75),
    top_k: int = 4,
    shared_dataflow: bool = False,
    tile_stats_caches: dict[int, TileStats] | None = None,
) -> ModelSchedule:
    """End-to-end mapper for a multi-layer GNN (paper Sec. 4.4 composed).

    Per layer, the batched Table-5 sweep (:func:`search_dataflows`, sharing
    one :class:`TileStats` cache per distinct graph) yields up to
    ``top_k`` Pareto candidates per skeleton; a dynamic program then picks
    one candidate per layer minimizing ``sum(layer objective) +
    sum(transition objective)`` where mismatched inter-layer walks charge
    the re-layout of the V x F intermediate.

    ``shared_dataflow=True`` reproduces the homogeneous baseline: the
    single concrete dataflow (drawn from the same candidate pool) that
    minimizes the end-to-end objective when reused for every layer.  The
    heterogeneous DP also sees that winner as a candidate in every layer,
    so its result is never worse than the homogeneous one.

    ``objective`` must be additive across layers: "cycles" or "energy".
    Returns a :class:`ModelSchedule` whose layers carry per-layer
    ``RunStats`` and whose ``stats`` is the end-to-end
    :class:`~repro.core.simulator.ModelStats`; the schedule records the
    ``hw`` it was priced on.  ``tile_stats_caches`` (an ``id(nnz) ->
    TileStats`` dict) lets a hardware-grid sweep share the tile ladders
    across hw points.
    """
    if not get_objective(objective).additive:
        raise ValueError(
            f"model-level objective must be additive "
            f"({', '.join(objective_names(additive_only=True))}), "
            f"got {objective!r}"
        )
    if not workloads:
        raise ValueError("need at least one layer workload")
    validate_workload_chain(workloads)

    ts_for = _tile_stats_cache(tile_stats_caches)

    per_layer = [
        search_dataflows(
            wl,
            hw,
            objective=objective,
            names=names,
            pe_splits=pe_splits,
            top_k=top_k,
            tile_stats=ts_for(wl),
        )
        for wl in workloads
    ]
    for i, cands in enumerate(per_layer):
        if not cands:
            raise RuntimeError(f"no legal mapping found for layer {i}")

    # ---- homogeneous baseline: one concrete dataflow reused everywhere ----
    # scored on the batch engine (one vectorized pass per layer over the
    # whole candidate pool), with the self-transition charged when a
    # dataflow's own output walk disagrees with its input walk; only the
    # winner is re-simulated through the scalar oracle.
    pool: list[GNNDataflow] = []
    for cands in per_layer:
        for r in cands:
            if r.dataflow not in pool:
                pool.append(r.dataflow)
    totals = np.zeros(len(pool), dtype=np.float64)
    for wl in workloads:
        batch = simulate_batch(pool, wl, hw, tile_stats=ts_for(wl))
        totals += batch.masked_objective(objective)
    for k, df in enumerate(pool):
        if not np.isfinite(totals[k]):
            continue
        totals[k] += sum(
            transition_cost(
                df, df, v=workloads[i].v, f=workloads[i].f_in, hw=hw
            ).objective(objective)
            for i in range(1, len(workloads))
        )
    if not np.isfinite(totals).any():
        raise RuntimeError("no candidate dataflow is legal across all layers")
    best_shared = pool[int(np.argmin(totals))]
    best_shared_stats = simulate_model([best_shared], list(workloads), hw)
    shared_schedule = ModelSchedule(
        tuple(
            LayerSchedule(best_shared, wl.f_in, wl.g_out, name=wl.name, stats=st)
            for wl, st in zip(workloads, best_shared_stats.layers)
        ),
        tuple(t.spec for t in best_shared_stats.transitions),
        objective=objective,
        stats=best_shared_stats,
        hw=hw,
    )

    if shared_dataflow:
        return shared_schedule

    layer_dfs = [[r.dataflow for r in cands] for cands in per_layer]
    layer_obj = [
        np.array([r.objective(objective) for r in cands], dtype=np.float64)
        for cands in per_layer
    ]
    # guarantee DP <= homogeneous: the shared winner is a path in the DP
    for i, wl in enumerate(workloads):
        if best_shared not in layer_dfs[i]:
            layer_dfs[i].append(best_shared)
            layer_obj[i] = np.append(
                layer_obj[i],
                best_shared_stats.layers[i].cycles
                if objective == "cycles"
                else best_shared_stats.layers[i].energy_pj,
            )
    idx, _ = _dp_assign(layer_dfs, layer_obj, list(workloads), hw, objective)
    chosen = [layer_dfs[i][j] for i, j in enumerate(idx)]
    stats = simulate_model(chosen, list(workloads), hw)

    layers = tuple(
        LayerSchedule(df, wl.f_in, wl.g_out, name=wl.name, stats=st)
        for df, wl, st in zip(chosen, workloads, stats.layers)
    )
    transitions = tuple(t.spec for t in stats.transitions)
    return ModelSchedule(
        layers,
        transitions,
        objective=objective,
        stats=stats,
        shared_baseline=shared_schedule,
        hw=hw,
    )


def search_model_topk(
    workloads: list[GNNLayerWorkload],
    hw: AcceleratorConfig = DEFAULT_ACCEL,
    objective: str = "cycles",
    names: tuple[str, ...] = TABLE5_NAMES,
    pe_splits: tuple[float, ...] = (0.25, 0.5, 0.75),
    top_k: int = 4,
    tile_stats_caches: dict[int, TileStats] | None = None,
) -> list[ModelSchedule]:
    """Ranked candidate schedules for measured re-ranking.

    The analytic winner alone is what :func:`search_model` returns; the
    serving engine's execution-feedback loop (Bao-style) instead wants the
    model's *top-k* so it can time each candidate on the real backend and
    keep the measured best.  Returns up to ``top_k`` schedules, analytic
    best first: the DP winner, the homogeneous shared baseline, and the
    best homogeneous schedule per distinct *executable policy family*
    (``seq`` / ``sp_generic`` / ``sp_opt`` / ``pp``) from the per-layer
    candidate pool — family diversity is what gives measurement something
    meaningful to choose between, since same-family tilings lower to the
    same kernels.  Deduplicated by :meth:`ModelSchedule.digest`; every
    candidate carries its own priced stats on ``hw``.
    """
    caches = tile_stats_caches if tile_stats_caches is not None else {}
    winner = search_model(
        workloads,
        hw,
        objective=objective,
        names=names,
        pe_splits=pe_splits,
        top_k=top_k,
        tile_stats_caches=caches,
    )
    candidates: list[ModelSchedule] = [winner]
    if winner.shared_baseline is not None:
        candidates.append(winner.shared_baseline)

    # homogeneous candidates from the same per-layer pool the DP saw
    ts_for = _tile_stats_cache(caches)
    pool: list[GNNDataflow] = []
    for wl in workloads:
        for r in search_dataflows(
            wl,
            hw,
            objective=objective,
            names=names,
            pe_splits=pe_splits,
            top_k=top_k,
            tile_stats=ts_for(wl),
        ):
            if r.dataflow not in pool:
                pool.append(r.dataflow)
    by_family: dict[str, ModelSchedule] = {}
    for df in pool:
        try:
            stats = simulate_model([df], list(workloads), hw)
        except ValueError:  # illegal on some layer of this model
            continue
        sched = ModelSchedule(
            tuple(
                LayerSchedule(df, wl.f_in, wl.g_out, name=wl.name, stats=st)
                for wl, st in zip(workloads, stats.layers)
            ),
            tuple(t.spec for t in stats.transitions),
            objective=objective,
            stats=stats,
            hw=hw,
        )
        fam = sched.layers[0].lower().policy
        cur = by_family.get(fam)
        if cur is None or stats.objective(objective) < cur.stats.objective(
            objective
        ):
            by_family[fam] = sched
    candidates.extend(by_family.values())

    seen: set[str] = set()
    unique: list[ModelSchedule] = []
    for s in candidates:
        dig = s.digest()
        if dig not in seen:
            seen.add(dig)
            unique.append(s)
    unique.sort(key=lambda s: s.stats.objective(objective))
    return unique[: max(1, int(top_k))]


# ---------------------------------------------------------------------------
# Hardware co-design: dataflow x hardware grid search + value of flexibility
# ---------------------------------------------------------------------------


@dataclass
class CodesignPoint:
    """One hardware grid point of a :func:`search_codesign` sweep."""

    hw: AcceleratorConfig
    hw_cost: float  # n_pes x gb_bandwidth provisioning proxy
    objective_total: float  # sum of per-workload best objectives (inf = infeasible)
    dataflows: list[GNNDataflow | None]  # per-workload winner
    on_frontier: bool = False
    #: scalar-oracle pricing of the winners; filled for frontier points only
    mappings: list[MappingResult] | None = None

    @property
    def feasible(self) -> bool:
        return bool(np.isfinite(self.objective_total))


@dataclass
class CodesignResult:
    """Joint (hardware, dataflow) search result over an :class:`HWGrid`."""

    objective: str
    grid: HWGrid
    points: list[CodesignPoint]

    @property
    def frontier(self) -> list[CodesignPoint]:
        """The joint Pareto frontier (objective vs hw-cost), cheapest-hw
        first — the paper's "what does flexibility buy at each provisioning
        level" curve."""
        return sorted(
            (p for p in self.points if p.on_frontier), key=lambda p: p.hw_cost
        )

    @property
    def best(self) -> CodesignPoint:
        """The feasible point with the best objective (ties: cheaper hw)."""
        feas = [p for p in self.points if p.feasible]
        if not feas:
            raise RuntimeError("no feasible hardware point in the grid")
        return min(feas, key=lambda p: (p.objective_total, p.hw_cost))


def _grid_best_per_point(
    wl: GNNLayerWorkload,
    grid: HWGrid,
    objective: str,
    names: tuple[str, ...],
    pe_splits: tuple[float, ...],
    max_evals: int,
    ts: TileStats,
) -> tuple[np.ndarray, list[GNNDataflow | None]]:
    """Best (objective value, concrete dataflow) per hw grid point for one
    workload.  Hw points sharing an ``n_pes`` also share their candidate
    tiling grids (the PE budget is what shapes them), so the sweep costs one
    vectorized ``_eval_candidates`` per (skeleton, distinct n_pes) — the
    bandwidth / capacity axes ride along as broadcast columns."""
    cols = grid.columns()
    n_hw = len(grid)
    best_obj = np.full(n_hw, np.inf)
    winners: list[tuple[DataflowSkeleton, dict, int] | None] = [None] * n_hw
    for npes in np.unique(cols["n_pes"]):
        sel = np.flatnonzero(cols["n_pes"] == npes)
        budget_hw = replace(grid.base, n_pes=int(npes))
        sub_cols = {k: c[sel] for k, c in cols.items()}
        for name in names:
            skeleton = named_skeleton(name)
            cand = _candidate_grid(skeleton, wl, budget_hw, pe_splits, max_evals)
            if not cand or len(cand["t_v_a"]) == 0:
                continue
            spec = _GroupSpec(
                skeleton.inter,
                skeleton.order,
                skeleton.agg.order,
                skeleton.cmb.order,
            )
            res = _eval_candidates(
                spec, expand_hw_columns(cand, sub_cols), wl, grid.base, ts
            )
            obj = np.asarray(
                objective_value(objective, res["cycles"], res["energy_pj"]),
                dtype=np.float64,
            )
            obj[~res["legal"]] = np.inf
            obj = obj.reshape(-1, len(sel))
            arg = np.argmin(obj, axis=0)
            val = obj[arg, np.arange(len(sel))]
            for j, h in enumerate(sel):
                if val[j] < best_obj[h]:
                    best_obj[h] = val[j]
                    winners[h] = (skeleton, cand, int(arg[j]))
    dataflows = [
        _concretize_at(w[0], w[1], w[2]) if w is not None else None
        for w in winners
    ]
    return best_obj, dataflows


def search_codesign(
    workloads: list[GNNLayerWorkload],
    hw_grid: HWGrid,
    objective: str = "edp",
    names: tuple[str, ...] = TABLE5_NAMES,
    pe_splits: tuple[float, ...] = (0.25, 0.5, 0.75),
    max_evals: int = 4096,
    price_frontier: bool = True,
) -> CodesignResult:
    """Joint hardware x dataflow search: price the whole (dataflow x tiling
    x hw grid) space in vectorized passes and return every grid point with
    its per-workload best mapping, marking the (objective, hw-cost) Pareto
    frontier.

    Each hw point's objective is the *suite total* — the sum over
    ``workloads`` of the best objective a flexible accelerator of that
    provisioning reaches (dataflow re-chosen per workload, the paper's
    flexibility premise; :func:`flexibility_value` prices the premise
    itself).  ``hw_cost`` is the ``n_pes x gb_bandwidth`` proxy from
    :meth:`HWGrid.hw_cost`.  Frontier points get their winners re-priced
    through the scalar :func:`~repro.core.simulator.simulate` oracle
    (``price_frontier=False`` skips that for large grids).
    """
    get_objective(objective)
    if not workloads:
        raise ValueError("need at least one workload")
    if not isinstance(hw_grid, HWGrid):
        raise TypeError(
            f"hw_grid must be an HWGrid, got {type(hw_grid).__name__} "
            "(wrap a single AcceleratorConfig's axes: HWGrid(n_pes=..., ...))"
        )

    ts_for = _tile_stats_cache()

    per_wl = [
        _grid_best_per_point(
            wl, hw_grid, objective, names, pe_splits, max_evals, ts_for(wl)
        )
        for wl in workloads
    ]
    totals = np.sum([obj for obj, _ in per_wl], axis=0)
    hw_cost = hw_grid.hw_cost()
    frontier = _pareto_mask(totals, hw_cost, np.isfinite(totals))

    points = []
    for h, cfg in enumerate(hw_grid.configs()):
        dfs = [per_wl[w][1][h] for w in range(len(workloads))]
        pt = CodesignPoint(
            hw=cfg,
            hw_cost=float(hw_cost[h]),
            objective_total=float(totals[h]),
            dataflows=dfs,
            on_frontier=bool(frontier[h]),
        )
        if pt.on_frontier and price_frontier:
            pt.mappings = [
                MappingResult(df, simulate(df, wl, cfg))
                for df, wl in zip(dfs, workloads)
            ]
        points.append(pt)
    return CodesignResult(objective=objective, grid=hw_grid, points=points)


@dataclass
class FlexibilityReport:
    """The paper's "value of flexibility", made quantitative: how much a
    workload-adaptive (flexible) accelerator beats the best *single fixed
    dataflow* across a workload suite on the same hardware."""

    objective: str
    hw: AcceleratorConfig
    #: flexible accelerator: best dataflow re-chosen per workload
    per_workload: list[MappingResult]
    #: rigid accelerator: the one dataflow minimizing the suite total,
    #: priced on every workload
    fixed: list[MappingResult]

    @property
    def fixed_dataflow(self) -> GNNDataflow:
        return self.fixed[0].dataflow

    @property
    def flexible_total(self) -> float:
        return sum(r.objective(self.objective) for r in self.per_workload)

    @property
    def fixed_total(self) -> float:
        return sum(r.objective(self.objective) for r in self.fixed)

    @property
    def value(self) -> float:
        """fixed / flexible objective ratio; >= 1.0 up to the 1e-6
        scalar/batch oracle-parity tolerance (both sides are picked by
        batch scores over the same candidate pool, then re-priced through
        the scalar oracle), > 1.0 exactly when no single dataflow is best
        for every workload."""
        return self.fixed_total / max(self.flexible_total, 1e-300)

    @property
    def win_pct(self) -> float:
        return (self.value - 1.0) * 100.0


def flexibility_value(
    workloads: list[GNNLayerWorkload],
    hw: AcceleratorConfig = DEFAULT_ACCEL,
    objective: str = "edp",
    names: tuple[str, ...] = TABLE5_NAMES,
    pe_splits: tuple[float, ...] = (0.25, 0.5, 0.75),
    top_k: int = 4,
) -> FlexibilityReport:
    """Quantify the value of dataflow flexibility on a workload suite.

    Runs the per-workload Table-5 search, pools every candidate the
    searches surfaced, and scores the whole pool on every workload with one
    :func:`~repro.core.simulator.simulate_batch` call per workload (shared
    :class:`TileStats`).  The *flexible* cost re-picks the pool's best per
    workload; the *fixed* cost forces the single pool dataflow with the
    best suite total everywhere — both sides drawn from the same pool, so
    ``value >= 1`` by construction and the gap is exactly what hardware
    flexibility buys (cf. VersaGNN's motivation, arXiv:2105.01280).
    """
    get_objective(objective)
    if not workloads:
        raise ValueError("need at least one workload")

    ts_for = _tile_stats_cache()

    per_search = [
        search_dataflows(
            wl,
            hw,
            objective=objective,
            names=names,
            pe_splits=pe_splits,
            top_k=top_k,
            tile_stats=ts_for(wl),
        )
        for wl in workloads
    ]
    for i, res in enumerate(per_search):
        if not res:
            raise RuntimeError(
                f"no legal mapping found for workload {i} "
                f"({workloads[i].name or 'unnamed'})"
            )
    pool: list[GNNDataflow] = []
    for res in per_search:
        for r in res:
            if r.dataflow not in pool:
                pool.append(r.dataflow)

    score = np.empty((len(pool), len(workloads)), dtype=np.float64)
    for w, wl in enumerate(workloads):
        batch = simulate_batch(pool, wl, hw, tile_stats=ts_for(wl))
        score[:, w] = batch.masked_objective(objective)

    flex_idx = np.argmin(score, axis=0)  # per-workload pool winner
    totals = score.sum(axis=1)  # inf wherever illegal on any workload
    if not np.isfinite(totals).any():
        raise RuntimeError("no pool dataflow is legal across the whole suite")
    fixed_idx = int(np.argmin(totals))

    per_workload = [
        MappingResult(pool[int(i)], simulate(pool[int(i)], wl, hw))
        for i, wl in zip(flex_idx, workloads)
    ]
    fixed = [
        MappingResult(pool[fixed_idx], simulate(pool[fixed_idx], wl, hw))
        for wl in workloads
    ]
    return FlexibilityReport(
        objective=objective, hw=hw, per_workload=per_workload, fixed=fixed
    )


def search_model_codesign(
    workloads: list[GNNLayerWorkload],
    hw_grid: HWGrid,
    objective: str = "cycles",
    names: tuple[str, ...] = TABLE5_NAMES,
    pe_splits: tuple[float, ...] = (0.25, 0.5, 0.75),
    top_k: int = 4,
) -> list[ModelSchedule | None]:
    """:func:`search_model` at every point of a hardware grid, sharing the
    per-graph :class:`TileStats` ladders across points.  Transition costs
    are re-priced inside each point's DP on that point's bandwidth /
    capacity, so the chosen schedule can change shape with the hardware
    (e.g. relayouts become affordable at high bandwidth).  One
    :class:`ModelSchedule` per grid point, in grid order, each recording
    its ``hw`` — ``None`` where the point admits no legal mapping."""
    if not isinstance(hw_grid, HWGrid):
        raise TypeError(
            f"hw_grid must be an HWGrid, got {type(hw_grid).__name__}"
        )
    caches: dict[int, TileStats] = {}
    out: list[ModelSchedule | None] = []
    for cfg in hw_grid.configs():
        try:
            out.append(
                search_model(
                    workloads,
                    cfg,
                    objective=objective,
                    names=names,
                    pe_splits=pe_splits,
                    top_k=top_k,
                    tile_stats_caches=caches,
                )
            )
        except RuntimeError:
            out.append(None)
    return out
