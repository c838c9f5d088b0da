"""Analytical per-phase cost model (paper Sec. 4, Tables 1-3).

The model is a single-level "Timeloop-lite": each PE's register file holds
one tile per operand; a tile is (re)fetched from the Global Buffer whenever
any loop at or above the operand's innermost *effective* relevant loop
increments (degenerate trip-count-1 loops grant free reuse and are dropped
from the nest).  Spatially-mapped dimensions multicast tiles across lanes,
so spatial unrolling never multiplies GB traffic — exactly the paper's
Table 1 semantics (e.g. ``{GsFs}Vt`` keeps weights stationary, ``{VsGs}Ft``
keeps outputs stationary and streams both inputs).

Aggregation is ragged: vertex tiles run in lockstep, so a tile's neighbor
trip count is ``ceil(max_nnz_in_tile / T_N)`` — this is how "evil rows"
(paper Sec. 5.2.1, AWB-GCN) show up as both load imbalance and padded
occupancy.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .hw import AcceleratorConfig
from .taxonomy import (
    Binding,
    GNNDataflow,
    IntraPhaseDataflow,
    InterPhase,
    PhaseOrder,
)


@dataclass(frozen=True)
class GNNLayerWorkload:
    """One GCN layer: AX W (AC) or A (XW) (CA) over a CSR graph."""

    nnz: np.ndarray  # per-vertex neighbor count (self-loops included)
    f_in: int
    g_out: int
    name: str = ""

    @property
    def v(self) -> int:
        return int(len(self.nnz))

    @property
    def e(self) -> int:
        return int(self.nnz.sum())

    def macs(self, order: PhaseOrder) -> tuple[int, int]:
        """(aggregation MACs, combination MACs)."""
        cmb = self.v * self.f_in * self.g_out
        agg = self.e * (self.f_in if order == PhaseOrder.AC else self.g_out)
        return agg, cmb


@dataclass
class PhaseCost:
    """Cost of one phase of one layer."""

    cycles: float
    macs: float
    # GB traffic in elements, keyed by logical operand:
    #   agg: adj / inp / out (+psum) ; cmb: inp / wt / out (+psum)
    gb_reads: dict[str, float] = field(default_factory=dict)
    gb_writes: dict[str, float] = field(default_factory=dict)
    rf_accesses: float = 0.0
    spatial_util: float = 0.0  # busy-lane fraction of the PE budget

    @property
    def gb_total(self) -> float:
        return sum(self.gb_reads.values()) + sum(self.gb_writes.values())


def _tiles_of(nnz: np.ndarray, t_v: int) -> np.ndarray:
    """Max nnz per consecutive vertex tile of size t_v."""
    v = len(nnz)
    n_tiles = -(-v // t_v)
    padded = np.full(n_tiles * t_v, 0, dtype=np.int64)
    padded[:v] = nnz
    return padded.reshape(n_tiles, t_v).max(axis=1)


def _ceil(a, b):
    return -(-a // b) if isinstance(a, (int, np.integer)) else np.ceil(a / b)


@dataclass
class BandStats:
    """Per-chunk producer-side trip counts for one PP chunking of a workload.

    ``band`` holds the sum of aggregation N-trips inside each pipeline chunk
    (a band of consecutive vertex tiles).  The sorted copy + prefix sums let
    the batch engine evaluate ``sum(max(alpha * band, gamma))`` — the
    two-stage-pipeline overlap term — in O(log n_chunks) per candidate via
    ``searchsorted`` instead of O(n_chunks).
    """

    band: np.ndarray  # (n_chunks,) float64 per-chunk ntrip sums
    sorted_all: np.ndarray  # band sorted ascending
    prefix_all: np.ndarray  # (n_chunks + 1,) cumulative sums of sorted_all
    sorted_tail: np.ndarray  # band[1:] sorted ascending
    prefix_tail: np.ndarray  # (n_chunks,) cumulative sums of sorted_tail

    @property
    def n_chunks(self) -> int:
        return len(self.band)

    @property
    def first(self) -> float:
        return float(self.band[0])

    @property
    def total(self) -> float:
        return float(self.prefix_all[-1])

    def sum_max_all(self, alpha: np.ndarray, gamma: np.ndarray) -> np.ndarray:
        """Vectorized ``sum_j max(alpha * band_j, gamma)`` over all chunks."""
        return self._sum_max(self.sorted_all, self.prefix_all, alpha, gamma)

    def sum_max_tail(self, alpha: np.ndarray, gamma: np.ndarray) -> np.ndarray:
        """Vectorized ``sum_{j>=1} max(alpha * band_j, gamma)``."""
        return self._sum_max(self.sorted_tail, self.prefix_tail, alpha, gamma)

    @staticmethod
    def _sum_max(srt, prefix, alpha, gamma):
        alpha = np.asarray(alpha, dtype=np.float64)
        gamma = np.asarray(gamma, dtype=np.float64)
        with np.errstate(divide="ignore", invalid="ignore"):
            thr = np.where(alpha > 0, gamma / np.maximum(alpha, 1e-300), np.inf)
        k = np.searchsorted(srt, thr, side="right")
        total = prefix[-1]
        return alpha * (total - prefix[k]) + gamma * k


class TileStats:
    """Per-workload memo of every tile-derived quantity the cost model and
    simulator need, so a mapper sweep never redoes O(V) numpy work per
    candidate.

    ``tile_max(t_v)`` — the per-vertex-tile max nnz array — is built by
    hierarchical doubling: ``tile_max(2k)`` is the pairwise max of
    consecutive entries of ``tile_max(k)`` (tile boundaries are consecutive,
    so halves always align; zero-padding is harmless under ``max``).  The
    whole power-of-two ladder therefore costs O(V log V) once per workload
    instead of O(V) per candidate tiling.
    """

    def __init__(self, nnz: np.ndarray):
        self.nnz = np.ascontiguousarray(np.asarray(nnz, dtype=np.int64))
        self._tile_max: dict[int, np.ndarray] = {}
        self._sum_ntrips: dict[tuple[int, int], float] = {}
        self._ntrips: dict[tuple[int, int], np.ndarray] = {}
        self._bands: dict[tuple[int, int, int], BandStats] = {}

    def tile_max(self, t_v: int) -> np.ndarray:
        """Max nnz per consecutive vertex tile of size ``t_v`` (cached)."""
        arr = self._tile_max.get(t_v)
        if arr is None:
            if t_v == 1:
                arr = self.nnz
            elif t_v % 2 == 0:
                half = self.tile_max(t_v // 2)
                if len(half) % 2:
                    half = np.append(half, 0)
                arr = half.reshape(-1, 2).max(axis=1)
            else:
                arr = _tiles_of(self.nnz, t_v)
            self._tile_max[t_v] = arr
        return arr

    def n_vtiles(self, t_v: int) -> int:
        return len(self.tile_max(t_v))

    def ntrips(self, t_v: int, t_n: int) -> np.ndarray:
        """Per-vertex-tile neighbor trip counts ``max(1, ceil(max_nnz/t_n))``."""
        key = (t_v, t_n)
        arr = self._ntrips.get(key)
        if arr is None:
            tm = self.tile_max(t_v)
            arr = np.maximum(1, -(-tm // t_n)).astype(np.float64)
            self._ntrips[key] = arr
        return arr

    def sum_ntrips(self, t_v: int, t_n: int) -> float:
        key = (t_v, t_n)
        val = self._sum_ntrips.get(key)
        if val is None:
            val = float(self.ntrips(*key).sum())
            self._sum_ntrips[key] = val
        return val

    def band_stats(self, t_v: int, t_n: int, vtiles_per_chunk: int) -> BandStats:
        """Per-chunk ntrip sums for bands of ``vtiles_per_chunk`` consecutive
        vertex tiles (the PP row/element chunking), with sorted prefix sums."""
        key = (t_v, t_n, vtiles_per_chunk)
        bs = self._bands.get(key)
        if bs is None:
            nt = self.ntrips(t_v, t_n)
            n_chunks = -(-len(nt) // vtiles_per_chunk)
            pad = n_chunks * vtiles_per_chunk - len(nt)
            if pad:
                nt = np.pad(nt, (0, pad))
            band = nt.reshape(n_chunks, vtiles_per_chunk).sum(axis=1)
            sorted_all = np.sort(band)
            sorted_tail = np.sort(band[1:])
            bs = BandStats(
                band=band,
                sorted_all=sorted_all,
                prefix_all=np.concatenate(([0.0], np.cumsum(sorted_all))),
                sorted_tail=sorted_tail,
                prefix_tail=np.concatenate(([0.0], np.cumsum(sorted_tail))),
            )
            self._bands[key] = bs
        return bs


def _loads(
    order: tuple[str, ...],
    trips: dict[str, float],
    relevant: tuple[str, ...],
) -> float:
    """Tile loads for an operand = product of trips of all loops at or above
    its innermost effective relevant loop (trip-1 loops dropped)."""
    eff = [d for d in order if trips[d] > 1]
    rel_pos = [i for i, d in enumerate(eff) if d in relevant]
    if not rel_pos:
        return 1.0
    j = max(rel_pos)
    out = 1.0
    for d in eff[: j + 1]:
        out *= trips[d]
    return out


def aggregation_cost(
    df: IntraPhaseDataflow,
    nnz: np.ndarray,
    feat_extent: int,
    hw: AcceleratorConfig,
    pe_budget: int | None = None,
    row_slice: slice | None = None,
    stats: "TileStats | None" = None,
) -> PhaseCost:
    """Cost of the aggregation phase (SpMM) under an intra-phase dataflow.

    ``feat_extent`` is F for AC and G for CA.  ``row_slice`` restricts the
    evaluation to a band of vertices (used for PP/SP chunk accounting).
    ``stats`` is an optional :class:`TileStats` cache for the *full* nnz
    array (ignored when ``row_slice`` is given).
    """
    pe_budget = pe_budget or hw.n_pes
    if df.spatial_footprint > pe_budget:
        raise ValueError(
            f"agg footprint {df.spatial_footprint} > PE budget {pe_budget}"
        )
    if row_slice is not None:
        nnz = nnz[row_slice]
        stats = None
    v = len(nnz)
    e = float(nnz.sum())
    if v == 0 or e == 0:
        return PhaseCost(cycles=0.0, macs=0.0)

    t_v, t_n, t_f = df.tile("V"), df.tile("N"), df.tile("F")
    order = df.order
    pos = {d: i for i, d in enumerate(order)}

    if stats is not None:
        ntrips = stats.ntrips(t_v, t_n)
        n_vtiles = stats.n_vtiles(t_v)
    else:
        tile_max = _tiles_of(nnz, t_v)  # (n_vtiles,)
        ntrips = np.maximum(1, -(-tile_max // t_n)).astype(np.float64)
        n_vtiles = len(tile_max)
    f_trips = float(_ceil(feat_extent, t_f))
    sum_ntrips = float(ntrips.sum())

    cycles = f_trips * sum_ntrips
    macs = e * feat_extent

    # ---- GB traffic -------------------------------------------------------
    reads: dict[str, float] = {}
    writes: dict[str, float] = {}
    # adjacency (CSR indices): re-read per F pass only if the F loop is
    # outside the N loop.
    adj_factor = f_trips if pos["F"] < pos["N"] else 1.0
    reads["adj"] = e * adj_factor
    # gathered neighbor features: irregular, no cross-vertex reuse.
    reads["inp"] = e * feat_extent
    # intermediate output (V x feat): partial-sum spills occur when the N
    # loop sits above an effective relevant loop of the output.
    spill = (pos["N"] < pos["F"] and f_trips > 1) or (
        pos["N"] < pos["V"] and n_vtiles > 1
    )
    out_elems = float(v * feat_extent)
    if spill:
        visits = float((ntrips * f_trips).sum()) * t_v * t_f
        writes["out"] = out_elems
        writes["psum"] = max(0.0, visits - out_elems)
        reads["psum"] = max(0.0, visits - out_elems)
    else:
        writes["out"] = out_elems

    # ---- RF ---------------------------------------------------------------
    # two operand reads per MAC; temporal reduction adds an accumulator
    # read+write per MAC (paper Table 1: "temporal reduction within each PE")
    rf = 2.0 * macs
    if df.binding("N") == Binding.TEMPORAL:
        rf += 2.0 * macs
    else:
        rf += macs / max(t_n, 1)  # adder-tree root writes

    # busy-lane fraction: real MACs over (lanes x busy cycles)
    util = macs / max(cycles * df.spatial_footprint, 1.0)
    return PhaseCost(
        cycles=cycles,
        macs=macs,
        gb_reads=reads,
        gb_writes=writes,
        rf_accesses=rf,
        spatial_util=min(util, 1.0),
    )


def combination_cost(
    df: IntraPhaseDataflow,
    v: int,
    g: int,
    f: int,
    hw: AcceleratorConfig,
    pe_budget: int | None = None,
) -> PhaseCost:
    """Cost of the combination phase (dense GEMM, V x F x G)."""
    pe_budget = pe_budget or hw.n_pes
    if df.spatial_footprint > pe_budget:
        raise ValueError(
            f"cmb footprint {df.spatial_footprint} > PE budget {pe_budget}"
        )
    if v == 0:
        return PhaseCost(cycles=0.0, macs=0.0)
    t_v, t_g, t_f = df.tile("V"), df.tile("G"), df.tile("F")
    order = df.order
    trips = {
        "V": float(_ceil(v, t_v)),
        "G": float(_ceil(g, t_g)),
        "F": float(_ceil(f, t_f)),
    }
    cycles = trips["V"] * trips["G"] * trips["F"]
    macs = float(v) * g * f

    reads: dict[str, float] = {}
    writes: dict[str, float] = {}
    reads["inp"] = _loads(order, trips, ("V", "F")) * t_v * t_f
    reads["wt"] = _loads(order, trips, ("F", "G")) * t_f * t_g
    pos = {d: i for i, d in enumerate(order)}
    eff = [d for d in order if trips[d] > 1]
    # output spills: reduction (F) loop above an effective relevant loop
    spill = ("F" in eff) and (
        (pos["F"] < pos["V"] and trips["V"] > 1)
        or (pos["F"] < pos["G"] and trips["G"] > 1)
    )
    out_elems = float(v) * g
    if spill:
        visits = _loads(order, {**trips}, ("V", "G"))
        # ensure the reduction factor is counted (loops above j included)
        visits = max(visits, trips["V"] * trips["G"] * trips["F"])
        vol = visits * t_v * t_g
        writes["out"] = out_elems
        writes["psum"] = max(0.0, vol - out_elems)
        reads["psum"] = max(0.0, vol - out_elems)
    else:
        writes["out"] = out_elems

    rf = 2.0 * macs
    if df.binding("F") == Binding.TEMPORAL:
        rf += 2.0 * macs
    else:
        rf += macs / max(t_f, 1)

    util = macs / max(cycles * df.spatial_footprint, 1.0)
    return PhaseCost(
        cycles=cycles,
        macs=macs,
        gb_reads=reads,
        gb_writes=writes,
        rf_accesses=rf,
        spatial_util=min(util, 1.0),
    )


# ---------------------------------------------------------------------------
# Table 3 closed forms (for validation against the simulator)
# ---------------------------------------------------------------------------


def table3_buffering(df: GNNDataflow, wl: GNNLayerWorkload) -> float:
    """Intermediate buffering requirement in elements (paper Table 3)."""
    feat = wl.f_in if df.order == PhaseOrder.AC else wl.g_out
    if df.inter == InterPhase.SEQ:
        return float(wl.v * feat)
    if df.inter == InterPhase.SP and df.is_sp_optimized:
        return 0.0
    pel = pipelined_elements(df, wl)
    return 2.0 * pel if df.inter == InterPhase.PP else pel


def pipelined_elements(df: GNNDataflow, wl: GNNLayerWorkload) -> float:
    """Pel — elements of the intermediate matrix in flight (Sec. 4.4)."""
    feat = wl.f_in if df.order == PhaseOrder.AC else wl.g_out
    gran = df.granularity
    if df.order == PhaseOrder.AC:
        rows_first, cols_first = df.agg.tile("V"), df.agg.tile("F")
        rows_second, cols_second = df.cmb.tile("V"), df.cmb.tile("F")
    else:
        rows_first, cols_first = df.cmb.tile("V"), df.cmb.tile("G")
        # The intermediate X.W is V x G; the aggregation phase consumes a
        # band of it per *output vertex* tile, so its row granularity is the
        # aggregation V tile (not N, which indexes gathered neighbors).
        rows_second, cols_second = df.agg.tile("V"), df.agg.tile("F")
    t_v = max(rows_first, rows_second)
    t_f = max(cols_first, cols_second)
    if gran.value == "element":
        return float(t_v * t_f)
    if gran.value == "row":
        return float(t_v * feat)
    if gran.value == "column":
        return float(wl.v * t_f)
    return float(wl.v * feat)
