"""Tile-level simulator for multiphase GNN dataflows (paper Sec. 5.1.1).

Composes the per-phase cost model (:mod:`repro.core.cost_model`) under the
four inter-phase strategies of the paper (Seq / SP-Generic / SP-Optimized /
PP at element/row/column granularity), producing runtime, energy breakdown
and buffering statistics — the quantities behind the paper's Figures 9-13
and Table 3.

Pipeline-parallel (PP) runtime follows Sec. 4.3: the accelerator's PEs are
split between the phases (``pe_split``), the intermediate matrix is chunked
at the dataflow's granularity and the two phases advance in a two-stage
pipeline whose per-chunk latency is the max of the two phases — so
unstructured sparsity shows up directly as pipeline bubbles (the paper's
Collab case).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import TYPE_CHECKING

import numpy as np

from .cost_model import (
    GNNLayerWorkload,
    PhaseCost,
    TileStats,
    aggregation_cost,
    combination_cost,
    pipelined_elements,
    table3_buffering,
    _ceil,
    _tiles_of,
)
from .hw import AcceleratorConfig, DEFAULT_ACCEL, HWGrid
from .registry import get_objective, objective_names, objective_value
from .taxonomy import (
    Binding,
    GNNDataflow,
    InterPhase,
    PhaseOrder,
    Granularity,
    classify_granularity,
)

if TYPE_CHECKING:
    from .schedule import TransitionSpec


@dataclass
class RunStats:
    """Simulated execution statistics for one GNN layer."""

    dataflow: str
    cycles: float
    energy_pj: float
    energy_breakdown: dict[str, float]
    gb_accesses: dict[str, float]  # element counts per logical operand
    rf_accesses: float
    buffering_elems: float
    macs: float
    pe_utilization: float
    stall_factor: float
    agg_cycles: float
    cmb_cycles: float

    @property
    def gb_total(self) -> float:
        return sum(self.gb_accesses.values())


def _merge(into: dict[str, float], src: dict[str, float], rename: dict[str, str]):
    for k, val in src.items():
        key = rename.get(k, k)
        into[key] = into.get(key, 0.0) + val


def _phase_costs(
    df: GNNDataflow,
    wl: GNNLayerWorkload,
    hw: AcceleratorConfig,
    pe_agg: int,
    pe_cmb: int,
):
    """Evaluate both phases.  Returns (agg, cmb, first_traffic,
    second_traffic) where each traffic dict uses canonical operand labels
    (adj/inp/wt/out/psum_rd/psum_wr/int_rd/int_wr): the intermediate matrix
    is written by the first phase and read by the second."""
    feat = wl.f_in if df.order == PhaseOrder.AC else wl.g_out
    agg = aggregation_cost(df.agg, wl.nnz, feat, hw, pe_budget=pe_agg)
    cmb = combination_cost(df.cmb, wl.v, wl.g_out, wl.f_in, hw, pe_budget=pe_cmb)
    first_c, second_c = (agg, cmb) if df.order == PhaseOrder.AC else (cmb, agg)
    first: dict[str, float] = {}
    second: dict[str, float] = {}
    if df.order == PhaseOrder.AC:
        _merge(first, agg.gb_reads, {"adj": "adj", "inp": "inp", "psum": "psum_rd"})
        _merge(first, agg.gb_writes, {"out": "int_wr", "psum": "psum_wr"})
        _merge(second, cmb.gb_reads, {"inp": "int_rd", "wt": "wt", "psum": "psum_rd"})
        _merge(second, cmb.gb_writes, {"out": "out", "psum": "psum_wr"})
    else:
        _merge(first, cmb.gb_reads, {"inp": "inp", "wt": "wt", "psum": "psum_rd"})
        _merge(first, cmb.gb_writes, {"out": "int_wr", "psum": "psum_wr"})
        _merge(second, agg.gb_reads, {"adj": "adj", "inp": "int_rd", "psum": "psum_rd"})
        _merge(second, agg.gb_writes, {"out": "out", "psum": "psum_wr"})
    return agg, cmb, first_c, second_c, first, second


def _pp_chunk_times(
    df: GNNDataflow,
    wl: GNNLayerWorkload,
    hw: AcceleratorConfig,
    pe_agg: int,
    pe_cmb: int,
    first_total: float,
    second_total: float,
) -> tuple[np.ndarray, np.ndarray]:
    """Per-chunk (producer, consumer) cycle arrays at the dataflow's
    pipelining granularity.  Exact row-band accounting for AC (captures
    evil-row bubbles); proportional chunking for CA (documented
    approximation — AWB-GCN's column granularity is uniform per column,
    where proportional is exact)."""
    gran = df.granularity
    feat = wl.f_in if df.order == PhaseOrder.AC else wl.g_out

    if df.order == PhaseOrder.CA:
        if gran == Granularity.ROW:
            n_chunks = int(_ceil(wl.v, max(df.cmb.tile("V"), df.agg.tile("N"))))
        elif gran == Granularity.COLUMN:
            n_chunks = int(_ceil(wl.g_out, max(df.cmb.tile("G"), df.agg.tile("F"))))
        else:
            n_v = int(_ceil(wl.v, max(df.cmb.tile("V"), df.agg.tile("N"))))
            n_f = int(_ceil(wl.g_out, max(df.cmb.tile("G"), df.agg.tile("F"))))
            n_chunks = n_v * n_f
        n_chunks = max(n_chunks, 1)
        first = np.full(n_chunks, first_total / n_chunks)
        second = np.full(n_chunks, second_total / n_chunks)
        return first, second

    # ---- AC: exact row/element/column band accounting ---------------------
    t_v_a, t_n, t_f_a = df.agg.tile("V"), df.agg.tile("N"), df.agg.tile("F")
    t_v_c, t_g, t_f_c = df.cmb.tile("V"), df.cmb.tile("G"), df.cmb.tile("F")
    tile_max = _tiles_of(wl.nnz, t_v_a)
    ntrips = np.maximum(1, -(-tile_max // t_n)).astype(np.float64)
    g_trips = float(_ceil(wl.g_out, t_g))

    if gran == Granularity.ROW:
        rows = max(t_v_a, t_v_c)
        vtiles_per_chunk = max(1, rows // t_v_a)
        n_chunks = int(_ceil(len(ntrips), vtiles_per_chunk))
        pad = n_chunks * vtiles_per_chunk - len(ntrips)
        nt = np.pad(ntrips, (0, pad))
        band = nt.reshape(n_chunks, vtiles_per_chunk).sum(axis=1)
        f_trips_a = float(_ceil(feat, t_f_a))
        a = band * f_trips_a
        c = np.full(
            n_chunks,
            _ceil(rows, t_v_c) * g_trips * _ceil(wl.f_in, t_f_c),
        )
        return a, c

    if gran == Granularity.COLUMN:
        cols = max(t_f_a, t_f_c)
        n_chunks = int(_ceil(feat, cols))
        a = np.full(n_chunks, float(ntrips.sum()) * _ceil(cols, t_f_a))
        c = np.full(
            n_chunks,
            _ceil(wl.v, t_v_c) * g_trips * _ceil(cols, t_f_c),
        )
        return a, c

    # ELEMENT: grid of (row band x column band) chunks, row-major.
    rows = max(t_v_a, t_v_c)
    cols = max(t_f_a, t_f_c)
    vtiles_per_chunk = max(1, rows // t_v_a)
    n_vchunks = int(_ceil(len(ntrips), vtiles_per_chunk))
    pad = n_vchunks * vtiles_per_chunk - len(ntrips)
    nt = np.pad(ntrips, (0, pad))
    band = nt.reshape(n_vchunks, vtiles_per_chunk).sum(axis=1)
    n_fchunks = int(_ceil(feat, cols))
    a = np.repeat(band, n_fchunks) * _ceil(cols, t_f_a)
    c_per = _ceil(rows, t_v_c) * g_trips * _ceil(cols, t_f_c)
    c = np.full(n_vchunks * n_fchunks, float(c_per))
    return a, c


def simulate(
    df: GNNDataflow,
    wl: GNNLayerWorkload,
    hw: AcceleratorConfig = DEFAULT_ACCEL,
) -> RunStats:
    """Simulate one GNN layer under a complete dataflow description."""
    df.validate()
    if df.inter == InterPhase.PP:
        pe_first = max(1, int(round(hw.n_pes * df.pe_split)))
        pe_second = max(1, hw.n_pes - pe_first)
        if df.order == PhaseOrder.AC:
            pe_agg, pe_cmb = pe_first, pe_second
        else:
            pe_agg, pe_cmb = pe_second, pe_first
    else:
        pe_agg = pe_cmb = hw.n_pes

    agg, cmb, first_c, second_c, first_t, second_t = _phase_costs(
        df, wl, hw, pe_agg, pe_cmb
    )
    feat = wl.f_in if df.order == PhaseOrder.AC else wl.g_out
    bytes_per = hw.bytes_per_elem
    sp_opt = df.inter == InterPhase.SP and df.is_sp_optimized

    # ---- intermediate traffic billing -------------------------------------
    # Seq / SP-Generic: intermediate goes through the Global Buffer (and
    # consumes its bandwidth).  PP: dedicated ping-pong buffer + NoC — GB
    # bandwidth is NOT consumed, energy scales with the (small) buffer.
    # SP-Optimized: intermediate never leaves the PEs.
    int_energy_per_access = hw.gb_energy_pj
    buffering = table3_buffering(df, wl)
    int_uses_gb_bw = df.inter in (InterPhase.SEQ, InterPhase.SP)
    if sp_opt:
        first_t.pop("int_wr", None)
        second_t.pop("int_rd", None)
        int_energy_per_access = 0.0
        int_uses_gb_bw = False
    elif df.inter == InterPhase.PP:
        int_energy_per_access = hw.buffer_access_energy(int(buffering * bytes_per))
    # Capacity check: the *live* intermediate footprint is the whole V x F
    # matrix only for Seq (staged in full between the phases); the pipelined
    # strategies keep just the chunk in flight (Table 3's buffering) — every
    # non-fused path spills to DRAM pricing when its own footprint exceeds
    # the GB capacity.
    spilled = (
        not sp_opt
        and hw.gb_capacity_bytes is not None
        and buffering * bytes_per > hw.gb_capacity_bytes
    )
    if spilled:
        int_energy_per_access = hw.dram_energy_pj

    # ---- runtime -----------------------------------------------------------
    def gb_traffic(t: dict[str, float]) -> float:
        tot = 0.0
        for k, v_ in t.items():
            if k.startswith("int") and not int_uses_gb_bw:
                continue
            tot += v_
        return tot

    lm = hw.latency
    bw = lm.effective_bw(hw.gb_bandwidth)
    # operand traffic (excluding the intermediate) overlaps with compute and
    # shows up as a bandwidth stall; the intermediate hand-off is serialized
    # at the phase boundary for Seq/SP-Generic — this is exactly Table 3's
    # `t_load` that SP-Optimized saves.
    int_wr = first_t.get("int_wr", 0.0) if int_uses_gb_bw else 0.0
    int_rd = second_t.get("int_rd", 0.0) if int_uses_gb_bw else 0.0
    traf_1 = gb_traffic(first_t) - int_wr
    traf_2 = gb_traffic(second_t) - int_rd
    stall_1 = max(1.0, traf_1 / max(bw * first_c.cycles, 1e-9))
    stall_2 = max(1.0, traf_2 / max(bw * second_c.cycles, 1e-9))

    if df.inter == InterPhase.SEQ or (df.inter == InterPhase.SP and not sp_opt):
        # a spilled intermediate hands off through DRAM: when the fitted
        # model carries a measured spill bandwidth, the serialized
        # transfer moves at that rate instead of the GB rate.
        bw_int = lm.dram_bw if (spilled and lm.dram_bw is not None) else bw
        t_xfer = (int_wr + int_rd) / bw_int
        cycles = stall_1 * first_c.cycles + stall_2 * second_c.cycles + t_xfer
        stall = cycles / max(first_c.cycles + second_c.cycles, 1e-9)
    elif sp_opt:
        # the fused dataflow never moves the intermediate at all
        cycles = stall_1 * first_c.cycles + stall_2 * second_c.cycles
        stall = cycles / max(first_c.cycles + second_c.cycles, 1e-9)
    else:  # PP
        a_ck, b_ck = _pp_chunk_times(
            df, wl, hw, pe_agg, pe_cmb, first_c.cycles, second_c.cycles
        )
        n = len(a_ck)
        if n == 1:
            nostall = float(a_ck[0] + b_ck[0])
        else:
            overlap = np.maximum(a_ck[1:], b_ck[:-1]).sum()
            nostall = float(a_ck[0] + overlap + b_ck[-1])
        # Both phases pull operands from the GB *concurrently* during the
        # overlapped window, so their instantaneous demands add — this is
        # why PP suffers most when bandwidth shrinks (paper Fig. 13).
        d1 = traf_1 / max(float(a_ck.sum()), 1e-9)
        d2 = traf_2 / max(float(b_ck.sum()), 1e-9)
        stall = max(1.0, (d1 + d2) / bw)
        cycles = nostall * stall

    # calibrated-model correction: per-family overhead multiplier plus
    # per-dispatch setup, mirroring the empirical GEMM model's
    # `overhead_factor` / `C_setup`.  Identity at the uncalibrated default
    # (`x * 1.0 + 0.0` is bit-exact), pinned by tests/test_calibrate.py.
    if df.inter == InterPhase.SEQ:
        family = "seq"
    elif df.inter == InterPhase.PP:
        family = "pp"
    else:
        family = "sp_opt" if sp_opt else "sp_generic"
    cycles = lm.calibrate_cycles(cycles, family)

    # ---- energy ------------------------------------------------------------
    breakdown: dict[str, float] = {}
    gb_acc: dict[str, float] = {}
    for t in (first_t, second_t):
        for k, v_ in t.items():
            if k.startswith("int"):
                e, label = int_energy_per_access, "int"
            elif k.startswith("psum"):
                e, label = hw.gb_energy_pj, "psum"
            else:
                e, label = hw.gb_energy_pj, k
            breakdown[f"gb_{label}"] = breakdown.get(f"gb_{label}", 0.0) + v_ * e
            gb_acc[label] = gb_acc.get(label, 0.0) + v_
    rf_total = agg.rf_accesses + cmb.rf_accesses
    breakdown["rf"] = rf_total * hw.rf_energy_pj
    energy = sum(breakdown.values())

    macs = agg.macs + cmb.macs
    util = macs / max(cycles * hw.n_pes, 1e-9)
    return RunStats(
        dataflow=str(df),
        cycles=float(cycles),
        energy_pj=float(energy),
        energy_breakdown=breakdown,
        gb_accesses=gb_acc,
        rf_accesses=float(rf_total),
        buffering_elems=float(buffering),
        macs=float(macs),
        pe_utilization=float(min(util, 1.0)),
        stall_factor=float(stall),
        agg_cycles=float(agg.cycles),
        cmb_cycles=float(cmb.cycles),
    )


# ---------------------------------------------------------------------------
# Batched, cache-backed simulation
# ---------------------------------------------------------------------------
#
# The mapper sweeps thousands of candidate tilings per skeleton; every
# quantity in `simulate` above is a closed-form scalar once the workload's
# tile ladder (`TileStats`) is known, so a whole candidate grid can be
# evaluated as numpy array ops.  `_eval_candidates` is the vectorized mirror
# of `simulate` — the scalar path stays the reference oracle, and
# `tests/test_mapper.py` pins the two to within 1e-6 relative tolerance.

#: Candidate tile-size columns understood by the batch evaluator.
TILE_COLUMNS = ("t_v_a", "t_n", "t_f_a", "t_v_c", "t_g", "t_f_c")


@dataclass(frozen=True)
class _GroupSpec:
    """Structural (non-tile) description shared by a batch of candidates."""

    inter: InterPhase
    order: PhaseOrder
    agg_order: tuple[str, ...]
    cmb_order: tuple[str, ...]

    @property
    def granularity(self) -> Granularity:
        return classify_granularity(self.order, self.agg_order, self.cmb_order)


@dataclass
class BatchStats:
    """Vectorized simulation results for a batch of candidate dataflows.

    Arrays are aligned with the candidate order passed to
    :func:`simulate_batch`.  ``legal`` is False where the candidate violates
    its PE budget (or is not pipelineable) — the scalar path raises
    ``ValueError`` there instead.

    When :func:`simulate_batch` is handed an :class:`~repro.core.hw.HWGrid`
    the arrays are 2-D, shaped ``(n_dataflows, len(grid))`` with the grid's
    point order along the second axis (``grid`` records which one).
    """

    cycles: np.ndarray
    energy_pj: np.ndarray
    legal: np.ndarray
    agg_cycles: np.ndarray
    cmb_cycles: np.ndarray
    macs: np.ndarray
    dataflows: list[GNNDataflow] | None = None
    grid: HWGrid | None = None

    def __len__(self) -> int:
        return len(self.cycles)

    def objective(self, name: str) -> np.ndarray:
        """Objective values for the whole batch (see the objective
        registry, :mod:`repro.core.registry`); unknown names raise
        ``ValueError`` listing the valid ones."""
        return objective_value(name, self.cycles, self.energy_pj)

    def masked_objective(self, name: str) -> np.ndarray:
        """Objective with illegal candidates forced to +inf."""
        obj = np.array(self.objective(name), dtype=np.float64)
        obj[~self.legal] = np.inf
        return obj


def _unique_map(cols: list[np.ndarray], fn) -> np.ndarray:
    """``fn(*key) -> float`` evaluated once per unique key row, broadcast
    back to the full candidate length."""
    stacked = np.stack([np.asarray(c, dtype=np.int64) for c in cols], axis=1)
    uniq, inv = np.unique(stacked, axis=0, return_inverse=True)
    vals = np.fromiter(
        (fn(*row) for row in uniq), dtype=np.float64, count=len(uniq)
    )
    return vals[inv]


def _pp_closed_form(
    spec: _GroupSpec,
    c: dict[str, np.ndarray],
    wl: GNNLayerWorkload,
    ts: TileStats,
    sum_nt: np.ndarray,
    first_cycles: np.ndarray,
    second_cycles: np.ndarray,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Closed-form (nostall_cycles, sum_producer, sum_consumer) for the PP
    two-stage pipeline — the vectorized mirror of `_pp_chunk_times` plus the
    `a[0] + sum(max(a[1:], b[:-1])) + b[-1]` recurrence of `simulate`.

    The consumer chunk time is a per-candidate constant, so the overlap term
    reduces to ``sum(max(alpha * band, gamma))`` over the cached per-band
    ntrip sums, answered in O(log n_chunks) via sorted prefix sums.
    """
    v, f_in, g_out = wl.v, wl.f_in, wl.g_out
    feat = f_in if spec.order == PhaseOrder.AC else g_out
    gran = spec.granularity
    t_v_a, t_n, t_f_a = c["t_v_a"], c["t_n"], c["t_f_a"]
    t_v_c, t_g, t_f_c = c["t_v_c"], c["t_g"], c["t_f_c"]

    if spec.order == PhaseOrder.CA:
        # proportional chunking (documented approximation, as in the scalar
        # path): both chunk times are constants.
        if gran == Granularity.ROW:
            n_chunks = -(-v // np.maximum(t_v_c, t_n))
        elif gran == Granularity.COLUMN:
            n_chunks = -(-g_out // np.maximum(t_g, t_f_a))
        else:
            n_chunks = (-(-v // np.maximum(t_v_c, t_n))) * (
                -(-g_out // np.maximum(t_g, t_f_a))
            )
        n_chunks = np.maximum(n_chunks, 1).astype(np.float64)
        a_per = first_cycles / n_chunks
        b_per = second_cycles / n_chunks
        nostall = np.where(
            n_chunks == 1,
            a_per + b_per,
            a_per + (n_chunks - 1) * np.maximum(a_per, b_per) + b_per,
        )
        return nostall, n_chunks * a_per, n_chunks * b_per

    g_trips = (-(-g_out // t_g)).astype(np.float64)

    if gran == Granularity.COLUMN:
        cols = np.maximum(t_f_a, t_f_c)
        n_chunks = (-(-feat // cols)).astype(np.float64)
        a_per = sum_nt * (-(-cols // t_f_a))
        gamma = (-(-v // t_v_c)) * g_trips * (-(-cols // t_f_c))
        nostall = np.where(
            n_chunks == 1,
            a_per + gamma,
            a_per + (n_chunks - 1) * np.maximum(a_per, gamma) + gamma,
        )
        return nostall, n_chunks * a_per, n_chunks * gamma

    rows = np.maximum(t_v_a, t_v_c)
    vpc = np.maximum(1, rows // t_v_a)
    n = len(t_v_a)
    nostall = np.empty(n, dtype=np.float64)
    sum_a = np.empty(n, dtype=np.float64)
    sum_b = np.empty(n, dtype=np.float64)
    keys = np.stack([t_v_a, t_n, vpc], axis=1)
    uniq, inv = np.unique(keys, axis=0, return_inverse=True)

    if gran == Granularity.ROW:
        alpha = (-(-feat // t_f_a)).astype(np.float64)
        gamma = (-(-rows // t_v_c)) * g_trips * (-(-f_in // t_f_c))
        for u, row in enumerate(uniq):
            idx = np.flatnonzero(inv == u)
            bs = ts.band_stats(int(row[0]), int(row[1]), int(row[2]))
            al, ga = alpha[idx], gamma[idx]
            nostall[idx] = al * bs.first + bs.sum_max_tail(al, ga) + ga
            sum_a[idx] = al * bs.total
            sum_b[idx] = bs.n_chunks * ga
        return nostall, sum_a, sum_b

    # ELEMENT: a row-major (row band x column band) chunk grid; the column
    # bands repeat each row band's trip sum n_fchunks times.
    cols = np.maximum(t_f_a, t_f_c)
    n_f = (-(-feat // cols)).astype(np.float64)
    alpha = (-(-cols // t_f_a)).astype(np.float64)
    gamma = (-(-rows // t_v_c)) * g_trips * (-(-cols // t_f_c))
    for u, row in enumerate(uniq):
        idx = np.flatnonzero(inv == u)
        bs = ts.band_stats(int(row[0]), int(row[1]), int(row[2]))
        al, ga, nf = alpha[idx], gamma[idx], n_f[idx]
        s_all = bs.sum_max_all(al, ga)
        overlap = nf * s_all - np.maximum(al * bs.first, ga)
        nostall[idx] = al * bs.first + overlap + ga
        sum_a[idx] = nf * al * bs.total
        sum_b[idx] = bs.n_chunks * nf * ga
    return nostall, sum_a, sum_b


def _eval_candidates(
    spec: _GroupSpec,
    cand: dict[str, np.ndarray],
    wl: GNNLayerWorkload,
    hw: AcceleratorConfig,
    ts: TileStats,
) -> dict[str, np.ndarray]:
    """Evaluate a structural group of candidates (shared loop orders /
    inter-phase strategy, varying tile sizes + PE split) in one vectorized
    pass.  Mirrors `simulate` + the per-phase cost model term by term.

    ``cand`` columns: the six ``TILE_COLUMNS`` plus ``pe_split`` (float),
    ``agg_n_temporal`` / ``cmb_f_temporal`` (reduction-loop bindings) and
    ``sp_opt`` (bool).  The hardware axis is broadcastable: optional
    ``n_pes`` (int64), ``gb_bw`` (float64) and ``gb_cap`` (float64, ``inf``
    = unconstrained) columns override the scalar ``hw`` values per
    candidate, so one call can price a dataflow x hardware grid (``hw``
    still supplies the shared energy constants).  Requires a non-empty
    workload (V > 0, E > 0).
    """
    t_v_a = np.asarray(cand["t_v_a"], dtype=np.int64)
    t_n = np.asarray(cand["t_n"], dtype=np.int64)
    t_f_a = np.asarray(cand["t_f_a"], dtype=np.int64)
    t_v_c = np.asarray(cand["t_v_c"], dtype=np.int64)
    t_g = np.asarray(cand["t_g"], dtype=np.int64)
    t_f_c = np.asarray(cand["t_f_c"], dtype=np.int64)
    split = np.asarray(cand["pe_split"], dtype=np.float64)
    n = len(t_v_a)

    # hardware columns (scalar fallbacks broadcast against the candidates)
    if "n_pes" in cand:
        n_pes = np.asarray(cand["n_pes"], dtype=np.int64)
    else:
        n_pes = hw.n_pes
    lm = hw.latency
    if "gb_bw" in cand:
        bw = np.asarray(cand["gb_bw"], dtype=np.float64)
        if lm.bw_eff is not None:
            # hardware-grid sweep: derate every point's nominal bandwidth
            # by the measured/nominal ratio of the base config
            bw = bw * (float(lm.bw_eff) / float(hw.gb_bandwidth))
    else:
        bw = lm.effective_bw(hw.gb_bandwidth)
    if "gb_cap" in cand:
        gb_cap = np.asarray(cand["gb_cap"], dtype=np.float64)
    else:
        gb_cap = np.inf if hw.gb_capacity_bytes is None else float(hw.gb_capacity_bytes)

    v = wl.v
    e = float(wl.nnz.sum())
    f_in, g_out = wl.f_in, wl.g_out
    ac = spec.order == PhaseOrder.AC
    feat = f_in if ac else g_out

    # ---- PE budgets + legality -------------------------------------------
    fp_a = t_v_a * t_n * t_f_a
    fp_c = t_v_c * t_g * t_f_c
    if spec.inter == InterPhase.PP:
        pe_first = np.maximum(1, np.rint(n_pes * split).astype(np.int64))
        pe_second = np.maximum(1, n_pes - pe_first)
        pe_agg, pe_cmb = (pe_first, pe_second) if ac else (pe_second, pe_first)
    else:
        pe_agg = pe_cmb = np.broadcast_to(
            np.asarray(n_pes, dtype=np.int64), (n,)
        )
    legal = (fp_a <= pe_agg) & (fp_c <= pe_cmb)
    if spec.inter in (InterPhase.SP, InterPhase.PP):
        if spec.granularity == Granularity.NONE:
            legal = np.zeros(n, dtype=bool)

    # ---- aggregation phase (cache-backed) --------------------------------
    apos = {d: i for i, d in enumerate(spec.agg_order)}
    f_trips_a = -(-feat // t_f_a)
    sum_nt = _unique_map(
        [t_v_a, t_n], lambda a, b: ts.sum_ntrips(int(a), int(b))
    )
    n_vt = _unique_map([t_v_a], lambda a: float(ts.n_vtiles(int(a))))
    cycles_a = f_trips_a * sum_nt
    macs_a = e * feat
    adj = e * f_trips_a.astype(np.float64) if apos["F"] < apos["N"] else np.full(n, e)
    inp_a = e * feat
    spill_a = np.zeros(n, dtype=bool)
    if apos["N"] < apos["F"]:
        spill_a |= f_trips_a > 1
    if apos["N"] < apos["V"]:
        spill_a |= n_vt > 1
    out_elems_a = float(v * feat)
    visits_a = f_trips_a * sum_nt * t_v_a * t_f_a
    psum_a = np.where(spill_a, np.maximum(0.0, visits_a - out_elems_a), 0.0)
    rf_a = 2.0 * macs_a + np.where(
        np.asarray(cand["agg_n_temporal"], dtype=bool),
        2.0 * macs_a,
        macs_a / np.maximum(t_n, 1),
    )

    # ---- combination phase -----------------------------------------------
    cpos = {d: i for i, d in enumerate(spec.cmb_order)}
    trips = {"V": -(-v // t_v_c), "G": -(-g_out // t_g), "F": -(-f_in // t_f_c)}
    tripsf = {d: t.astype(np.float64) for d, t in trips.items()}
    cycles_c = tripsf["V"] * tripsf["G"] * tripsf["F"]
    macs_c = float(v) * g_out * f_in

    def loads(relevant: tuple[str, ...]) -> np.ndarray:
        # innermost effective relevant loop position; trip-1 loops above it
        # contribute a factor of 1, so the product can run over all loops
        j = np.full(n, -1, dtype=np.int64)
        for d in relevant:
            j = np.maximum(j, np.where(trips[d] > 1, cpos[d], -1))
        out = np.ones(n, dtype=np.float64)
        for d in spec.cmb_order:
            out *= np.where(cpos[d] <= j, tripsf[d], 1.0)
        return out

    inp_c = loads(("V", "F")) * t_v_c * t_f_c
    wt_c = loads(("F", "G")) * t_f_c * t_g
    spill_c = np.zeros(n, dtype=bool)
    if cpos["F"] < cpos["V"]:
        spill_c |= trips["V"] > 1
    if cpos["F"] < cpos["G"]:
        spill_c |= trips["G"] > 1
    spill_c &= trips["F"] > 1
    vol_c = np.maximum(loads(("V", "G")), cycles_c) * t_v_c * t_g
    out_elems_c = float(v) * g_out
    psum_c = np.where(spill_c, np.maximum(0.0, vol_c - out_elems_c), 0.0)
    rf_c = 2.0 * macs_c + np.where(
        np.asarray(cand["cmb_f_temporal"], dtype=bool),
        2.0 * macs_c,
        macs_c / np.maximum(t_f_c, 1),
    )

    # ---- canonical traffic (int_* excluded from GB bandwidth as in the
    # scalar path: it is either serialized at the phase boundary or moved
    # through the PP ping-pong buffer) -------------------------------------
    if ac:
        first_cycles, second_cycles = cycles_a, cycles_c
        first_nonint = adj + inp_a + 2.0 * psum_a
        int_wr = np.full(n, out_elems_a)
        second_nonint = wt_c + out_elems_c + 2.0 * psum_c
        int_rd = inp_c
    else:
        first_cycles, second_cycles = cycles_c, cycles_a
        first_nonint = inp_c + wt_c + 2.0 * psum_c
        int_wr = np.full(n, out_elems_c)
        second_nonint = adj + out_elems_a + 2.0 * psum_a
        int_rd = np.full(n, inp_a)

    # ---- intermediate buffering + per-access energy ----------------------
    sp_opt = np.asarray(cand["sp_opt"], dtype=bool)
    if ac:
        rows_f, cols_f, rows_s, cols_s = t_v_a, t_f_a, t_v_c, t_f_c
    else:
        rows_f, cols_f, rows_s, cols_s = t_v_c, t_g, t_v_a, t_f_a
    t_vmax = np.maximum(rows_f, rows_s)
    t_fmax = np.maximum(cols_f, cols_s)
    gran = spec.granularity
    if gran == Granularity.ELEMENT:
        pel = (t_vmax * t_fmax).astype(np.float64)
    elif gran == Granularity.ROW:
        pel = t_vmax * float(feat)
    elif gran == Granularity.COLUMN:
        pel = float(v) * t_fmax
    else:
        pel = np.full(n, float(v * feat))

    bytes_per = hw.bytes_per_elem
    if spec.inter == InterPhase.PP:
        buffering = 2.0 * pel
        int_e = hw.buffer_access_energy(buffering * bytes_per)
    elif spec.inter == InterPhase.SEQ:
        # Seq stages the whole V x feat intermediate between the phases
        buffering = np.full(n, float(v) * feat)
        int_e = np.full(n, hw.gb_energy_pj)
    else:  # SP: optimized variants never move the intermediate
        buffering = np.where(sp_opt, 0.0, pel)
        int_e = np.where(sp_opt, 0.0, hw.gb_energy_pj)
    # capacity spill: each strategy's own live footprint (mirrors `simulate`)
    spilled = buffering * bytes_per > gb_cap
    int_e = np.where(spilled, hw.dram_energy_pj, int_e)

    # ---- runtime ---------------------------------------------------------
    stall_1 = np.maximum(1.0, first_nonint / np.maximum(bw * first_cycles, 1e-9))
    stall_2 = np.maximum(1.0, second_nonint / np.maximum(bw * second_cycles, 1e-9))

    if spec.inter in (InterPhase.SEQ, InterPhase.SP):
        base = stall_1 * first_cycles + stall_2 * second_cycles
        # spilled intermediates hand off at the measured DRAM rate when the
        # fitted model carries one (mirrors `simulate`)
        bw_int = np.where(spilled, float(lm.dram_bw), bw) if lm.dram_bw is not None else bw
        t_xfer = (int_wr + int_rd) / bw_int
        if spec.inter == InterPhase.SEQ:
            cycles = base + t_xfer
        else:
            cycles = base + np.where(sp_opt, 0.0, t_xfer)
    else:
        nostall, sum_a, sum_b = _pp_closed_form(
            spec, cand, wl, ts, sum_nt, first_cycles, second_cycles
        )
        d1 = first_nonint / np.maximum(sum_a, 1e-9)
        d2 = second_nonint / np.maximum(sum_b, 1e-9)
        cycles = nostall * np.maximum(1.0, (d1 + d2) / bw)

    # calibrated-model correction, term-for-term with `simulate`
    if spec.inter == InterPhase.SEQ:
        ov = lm.overhead_seq
    elif spec.inter == InterPhase.PP:
        ov = lm.overhead_pp
    else:
        ov = np.where(sp_opt, lm.overhead_sp_opt, lm.overhead_sp_generic)
    cycles = cycles * ov + lm.c_setup

    # ---- energy ----------------------------------------------------------
    int_traffic = np.where(sp_opt, 0.0, int_wr + int_rd)
    energy = (
        hw.gb_energy_pj * (first_nonint + second_nonint)
        + int_e * int_traffic
        + (rf_a + rf_c) * hw.rf_energy_pj
    )

    return {
        "cycles": cycles.astype(np.float64),
        "energy_pj": energy.astype(np.float64),
        "legal": legal,
        "agg_cycles": cycles_a.astype(np.float64),
        "cmb_cycles": cycles_c.astype(np.float64),
        "macs": np.full(n, macs_a + macs_c, dtype=np.float64),
    }


def simulate_batch(
    dataflows: list[GNNDataflow],
    wl: GNNLayerWorkload,
    hw: AcceleratorConfig | HWGrid = DEFAULT_ACCEL,
    tile_stats: TileStats | None = None,
) -> BatchStats:
    """Vectorized counterpart of :func:`simulate` for a list of candidates.

    Candidates are grouped by loop-order structure and each group is
    evaluated as numpy array ops over closed-form scalars memoized in a
    per-workload :class:`TileStats` cache.  Candidates that violate their PE
    budget (or are not pipelineable) come back with ``legal=False`` instead
    of raising, so a whole mapper grid can be scored in one call.

    ``hw`` may be an :class:`~repro.core.hw.HWGrid`: every candidate is
    then priced at every grid point in the same vectorized pass (the
    hardware columns broadcast against the dataflow axis) and the returned
    arrays are 2-D, ``(len(dataflows), len(hw))`` — pinned to 1e-6 oracle
    parity with scalar :func:`simulate` at every grid point by
    ``tests/test_codesign.py``.
    """
    grid = hw if isinstance(hw, HWGrid) else None
    base = grid.base if grid is not None else hw
    hw_cols = grid.columns() if grid is not None else None
    n_hw = len(grid) if grid is not None else None

    ts = tile_stats if tile_stats is not None else TileStats(wl.nnz)
    n = len(dataflows)
    shape = (n,) if n_hw is None else (n, n_hw)
    out = {
        "cycles": np.zeros(shape),
        "energy_pj": np.zeros(shape),
        "legal": np.zeros(shape, dtype=bool),
        "agg_cycles": np.zeros(shape),
        "cmb_cycles": np.zeros(shape),
        "macs": np.zeros(shape),
    }
    groups: dict[tuple, list[int]] = {}
    for i, df in enumerate(dataflows):
        key = (df.inter, df.order, df.agg.order, df.cmb.order)
        groups.setdefault(key, []).append(i)
    for key, idxs in groups.items():
        spec = _GroupSpec(*key)
        dfs = [dataflows[i] for i in idxs]
        cand = {
            "t_v_a": np.array([d.agg.tile("V") for d in dfs], dtype=np.int64),
            "t_n": np.array([d.agg.tile("N") for d in dfs], dtype=np.int64),
            "t_f_a": np.array([d.agg.tile("F") for d in dfs], dtype=np.int64),
            "t_v_c": np.array([d.cmb.tile("V") for d in dfs], dtype=np.int64),
            "t_g": np.array([d.cmb.tile("G") for d in dfs], dtype=np.int64),
            "t_f_c": np.array([d.cmb.tile("F") for d in dfs], dtype=np.int64),
            "pe_split": np.array([d.pe_split for d in dfs], dtype=np.float64),
            "agg_n_temporal": np.array(
                [d.agg.binding("N") == Binding.TEMPORAL for d in dfs], dtype=bool
            ),
            "cmb_f_temporal": np.array(
                [d.cmb.binding("F") == Binding.TEMPORAL for d in dfs], dtype=bool
            ),
            "sp_opt": np.array(
                [d.inter == InterPhase.SP and d.is_sp_optimized for d in dfs],
                dtype=bool,
            ),
        }
        if n_hw is not None:
            cand = expand_hw_columns(cand, hw_cols)
        res = _eval_candidates(spec, cand, wl, base, ts)
        ix = np.asarray(idxs)
        for k in out:
            out[k][ix] = res[k] if n_hw is None else res[k].reshape(-1, n_hw)
    return BatchStats(dataflows=list(dataflows), grid=grid, **out)


def expand_hw_columns(
    cand: dict[str, np.ndarray], hw_cols: dict[str, np.ndarray]
) -> dict[str, np.ndarray]:
    """Cross a candidate-column dict with per-hw-point columns: candidates
    repeat along the (minor) hardware axis, hardware points tile along the
    candidate axis — flattened row-major so a ``reshape(k, n_hw)`` recovers
    the (candidate, hw point) grid."""
    k = len(next(iter(cand.values())))
    n_hw = len(next(iter(hw_cols.values())))
    out = {key: np.repeat(col, n_hw) for key, col in cand.items()}
    for key, col in hw_cols.items():
        out[key] = np.tile(col, k)
    return out


# ---------------------------------------------------------------------------
# Model-level simulation: per-layer stats + inter-layer transition costs
# ---------------------------------------------------------------------------


@dataclass
class TransitionStats:
    """Cost of one layer boundary (see :mod:`repro.core.schedule`).

    When the producer's output walk disagrees with the consumer's input
    walk, the V x F intermediate is re-materialized through the GB (or
    DRAM, when it does not fit): one read + one write per element,
    serialized between the layers.
    """

    spec: "TransitionSpec"
    gb_accesses: float  # element accesses charged for the re-layout
    cycles: float
    energy_pj: float

    @property
    def relayout(self) -> bool:
        return self.spec.relayout

    def objective(self, name: str) -> float:
        """Additive objective contribution (model-level DP uses this)."""
        obj = get_objective(name)
        if not obj.additive:
            raise ValueError(
                f"transition costs only support additive objectives "
                f"{objective_names(additive_only=True)}, got {name!r}"
            )
        return obj.fn(self.cycles, self.energy_pj)


def transition_cost(
    prev: GNNDataflow,
    nxt: GNNDataflow,
    v: int,
    f: int,
    hw: AcceleratorConfig = DEFAULT_ACCEL,
) -> TransitionStats:
    """Price the hand-off of the V x F intermediate between two layers.

    Matching walks are free — the consumer streams the producer's output
    exactly as written, and the write/read traffic is already billed inside
    each layer's :func:`simulate`.  Mismatched walks re-lay-out the matrix:
    ``2 * V * F`` extra GB accesses (DRAM-priced when the matrix exceeds
    the GB capacity), serialized at the boundary at the GB bandwidth.
    """
    from .schedule import transition_spec  # local: schedule imports taxonomy only

    spec = transition_spec(prev, nxt, v=v, f=f)
    if not spec.relayout:
        return TransitionStats(spec, 0.0, 0.0, 0.0)
    elems = float(spec.elements)
    accesses = 2.0 * elems
    lm = hw.latency
    bw = lm.effective_bw(hw.gb_bandwidth)
    e_per = hw.gb_energy_pj
    spilled = (
        hw.gb_capacity_bytes is not None
        and elems * hw.bytes_per_elem > hw.gb_capacity_bytes
    )
    if spilled:
        e_per = hw.dram_energy_pj
        if lm.dram_bw is not None:
            bw = lm.dram_bw
    return TransitionStats(
        spec,
        gb_accesses=accesses,
        cycles=accesses / bw,
        energy_pj=accesses * e_per,
    )


# ---------------------------------------------------------------------------
# Partitioned execution: footprint + inter-partition communication costs
# ---------------------------------------------------------------------------


def intermediate_footprint_bytes(
    v: int, f: int, hw: AcceleratorConfig = DEFAULT_ACCEL
) -> int:
    """Bytes of the staged V x F intermediate for non-fused strategies.

    This is the quantity the spill model in :func:`simulate` compares
    against ``gb_capacity_bytes`` for Seq-family buffering, and what
    admission control / the partition planner use to agree on what
    "oversized" means for a graph."""
    return int(v) * int(f) * int(hw.bytes_per_elem)


PARTITION_KINDS = ("monolithic", "feature_chunk", "row_stream", "pp_shard")


@dataclass(frozen=True)
class PartitionCommStats:
    """Inter-partition traffic for one partitioned-execution plan.

    Mirrors :class:`TransitionStats`: an additive cost layered on top of
    the per-layer :func:`simulate` numbers, so the scalar/vector parity
    of the per-strategy paths is untouched.  Pricing follows the
    communication-requirements model (arXiv:2103.10515): every element
    crossing a partition boundary is one read at the producer plus one
    write at the consumer, serialized at the GB bandwidth; traffic whose
    working set cannot be GB-resident is DRAM-priced (arXiv:2404.15510's
    off-chip halo gathers).
    """

    kind: str  # one of PARTITION_KINDS
    n_partitions: int
    elems: float  # elements crossing partition boundaries
    gb_accesses: float  # accesses billed at GB energy
    dram_accesses: float  # accesses billed at DRAM energy
    cycles: float
    energy_pj: float

    def objective(self, name: str) -> float:
        """Additive objective contribution (plan ranking uses this)."""
        obj = get_objective(name)
        if not obj.additive:
            raise ValueError(
                f"partition comm costs only support additive objectives "
                f"{objective_names(additive_only=True)}, got {name!r}"
            )
        return obj.fn(self.cycles, self.energy_pj)


def partition_comm_cost(
    kind: str,
    n_partitions: int,
    *,
    v: int,
    f: int,
    hw: AcceleratorConfig = DEFAULT_ACCEL,
    halo_elems: int = 0,
) -> PartitionCommStats:
    """Price the inter-partition traffic of one execution plan.

    - ``monolithic``: zero — any spill traffic is already priced inside
      each layer's :func:`simulate` (the PR-4 footprint/spill model).
    - ``row_stream``: the halo features gathered per node block come from
      DRAM (the full feature matrix cannot be GB-resident, which is why
      we partitioned): ``2 * halo_elems`` DRAM accesses.
    - ``feature_chunk``: the V x F intermediate round-trips through DRAM
      once per chunk boundary pass: ``2 * v * f`` DRAM accesses.
    - ``pp_shard``: the intermediate crosses the device mesh once per
      boundary, GB/NoC-priced: ``2 * v * f`` GB accesses.
    """
    if kind not in PARTITION_KINDS:
        raise ValueError(f"unknown partition kind {kind!r}; expected {PARTITION_KINDS}")
    if n_partitions < 1:
        raise ValueError(f"n_partitions must be >= 1, got {n_partitions}")
    if kind == "monolithic" or n_partitions == 1:
        return PartitionCommStats(kind, n_partitions, 0.0, 0.0, 0.0, 0.0, 0.0)
    if kind == "row_stream":
        elems = float(halo_elems)
        gb_acc, dram_acc = 0.0, 2.0 * elems
    elif kind == "feature_chunk":
        elems = float(v) * float(f)
        gb_acc, dram_acc = 0.0, 2.0 * elems
    else:  # pp_shard
        elems = float(v) * float(f)
        gb_acc, dram_acc = 2.0 * elems, 0.0
    energy = gb_acc * hw.gb_energy_pj + dram_acc * hw.dram_energy_pj
    lm = hw.latency
    bw = lm.effective_bw(hw.gb_bandwidth)
    dram_bw = bw if lm.dram_bw is None else float(lm.dram_bw)
    return PartitionCommStats(
        kind,
        n_partitions,
        elems=elems,
        gb_accesses=gb_acc,
        dram_accesses=dram_acc,
        cycles=gb_acc / bw + dram_acc / dram_bw,
        energy_pj=energy,
    )


@dataclass
class ModelStats:
    """End-to-end statistics for a multi-layer GNN schedule."""

    layers: list[RunStats]
    transitions: list[TransitionStats]

    def __post_init__(self):
        if len(self.transitions) != max(len(self.layers) - 1, 0):
            raise ValueError(
                f"{len(self.layers)} layers need {len(self.layers) - 1} "
                f"transitions, got {len(self.transitions)}"
            )

    @property
    def layer_cycles(self) -> float:
        return sum(s.cycles for s in self.layers)

    @property
    def transition_cycles(self) -> float:
        return sum(t.cycles for t in self.transitions)

    @property
    def cycles(self) -> float:
        return self.layer_cycles + self.transition_cycles

    @property
    def layer_energy_pj(self) -> float:
        return sum(s.energy_pj for s in self.layers)

    @property
    def transition_energy_pj(self) -> float:
        return sum(t.energy_pj for t in self.transitions)

    @property
    def energy_pj(self) -> float:
        return self.layer_energy_pj + self.transition_energy_pj

    @property
    def n_relayouts(self) -> int:
        return sum(t.relayout for t in self.transitions)

    def objective(self, name: str) -> float:
        """End-to-end objective (resolved via the objective registry)."""
        return objective_value(name, self.cycles, self.energy_pj)


def validate_workload_chain(workloads: list[GNNLayerWorkload]) -> None:
    """Each layer must consume the feature width the previous one produced."""
    for i in range(1, len(workloads)):
        prev, cur = workloads[i - 1], workloads[i]
        if cur.f_in != prev.g_out:
            raise ValueError(
                f"workload {i} ({cur.name or 'unnamed'}) has f_in={cur.f_in} "
                f"but workload {i - 1} ({prev.name or 'unnamed'}) produces "
                f"g_out={prev.g_out}"
            )


def simulate_model(
    dataflows: list[GNNDataflow],
    workloads: list[GNNLayerWorkload],
    hw: AcceleratorConfig = DEFAULT_ACCEL,
) -> ModelStats:
    """Simulate a multi-layer GNN: one dataflow per layer (or one reused).

    Returns :class:`ModelStats` — per-layer :class:`RunStats` plus the
    inter-layer :class:`TransitionStats` (re-layout traffic charged when
    consecutive layers disagree on how the intermediate is walked) and the
    end-to-end cycle/energy totals.
    """
    if not workloads:
        raise ValueError("need at least one layer workload")
    if len(dataflows) == 1:
        dataflows = dataflows * len(workloads)
    if len(dataflows) != len(workloads):
        raise ValueError(
            f"got {len(dataflows)} dataflows for {len(workloads)} layer "
            "workloads; pass exactly 1 (shared across layers) or one per layer"
        )
    validate_workload_chain(workloads)
    layers = [simulate(d, w, hw) for d, w in zip(dataflows, workloads)]
    transitions = [
        transition_cost(
            dataflows[i],
            dataflows[i + 1],
            v=workloads[i + 1].v,
            f=workloads[i + 1].f_in,
            hw=hw,
        )
        for i in range(len(workloads) - 1)
    ]
    return ModelStats(layers, transitions)
