"""GNN multiphase dataflow taxonomy (paper Tables 1 and 2).

This module encodes the paper's complete dataflow description template::

    <Inter><order>(<AggIntra>, <CmbIntra>)

 * ``Inter``    — SEQ | SP | PP  (SP-Optimized is a *subset* of SP, per
                  paper Sec. 4.2: "we can select a subset of intra-phase
                  dataflows ...").
 * ``order``    — AC (aggregation->combination) | CA.
 * ``*Intra``   — a permutation of the phase's three loop dimensions, each
                  bound spatially or temporally, each with a tile size
                  ``T_dim`` (T_dim == 1 for temporal dims).

Aggregation loops over dims (V, N, F): vertices, neighbors (reduction),
features.  Combination loops over (V, G, F): vertices, out-features,
in-features (reduction).  For CA order the aggregation's ``F`` extent binds
to ``G`` (the intermediate X·W is V x G).

``enumerate_dataflows`` reproduces the paper's count of **6,656** loop-order
x parallelism x phase-order choices across the three inter-phase classes
(Seq: unconstrained; SP/PP: constrained to the pipelineable patterns of
Table 2 rows 4-9).  Tile sizes multiply this into the trillions and are
handled by :mod:`repro.core.mapper`.
"""
from __future__ import annotations

import enum
import itertools
import re
from dataclasses import dataclass, field, replace
from typing import Iterable, Sequence

AGG_DIMS = ("V", "N", "F")  # N is the reduction dim of aggregation (SpMM)
CMB_DIMS = ("V", "G", "F")  # F is the reduction dim of combination (GEMM)
AGG_REDUCTION = "N"
CMB_REDUCTION = "F"


class Binding(str, enum.Enum):
    SPATIAL = "s"
    TEMPORAL = "t"


class InterPhase(str, enum.Enum):
    SEQ = "Seq"
    SP = "SP"
    PP = "PP"


class PhaseOrder(str, enum.Enum):
    AC = "AC"  # aggregation then combination (e.g. GraphSAGE, HyGCN)
    CA = "CA"  # combination then aggregation (e.g. AWB-GCN)


class Granularity(str, enum.Enum):
    """Pipelining granularity of the intermediate matrix (paper Sec. 4.4)."""

    ELEMENT = "element"
    ROW = "row"
    COLUMN = "column"
    NONE = "none"  # Seq has no pipelining granularity


@dataclass(frozen=True)
class Loop:
    """One loop level: a dimension, its binding and its tile size.

    ``tile`` is T_dim — the number of elements of the dimension mapped in
    parallel across PEs when spatial.  Temporal dims have tile == 1.
    """

    dim: str
    binding: Binding
    tile: int = 1

    def __post_init__(self):
        if self.binding == Binding.TEMPORAL and self.tile != 1:
            raise ValueError(
                f"temporal loop {self.dim} must have tile 1, got {self.tile}"
            )
        if self.tile < 1:
            raise ValueError(f"tile size must be >= 1, got {self.tile}")

    @property
    def spatial(self) -> bool:
        return self.binding == Binding.SPATIAL

    def __str__(self) -> str:  # e.g. "Vs(8)" or "Nt"
        t = f"({self.tile})" if self.spatial and self.tile > 1 else ""
        return f"{self.dim}{self.binding.value}{t}"


@dataclass(frozen=True)
class IntraPhaseDataflow:
    """Loop nest for a single phase, outermost loop first."""

    loops: tuple[Loop, ...]
    phase: str = "agg"  # "agg" | "cmb"

    def __post_init__(self):
        dims = tuple(l.dim for l in self.loops)
        expected = AGG_DIMS if self.phase == "agg" else CMB_DIMS
        if sorted(dims) != sorted(expected):
            raise ValueError(
                f"{self.phase} dataflow must permute {expected}, got {dims}"
            )

    # -- helpers ----------------------------------------------------------
    @property
    def order(self) -> tuple[str, ...]:
        return tuple(l.dim for l in self.loops)

    def loop(self, dim: str) -> Loop:
        for l in self.loops:
            if l.dim == dim:
                return l
        raise KeyError(dim)

    def tile(self, dim: str) -> int:
        return self.loop(dim).tile

    def binding(self, dim: str) -> Binding:
        return self.loop(dim).binding

    @property
    def reduction_dim(self) -> str:
        return AGG_REDUCTION if self.phase == "agg" else CMB_REDUCTION

    @property
    def spatial_footprint(self) -> int:
        """Number of PE lanes this intra-phase mapping occupies."""
        out = 1
        for l in self.loops:
            out *= l.tile
        return out

    @property
    def temporal_reduction(self) -> bool:
        return self.binding(self.reduction_dim) == Binding.TEMPORAL

    def with_tiles(self, **tiles: int) -> "IntraPhaseDataflow":
        new = []
        for l in self.loops:
            if l.dim in tiles:
                t = tiles[l.dim]
                b = Binding.SPATIAL if t > 1 else l.binding
                # setting tile 1 on a spatial loop leaves it spatial with T=1
                new.append(Loop(l.dim, b if t > 1 else l.binding, t))
            else:
                new.append(l)
        return replace(self, loops=tuple(new))

    def __str__(self) -> str:
        return "".join(str(l) for l in self.loops)


def intra(spec: str, phase: str, **tiles: int) -> IntraPhaseDataflow:
    """Parse a compact spec like ``"VtFsNt"`` into an IntraPhaseDataflow.

    ``tiles`` provides T_dim for spatial dims, e.g. ``intra("VsFsNt", "agg",
    V=16, F=32)``.
    """
    if len(spec) != 6:
        raise ValueError(f"spec must be 6 chars like 'VtFsNt', got {spec!r}")
    loops = []
    for i in range(0, 6, 2):
        dim, b = spec[i], spec[i + 1]
        binding = Binding(b)
        tile = tiles.get(dim, 1)
        if binding == Binding.TEMPORAL:
            tile = 1
        loops.append(Loop(dim, binding, tile))
    return IntraPhaseDataflow(tuple(loops), phase=phase)


# ---------------------------------------------------------------------------
# Complete dataflow
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class GNNDataflow:
    """Complete description: <Inter><order>(<AggIntra>, <CmbIntra>)."""

    inter: InterPhase
    order: PhaseOrder
    agg: IntraPhaseDataflow
    cmb: IntraPhaseDataflow
    # PP only: fraction of PEs given to the *first* phase of `order`.
    pe_split: float = 0.5

    def __post_init__(self):
        if self.agg.phase != "agg" or self.cmb.phase != "cmb":
            raise ValueError("agg/cmb intra dataflows swapped")
        if self.inter == InterPhase.PP and not 0.0 < self.pe_split < 1.0:
            raise ValueError("pe_split must be in (0, 1)")

    # -- classification ----------------------------------------------------
    @property
    def first(self) -> IntraPhaseDataflow:
        return self.agg if self.order == PhaseOrder.AC else self.cmb

    @property
    def second(self) -> IntraPhaseDataflow:
        return self.cmb if self.order == PhaseOrder.AC else self.agg

    @property
    def granularity(self) -> Granularity:
        return classify_granularity(self.order, self.agg.order, self.cmb.order)

    @property
    def is_pipelineable(self) -> bool:
        return self.granularity != Granularity.NONE

    @property
    def is_sp_optimized(self) -> bool:
        """Paper Table 2 row 2 — the SP subset whose intermediate stays in
        the PEs.  Requires: element granularity loop orders, temporal
        reduction in the first phase (T_N = 1 for AC), matching tiles for
        the shared dims, and a temporal inner loop in the second phase."""
        if self.inter != InterPhase.SP:
            return False
        if self.granularity != Granularity.ELEMENT:
            return False
        if self.order == PhaseOrder.AC:
            shared = ("V", "F")
            if self.agg.binding("N") != Binding.TEMPORAL:
                return False
            if self.cmb.binding("G") != Binding.TEMPORAL:
                return False
            return all(self.agg.tile(d) == self.cmb.tile(d) for d in shared)
        else:
            # CA - {N_x F_x} V_t , {V_x G_x} F_t  (intermediate is V x G,
            # shared dims map agg.N<->cmb.V and agg.F<->cmb.G)
            if self.agg.binding("V") != Binding.TEMPORAL:
                return False
            if self.cmb.binding("F") != Binding.TEMPORAL:
                return False
            return (
                self.agg.tile("N") == self.cmb.tile("V")
                and self.agg.tile("F") == self.cmb.tile("G")
            )

    def validate(self, n_pes: int | None = None) -> None:
        """Raise ValueError if the dataflow is illegal (paper Table 2)."""
        if self.inter in (InterPhase.SP, InterPhase.PP):
            if not self.is_pipelineable:
                raise ValueError(
                    f"{self} is not pipelineable: loop orders "
                    f"({'/'.join(self.agg.order)}, {'/'.join(self.cmb.order)}) "
                    "admit no element/row/column granularity (Table 2 rows 4-9)"
                )
        if n_pes is not None:
            if self.inter == InterPhase.PP:
                pe_first = max(1, int(n_pes * self.pe_split))
                pe_second = max(1, n_pes - pe_first)
                budgets = (
                    (self.first, pe_first),
                    (self.second, pe_second),
                )
            else:
                budgets = ((self.agg, n_pes), (self.cmb, n_pes))
            for df, budget in budgets:
                if df.spatial_footprint > budget:
                    raise ValueError(
                        f"{df} spatial footprint {df.spatial_footprint} "
                        f"exceeds PE budget {budget}"
                    )

    def __str__(self) -> str:
        name = self.inter.value
        if self.is_sp_optimized:
            name = "SPopt"
        return f"{name}_{self.order.value}({self.agg}, {self.cmb})"

    def to_string(self) -> str:
        """Canonical, parseable template notation (paper Sec. 4.1):

            <Inter>[<pe_split>]_<order>(<AggIntra>, <CmbIntra>)

        Unlike ``str(df)`` this never renames SP to "SPopt" (the subset
        membership is derived, not stored), always prints spatial tile
        sizes, and carries the PP PE split so
        ``parse_dataflow(df.to_string()) == df`` holds exactly.
        """
        def loops(ph: IntraPhaseDataflow) -> str:
            out = []
            for l in ph.loops:
                t = f"({l.tile})" if l.spatial else ""
                out.append(f"{l.dim}{l.binding.value}{t}")
            return "".join(out)

        split = f"[{self.pe_split!r}]" if self.inter == InterPhase.PP else ""
        return (
            f"{self.inter.value}{split}_{self.order.value}"
            f"({loops(self.agg)}, {loops(self.cmb)})"
        )


# ---------------------------------------------------------------------------
# Granularity classification (paper Sec 4.4, Table 2 rows 4-9)
# ---------------------------------------------------------------------------


def classify_granularity(
    order: PhaseOrder,
    agg_order: Sequence[str],
    cmb_order: Sequence[str],
) -> Granularity:
    """Classify the pipelining granularity admitted by a loop-order pair.

    The intermediate matrix is V x F for AC (rows indexed by V, columns by
    the feature dim) and V x G for CA.  A pair is pipelineable iff producer
    and consumer walk the intermediate in a compatible order:

      * ELEMENT — both phases' outer two loops are the intermediate's two
        index dims, in the same order (Table 2 rows 4, 7).
      * ROW     — both phases' outermost loop is the intermediate's row dim
        (rows 5, 8), excluding pairs already classified ELEMENT.
      * COLUMN  — both outermost loops are the intermediate's column dim
        (rows 6, 9), excluding ELEMENT pairs.
    """
    agg_order = tuple(agg_order)
    cmb_order = tuple(cmb_order)
    if order == PhaseOrder.AC:
        # intermediate (AX) is V x F: agg indexes it (V, F); cmb (V, F).
        first_ix = {"row": "V", "col": "F", "dims": ("V", "F")}
        first, second = agg_order, cmb_order
        second_ix = {"row": "V", "col": "F", "dims": ("V", "F")}
    else:
        # intermediate (XW) is V x G: cmb indexes it (V, G); agg consumes it
        # as its "input feature" matrix indexed by (N [gathered rows], F=G).
        first_ix = {"row": "V", "col": "G", "dims": ("V", "G")}
        first, second = cmb_order, agg_order
        second_ix = {"row": "N", "col": "F", "dims": ("N", "F")}

    def outer2(o, ix):
        return tuple(d for d in o if d in ix["dims"])[:2]

    f2 = outer2(first, first_ix)
    s2 = outer2(second, second_ix)
    # map second phase's intermediate dims onto (row, col) labels
    def lab(d, ix):
        return "row" if d == ix["row"] else "col"

    f_lab = tuple(lab(d, first_ix) for d in f2)
    s_lab = tuple(lab(d, second_ix) for d in s2)

    # ELEMENT: outer two loops of both phases are the intermediate dims in
    # the same (row/col) order — i.e. the third (non-intermediate) dim is
    # innermost in both phases (Table 2 rows 4, 7).
    f_elem = first[0] in first_ix["dims"] and first[1] in first_ix["dims"]
    s_elem = second[0] in second_ix["dims"] and second[1] in second_ix["dims"]
    if f_elem and s_elem and f_lab == s_lab:
        return Granularity.ELEMENT
    # ROW / COLUMN: outermost loops of both phases walk the same axis of the
    # intermediate (rows 5-6, 8-9); ELEMENT pairs were already consumed.
    if first[0] == first_ix["row"] and second[0] == second_ix["row"]:
        return Granularity.ROW
    if first[0] == first_ix["col"] and second[0] == second_ix["col"]:
        return Granularity.COLUMN
    return Granularity.NONE


# ---------------------------------------------------------------------------
# Template-notation parsing (inverse of GNNDataflow.to_string)
# ---------------------------------------------------------------------------

_DF_RE = re.compile(
    r"^(?P<inter>Seq|SPopt|SP|PP)"
    r"(?:\[(?P<split>[0-9.eE+-]+)\])?"
    r"_(?P<order>AC|CA)"
    r"\((?P<agg>[^,]+),\s*(?P<cmb>.+)\)$"
)
_LOOP_RE = re.compile(r"([VNFG])([st])(?:\((\d+)\))?")


def _parse_intra(spec: str, phase: str) -> IntraPhaseDataflow:
    loops, consumed = [], 0
    for m in _LOOP_RE.finditer(spec):
        if m.start() != consumed:
            raise ValueError(f"malformed intra-phase spec {spec!r}")
        consumed = m.end()
        dim, b, tile = m.group(1), Binding(m.group(2)), m.group(3)
        loops.append(Loop(dim, b, int(tile) if tile else 1))
    if consumed != len(spec) or len(loops) != 3:
        raise ValueError(f"malformed intra-phase spec {spec!r}")
    return IntraPhaseDataflow(tuple(loops), phase=phase)


def parse_dataflow(text: str) -> GNNDataflow:
    """Parse the paper's ``<Inter><order>(<AggIntra>, <CmbIntra>)`` template.

    Inverse of :meth:`GNNDataflow.to_string`; also accepts the "SPopt"
    prefix that ``str(df)`` prints for SP-Optimized instances (membership is
    re-derived from the loop structure, not stored).  A ``[pe_split]``
    bracket after the inter-phase class carries the PP PE allocation.
    """
    m = _DF_RE.match(text.strip())
    if m is None:
        raise ValueError(f"cannot parse dataflow template {text!r}")
    inter = InterPhase.SP if m["inter"] == "SPopt" else InterPhase(m["inter"])
    kwargs = {}
    if m["split"] is not None:
        kwargs["pe_split"] = float(m["split"])
    return GNNDataflow(
        inter,
        PhaseOrder(m["order"]),
        _parse_intra(m["agg"].strip(), "agg"),
        _parse_intra(m["cmb"].strip(), "cmb"),
        **kwargs,
    )


# ---------------------------------------------------------------------------
# Layer-boundary walk orders (model-level transition costing, Sec. 4.4)
# ---------------------------------------------------------------------------


def output_walk(df: GNNDataflow) -> str:
    """Major order ("row" | "column") in which a layer's final V x F_out
    output matrix is produced.

    The output is written by the *second* phase of the phase order: the
    combination (V x G) for AC, the aggregation (V x F) for CA.  For
    pipelined dataflows (SP/PP) the walk follows the pipelining granularity;
    for Seq it is the loop order of the producing phase.
    """
    second = df.second
    col = "G" if second.phase == "cmb" else "F"
    gran = df.granularity
    if df.inter in (InterPhase.SP, InterPhase.PP) and gran != Granularity.NONE:
        # element granularity walks the chunk grid row-major (see
        # simulator._pp_chunk_times)
        return "column" if gran == Granularity.COLUMN else "row"
    order = second.order
    return "row" if order.index("V") < order.index(col) else "column"


def input_walk(df: GNNDataflow) -> str:
    """Major order ("row" | "column") in which a layer streams its input
    feature matrix X (V x F_in) out of the Global Buffer.

    AC consumes X in the aggregation phase: neighbor *rows* are gathered by
    N (row-major access), except when the F loop is outermost — then the
    whole matrix is swept one column block at a time.  CA consumes X in the
    combination GEMM as a dense (V, F) operand, column-major when F is
    outer to V.
    """
    first = df.first
    if first.phase == "cmb":
        return "row" if first.order.index("V") < first.order.index("F") else "column"
    return "column" if first.order[0] == "F" else "row"


# ---------------------------------------------------------------------------
# Enumeration (paper: 6,656 choices)
# ---------------------------------------------------------------------------


def _all_intra(phase: str) -> list[IntraPhaseDataflow]:
    dims = AGG_DIMS if phase == "agg" else CMB_DIMS
    out = []
    for perm in itertools.permutations(dims):
        for bindings in itertools.product(Binding, repeat=3):
            loops = tuple(Loop(d, b, 1) for d, b in zip(perm, bindings))
            out.append(IntraPhaseDataflow(loops, phase=phase))
    return out


def enumerate_dataflows(
    inter_phases: Iterable[InterPhase] = tuple(InterPhase),
    orders: Iterable[PhaseOrder] = tuple(PhaseOrder),
) -> list[GNNDataflow]:
    """Enumerate the loop-order x parallelism x phase-order design space.

    Tile sizes are left at 1 (they are a separate, continuous axis of the
    map space).  With all three inter-phase classes and both phase orders
    this yields exactly 6,656 dataflows: 48x48x2 = 4,608 Seq + 1,024 SP +
    1,024 PP (the pipelineable loop-order pairs of Table 2 rows 4-9).
    """
    aggs = _all_intra("agg")
    cmbs = _all_intra("cmb")
    out: list[GNNDataflow] = []
    for ip in inter_phases:
        for order in orders:
            for a, c in itertools.product(aggs, cmbs):
                df = GNNDataflow(ip, order, a, c)
                if ip in (InterPhase.SP, InterPhase.PP) and not df.is_pipelineable:
                    continue
                out.append(df)
    return out


# ---------------------------------------------------------------------------
# Skeletons: dataflows with free ("x") dims, for the mapping optimizer
# ---------------------------------------------------------------------------


class Cons(str, enum.Enum):
    """Binding constraint for one dim of a dataflow skeleton.

    Mirrors the paper's subscripts: ``t``/``s`` are forced, ``x`` is free
    (the mapper chooses), ``s_high``/``s_low`` are the paper's Vsh / Vt/sl
    annotations (necessarily-spatial with a large / small tile).
    """

    T = "t"
    S = "s"
    X = "x"
    S_HIGH = "sh"
    S_LOW = "sl"
    S_FULL = "sf"  # the whole PE budget on this one dim (rigid substrate)


@dataclass(frozen=True)
class SkeletonPhase:
    order: tuple[str, ...]
    cons: tuple[Cons, Cons, Cons]  # aligned with `order`
    fixed: tuple[int, ...] = (0, 0, 0)  # 0 = not fixed, else exact tile

    def constraint(self, dim: str) -> Cons:
        return self.cons[self.order.index(dim)]

    def fixed_tile(self, dim: str) -> int:
        return self.fixed[self.order.index(dim)]

    def to_intra(self, phase: str, tiles: dict[str, int]) -> IntraPhaseDataflow:
        loops = []
        for d, c in zip(self.order, self.cons):
            t = tiles.get(d, 1)
            if c == Cons.T:
                loops.append(Loop(d, Binding.TEMPORAL, 1))
            else:
                loops.append(Loop(d, Binding.SPATIAL if t > 1 else Binding.TEMPORAL, max(t, 1)))
        return IntraPhaseDataflow(tuple(loops), phase=phase)


@dataclass(frozen=True)
class DataflowSkeleton:
    """A Table-5 style dataflow family: loop orders + binding constraints.

    The mapper (:mod:`repro.core.mapper`) binds tile sizes, producing a
    concrete :class:`GNNDataflow`.
    """

    name: str
    inter: InterPhase
    order: PhaseOrder
    agg: SkeletonPhase
    cmb: SkeletonPhase
    sp_optimized: bool = False  # tie T_V/T_F across phases, T_N = 1

    def concretize(
        self,
        agg_tiles: dict[str, int],
        cmb_tiles: dict[str, int],
        pe_split: float = 0.5,
    ) -> GNNDataflow:
        return GNNDataflow(
            self.inter,
            self.order,
            self.agg.to_intra("agg", agg_tiles),
            self.cmb.to_intra("cmb", cmb_tiles),
            pe_split=pe_split,
        )


def _sk(order: str, cons: str, fixed: tuple[int, int, int] = (0, 0, 0)) -> SkeletonPhase:
    dims = tuple(order)
    cmap = {
        "t": Cons.T,
        "s": Cons.S,
        "x": Cons.X,
        "h": Cons.S_HIGH,
        "l": Cons.S_LOW,
        "f": Cons.S_FULL,
    }
    return SkeletonPhase(dims, tuple(cmap[c] for c in cons), fixed)


#: Table 5 dataflow configurations (+ HyGCN / AWB-GCN / EnGN), as skeletons.
SKELETONS: dict[str, DataflowSkeleton] = {
    # Seq_AC(VxFxNt, VxGxFx) — temporal aggregation
    "Seq-Nt": DataflowSkeleton(
        "Seq-Nt", InterPhase.SEQ, PhaseOrder.AC, _sk("VFN", "xxt"), _sk("VGF", "xxx")
    ),
    # Seq_AC(VxFxNs, VxGxFx) — spatial aggregation
    "Seq-Ns": DataflowSkeleton(
        "Seq-Ns", InterPhase.SEQ, PhaseOrder.AC, _sk("VFN", "xxs"), _sk("VGF", "xxx")
    ),
    # SP_AC(VxFsNt, VxFsGx) — SP-optimized, high T_F
    "SP-FsNt-Fs": DataflowSkeleton(
        "SP-FsNt-Fs", InterPhase.SP, PhaseOrder.AC,
        _sk("VFN", "xht"), _sk("VFG", "xht"), sp_optimized=True,
    ),
    # SP_AC(VsFxNt, VsFxGx) — SP-optimized, high T_V
    "SP-VsNt-Vs": DataflowSkeleton(
        "SP-VsNt-Vs", InterPhase.SP, PhaseOrder.AC,
        _sk("VFN", "hxt"), _sk("VFG", "hxt"), sp_optimized=True,
    ),
    # High-Vs-SP — the rigid-substrate degenerate SP-opt: T_F = T_N = 1,
    # all parallelism on V (paper Sec. 5.4)
    "High-Vs-SP": DataflowSkeleton(
        "High-Vs-SP", InterPhase.SP, PhaseOrder.AC,
        _sk("VFN", "ftt"), _sk("VFG", "ftt"), sp_optimized=True,
    ),
    # PP_AC(VxFxNt, VxGxFx) — row granularity, few rows pipelined
    "PP-Nt-Vt/sl": DataflowSkeleton(
        "PP-Nt-Vt/sl", InterPhase.PP, PhaseOrder.AC,
        _sk("VFN", "xxt"), _sk("VGF", "lxx"),
    ),
    "PP-Ns-Vt/sl": DataflowSkeleton(
        "PP-Ns-Vt/sl", InterPhase.PP, PhaseOrder.AC,
        _sk("VFN", "xxs"), _sk("VGF", "lxx"),
    ),
    # PP_AC(VxFxNt, VsGxFx) — row granularity, many rows pipelined
    "PP-Nt-Vsh": DataflowSkeleton(
        "PP-Nt-Vsh", InterPhase.PP, PhaseOrder.AC,
        _sk("VFN", "xxt"), _sk("VGF", "hxx"),
    ),
    "PP-Ns-Vsh": DataflowSkeleton(
        "PP-Ns-Vsh", InterPhase.PP, PhaseOrder.AC,
        _sk("VFN", "xxs"), _sk("VGF", "hxx"),
    ),
    # HyGCN: PP_AC(VxFsNt, VsGsFt)
    "HyGCN": DataflowSkeleton(
        "HyGCN", InterPhase.PP, PhaseOrder.AC,
        _sk("VFN", "xst"), _sk("VGF", "sst"),
    ),
    # AWB-GCN: PP_CA(FsNtVs, GtFtVs)
    "AWB-GCN": DataflowSkeleton(
        "AWB-GCN", InterPhase.PP, PhaseOrder.CA,
        _sk("FNV", "sts"), _sk("GFV", "tts"),
    ),
    # EnGN: SP-Optimized instance
    "EnGN": DataflowSkeleton(
        "EnGN", InterPhase.SP, PhaseOrder.AC,
        _sk("VFN", "sst"), _sk("VFG", "sst"), sp_optimized=True,
    ),
}


def named_skeleton(name: str) -> DataflowSkeleton:
    if name not in SKELETONS:
        raise KeyError(f"unknown skeleton {name!r}; have {sorted(SKELETONS)}")
    return SKELETONS[name]


# ---------------------------------------------------------------------------
# Named dataflows from the paper (Table 5 + known accelerators)
# ---------------------------------------------------------------------------


def named_dataflow(name: str, **tiles) -> GNNDataflow:
    """Table 5 configurations plus HyGCN / AWB-GCN / EnGN dataflows.

    ``tiles`` keys: T_V_AGG, T_N, T_F_AGG, T_V_CMB, T_G, T_F_CMB.
    """
    tv_a = tiles.get("T_V_AGG", 1)
    tn = tiles.get("T_N", 1)
    tf_a = tiles.get("T_F_AGG", 1)
    tv_c = tiles.get("T_V_CMB", 1)
    tg = tiles.get("T_G", 1)
    tf_c = tiles.get("T_F_CMB", 1)

    def a(spec):
        return intra(spec, "agg", V=tv_a, N=tn, F=tf_a)

    def c(spec):
        return intra(spec, "cmb", V=tv_c, G=tg, F=tf_c)

    def s(d, t):  # binding char from tile size
        return "s" if t > 1 else d

    catalog = {
        # -- Table 5 ---------------------------------------------------------
        "Seq-Nt": lambda: GNNDataflow(
            InterPhase.SEQ, PhaseOrder.AC,
            a(f"V{'s' if tv_a>1 else 't'}F{'s' if tf_a>1 else 't'}Nt"),
            c(f"V{'s' if tv_c>1 else 't'}G{'s' if tg>1 else 't'}F{'s' if tf_c>1 else 't'}"),
        ),
        "Seq-Ns": lambda: GNNDataflow(
            InterPhase.SEQ, PhaseOrder.AC,
            a(f"V{'s' if tv_a>1 else 't'}F{'s' if tf_a>1 else 't'}Ns"),
            c(f"V{'s' if tv_c>1 else 't'}G{'s' if tg>1 else 't'}F{'s' if tf_c>1 else 't'}"),
        ),
        "SP-FsNt-Fs": lambda: GNNDataflow(  # SP-opt, high T_F
            InterPhase.SP, PhaseOrder.AC,
            a(f"V{'s' if tv_a>1 else 't'}FsNt"),
            c(f"V{'s' if tv_c>1 else 't'}FsGt"),
        ),
        "SP-VsNt-Vs": lambda: GNNDataflow(  # SP-opt, high T_V
            InterPhase.SP, PhaseOrder.AC,
            a(f"VsF{'s' if tf_a>1 else 't'}Nt"),
            c(f"VsF{'s' if tf_c>1 else 't'}Gt"),
        ),
        "High-Vs-SP": lambda: GNNDataflow(  # SP-opt degenerate: T_F=T_N=1
            InterPhase.SP, PhaseOrder.AC,
            a("VsFtNt"),
            c("VsFtGt"),
        ),
        "PP-Nt-Vt/sl": lambda: GNNDataflow(  # row granularity, low rows
            InterPhase.PP, PhaseOrder.AC,
            a(f"V{'s' if tv_a>1 else 't'}F{'s' if tf_a>1 else 't'}Nt"),
            c(f"V{'s' if tv_c>1 else 't'}G{'s' if tg>1 else 't'}F{'s' if tf_c>1 else 't'}"),
            pe_split=tiles.get("pe_split", 0.5),
        ),
        "PP-Ns-Vt/sl": lambda: GNNDataflow(
            InterPhase.PP, PhaseOrder.AC,
            a(f"V{'s' if tv_a>1 else 't'}F{'s' if tf_a>1 else 't'}Ns"),
            c(f"V{'s' if tv_c>1 else 't'}G{'s' if tg>1 else 't'}F{'s' if tf_c>1 else 't'}"),
            pe_split=tiles.get("pe_split", 0.5),
        ),
        "PP-Nt-Vsh": lambda: GNNDataflow(  # high granularity (many rows)
            InterPhase.PP, PhaseOrder.AC,
            a(f"V{'s' if tv_a>1 else 't'}F{'s' if tf_a>1 else 't'}Nt"),
            c(f"VsG{'s' if tg>1 else 't'}F{'s' if tf_c>1 else 't'}"),
            pe_split=tiles.get("pe_split", 0.5),
        ),
        "PP-Ns-Vsh": lambda: GNNDataflow(
            InterPhase.PP, PhaseOrder.AC,
            a(f"V{'s' if tv_a>1 else 't'}F{'s' if tf_a>1 else 't'}Ns"),
            c(f"VsG{'s' if tg>1 else 't'}F{'s' if tf_c>1 else 't'}"),
            pe_split=tiles.get("pe_split", 0.5),
        ),
        # -- published accelerators -----------------------------------------
        # HyGCN: PP_AC(VxFsNt, VsGsFt)
        "HyGCN": lambda: GNNDataflow(
            InterPhase.PP, PhaseOrder.AC,
            a(f"V{'s' if tv_a>1 else 't'}FsNt"),
            c("VsGsFt"),
            pe_split=tiles.get("pe_split", 0.5),
        ),
        # AWB-GCN: PP_CA(FsNtVs, GtFtVs)
        "AWB-GCN": lambda: GNNDataflow(
            InterPhase.PP, PhaseOrder.CA,
            a("FsNtVs"),
            c("GtFtVs"),
            pe_split=tiles.get("pe_split", 0.5),
        ),
        # EnGN: SP-Optimized instance
        "EnGN": lambda: GNNDataflow(
            InterPhase.SP, PhaseOrder.AC,
            a("VsFsNt"),
            c("VsFsGt"),
        ),
    }
    if name not in catalog:
        raise KeyError(f"unknown dataflow {name!r}; have {sorted(catalog)}")
    return catalog[name]()
