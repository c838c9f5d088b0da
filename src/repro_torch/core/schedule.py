"""Model-level schedule IR: from taxonomy dataflows to executable knobs.

The paper's design-space is per *layer*; its case studies compose
heterogeneous dataflows across a multi-layer GNN (feature widths shrink
layer by layer, so the optimal dataflow changes — Sec. 4.4 / Sec. 5).  This
module is the bridge that makes the taxonomy :class:`GNNDataflow` the
single source of truth from search to execution:

* :class:`LayerSchedule` — one concrete dataflow bound to a layer's
  (f_in, f_out) shape, with :meth:`LayerSchedule.lower` deriving the
  executable knobs (:class:`ExecSpec`): the ``repro.gnn`` policy string,
  the row-band size of the scan, the ELL block rows, and the Pallas
  grid/block shapes consumed by ``kernels/*/ops.py``.
* :class:`ModelSchedule` — per-layer schedules plus the inter-layer
  :class:`TransitionSpec` descriptors (does the producer's output walk
  match the consumer's input walk, and how many elements re-lay-out if
  not).  JSON round-trips through the taxonomy's template notation
  (:meth:`GNNDataflow.to_string` / :func:`~repro.core.taxonomy.parse_dataflow`).

The costed counterpart lives in :mod:`repro.core.simulator`
(``ModelStats`` / ``transition_cost``); the search entry point is
``repro.core.mapper.search_model``.
"""
from __future__ import annotations

import json
import zlib
from dataclasses import asdict, dataclass, field
from typing import TYPE_CHECKING, Sequence

from .hw import AcceleratorConfig
from .taxonomy import (
    GNNDataflow,
    InterPhase,
    PhaseOrder,
    input_walk,
    intra,
    output_walk,
    parse_dataflow,
)

if TYPE_CHECKING:  # costed types only annotate; no runtime import cycle
    from .simulator import ModelStats, RunStats


# ---------------------------------------------------------------------------
# Executable knobs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ExecSpec:
    """Executable knobs for one layer, consumed by :mod:`repro.gnn`.

    ``band_size`` doubles as the Pallas row-block (``block_v``) of the
    SpMM / fused kernels; ``block_f`` is their feature-block;
    ``ell_block_rows`` groups rows when building the padded-ELL adjacency.
    """

    policy: str  # seq | sp_generic | sp_opt | pp
    order: str  # AC | CA
    band_size: int
    block_f: int | None = None  # None = the kernel's own default
    ell_block_rows: int = 1
    use_pallas: bool = False


def policy_of(df: GNNDataflow) -> str:
    """The ``repro.gnn`` execution policy a dataflow lowers to."""
    if df.inter == InterPhase.SEQ:
        return "seq"
    if df.inter == InterPhase.SP:
        return "sp_opt" if df.is_sp_optimized else "sp_generic"
    return "pp"


def _pipeline_rows(df: GNNDataflow) -> int:
    """Row extent of the intermediate chunk in flight (Sec. 4.4)."""
    if df.order == PhaseOrder.AC:
        return max(df.agg.tile("V"), df.cmb.tile("V"))
    return max(df.cmb.tile("V"), df.agg.tile("N"))


def _pipeline_cols(df: GNNDataflow) -> int:
    """Column extent of the intermediate chunk in flight."""
    if df.order == PhaseOrder.AC:
        return max(df.agg.tile("F"), df.cmb.tile("F"))
    return max(df.cmb.tile("G"), df.agg.tile("F"))


# ---------------------------------------------------------------------------
# Per-layer schedule
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class LayerSchedule:
    """One concrete dataflow bound to a layer's (f_in, f_out) shape."""

    dataflow: GNNDataflow
    f_in: int
    f_out: int
    name: str = ""
    #: RunStats from the mapper's scalar oracle, when searched (not part of
    #: identity — two schedules with the same dataflow/shape are equal).
    stats: "RunStats | None" = field(default=None, compare=False, repr=False)

    def lower(self, use_pallas: bool = False, default_band: int = 128) -> ExecSpec:
        """Derive the executable knobs from the dataflow's structure.

        The scan band is the pipelined row chunk (``max`` of the two
        phases' row tiles — exactly the simulator's chunking); dataflows
        whose row dims are temporal fall back to ``default_band``.  Blocks
        are clamped to >= 8 rows so the Pallas tiles stay legal.
        """
        df = self.dataflow
        rows = _pipeline_rows(df)
        cols = _pipeline_cols(df)
        band = max(8, rows if rows > 1 else default_band)
        block_f = max(8, cols if cols > 1 else default_band)
        return ExecSpec(
            policy=policy_of(df),
            order=df.order.value,
            band_size=band,
            block_f=block_f,
            ell_block_rows=band,
            use_pallas=use_pallas,
        )

    def to_dict(self) -> dict:
        return {
            "dataflow": self.dataflow.to_string(),
            "f_in": self.f_in,
            "f_out": self.f_out,
            "name": self.name,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "LayerSchedule":
        return cls(
            parse_dataflow(d["dataflow"]),
            int(d["f_in"]),
            int(d["f_out"]),
            name=d.get("name", ""),
        )


# ---------------------------------------------------------------------------
# Inter-layer transitions
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class TransitionSpec:
    """Structural descriptor of one layer boundary.

    ``relayout`` is True when the producer's output walk disagrees with the
    consumer's input walk — the V x F intermediate must then be
    re-materialized through the GB/DRAM in the other major order before the
    next layer can stream it (the cost is priced by
    :func:`repro.core.simulator.transition_cost`).
    """

    producer_walk: str  # row | column
    consumer_walk: str  # row | column
    producer_granularity: str  # element | row | column | none
    relayout: bool
    elements: int  # V x F_in of the consuming layer (0 when shape unknown)

    def to_dict(self) -> dict:
        return {
            "producer_walk": self.producer_walk,
            "consumer_walk": self.consumer_walk,
            "producer_granularity": self.producer_granularity,
            "relayout": self.relayout,
            "elements": self.elements,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "TransitionSpec":
        return cls(
            d["producer_walk"],
            d["consumer_walk"],
            d["producer_granularity"],
            bool(d["relayout"]),
            int(d["elements"]),
        )


def transition_spec(
    prev: GNNDataflow, nxt: GNNDataflow, v: int = 0, f: int = 0
) -> TransitionSpec:
    """Classify the boundary between two consecutive layers' dataflows.

    ``v`` / ``f`` are the shape of the inter-layer feature matrix (the
    producing layer's output = the consuming layer's input); ``elements``
    is 0 when they are unknown.
    """
    prod = output_walk(prev)
    cons = input_walk(nxt)
    return TransitionSpec(
        producer_walk=prod,
        consumer_walk=cons,
        producer_granularity=prev.granularity.value,
        relayout=prod != cons,
        elements=int(v) * int(f),
    )


# ---------------------------------------------------------------------------
# Model schedule
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ModelSchedule:
    """Per-layer schedules + inter-layer transition descriptors."""

    layers: tuple[LayerSchedule, ...]
    transitions: tuple[TransitionSpec, ...] = ()
    objective: str = "cycles"
    #: end-to-end ModelStats from the simulator, when searched.
    stats: "ModelStats | None" = field(default=None, compare=False, repr=False)
    #: the best homogeneous shared-dataflow schedule from the same search
    #: (attached by `search_model`, so callers never pay a second sweep).
    shared_baseline: "ModelSchedule | None" = field(
        default=None, compare=False, repr=False
    )
    #: the AcceleratorConfig the schedule was searched / priced on (set by
    #: `search_model`; the hw x dataflow co-search compares schedules by
    #: it).  Serialized when present; not part of schedule identity.
    hw: AcceleratorConfig | None = field(default=None, compare=False, repr=False)

    def __post_init__(self):
        if not self.layers:
            raise ValueError("ModelSchedule needs at least one layer")
        if len(self.transitions) != len(self.layers) - 1:
            raise ValueError(
                f"{len(self.layers)} layers need {len(self.layers) - 1} "
                f"transitions, got {len(self.transitions)}"
            )
        for i in range(1, len(self.layers)):
            prev, cur = self.layers[i - 1], self.layers[i]
            if prev.f_out != cur.f_in:
                raise ValueError(
                    f"layer {i} consumes f_in={cur.f_in} but layer {i - 1} "
                    f"produces f_out={prev.f_out}"
                )

    # -- views --------------------------------------------------------------
    @property
    def n_layers(self) -> int:
        return len(self.layers)

    @property
    def dataflows(self) -> list[GNNDataflow]:
        return [l.dataflow for l in self.layers]

    @property
    def is_heterogeneous(self) -> bool:
        return len({l.dataflow for l in self.layers}) > 1

    @property
    def n_relayouts(self) -> int:
        return sum(t.relayout for t in self.transitions)

    # -- lowering -----------------------------------------------------------
    def lower(self, use_pallas: bool = False) -> list[ExecSpec]:
        """Executable knobs for every layer, in order."""
        return [l.lower(use_pallas=use_pallas) for l in self.layers]

    @property
    def ell_block_rows(self) -> int:
        """Row grouping for the (shared) padded-ELL adjacency: the largest
        per-layer requirement, so every layer's band scan stays aligned."""
        return max(l.lower().ell_block_rows for l in self.layers)

    # -- construction -------------------------------------------------------
    @classmethod
    def from_dataflows(
        cls,
        dataflows: Sequence[GNNDataflow],
        dims: Sequence[tuple[int, int]],
        v: int = 0,
        objective: str = "cycles",
        names: Sequence[str] | None = None,
    ) -> "ModelSchedule":
        """Build a schedule from per-layer dataflows + (f_in, f_out) dims."""
        if len(dataflows) != len(dims):
            raise ValueError(
                f"{len(dataflows)} dataflows vs {len(dims)} layer dims"
            )
        names = list(names or [""] * len(dims))
        layers = tuple(
            LayerSchedule(df, fi, fo, name=n)
            for df, (fi, fo), n in zip(dataflows, dims, names)
        )
        transitions = tuple(
            transition_spec(
                dataflows[i], dataflows[i + 1], v=v, f=dims[i + 1][0]
            )
            for i in range(len(dataflows) - 1)
        )
        return cls(layers, transitions, objective=objective)

    @classmethod
    def from_policies(
        cls,
        policy: str,
        order: str,
        dims: Sequence[tuple[int, int]],
        band_size: int = 128,
        v: int = 0,
    ) -> "ModelSchedule":
        """Compatibility shim: the legacy string knobs as a ModelSchedule.

        This is what ``repro.gnn`` builds internally when handed bare
        ``policy`` / ``order`` strings, so the executable path always runs
        off a schedule.
        """
        df = default_dataflow(policy, order=order, band_size=band_size)
        return cls.from_dataflows([df] * len(dims), dims, v=v)

    def digest(self) -> str:
        """Stable 8-hex identity of the schedule *content* (layers +
        transitions + objective, hw excluded so repricing on a different
        or recalibrated config does not change identity).  This is the
        key the serving engine's measured-latency ledger and re-ranker
        use to attribute wall-clock observations to a schedule."""
        payload = {
            "objective": self.objective,
            "layers": [l.to_dict() for l in self.layers],
            "transitions": [t.to_dict() for t in self.transitions],
        }
        data = json.dumps(payload, sort_keys=True).encode()
        return f"{zlib.crc32(data) & 0xFFFFFFFF:08x}"

    # -- (de)serialization ---------------------------------------------------
    def to_json(self, indent: int | None = 2) -> str:
        payload = {
            "objective": self.objective,
            "layers": [l.to_dict() for l in self.layers],
            "transitions": [t.to_dict() for t in self.transitions],
        }
        if self.hw is not None:
            payload["hw"] = asdict(self.hw)
        return json.dumps(payload, indent=indent)

    @classmethod
    def from_json(cls, text: str) -> "ModelSchedule":
        d = json.loads(text)
        return cls(
            tuple(LayerSchedule.from_dict(l) for l in d["layers"]),
            tuple(TransitionSpec.from_dict(t) for t in d.get("transitions", [])),
            objective=d.get("objective", "cycles"),
            hw=AcceleratorConfig.from_dict(d["hw"]) if "hw" in d else None,
        )

    def __str__(self) -> str:
        rows = [
            f"  [{i}] {l.f_in:>4d}->{l.f_out:<4d} {l.dataflow.to_string()}"
            for i, l in enumerate(self.layers)
        ]
        for i, t in enumerate(self.transitions):
            mark = "relayout" if t.relayout else "aligned"
            rows.insert(
                2 * i + 1,
                f"   |-- {t.producer_walk}->{t.consumer_walk} ({mark})",
            )
        return "ModelSchedule(\n" + "\n".join(rows) + "\n)"


# ---------------------------------------------------------------------------
# Default dataflows for the legacy string policies
# ---------------------------------------------------------------------------


def default_dataflow(
    policy: str, order: str = "AC", band_size: int = 128
) -> GNNDataflow:
    """A canonical taxonomy dataflow matching a ``repro.gnn`` policy string.

    Row tiles are bound to ``band_size`` so :meth:`LayerSchedule.lower`
    round-trips the band the executable scan actually uses.
    """
    band = max(int(band_size), 1)
    po = PhaseOrder(order)
    ac = po == PhaseOrder.AC

    if policy == "seq":
        agg = intra("VsFtNt", "agg", V=band)
        cmb = intra("VsGtFt", "cmb", V=band)
        return GNNDataflow(InterPhase.SEQ, po, agg, cmb)
    if policy in ("sp_generic", "pp"):
        ip = InterPhase.SP if policy == "sp_generic" else InterPhase.PP
        if ac:
            agg = intra("VsFtNt", "agg", V=band)
            cmb = intra("VsGtFt", "cmb", V=band)
        else:
            # NsVtFt (not NsFtVt) keeps the pair at ROW granularity — the
            # element-granularity variant would classify as SP-Optimized.
            agg = intra("NsVtFt", "agg", N=band)
            cmb = intra("VsGtFt", "cmb", V=band)
        return GNNDataflow(ip, po, agg, cmb)
    if policy == "sp_opt":
        if ac:
            agg = intra("VsFsNt", "agg", V=band)
            cmb = intra("VsFsGt", "cmb", V=band)
        else:
            agg = intra("NsFsVt", "agg", N=band)
            cmb = intra("VsGsFt", "cmb", V=band)
        df = GNNDataflow(InterPhase.SP, po, agg, cmb)
        assert df.is_sp_optimized, df
        return df
    raise ValueError(
        f"unknown policy {policy!r}; expected seq|sp_generic|sp_opt|pp"
    )
