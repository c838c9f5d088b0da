"""``repro_torch.compile()``: one compiler-style front-end over the whole stack.

The port of :mod:`repro.api`; Program artifacts keep its JSON format, so a
Program saved by either package loads in the other.

The paper's thesis is that a *mapper* should pick intra- and inter-phase
dataflows per workload and hand an optimized mapping to a flexible
accelerator.  This module is the stable compilation boundary that composes
every piece the repo already has:

    search (``repro_torch.core.mapper.search_model``)
      -> lower (``ModelSchedule.lower`` -> per-layer ``ExecSpec``)
        -> execute (the kernel registry behind ``repro_torch.gnn``)

behind a single entry point::

    import repro_torch
    program = repro_torch.compile(workloads, graph=g, objective="cycles")
    logits  = program.run(params, x)       # runs the searched schedule
    program.save("model.program.json")     # cacheable compiled artifact

A :class:`Program` is a frozen artifact: the searched
:class:`~repro_torch.core.schedule.ModelSchedule`, the
:class:`~repro_torch.core.hw.AcceleratorConfig` it was priced on, the predicted
:class:`~repro_torch.core.simulator.ModelStats`, and a fingerprint of the
workloads it was compiled for.  ``save``/``load`` round-trip all of that
through byte-stable JSON so serving paths can cache compiled programs and
skip the mapper entirely.
"""
from __future__ import annotations

import json
import os
import zlib
from dataclasses import asdict, dataclass, field, replace
from pathlib import Path
from typing import Sequence

import numpy as np
import torch

from .core.cost_model import GNNLayerWorkload
from .core.hw import AcceleratorConfig, DEFAULT_ACCEL, HWGrid, LatencyModel
from .core.mapper import TABLE5_NAMES, search_model, search_model_codesign
from .core.registry import get_objective, has_kernel, lookup_kernel
from .core.schedule import ModelSchedule, TransitionSpec
from .core.simulator import (
    ModelStats,
    RunStats,
    TransitionStats,
    simulate_model,
)
from .device import on_device, resolve_device
from .gnn.layers import LAYER_FNS, EllAdjacency, init_layer
from .gnn.model import GNNConfig, forward_layers, masked_xent_loss
from .graphs.csr import CSRGraph

#: Artifact schema version.  Bump the suffix whenever the JSON layout of
#: :meth:`Program.to_json` changes incompatibly (new required field,
#: changed schedule encoding, ...).  ``Program.from_json`` rejects any
#: other format string with a ``ValueError`` — deliberately, so a loader
#: can *choose* its forward-compat policy: direct callers see the error,
#: while :class:`repro_torch.runtime.store.ProgramStore` treats it as a cache
#: miss and recompiles, which is how a version bump invalidates every
#: persisted store entry without ever crashing a serving process.
PROGRAM_FORMAT = "repro.program/v1"

#: total number of executables built by Programs, process-wide.  The port
#: runs eagerly, so a "trace" is the first build of an ``_exec_cache``
#: entry for one shape key; a second run on a same-shape input (or a
#: same-shape rebind) must leave this counter unchanged — the reference's
#: zero-retrace contract, which the serving engine asserts.
_TRACE_COUNT = 0


def _note_trace() -> None:
    global _TRACE_COUNT
    _TRACE_COUNT += 1


def trace_count() -> int:
    """Process-wide count of executables built by ``Program.run``."""
    return _TRACE_COUNT


def workload_fingerprint(workloads: Sequence[GNNLayerWorkload]) -> dict:
    """A compact identity for the graph + layer shapes a Program was
    compiled for: cache keys for compiled artifacts.  The degree vector is
    hashed with crc32 (stable across processes, unlike ``hash``)."""
    first = workloads[0]
    return {
        "v": first.v,
        "e": first.e,
        "nnz_crc32": int(zlib.crc32(np.ascontiguousarray(first.nnz).tobytes())),
        "dims": [[wl.f_in, wl.g_out] for wl in workloads],
    }


# ---------------------------------------------------------------------------
# (De)serialization helpers for the costed stats
# ---------------------------------------------------------------------------


def _stats_to_dict(stats: ModelStats) -> dict:
    return {
        "layers": [asdict(s) for s in stats.layers],
        "transitions": [
            {
                "spec": t.spec.to_dict(),
                "gb_accesses": t.gb_accesses,
                "cycles": t.cycles,
                "energy_pj": t.energy_pj,
            }
            for t in stats.transitions
        ],
    }


def _stats_from_dict(d: dict) -> ModelStats:
    return ModelStats(
        layers=[RunStats(**s) for s in d["layers"]],
        transitions=[
            TransitionStats(
                spec=TransitionSpec.from_dict(t["spec"]),
                gb_accesses=t["gb_accesses"],
                cycles=t["cycles"],
                energy_pj=t["energy_pj"],
            )
            for t in d["transitions"]
        ],
    )


# ---------------------------------------------------------------------------
# Program
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Program:
    """A compiled multiphase GNN: schedule + hardware + predicted cost.

    Frozen artifact of :func:`repro_torch.compile`.  ``run``/``loss`` execute the
    searched schedule through the kernel registry; ``save``/``load``
    round-trip the artifact through byte-stable JSON (schedule, hw,
    predicted stats, workload fingerprint) so a serving path can cache the
    compilation and never re-run the mapper.
    """

    schedule: ModelSchedule
    hw: AcceleratorConfig = DEFAULT_ACCEL
    kind: str = "gcn"  # gcn | sage | gin
    objective: str = "cycles"
    use_pallas: bool = False
    fingerprint: dict = field(default_factory=dict)
    stats: ModelStats | None = field(default=None, compare=False, repr=False)
    #: runtime adjacency binding (set by compile(graph=...) / bind()); not
    #: part of the artifact and never serialized.
    adj: EllAdjacency | None = field(default=None, compare=False, repr=False)
    #: the hw x objective sweep behind a co-searched Program (one
    #: (AcceleratorConfig, objective value) pair per HWGrid point, in grid
    #: order, inf = infeasible); informational, never serialized.
    codesign: list | None = field(default=None, compare=False, repr=False)
    #: where ``bind``/``init`` place tensors when not told otherwise
    #: (None = the CUDA device); never serialized.
    device: torch.device | None = field(default=None, compare=False, repr=False)
    #: shape-keyed executables.  ``bind`` shares this dict across rebound
    #: copies, so serving a stream of same-shape graphs builds each
    #: executable once (see ``trace_count``).
    _exec_cache: dict = field(
        default_factory=dict, init=False, compare=False, repr=False
    )

    def __post_init__(self):
        if self.kind not in LAYER_FNS:
            raise ValueError(
                f"kind must be one of {tuple(sorted(LAYER_FNS))}, got "
                f"{self.kind!r}"
            )
        get_objective(self.objective)

    # -- views --------------------------------------------------------------
    @property
    def n_layers(self) -> int:
        return self.schedule.n_layers

    @property
    def dims(self) -> list[tuple[int, int]]:
        """(f_in, f_out) per layer, straight off the schedule."""
        return [(l.f_in, l.f_out) for l in self.schedule.layers]

    @property
    def specs(self):
        """The lowered per-layer :class:`ExecSpec` knobs."""
        return self.schedule.lower(use_pallas=self.use_pallas)

    # -- runtime binding ----------------------------------------------------
    def bind(
        self, graph: CSRGraph, pad_degree: int | None = None, device=None
    ) -> "Program":
        """Bind a concrete graph: builds the padded-ELL adjacency with the
        schedule's row grouping on ``device`` (default: the Program's
        device, else the CUDA device).  Returns a new Program (self is
        frozen).

        ``pad_degree`` fixes the padded-ELL width (the serving engine pads
        every micro-batch of a bucket to the same width).  The rebound
        Program shares this Program's executable cache: rebinding a
        same-shape graph builds nothing new.
        """
        dev = resolve_device(device if device is not None else self.device)
        bound = replace(
            self,
            adj=EllAdjacency.from_schedule(
                graph, self.schedule, pad_to=pad_degree, device=dev
            ),
            device=dev,
        )
        object.__setattr__(bound, "_exec_cache", self._exec_cache)
        return bound

    def degraded(self, use_pallas: bool = False) -> "Program":
        """A tier-twin of this Program with the kernel family switched
        (``use_pallas``: the hand-written kernel tier) but the schedule,
        hardware, stats and adjacency binding unchanged — the serving
        engine's degradation ladder steps from the kernel tier to the
        eager registry paths through this without re-running the mapper.
        Returns ``self`` when already on the requested tier; the twin gets
        its own executable cache.
        """
        if bool(use_pallas) == self.use_pallas:
            return self
        return replace(self, use_pallas=bool(use_pallas))

    def _require_adj(self) -> EllAdjacency:
        if self.adj is None:
            raise ValueError(
                "Program has no graph bound; compile with graph=... or call "
                "program.bind(graph) before run()/loss()"
            )
        return self.adj

    # -- execution ----------------------------------------------------------
    def init(self, generator: torch.Generator, device=None):
        """Initialize layer parameters matching the schedule's shapes,
        drawn from ``generator`` and placed on ``device`` (default: the
        Program's device, else the CUDA device)."""
        dev = resolve_device(device if device is not None else self.device)
        return [
            init_layer(self.kind, generator, fi, fo, device=dev)
            for fi, fo in self.dims
        ]

    def _build(self, n_nodes: int, mesh, readout, num_segments):
        """A forward for one shape key (counted by :func:`trace_count`).
        It resolves each layer's registry kernel now, once: a kernel hook
        pushed later (:func:`repro_torch.runtime.faults.kill_pallas`)
        reaches only executables built after it, as a backend outage
        reaches only the reference's executables traced after it."""
        _note_trace()
        kind, specs = self.kind, self.specs
        kernels = [
            lookup_kernel(s.policy, s.order, s.use_pallas) for s in specs
        ]

        def exe(params, indices, weights, x, segment_ids):
            adj = EllAdjacency(indices, weights, n_nodes)
            return forward_layers(
                kind, params, adj, x, specs, mesh=mesh,
                segment_ids=segment_ids if readout is not None else None,
                num_segments=num_segments,
                readout=readout or "mean",
                kernels=kernels,
            )

        return exe

    def run(
        self,
        params,
        x,
        mesh=None,
        *,
        segment_ids=None,
        num_segments: int | None = None,
        readout: str | None = None,
        donate: bool = False,
    ) -> torch.Tensor:
        """Forward pass under the compiled schedule.

        Returns per-node logits of shape (V, f_out of the last layer) — or,
        with ``segment_ids`` / ``num_segments`` (a batched graph from
        :mod:`repro_torch.graphs.batching`), the (num_segments, f_out)
        per-graph ``readout`` (sum | mean | max, default mean).  Any of the
        three batching kwargs without ``segment_ids`` is an error — there
        is no per-graph readout of an unbatched run.

        ``x`` and ``segment_ids`` may be numpy arrays (copied to the bound
        graph's device); a tensor, parameters included, must already be on
        that device.  Executables are cached per shape key: the
        second call on a same-shape input (including a same-shape
        :meth:`bind`) builds nothing (see :func:`trace_count`).  An
        executable whose first run raises is not kept (the reference keeps
        no executable for a failed trace): the next run builds it again.

        ``donate`` gives the feature tensor ``x`` to the run, as the
        reference donates the feature buffer: once the forward is
        dispatched its storage is released to the allocator (the next
        batch's staging can reuse the block), and ``x`` must not be used
        again.  It must be a tensor that owns its whole storage, else the
        run raises ``ValueError``; a numpy ``x`` is copied, so donating it
        releases only that copy.  ``donate`` is part of the executable's
        key, as in the reference.
        """
        adj = self._require_adj()
        dev = adj.indices.device
        if len(params) != self.n_layers:
            raise ValueError(
                f"program has {self.n_layers} layers but params have "
                f"{len(params)}"
            )
        batched = segment_ids is not None
        if batched and num_segments is None:
            raise ValueError("segment_ids needs num_segments")
        if not batched and (num_segments is not None or readout is not None):
            raise ValueError(
                "num_segments/readout need segment_ids (a batched graph)"
            )
        given = x
        x = on_device(x, dev, "x")
        if donate and isinstance(given, torch.Tensor):
            st = x.untyped_storage()
            if (
                not st.resizable() or x.storage_offset() != 0
                or st.nbytes() != x.numel() * x.element_size()
            ):
                raise ValueError(
                    "donate=True needs x to own its whole storage (not a "
                    "view, not memory shared with numpy)"
                )
        for i, layer in enumerate(params):
            for k, v in layer.items():
                on_device(v, dev, f"params[{i}][{k!r}]")
        if batched:
            segment_ids = on_device(segment_ids, dev, "segment_ids")
        readout = (readout or "mean") if batched else None
        key = (
            adj.n_nodes, None if mesh is None else tuple(mesh), bool(donate),
            readout, num_segments, tuple(adj.indices.shape), tuple(x.shape),
            x.dtype,
            tuple(
                (k, tuple(v.shape), v.dtype)
                for layer in params for k, v in sorted(layer.items())
            ),
        )
        exe = self._exec_cache.get(key)
        fresh = exe is None
        if fresh:
            exe = self._build(adj.n_nodes, mesh, readout, num_segments)
        out = exe(params, adj.indices, adj.weights, x, segment_ids)
        if fresh:  # kept only once it has run
            self._exec_cache[key] = exe
        if donate:
            x.untyped_storage().resize_(0)
        return out

    def prime(
        self,
        params,
        mesh=None,
        *,
        segment_ids=None,
        num_segments: int | None = None,
        readout: str | None = None,
        donate: bool = False,
    ) -> int:
        """Warm the executable cache for one input shape, off the request
        path: runs :meth:`run` on a zeros feature array of the bound
        graph's shape (same static knobs, ``donate`` included, so the
        executable is the exact one a later same-shape request will hit)
        and returns how many new executables it built — 0 when the shape
        was already warm.
        """
        adj = self._require_adj()
        x = torch.zeros(
            (adj.n_nodes, self.dims[0][0]), dtype=torch.float32,
            device=adj.indices.device,
        )
        before = _TRACE_COUNT
        self.run(
            params,
            x,
            mesh,
            segment_ids=segment_ids,
            num_segments=num_segments,
            readout=readout,
            donate=donate,
        )
        if adj.indices.device.type == "cuda":
            torch.cuda.synchronize(adj.indices.device)
        return _TRACE_COUNT - before

    def loss(self, params, x, labels, mask, mesh=None):
        """Masked softmax cross-entropy over :meth:`run`'s logits."""
        dev = self._require_adj().indices.device
        return masked_xent_loss(
            self.run(params, x, mesh=mesh),
            on_device(labels, dev, "labels"),
            on_device(mask, dev, "mask"),
        )

    def _train_executable(self, n_nodes: int, mesh, lr: float):
        """One SGD step for one ``("train", n_nodes, mesh, lr)`` key,
        counted by :func:`trace_count`; :meth:`train_step` keeps it in the
        forward executables' shared cache once it has run."""
        _note_trace()
        kind, specs = self.kind, self.specs
        kernels = [lookup_kernel(s.policy, s.order, s.use_pallas) for s in specs]

        def exe(params, indices, weights, x, labels, mask):
            adj = EllAdjacency(indices, weights, n_nodes)
            with torch.enable_grad():
                p = [
                    {k: v.detach().requires_grad_() for k, v in layer.items()}
                    for layer in params
                ]
                h = forward_layers(kind, p, adj, x, specs, mesh=mesh, kernels=kernels)
                loss = masked_xent_loss(h, labels, mask)
                leaves = [v for layer in p for v in layer.values()]
                grads = iter(torch.autograd.grad(loss, leaves))
            with torch.no_grad():
                new = [
                    {k: v - lr * next(grads) for k, v in layer.items()}
                    for layer in p
                ]
            return loss.detach(), new

        return exe

    def train_step(self, params, x, labels, mask, *, lr: float = 0.05, mesh=None):
        """One SGD step (loss, grad, parameter update) under the compiled
        schedule; returns ``(loss, new_params)``, detached tensors.

        The step lives in the Program's shared executable cache keyed by
        ``(shape, mesh, lr)``: later epochs — and same-shape rebinds —
        build nothing (:func:`trace_count` stays put); a step whose first
        run raises is not kept, as in :meth:`run`.  Gradients come from
        autograd through the eager tier's plain PyTorch ops on the bound
        device, as the reference differentiates its jnp ops.

        No hand-written kernel has a backward, as no Pallas kernel of the
        reference has one (its ``train_step`` fails to linearize a layer
        that reaches one).  So a ``use_pallas`` layer whose schedule has a
        kernel (seq, sp_opt/AC) raises ``ValueError`` here before anything
        is built or launched; train ``Program.degraded(use_pallas=False)``.
        The other ``use_pallas`` layers run the eager path and train, as
        in the reference.  A ``pp`` layer on a mesh of two CUDA devices or
        streams raises ``NotImplementedError``: the two-stream pipeline is
        not differentiated yet (ROADMAP Queue 1 item 6b, slice 10).
        """
        reached = sorted({
            f"{s.policy}/{s.order}" for s in self.specs
            if s.use_pallas and has_kernel(s.policy, s.order, True)
        })
        if reached:
            raise ValueError(
                f"train_step: the kernel tier's {', '.join(reached)} layers "
                "run hand-written kernels with no backward, as the "
                "reference's Pallas kernels have none; train "
                "program.degraded(use_pallas=False) instead"
            )
        adj = self._require_adj()
        dev = adj.indices.device
        if len(params) != self.n_layers:
            raise ValueError(
                f"program has {self.n_layers} layers but params have "
                f"{len(params)}"
            )
        if mesh is not None:
            mesh = tuple(mesh)
            if any(s.policy == "pp" for s in self.specs) and len(mesh) >= 2:
                from .gnn.pp import mesh_devices

                if any(d.type == "cuda" for d in mesh_devices(mesh)[:2]):
                    raise NotImplementedError(
                        "train_step: the two-stream Parallel Pipeline on a "
                        "CUDA mesh is not differentiated yet (ROADMAP Queue 1 "
                        "item 6b, slice 10); train with mesh=None"
                    )
        for i, layer in enumerate(params):
            for k, v in layer.items():
                on_device(v, dev, f"params[{i}][{k!r}]")
        key = ("train", adj.n_nodes, mesh, float(lr))
        exe = self._exec_cache.get(key)
        fresh = exe is None
        if fresh:
            exe = self._train_executable(adj.n_nodes, mesh, float(lr))
        out = exe(
            params, adj.indices, adj.weights, on_device(x, dev, "x"),
            on_device(labels, dev, "labels"), on_device(mask, dev, "mask"),
        )
        if fresh:  # kept only once it has run
            self._exec_cache[key] = exe
        return out

    @property
    def schedule_digest(self) -> str:
        """Stable identity of the compiled schedule content (see
        :meth:`ModelSchedule.digest`) — the key under which the serving
        engine attributes measured wall-clock observations."""
        return self.schedule.digest()

    # -- artifact -----------------------------------------------------------
    def to_json(self) -> str:
        """Canonical (sorted-keys, 2-space indent) JSON artifact; stable
        bytes across save/load/save."""
        payload = {
            "format": PROGRAM_FORMAT,
            "kind": self.kind,
            "objective": self.objective,
            "use_pallas": self.use_pallas,
            "fingerprint": self.fingerprint,
            "hw": asdict(self.hw),
            "schedule": json.loads(self.schedule.to_json(indent=None)),
            "stats": None if self.stats is None else _stats_to_dict(self.stats),
        }
        return json.dumps(payload, indent=2, sort_keys=True) + "\n"

    @classmethod
    def from_json(cls, text: str, device=None) -> "Program":
        """Parse an artifact; ``device`` is where a later ``bind``/``init``
        places tensors (None = the CUDA device)."""
        d = json.loads(text)
        if d.get("format") != PROGRAM_FORMAT:
            raise ValueError(
                f"not a {PROGRAM_FORMAT} artifact "
                f"(format={d.get('format')!r})"
            )
        stats = None if d["stats"] is None else _stats_from_dict(d["stats"])
        return cls(
            schedule=ModelSchedule.from_json(json.dumps(d["schedule"])),
            hw=AcceleratorConfig.from_dict(d["hw"]),
            kind=d["kind"],
            objective=d["objective"],
            use_pallas=d["use_pallas"],
            fingerprint=d["fingerprint"],
            stats=stats,
            device=device,
        )

    def save(self, path) -> Path:
        """Write the artifact atomically; returns the path.

        The JSON lands in a temp file in the same directory and is moved
        into place with ``os.replace``, so a crash (or injected failure)
        mid-write can never leave a truncated artifact at ``path`` — a
        reader sees either the previous complete artifact or the new one.
        """
        p = Path(path)
        tmp = p.with_name(p.name + f".tmp.{os.getpid()}")
        try:
            tmp.write_text(self.to_json())
            os.replace(tmp, p)
        finally:
            tmp.unlink(missing_ok=True)
        return p

    @classmethod
    def load(
        cls, path, graph: CSRGraph | None = None, device=None
    ) -> "Program":
        """Load a saved artifact; with ``graph``, also bind the adjacency
        on ``device`` (after checking the graph against the compiled
        fingerprint)."""
        prog = cls.from_json(Path(path).read_text(), device=device)
        if graph is not None:
            fp = prog.fingerprint
            if fp:
                crc = int(
                    zlib.crc32(np.ascontiguousarray(graph.nnz).tobytes())
                )
                if graph.n_nodes != fp["v"]:
                    raise ValueError(
                        f"graph does not match the program's compiled "
                        f"fingerprint: V={graph.n_nodes} vs compiled "
                        f"V={fp['v']}"
                    )
                if crc != fp["nnz_crc32"]:
                    raise ValueError(
                        f"graph does not match the program's compiled "
                        f"fingerprint: same V={fp['v']} but the degree "
                        f"vector differs (nnz crc32 {crc} vs "
                        f"{fp['nnz_crc32']})"
                    )
            prog = prog.bind(graph)
        return prog

    def __str__(self) -> str:
        head = (
            f"Program(kind={self.kind}, objective={self.objective}, "
            f"layers={self.n_layers}"
        )
        if self.stats is not None:
            head += (
                f", predicted {self.stats.cycles:.0f} cycles / "
                f"{self.stats.energy_pj / 1e6:.1f} uJ"
            )
        return head + ")\n" + str(self.schedule)


# ---------------------------------------------------------------------------
# compile()
# ---------------------------------------------------------------------------


def _resolve_workloads(
    target, graph: CSRGraph | None
) -> tuple[list[GNNLayerWorkload], GNNConfig | None]:
    """``target`` is either a GNNConfig (needs a graph for the degree
    vector) or an explicit per-layer workload sequence."""
    if isinstance(target, GNNConfig):
        if graph is None:
            raise ValueError(
                "compiling from a GNNConfig needs graph=... (the workload's "
                "degree vector comes from the graph)"
            )
        wls = [
            GNNLayerWorkload(graph.nnz, fi, fo, name=f"layer{i}")
            for i, (fi, fo) in enumerate(target.dims)
        ]
        return wls, target
    wls = list(target)
    if not wls:
        raise ValueError("need at least one layer workload")
    for wl in wls:
        if not isinstance(wl, GNNLayerWorkload):
            raise TypeError(
                f"compile() takes a GNNConfig or a sequence of "
                f"GNNLayerWorkload, got {type(wl).__name__}"
            )
    return wls, None


def _select_hw(
    objs: list[float], costs, hw_selection: str
) -> int:
    """Pick the winning grid point of a co-search.

    ``"objective"`` minimizes the objective outright (ties: cheapest
    hw-cost proxy); ``"objective_x_cost"`` minimizes objective x
    (n_pes x gb_bandwidth) — the provisioning-aware knee of the joint
    Pareto curve.
    """
    objs = np.asarray(objs, dtype=np.float64)
    costs = np.asarray(costs, dtype=np.float64)
    if not np.isfinite(objs).any():
        raise RuntimeError("no hardware grid point admits a legal mapping")
    if hw_selection == "objective":
        key = np.where(np.isfinite(objs), costs, np.inf)
        order = np.lexsort((key, objs))
    elif hw_selection == "objective_x_cost":
        prod = objs * costs
        order = np.lexsort((objs, prod))
    else:
        raise ValueError(
            f"hw_selection must be 'objective' or 'objective_x_cost', "
            f"got {hw_selection!r}"
        )
    return int(order[0])


def _reprice_schedule(schedule, hw, stats):
    """An explicit schedule handed to compile() may record the hw (and
    stats, down to the per-layer RunStats) it was originally searched on —
    or none at all; after re-pricing, every recorded quantity must agree
    with the chosen config."""
    if schedule.hw == hw and schedule.stats is stats:
        return schedule  # fresh from the search on this very hw
    return replace(
        schedule,
        hw=hw,
        stats=stats,
        layers=tuple(
            replace(l, stats=s)
            for l, s in zip(schedule.layers, stats.layers)
        ),
    )


def compile(
    target,
    graph: CSRGraph | None = None,
    hw: AcceleratorConfig | HWGrid = DEFAULT_ACCEL,
    *,
    objective: str = "cycles",
    schedule: ModelSchedule | None = None,
    kind: str | None = None,
    use_pallas: bool | None = None,
    names: tuple[str, ...] = TABLE5_NAMES,
    pe_splits: tuple[float, ...] = (0.25, 0.5, 0.75),
    top_k: int = 4,
    hw_selection: str = "objective",
    latency_model: LatencyModel | None = None,
    device=None,
) -> Program:
    """Search -> lower -> package: the one entry point over the mapper.

    ``target`` is either a :class:`~repro_torch.gnn.GNNConfig` (layer shapes from
    its ``dims``; degree vector from ``graph``) or an explicit sequence of
    :class:`~repro_torch.core.cost_model.GNNLayerWorkload`.  Unless a
    ``schedule`` is passed, the model-level mapper
    (:func:`~repro_torch.core.mapper.search_model`) picks one dataflow per layer
    by dynamic programming over inter-layer transition costs; an explicit
    ``schedule`` skips the search (it is validated against the workload
    shapes and priced with :func:`simulate_model` if it carries no stats).

    ``hw`` may be an :class:`~repro_torch.core.hw.HWGrid`: compile then runs the
    hardware x dataflow co-search (:func:`search_model_codesign` — the
    model-level DP re-prices transition costs at every grid point, sharing
    tile caches), picks the winner per ``hw_selection`` and freezes the
    chosen :class:`AcceleratorConfig` into the Program and its artifact;
    the full sweep stays inspectable on ``program.codesign``.  With an
    explicit ``schedule``, the grid re-prices that schedule at every point
    and picks the hardware the same way.

    Returns a frozen :class:`Program`; with ``graph`` given, the program is
    already bound and ``program.run(params, x)`` executes immediately.

    ``latency_model`` installs a fitted :class:`LatencyModel` (see
    :mod:`repro.core.calibrate`) into the pricing config before any search
    or re-pricing runs, so candidate ranking uses calibrated cycles.  When
    omitted, the ``REPRO_LATENCY_MODEL`` environment variable may point at
    a fitted artifact; otherwise the identity (paper-constant) model is
    used.

    ``device`` is where the Program binds graphs and places parameters:
    the CUDA device unless the caller asks for another (``"cpu"``); with
    no CUDA device and no explicit device, compile raises.
    """
    device = resolve_device(device)
    get_objective(objective)
    if latency_model is None:
        latency_model = LatencyModel.from_env()
    if latency_model is not None:
        if isinstance(hw, HWGrid):
            hw = replace(hw, base=replace(hw.base, latency=latency_model))
        else:
            hw = replace(hw, latency=latency_model)
    if hw_selection not in ("objective", "objective_x_cost"):
        # fail before any (expensive) search runs
        raise ValueError(
            f"hw_selection must be 'objective' or 'objective_x_cost', "
            f"got {hw_selection!r}"
        )
    workloads, cfg = _resolve_workloads(target, graph)
    if kind is None:
        kind = cfg.kind if cfg is not None else "gcn"
    if use_pallas is None:
        use_pallas = cfg.use_pallas if cfg is not None else False

    if schedule is not None:
        want = [(wl.f_in, wl.g_out) for wl in workloads]
        have = [(l.f_in, l.f_out) for l in schedule.layers]
        if want != have:
            raise ValueError(
                f"schedule layer shapes {have} do not match the workload "
                f"shapes {want}"
            )

    codesign_log = None
    if isinstance(hw, HWGrid):
        grid = hw
        if schedule is None:
            schedules = search_model_codesign(
                workloads,
                grid,
                objective=objective,
                names=names,
                pe_splits=pe_splits,
                top_k=top_k,
            )
            objs = [
                float("inf") if s is None else s.stats.objective(objective)
                for s in schedules
            ]
            i = _select_hw(objs, grid.hw_cost(), hw_selection)
            schedule = schedules[i]
            stats = schedule.stats
        else:
            stats_per = []
            for cfg_i in grid.configs():
                try:
                    stats_per.append(
                        simulate_model(schedule.dataflows, workloads, cfg_i)
                    )
                except ValueError:  # e.g. PE budget violated at this point
                    stats_per.append(None)
            objs = [
                float("inf") if s is None else s.objective(objective)
                for s in stats_per
            ]
            i = _select_hw(objs, grid.hw_cost(), hw_selection)
            stats = stats_per[i]
        codesign_log = list(zip(grid.configs(), objs))
        hw = grid.configs()[i]
        schedule = _reprice_schedule(schedule, hw, stats)
    elif schedule is None:
        schedule = search_model(
            workloads,
            hw,
            objective=objective,
            names=names,
            pe_splits=pe_splits,
            top_k=top_k,
        )
        stats = schedule.stats  # priced by the search on this hw
    else:
        # an explicit schedule may carry stats (and a recorded hw) from a
        # *different* config; always re-price on the given one so the
        # artifact's hw, schedule.hw and predicted stats agree.
        stats = simulate_model(schedule.dataflows, workloads, hw)
        schedule = _reprice_schedule(schedule, hw, stats)

    prog = Program(
        schedule=schedule,
        hw=hw,
        kind=kind,
        objective=objective,
        use_pallas=use_pallas,
        fingerprint=workload_fingerprint(workloads),
        stats=stats,
        codesign=codesign_log,
        device=device,
    )
    return prog.bind(graph) if graph is not None else prog
