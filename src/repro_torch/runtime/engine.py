"""Serving runtime: a request stream -> bucketized batches -> compiled Programs.

The port of :mod:`repro.runtime.engine`.  The engine runs on the CUDA
device unless ``device=`` names another (the CPU tests pass ``"cpu"``);
with no CUDA device and no explicit device it raises, and nothing in it
moves to the CPU by itself.  Features are staged through pinned host
memory with a ``non_blocking`` copy, and each micro-batch's outputs come
back with one ``.cpu()``.  The kernel tier (``use_pallas=True``, the
reference's key) runs the hand-written CUDA kernels.

The executable stack below this module is single-graph:
``repro_torch.compile`` searches + lowers one
:class:`~repro_torch.api.Program` per graph, and every distinct input shape
costs a fresh executable build.  Real GNN serving traffic
is the opposite shape — many small graphs, few distinct sizes (the paper
batches 64/32 graphs per inference, Sec. 5.1.2).  The
:class:`InferenceEngine` turns the stream into batched device work:

1. **Admit**: every request is validated at the boundary
   (:func:`repro_torch.runtime.resilience.validate_request` — CSR invariants,
   float32 features) and checked against the policy's oversized-graph caps
   and the ``max_inflight_graphs`` load-shedding limit.  A request that
   fails admission returns a typed ``rejected`` :class:`Result`; it never
   joins a batch, so it cannot poison healthy neighbors.
2. **Route**: every admitted request's graph maps to a pow2 padding bucket
   (:class:`repro_torch.graphs.batching.BucketPolicy`).
3. **Assemble**: up to ``max_graphs`` same-bucket graphs become one
   block-diagonal micro-batch with per-graph segment ids
   (:func:`repro_torch.graphs.batching.assemble`), padded so every batch of a
   bucket presents identical device shapes.  Per-request deadlines are
   enforced here: an expired request fails with ``DeadlineExceeded``
   instead of occupying a slot.
4. **Compile-or-load**: one Program per (workload fingerprint, bucket,
   tier, hw) key through an LRU cache — the mapper search and the
   executable build are paid once per bucket, not once per request.  With a
   persistent :class:`~repro_torch.runtime.store.ProgramStore` attached they
   are paid once per bucket *ever*: fresh compiles persist to disk,
   restarts load instead of searching, and
   :meth:`InferenceEngine.precompile` replays the recorded
   :class:`~repro_torch.graphs.batching.TrafficProfile` at startup so even
   the executable builds happen off the request path (zero-cold-start
   serving).
5. **Execute with fault isolation**: each micro-batch walks the
   degradation ladder (:func:`repro_torch.runtime.resilience.default_ladder`
   — searched+kernels -> searched+eager -> default schedule) with bounded
   retries per tier; non-finite outputs raise instead of returning
   silently.  A multi-graph batch that faults at every tier is re-run
   request by request (**solo-retry quarantine**), so one poisoned request
   fails alone with a typed status while its neighbors still return
   bit-identical outputs.  ``submit()`` never raises for a per-request
   cause.  A CUDA kernel that fails to build, load or launch is not one:
   the ladder re-raises it rather than serve the eager tier in its place.

The engine reports graphs/sec, p50/p99 request latency and the full
resilience ledger — per-status counts, retries, downgrades, straggler
batches, and an error-taxonomy histogram (:meth:`InferenceEngine.stats`);
``chip_smoke.py``'s ``engine`` phase drives it on the card.
"""
from __future__ import annotations

import json
import time
from collections import OrderedDict
from dataclasses import asdict, dataclass, field, replace as dc_replace
from typing import Sequence

import numpy as np
import torch

from ..api import Program, compile as _compile, trace_count
from ..core.cost_model import GNNLayerWorkload
from ..core.hw import AcceleratorConfig, DEFAULT_ACCEL, DEFAULT_LATENCY, LatencyModel
from ..core.schedule import ModelSchedule
from ..device import resolve_device
from ..gnn.layers import init_layer, segment_readout
from ..kernels.common import CudaKernelError, measure_wall
from ..graphs.batching import (
    BucketPolicy,
    GraphBatch,
    TrafficProfile,
    assemble,
    bucketize,
    next_pow2,
)
from ..graphs.csr import CSRGraph, block_diagonal, from_edges
from .fault_tolerance import StragglerMonitor
from .faults import FaultInjector
from .store import ProgramStore, store_key
from .resilience import (
    STATUS_DEGRADED,
    STATUS_FAILED,
    STATUS_OK,
    STATUS_REJECTED,
    DeadlineExceeded,
    EngineOverloaded,
    NumericalFault,
    OversizedGraph,
    RetryPolicy,
    ServingError,
    Tier,
    as_serving_error,
    backlog_retry_after,
    default_ladder,
    validate_request,
)


@dataclass(frozen=True)
class Request:
    """One inference request: a graph and its node features.

    ``deadline_s`` is an optional per-request latency budget, measured
    from ``submit()`` entry; a request whose deadline has already expired
    when its micro-batch assembles fails with ``DeadlineExceeded`` instead
    of occupying batch slots.
    """

    graph: CSRGraph
    x: np.ndarray  # (n_nodes, f_in) float32
    rid: int = 0
    deadline_s: float | None = None


@dataclass(frozen=True)
class Result:
    """Per-request output plus serving metadata.

    ``status`` is the per-request verdict (see
    :mod:`repro_torch.runtime.resilience`): ``ok`` / ``degraded`` carry an
    ``output`` (the ``readout`` vector ``(f_out,)`` — or the
    ``(n_nodes, f_out)`` node logits when the engine runs with
    ``readout=None``); ``rejected`` / ``failed`` carry ``None`` plus the
    typed cause in ``error_type`` (taxonomy code) and ``error`` (message).
    """

    rid: int
    output: np.ndarray | None
    bucket: tuple[int, int] | None
    latency_s: float  # this request's enqueue -> result wall time
    status: str = STATUS_OK
    error: str | None = None
    error_type: str | None = None
    tier: str | None = None  # execution tier that produced the output
    n_retries: int = 0
    retry_after_s: float | None = None  # backpressure hint on shed load
    #: which device served this request (the engine's ``device_label``;
    #: the async front-end sets one per worker).  ``None`` = default.
    device: str | None = None
    #: partitioned-lane telemetry: how many partitions served this
    #: request (0 = the normal batched path), the partitioned wall
    #: clock, and the planner's chosen plan kind
    #: (``row_stream`` / ``feature_chunk`` / ``pp_shard``).
    n_partitions: int = 0
    partition_wall_s: float = 0.0
    plan: str | None = None

    @property
    def ok(self) -> bool:
        """True when ``output`` is a served answer (ok or degraded)."""
        return self.status in (STATUS_OK, STATUS_DEGRADED)


@dataclass
class EngineStats:
    """Aggregate serving report: throughput, latency percentiles, and the
    resilience ledger (statuses, retries, downgrades, stragglers).

    ``p50_ms`` / ``p99_ms`` are **per-request** enqueue -> result wall
    times (a request that waits behind earlier micro-batches of the same
    ``submit`` call — or in the async front-end's arrival queue — is
    charged that wait), not per-micro-batch wall; ``batch_p50_ms`` is the
    per-micro-batch median for comparison."""

    n_requests: int
    n_batches: int
    n_buckets: int
    wall_s: float
    graphs_per_sec: float
    p50_ms: float
    p99_ms: float
    #: ``search_s + trace_s`` — kept as the historical aggregate so older
    #: dashboards/benchmark JSON keep a comparable column.
    compile_s: float
    search_s: float  # mapper search + Program packaging (cold buckets)
    trace_s: float  # wall of executions that built new executables
    cache_hits: int
    cache_misses: int
    cache_evictions: int
    n_searches: int = 0  # mapper searches actually run (store hits skip them)
    store_hits: int = 0  # programs loaded from the persistent store
    store_misses: int = 0
    store_corrupt: int = 0  # artifacts that existed but failed to load
    n_ok: int = 0
    n_rejected: int = 0
    n_failed: int = 0
    n_degraded: int = 0
    n_retries: int = 0  # execution attempts repeated after a fault
    n_downgrades: int = 0  # micro-batches that left their preferred tier
    n_solo_retries: int = 0  # quarantine re-runs of single requests
    n_stragglers: int = 0  # micro-batches flagged by the StragglerMonitor
    errors: dict = field(default_factory=dict)  # taxonomy code -> count
    batch_p50_ms: float = 0.0  # median micro-batch wall (drain-rate probe)
    n_partitioned: int = 0  # oversized requests served via a partition plan
    partition_wall_s: float = 0.0  # wall spent inside the partitioned lane
    partition_plans: dict = field(default_factory=dict)  # plan kind -> count

    def as_dict(self) -> dict:
        return asdict(self)


@dataclass
class PrecompileReport:
    """What :meth:`InferenceEngine.precompile` did at startup: how many
    bucket shapes it warmed, how many Programs came from the persistent
    store vs fresh compiles (and how many of those ran the mapper), how
    many executable builds it took off the request path, and the wall
    clock."""

    n_shapes: int = 0
    n_store_hits: int = 0
    n_compiled: int = 0  # store misses compiled in-process
    n_searches: int = 0  # mapper searches among the compiles
    n_traces: int = 0  # executables built while warming
    wall_s: float = 0.0

    def as_dict(self) -> dict:
        return asdict(self)


@dataclass
class RerankReport:
    """What :meth:`InferenceEngine.rerank_topk` did: how many hot buckets
    it re-ranked, how many candidate schedules it measured, which buckets
    swapped to a measured-faster schedule (``swaps`` maps ``"VxD"`` to the
    incumbent/winner digests and walls), and how many executable builds the whole
    pass took — all off the request path."""

    n_buckets: int = 0
    n_candidates: int = 0  # candidate schedules compiled and measured
    n_swapped: int = 0  # buckets whose pinned schedule changed
    n_traces: int = 0  # executables built while measuring + re-priming
    wall_s: float = 0.0
    swaps: dict = field(default_factory=dict)  # "VxD" -> swap detail

    def as_dict(self) -> dict:
        return asdict(self)


class ProgramCache:
    """LRU over compiled Programs, keyed by (fingerprint, bucket, hw)."""

    def __init__(self, capacity: int = 32):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._programs: OrderedDict[tuple, Program] = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._programs)

    def get(self, key: tuple) -> Program | None:
        prog = self._programs.get(key)
        if prog is None:
            self.misses += 1
            return None
        self._programs.move_to_end(key)
        self.hits += 1
        return prog

    def peek(self, key: tuple) -> Program | None:
        """Non-counting lookup (used to derive tier twins)."""
        return self._programs.get(key)

    def put(self, key: tuple, prog: Program) -> None:
        self._programs[key] = prog
        self._programs.move_to_end(key)
        while len(self._programs) > self.capacity:
            self._programs.popitem(last=False)
            self.evictions += 1


def _chunks(seq: list, size: int):
    for i in range(0, len(seq), size):
        yield seq[i : i + size]


class InferenceEngine:
    """Bucketized multi-graph serving over an LRU of compiled Programs.

    One engine serves one model (``dims`` layer shapes + ``params``) under
    one objective on one accelerator config.  ``schedule`` pins an
    explicit :class:`~repro_torch.core.schedule.ModelSchedule` for every bucket;
    by default each bucket's first micro-batch runs the model-level mapper
    search once and the LRU amortizes it over the stream.

    ``readout`` is the per-graph reduction (``"mean"``/``"sum"``/``"max"``)
    — or ``None`` to return per-graph node logits instead.

    Resilience knobs:

    * ``retry`` — bounded backoff per ladder tier
      (:class:`~repro_torch.runtime.resilience.RetryPolicy`);
    * ``ladder`` — explicit degradation tiers (default:
      :func:`~repro_torch.runtime.resilience.default_ladder` of
      ``use_pallas``);
    * ``max_inflight_graphs`` — admission-control cap per ``submit`` call;
      excess requests are shed with ``rejected`` + ``retry_after_s``;
    * ``fault_injector`` — a
      :class:`~repro_torch.runtime.faults.FaultInjector` consulted at the
      compile and run boundaries (chaos testing);
    * ``check_numerics`` — treat non-finite outputs as faults (retried,
      then ``failed``) instead of returning them silently;
    * ``monitor`` — per-micro-batch latency
      :class:`~repro_torch.runtime.fault_tolerance.StragglerMonitor`;
    * ``store`` — a persistent
      :class:`~repro_torch.runtime.store.ProgramStore` backing the LRU:
      compiled Programs and the traffic profile survive the process, and
      :meth:`precompile` warms the recorded bucket grid at startup;
    * ``donate`` — hand each staged feature tensor to its forward (see
      :meth:`Program.run <repro_torch.api.Program.run>`): its device
      memory goes back to the allocator as soon as the forward is
      dispatched, for the next batch's staging;
    * ``device`` — where params, staged features and every executable
      live (None: the CUDA device; raises when there is none).
    """

    def __init__(
        self,
        dims: Sequence[tuple[int, int]],
        params=None,
        *,
        kind: str = "gcn",
        objective: str = "cycles",
        hw: AcceleratorConfig = DEFAULT_ACCEL,
        policy: BucketPolicy = BucketPolicy(),
        schedule: ModelSchedule | None = None,
        cache_capacity: int = 32,
        use_pallas: bool = False,
        readout: str | None = "mean",
        retry: RetryPolicy = RetryPolicy(max_retries=2, backoff_s=0.0),
        ladder: Sequence[Tier] | None = None,
        max_inflight_graphs: int | None = None,
        fault_injector: FaultInjector | None = None,
        check_numerics: bool = True,
        monitor: StragglerMonitor | None = None,
        store: ProgramStore | None = None,
        donate: bool = True,
        device_label: str | None = None,
        partition_oversized: bool = False,
        max_partitions: int = 256,
        device=None,
    ):
        self.device = resolve_device(device)
        self.dims = [(int(fi), int(fo)) for fi, fo in dims]
        if not self.dims:
            raise ValueError("engine needs at least one layer shape")
        self.params = params
        self.kind = kind
        self.objective = objective
        self.hw = hw
        self.policy = policy
        self.schedule = schedule
        self.use_pallas = use_pallas
        self.readout = readout
        self.retry = retry
        self.ladder = (
            tuple(ladder) if ladder is not None else default_ladder(use_pallas)
        )
        if not self.ladder:
            raise ValueError("the degradation ladder needs at least one tier")
        self.max_inflight_graphs = max_inflight_graphs
        self.injector = fault_injector
        self.check_numerics = check_numerics
        #: donate staged feature tensors to the executables (the engine
        #: stages them itself, anew for every attempt, so nothing else
        #: holds them).  The flag is part of the executable cache key, so
        #: an engine must pick one mode and keep it (precompile honors it).
        self.donate = donate
        #: stamped on every Result this engine produces (an async
        #: front-end labels each per-device engine with its device).
        self.device_label = device_label
        #: serve oversized admissions through a planner-chosen partition
        #: (:func:`repro_torch.graphs.partition.plan_partition`) instead of a
        #: typed rejection.  Off by default: the rejection contract
        #: stays intact unless a deployment opts in.
        self.partition_oversized = partition_oversized
        self.max_partitions = max_partitions
        self.monitor = monitor if monitor is not None else StragglerMonitor()
        self.cache = ProgramCache(cache_capacity)
        #: optional persistent backing for the program cache: a miss here
        #: consults the store before compiling, and every fresh compile is
        #: persisted, so a restarted engine loads instead of searching.
        self.store = store
        #: recorded bucket traffic.  Seeded from the store's persisted
        #: profile (bucket heat survives the process) and re-persisted
        #: after every ``submit``; ``precompile()`` replays it at startup.
        self.profile: TrafficProfile = TrafficProfile()
        if store is not None:
            prior = store.load_profile()
            if prior is not None:
                self.profile = prior
        # a fitted latency model calibrates every schedule this engine
        # searches.  When the caller left ``hw.latency`` at the identity
        # default, resolve one: the ``REPRO_LATENCY_MODEL`` env override
        # first, then the store's fitted model for this engine's device
        # (written by ``repro_torch.core.calibrate.calibrate``).  An
        # explicit non-default ``hw.latency`` always wins.
        if self.hw.latency == DEFAULT_LATENCY:
            lm = LatencyModel.from_env()
            if lm is None and store is not None:
                from ..core.calibrate import backend_fingerprint

                lm = store.load_latency_model(backend_fingerprint(self.device))
            if lm is not None:
                self.hw = dc_replace(self.hw, latency=lm)
        #: searched schedules keyed by (v_bucket, d_bucket): the mapper
        #: runs once per bucket; slot-count variants of the bucket (partial
        #: tail batches) reuse the schedule and only pay their executable
        #: build.
        self._schedules: dict[tuple[int, int], ModelSchedule] = {}
        # accumulators behind stats()
        self._latencies: list[float] = []  # per-request enqueue -> result
        self._batch_walls: list[float] = []  # per-micro-batch wall times
        self._buckets_seen: set[tuple[int, int]] = set()
        self._n_requests = 0
        self._n_batches = 0
        self._wall_s = 0.0
        self._search_s = 0.0  # mapper search + Program packaging
        self._trace_s = 0.0  # wall of executions that built executables
        self._n_searches = 0  # mapper searches actually run
        self._status_counts = {s: 0 for s in
                               (STATUS_OK, STATUS_REJECTED, STATUS_FAILED,
                                STATUS_DEGRADED)}
        self._errors: dict[str, int] = {}
        self._n_retries = 0
        self._n_downgrades = 0
        self._n_solo_retries = 0
        #: per-bucket micro-batch sequence numbers (fault-injection plans
        #: target (bucket, batch_index); solo-retry batches get their own)
        self._batch_seq: dict[tuple[int, int], int] = {}
        #: partition plans keyed by the graph's nominal bucket — planning
        #: (a few mapper searches) is paid once per oversized shape class
        self._plans: dict[tuple[int, int], "PartitionPlan"] = {}
        self._n_partitioned = 0
        self._partition_wall_s = 0.0
        self._partition_plans: dict[str, int] = {}

    @property
    def f_in(self) -> int:
        return self.dims[0][0]

    def init(self, generator: torch.Generator):
        """Initialize (and adopt) model parameters for the served dims,
        drawn from ``generator`` and placed on the engine's device."""
        self.params = [
            init_layer(self.kind, generator, fi, fo, device=self.device)
            for fi, fo in self.dims
        ]
        return self.params

    def _stage(self, x: np.ndarray) -> torch.Tensor:
        """A host feature block as a tensor of the engine's own on its
        device: through pinned memory and a ``non_blocking`` copy on the
        card, a copy on the CPU (never memory shared with numpy)."""
        host = torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32))
        if self.device.type == "cuda":
            return host.pin_memory().to(self.device, non_blocking=True)
        return host.clone().to(self.device)

    def _segment_ids(self, batch: GraphBatch) -> torch.Tensor:
        return torch.as_tensor(batch.segment_ids, device=self.device)

    # -- program cache -------------------------------------------------------
    def _shape_key(
        self, v_bucket: int, v_total: int, d_bucket: int, tier: Tier
    ) -> tuple:
        return (
            tuple(self.dims),
            self.kind,
            self.objective,
            (tier.use_pallas, tier.searched),
            # v_bucket AND v_total: buckets whose v_bucket * slots products
            # coincide (e.g. 32x2 and 64x1) must not share a Program
            (v_bucket, v_total, d_bucket),
            # canonical JSON string: asdict(hw) nests the latency-model
            # mapping, which is not hashable as a tuple of items
            json.dumps(asdict(self.hw), sort_keys=True),
        )

    def _cache_key(self, batch: GraphBatch, tier: Tier) -> tuple:
        return self._shape_key(
            batch.v_bucket, batch.v_total, batch.d_bucket, tier
        )

    def _store_key(self, batch: GraphBatch, tier: Tier) -> dict:
        """The persistent twin of :meth:`_cache_key` (see
        :func:`repro_torch.runtime.store.store_key`)."""
        return store_key(
            self.dims,
            (batch.v_bucket, batch.d_bucket),
            batch.v_total,
            kind=self.kind,
            objective=self.objective,
            use_pallas=tier.use_pallas,
            searched=tier.searched,
            hw=self.hw,
        )

    def _default_schedule(self) -> ModelSchedule:
        """The ladder's last rung: a fixed sp_opt/AC schedule that needs
        no mapper search and no kernel build."""
        return ModelSchedule.from_policies("sp_opt", "AC", self.dims)

    def _program_for(self, batch: GraphBatch, tier: Tier) -> Program:
        """Compile — or load — the bucket's Program for one ladder tier.

        Resolution order on a memory-cache miss: the persistent
        :class:`~repro_torch.runtime.store.ProgramStore` (a restarted engine
        loads the searched schedule instead of re-running the mapper; a
        corrupt artifact is a counted miss, never a crash), then the
        cached kernel-tier twin via :meth:`Program.degraded`, then a fresh
        compile — which is persisted back to the store atomically.  The
        mapper searches on the bucket's first micro-batch; later batches
        of the bucket reuse the schedule *and* the built executables
        (the Program's exec cache is shared across ``bind``).  Programs
        come back placed on the engine's device.
        """
        key = self._cache_key(batch, tier)
        prog = self.cache.get(key)
        if prog is None:
            if self.injector is not None:
                self.injector.on_compile((batch.v_bucket, batch.d_bucket))
            bucket = (batch.v_bucket, batch.d_bucket)
            skey = None
            if self.store is not None:
                skey = self._store_key(batch, tier)
                prog = self.store.get(skey)
                if prog is not None:
                    prog = dc_replace(prog, device=self.device)
            if prog is None:
                t0 = time.perf_counter()
                twin = None
                if tier.searched and not tier.use_pallas:
                    pallas_tier = Tier("pallas+searched", True, True)
                    twin = self.cache.peek(
                        self._cache_key(batch, pallas_tier)
                    )
                if twin is not None:
                    prog = twin.degraded(use_pallas=False)
                else:
                    wls = [
                        GNNLayerWorkload(
                            batch.graph.nnz, fi, fo, name=f"layer{i}"
                        )
                        for i, (fi, fo) in enumerate(self.dims)
                    ]
                    if tier.searched:
                        sched = self.schedule or self._schedules.get(bucket)
                    else:
                        sched = self._default_schedule()
                    if tier.searched and sched is None:
                        self._n_searches += 1
                    prog = _compile(
                        wls,
                        hw=self.hw,
                        objective=self.objective,
                        schedule=sched,
                        kind=self.kind,
                        use_pallas=tier.use_pallas,
                        device=self.device,
                    )
                self._search_s += time.perf_counter() - t0
                if skey is not None:
                    self.store.put(skey, prog)
            if tier.searched:
                self._schedules.setdefault(bucket, prog.schedule)
            self.cache.put(key, prog)
        return prog

    # -- ahead-of-time warmup ------------------------------------------------
    def _synthetic_batch(
        self, v_bucket: int, d_bucket: int, slots: int
    ) -> GraphBatch:
        """A stand-in micro-batch with the bucket's exact device shapes:
        ``slots`` member graphs of ``v_bucket`` nodes each (rings, or
        isolated self-loops when the degree bucket is too narrow for a
        ring), so binding at ``pad_degree=d_bucket`` and reading out over
        ``slots`` segments warms precisely the executable a real batch of
        this shape will request.  Only shapes matter here — the adjacency
        values never reach a served answer."""
        if d_bucket >= 3 and v_bucket >= 3:
            src = np.arange(v_bucket)
            dst = (src + 1) % v_bucket
            member = from_edges(
                v_bucket, np.concatenate([src, dst]), np.concatenate([dst, src])
            )
        else:
            member = from_edges(
                v_bucket, np.zeros(0, np.int64), np.zeros(0, np.int64)
            )
        batched = block_diagonal([member] * slots)
        segment_ids = np.repeat(
            np.arange(slots, dtype=np.int32), v_bucket
        )
        return GraphBatch(
            graph=batched,
            segment_ids=segment_ids,
            sizes=np.full(slots, v_bucket, dtype=np.int64),
            v_bucket=v_bucket,
            d_bucket=d_bucket,
        )

    def precompile(
        self,
        profile: TrafficProfile | None = None,
        *,
        max_shapes: int | None = None,
    ) -> PrecompileReport:
        """Warm the expected bucket grid ahead of traffic, hottest first.

        For every ``((v_bucket, d_bucket), slots)`` shape the
        :class:`~repro_torch.graphs.batching.TrafficProfile` recorded
        (argument, else the store's persisted profile, else this engine's
        own), the preferred ladder tier's Program is compiled-or-loaded
        through the store-backed cache and its executable built on a
        synthetic batch via :meth:`Program.prime
        <repro_torch.api.Program.prime>` — so a revived engine pays mapper
        search *zero* times (store hits) and takes every executable build
        here, off the request path: the first real request of a warm shape
        builds nothing (``repro_torch.trace_count()`` delta of 0) and runs
        at warm-path latency.  ``max_shapes`` bounds
        startup work to the hottest shapes.
        """
        if self.params is None:
            raise ValueError(
                "engine has no params; pass params= or call engine.init(generator)"
            )
        if profile is None and self.store is not None:
            profile = self.store.load_profile()
        if profile is None:
            profile = self.profile
        rep = PrecompileReport()
        t0 = time.perf_counter()
        shapes = profile.hot_shapes()
        if max_shapes is not None:
            shapes = shapes[:max_shapes]
        tier = self.ladder[0]
        hits0 = self.store.hits if self.store is not None else 0
        searches0 = self._n_searches
        misses0 = self.cache.misses
        for (v_bucket, d_bucket), slots in shapes:
            batch = self._synthetic_batch(v_bucket, d_bucket, slots)
            self._buckets_seen.add((v_bucket, d_bucket))
            prog = self._program_for(batch, tier)
            bound = prog.bind(batch.graph, pad_degree=batch.d_bucket)
            t_run = time.perf_counter()
            # prime with this engine's donate flag: the executable cache
            # keys on it, so a donate=False engine must warm donate=False
            # executables or the first real request would build one
            n_new = self._prime(bound, batch, self.donate)
            if n_new:
                self._trace_s += time.perf_counter() - t_run
            rep.n_shapes += 1
            rep.n_traces += n_new
        rep.n_store_hits = (
            (self.store.hits - hits0) if self.store is not None else 0
        )
        rep.n_searches = self._n_searches - searches0
        # shapes already warm in the memory cache cost neither a store
        # load nor a compile, so count compiles off the cache-miss delta
        rep.n_compiled = (self.cache.misses - misses0) - rep.n_store_hits
        rep.wall_s = time.perf_counter() - t0
        return rep

    def _prime(self, bound: Program, batch: GraphBatch, donate: bool) -> int:
        """Build the executable a real batch of this shape will use."""
        if self.readout is None:
            return bound.prime(self.params, donate=donate)
        return bound.prime(
            self.params,
            segment_ids=self._segment_ids(batch),
            num_segments=batch.slots,
            readout=self.readout,
            donate=donate,
        )

    # -- measured re-ranking -------------------------------------------------
    def rerank_topk(
        self,
        *,
        top_k: int = 4,
        max_shapes: int | None = None,
        min_improvement: float = 0.03,
        warmup: int = 1,
        iters: int = 5,
    ) -> RerankReport:
        """Re-rank every hot bucket's schedule by *measured* wall time.

        The mapper search behind each bucket minimizes the analytic cost
        model; a calibrated :class:`~repro_torch.core.hw.LatencyModel` narrows
        the model<->hardware gap but cannot close it per schedule.  This
        pass closes the loop with actual measurements, entirely off the
        request path:

        1. for each hot bucket (hottest first, bounded by ``max_shapes``),
           take the mapper's analytic top-k
           (:func:`~repro_torch.core.mapper.search_model_topk`) plus the
           incumbent schedule;
        2. compile each candidate with a *pinned* schedule (no search)
           and measure it on a synthetic batch of the bucket's hottest
           slot count via :func:`~repro_torch.kernels.common.measure_wall`
           (``donate=False`` so the measurement buffer survives repeat
           runs; on the card each timed call ends in a synchronize);
           every measurement lands in the profile's observation ledger
           (:meth:`TrafficProfile.record_wall
           <repro_torch.graphs.batching.TrafficProfile.record_wall>`);
        3. when the best candidate beats the incumbent by more than
           ``min_improvement`` (hysteresis against timer noise), hot-swap
           the bucket: pin the winner in the per-bucket schedule map,
           overwrite the memory-cache entry *and* the store artifact for
           every recorded slot variant, and re-prime the serving
           executables with this engine's own ``donate`` mode — so the
           next real request of the bucket builds nothing
           (``repro_torch.trace_count()`` delta of 0 on the request path).
        """
        if self.params is None:
            raise ValueError(
                "engine has no params; pass params= or call engine.init(generator)"
            )
        from ..core.mapper import search_model_topk

        rep = RerankReport()
        t0 = time.perf_counter()
        traces0 = trace_count()
        tier = self.ladder[0]
        shapes = self.profile.hot_shapes()
        if max_shapes is not None:
            shapes = shapes[:max_shapes]
        # the hottest slot variant of each bucket carries the measurement
        # (hot_shapes is hottest-first); the other variants only get
        # re-primed when the bucket swaps
        hot_slots: dict[tuple[int, int], int] = {}
        variants: dict[tuple[int, int], list[int]] = {}
        for bucket, slots in shapes:
            hot_slots.setdefault(bucket, slots)
            variants.setdefault(bucket, []).append(slots)

        for bucket, slots in hot_slots.items():
            rep.n_buckets += 1
            v_bucket, d_bucket = bucket
            batch = self._synthetic_batch(v_bucket, d_bucket, slots)
            incumbent = self._program_for(batch, tier)
            wls = [
                GNNLayerWorkload(batch.graph.nnz, fi, fo, name=f"layer{i}")
                for i, (fi, fo) in enumerate(self.dims)
            ]
            x = torch.zeros(
                (batch.graph.n_nodes, self.f_in), dtype=torch.float32,
                device=self.device,
            )
            seg = self._segment_ids(batch)

            def measure(prog: Program) -> float:
                bound = prog.bind(batch.graph, pad_degree=batch.d_bucket)

                def run():
                    if self.readout is None:
                        return bound.run(self.params, x, donate=False)
                    return bound.run(
                        self.params,
                        x,
                        segment_ids=seg,
                        num_segments=batch.slots,
                        readout=self.readout,
                        donate=False,
                    )

                wall = measure_wall(run, warmup=warmup, iters=iters)
                self.profile.record_wall(
                    bucket, batch.slots, prog.schedule_digest, wall
                )
                return wall

            walls: dict[str, tuple[float, Program]] = {
                incumbent.schedule_digest: (measure(incumbent), incumbent)
            }
            for cand in search_model_topk(
                wls, hw=self.hw, objective=self.objective, top_k=top_k
            ):
                dig = cand.digest()
                if dig in walls:
                    continue
                prog = _compile(
                    wls,
                    hw=self.hw,
                    objective=self.objective,
                    schedule=cand,
                    kind=self.kind,
                    use_pallas=tier.use_pallas,
                    device=self.device,
                )
                rep.n_candidates += 1
                walls[dig] = (measure(prog), prog)
            best_dig, (best_wall, best_prog) = min(
                walls.items(), key=lambda kv: kv[1][0]
            )
            inc_wall = walls[incumbent.schedule_digest][0]
            if (
                best_dig == incumbent.schedule_digest
                or best_wall >= inc_wall * (1.0 - min_improvement)
            ):
                continue
            rep.n_swapped += 1
            self._schedules[bucket] = best_prog.schedule
            rep.swaps[f"{v_bucket}x{d_bucket}"] = {
                "from": incumbent.schedule_digest,
                "to": best_dig,
                "incumbent_wall_s": inc_wall,
                "winner_wall_s": best_wall,
                "improvement": 1.0 - best_wall / inc_wall,
            }
            for sv in variants[bucket]:
                vb = self._synthetic_batch(v_bucket, d_bucket, sv)
                self.cache.put(self._cache_key(vb, tier), best_prog)
                if self.store is not None:
                    self.store.put(self._store_key(vb, tier), best_prog)
                bound = best_prog.bind(vb.graph, pad_degree=vb.d_bucket)
                self._prime(bound, vb, self.donate)
        if self.store is not None:
            self.store.save_profile(self.profile)
        rep.n_traces = trace_count() - traces0
        rep.wall_s = time.perf_counter() - t0
        return rep

    # -- admission -----------------------------------------------------------
    def median_batch_wall(self) -> float:
        """Recent median micro-batch wall time (the engine's drain rate);
        a conservative 50 ms before the first batch completes."""
        if not self._batch_walls:
            return 0.05
        return float(np.median(self._batch_walls[-50:]))

    def _retry_after_hint(self, queue_depth: int) -> float:
        """Backpressure hint for shed load, proportional to the backlog:
        the number of micro-batches the queued graphs represent times the
        recent median batch wall — not just one request's latency — so
        shed clients back off long enough for the queue to actually drain."""
        return backlog_retry_after(
            queue_depth, self.median_batch_wall(), self.policy.max_graphs
        )

    def oversized_reason(self, graph: CSRGraph) -> str | None:
        """Why ``graph`` exceeds this engine's admission limits, or
        ``None`` — the policy caps plus the simulator's footprint check
        against ``hw.gb_capacity_bytes`` (the widest served layer sets
        the staged-intermediate width)."""
        f_max = max(max(fi, fo) for fi, fo in self.dims)
        return self.policy.oversized_reason(graph, f=f_max, hw=self.hw)

    def _admission_error(
        self, req: Request, inflight_units: int
    ) -> ServingError | None:
        """Validity, size and load checks for one request.
        ``inflight_units`` is the work already admitted this call in
        batch-slot units (a partitioned giant counts ``n_partitions``)."""
        try:
            validate_request(req, self.f_in)
            reason = self.oversized_reason(req.graph)
            if reason is not None:
                raise OversizedGraph(f"request {req.rid}: {reason}")
            if (
                self.max_inflight_graphs is not None
                and inflight_units >= self.max_inflight_graphs
            ):
                hint = self._retry_after_hint(inflight_units)
                raise EngineOverloaded(
                    f"request {req.rid}: engine at max_inflight_graphs="
                    f"{self.max_inflight_graphs}; retry after {hint:.3f}s",
                    retry_after_s=hint,
                )
        except ServingError as e:
            return e
        return None

    # -- bookkeeping ---------------------------------------------------------
    def _record(self, results: list, pos: int, res: Result,
                err: ServingError | None = None) -> None:
        if self.device_label is not None and res.device is None:
            res = dc_replace(res, device=self.device_label)
        results[pos] = res
        self._status_counts[res.status] += 1
        if err is not None:
            self._errors[err.code] = self._errors.get(err.code, 0) + 1

    # -- serving -------------------------------------------------------------
    def submit(self, requests: Sequence[Request]) -> list[Result]:
        """Serve a slice of the stream: admit -> route -> assemble -> run.

        Requests are grouped by bucket and chunked into
        ``policy.max_graphs``-sized micro-batches; every request's latency
        is its own enqueue -> result wall time (bucket-cold compiles and
        time spent waiting behind earlier micro-batches of this call
        included, so the p99 reflects what the *request* experienced, not
        what its micro-batch cost).

        Never raises for a per-request cause: malformed, oversized, shed,
        expired or faulted requests come back as typed non-``ok``
        :class:`Result`\\ s while their healthy neighbors are served
        normally.  (A missing ``params`` is an engine misconfiguration and
        still raises, and so does a CUDA kernel that fails to build, load
        or launch, :class:`~repro_torch.kernels.common.CudaKernelError`:
        the ladder never serves the eager tier in a broken kernel's place.)
        """
        if self.params is None:
            raise ValueError(
                "engine has no params; pass params= or call engine.init(generator)"
            )
        t_submit = time.perf_counter()
        t_arrival = [t_submit] * len(requests)
        self._n_requests += len(requests)
        results: list[Result | None] = [None] * len(requests)

        admitted: list[int] = []
        partitioned: list[int] = []
        # admission charges *work units*, not request count: a normal
        # request is one batch slot, but an oversized request fans out
        # into plan.n_partitions device launches — charging only 1 would
        # let one giant blow straight through max_inflight_graphs
        inflight_units = 0
        for pos, req in enumerate(requests):
            err = self._admission_error(req, inflight_units)
            if err is None:
                admitted.append(pos)
                inflight_units += 1
            elif self.partition_oversized and isinstance(err, OversizedGraph):
                try:
                    units = self._plan_for(req.graph).n_partitions
                except ValueError:
                    # unplannable: admit with one unit; the partitioned
                    # lane fails it with the typed OversizedGraph cause
                    units = 1
                if (
                    self.max_inflight_graphs is not None
                    and inflight_units > 0
                    and inflight_units + units > self.max_inflight_graphs
                ):
                    # over the cap *and* not first in line — shed it with
                    # a hint sized to its real backlog contribution.  An
                    # empty engine always admits one giant (units may
                    # exceed the cap outright; progress beats starvation).
                    hint = self._retry_after_hint(inflight_units + units)
                    err = EngineOverloaded(
                        f"request {req.rid}: {units} partition units would "
                        f"exceed max_inflight_graphs="
                        f"{self.max_inflight_graphs} "
                        f"({inflight_units} units in flight); "
                        f"retry after {hint:.3f}s",
                        retry_after_s=hint,
                    )
                else:
                    partitioned.append(pos)
                    inflight_units += units
                    continue
                self._record(
                    results,
                    pos,
                    Result(
                        rid=req.rid,
                        output=None,
                        bucket=None,
                        latency_s=time.perf_counter() - t_submit,
                        status=err.status,
                        error=str(err),
                        error_type=err.code,
                        retry_after_s=err.retry_after_s,
                    ),
                    err,
                )
            else:
                self._record(
                    results,
                    pos,
                    Result(
                        rid=req.rid,
                        output=None,
                        bucket=None,
                        latency_s=time.perf_counter() - t_submit,
                        status=err.status,
                        error=str(err),
                        error_type=err.code,
                        retry_after_s=getattr(err, "retry_after_s", None),
                    ),
                    err,
                )

        if admitted:
            routed = bucketize(
                [requests[i].graph for i in admitted], self.policy
            )
            for bucket_key, local_idxs in routed.items():
                self._buckets_seen.add(bucket_key)
                self.profile.record_request(bucket_key, len(local_idxs))
                idxs = [admitted[j] for j in local_idxs]
                for chunk in _chunks(idxs, self.policy.max_graphs):
                    live = self._enforce_deadlines(
                        requests, chunk, bucket_key, t_arrival, results
                    )
                    if live:
                        self._serve_batch(
                            requests, live, bucket_key, results,
                            t_arrival=t_arrival,
                        )
        for pos in partitioned:
            self._serve_partitioned(requests, pos, results, t_arrival[pos])
        self._wall_s += time.perf_counter() - t_submit
        if self.store is not None:
            self.store.save_profile(self.profile)
        return results  # type: ignore[return-value]

    def _plan_for(self, graph: CSRGraph):
        """The cached partition plan for this graph's shape class."""
        key = self.policy.bucket_of(graph)
        plan = self._plans.get(key)
        if plan is None:
            from ..graphs.partition import plan_partition

            # a device-pinned worker engine (async front-end) must not
            # claim every card for a pp shard
            n_devices = (
                torch.cuda.device_count()
                if self.device.type == "cuda" and self.device_label is None
                else 1
            )
            t0 = time.perf_counter()
            plan = plan_partition(
                graph,
                self.dims,
                self.hw,
                objective=self.objective,
                n_devices=n_devices,
                allow_monolithic=False,
                max_partitions=self.max_partitions,
                max_block_rows=self.policy.max_nodes,
            )
            self._search_s += time.perf_counter() - t0
            self._plans[key] = plan
        return plan

    def _serve_partitioned(
        self, requests, pos: int, results: list, t_arr: float
    ) -> None:
        """Plan and execute one oversized request; records the Result."""
        req = requests[pos]
        t0 = time.perf_counter()
        dl = req.deadline_s
        if dl is not None and (t0 - t_arr) > dl:
            err = DeadlineExceeded(
                f"request {req.rid}: deadline {dl:.3f}s expired "
                f"({t0 - t_arr:.3f}s elapsed) before partitioned execution"
            )
            self._record(
                results, pos,
                Result(
                    rid=req.rid, output=None, bucket=None,
                    latency_s=t0 - t_arr, status=STATUS_FAILED,
                    error=str(err), error_type=err.code,
                ),
                err,
            )
            return
        bucket_key = self.policy.bucket_of(req.graph)
        try:
            plan = self._plan_for(req.graph)
        except ValueError as e:
            err = OversizedGraph(f"request {req.rid}: {e}")
            self._record(
                results, pos,
                Result(
                    rid=req.rid, output=None, bucket=bucket_key,
                    latency_s=time.perf_counter() - t_arr,
                    status=err.status, error=str(err), error_type=err.code,
                ),
                err,
            )
            return

        out, n_parts, tier_idx, n_retries, err = (
            self._execute_partitioned_ladder(req, plan)
        )
        wall = time.perf_counter() - t0
        lat = time.perf_counter() - t_arr
        self._latencies.append(lat)
        self._n_partitioned += 1
        self._partition_wall_s += wall
        self._partition_plans[plan.kind] = (
            self._partition_plans.get(plan.kind, 0) + 1
        )
        if err is not None:
            self._record(
                results, pos,
                Result(
                    rid=req.rid, output=None, bucket=bucket_key,
                    latency_s=lat, status=err.status, error=str(err),
                    error_type=err.code, n_retries=n_retries,
                    n_partitions=n_parts, partition_wall_s=wall,
                    plan=plan.kind,
                ),
                err,
            )
            return
        if tier_idx > 0:
            self._n_downgrades += 1
        tier = self.ladder[tier_idx]
        self._record(
            results, pos,
            Result(
                rid=req.rid, output=out, bucket=bucket_key, latency_s=lat,
                status=STATUS_DEGRADED if tier_idx > 0 else STATUS_OK,
                tier=tier.name, n_retries=n_retries,
                n_partitions=n_parts, partition_wall_s=wall, plan=plan.kind,
            ),
        )

    def _execute_partitioned_ladder(self, req: Request, plan):
        """Walk the degradation ladder around the whole partition loop
        (the batched path's retry/downgrade contract, per oversized
        request)."""
        last: BaseException | None = None
        n_retries = 0
        n_parts = plan.n_partitions
        for tier_idx, tier in enumerate(self.ladder):
            for attempt in range(self.retry.max_attempts):
                try:
                    out, n_parts = self._execute_partitioned(req, plan, tier)
                    return out, n_parts, tier_idx, n_retries, None
                except CudaKernelError:
                    raise  # a broken kernel: no lower tier may hide it
                except Exception as e:  # noqa: BLE001 — isolate any fault
                    last = e
                    if attempt < self.retry.max_retries:
                        n_retries += 1
                        self._n_retries += 1
                        self.retry.sleep_for(attempt)
        assert last is not None
        return (
            None, n_parts, len(self.ladder) - 1, n_retries,
            as_serving_error(last),
        )

    def _execute_partitioned(self, req: Request, plan, tier: Tier):
        """Execute one oversized request under its plan on one tier.

        ``row_stream`` streams halo closures through store-backed
        Programs: all partitions share one (closure-bucket) Program, each
        is bound and launched without blocking — the card runs this
        partition while the host gathers the next one's halo — and the
        per-partition ``[:n_own]`` node slices stitch back bit-identically
        to the whole-graph forward (every row's reduction is independent of
        the rows beside it).  Returns ``(output, n_partitions)``.
        """
        g = req.graph
        x_full = np.asarray(req.x)
        if plan.kind == "row_stream":
            from ..graphs.partition import extract_row_partitions

            parts = extract_row_partitions(g, plan.block_rows, plan.n_hops)
            d_bucket = self.policy.degree_bucket(g.max_degree)
            v_max = max(p.graph.n_nodes for p in parts)
            sub_policy = BucketPolicy(
                min_nodes=next_pow2(v_max), min_degree=d_bucket, max_graphs=1
            )
            prog = None
            pending = []
            traces_before = trace_count()
            t_run = time.perf_counter()
            for part in parts:
                batch = assemble([part.graph], sub_policy)
                if prog is None:
                    self._buckets_seen.add((batch.v_bucket, batch.d_bucket))
                    self.profile.record_request(
                        (batch.v_bucket, batch.d_bucket), 1
                    )
                    prog = self._program_for(batch, tier)
                self.profile.record_batch(
                    (batch.v_bucket, batch.d_bucket), batch.slots
                )
                bound = prog.bind(batch.graph, pad_degree=batch.d_bucket)
                x_in = self._stage(batch.batch_features([x_full[part.nodes]]))
                # enqueue without blocking: the device crunches this
                # partition while the host gathers the next one's halo
                out = bound.run(self.params, x_in, donate=False)
                pending.append(out[: part.n_own])
            h = torch.cat(pending, dim=0)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            if trace_count() > traces_before:
                self._trace_s += time.perf_counter() - t_run
            n_parts = len(parts)
        elif plan.kind == "feature_chunk":
            from ..graphs.partition import feature_chunk_forward

            h = torch.as_tensor(feature_chunk_forward(
                g, x_full, self.params, kind=self.kind, chunk_f=plan.chunk_f
            ), device=self.device)
            n_parts = plan.n_partitions
        elif plan.kind == "pp_shard":
            from ..graphs.partition import pp_shard_forward

            h = torch.as_tensor(pp_shard_forward(
                g, x_full, self.params, kind=self.kind,
                n_devices=plan.n_partitions,
            ), device=self.device)
            n_parts = plan.n_partitions
        else:
            raise ValueError(f"unexpected partition plan kind {plan.kind!r}")
        if self.readout is not None:
            seg = torch.zeros(h.shape[0], dtype=torch.int32, device=h.device)
            h = segment_readout(h, seg, 1, reduce=self.readout)[0]
        out = h.cpu().numpy()
        if self.check_numerics and not np.isfinite(out).all():
            raise NumericalFault(
                f"non-finite values in partitioned output of request "
                f"{req.rid} (plan {plan.kind}, tier {tier.name})"
            )
        return out, n_parts

    def _enforce_deadlines(
        self, requests, chunk, bucket_key, t_arrival, results
    ) -> list[int]:
        """Deadline check at batch-assembly time: expired requests fail
        with ``DeadlineExceeded`` and free their batch slots."""
        live = []
        for i in chunk:
            dl = requests[i].deadline_s
            elapsed = time.perf_counter() - t_arrival[i]
            if dl is not None and elapsed > dl:
                err = DeadlineExceeded(
                    f"request {requests[i].rid}: deadline {dl:.3f}s expired "
                    f"({elapsed:.3f}s elapsed) before batch assembly"
                )
                self._record(
                    results,
                    i,
                    Result(
                        rid=requests[i].rid,
                        output=None,
                        bucket=bucket_key,
                        latency_s=elapsed,
                        status=STATUS_FAILED,
                        error=str(err),
                        error_type=err.code,
                    ),
                    err,
                )
            else:
                live.append(i)
        return live

    def _serve_batch(
        self,
        requests: Sequence[Request],
        idxs: list[int],
        bucket_key: tuple[int, int],
        results: list,
        *,
        t_arrival: Sequence[float],
        solo: bool = False,
    ) -> None:
        """Assemble and execute one micro-batch down the ladder; on a
        whole-batch fault, quarantine by re-running each member solo."""
        t0 = time.perf_counter()
        batch = assemble([requests[i].graph for i in idxs], self.policy)
        x_in = batch.batch_features([requests[i].x for i in idxs])
        self.profile.record_batch(bucket_key, batch.slots)
        rids = [requests[i].rid for i in idxs]
        batch_index = self._batch_seq.get(bucket_key, 0)
        self._batch_seq[bucket_key] = batch_index + 1

        outs, tier_idx, n_retries, err = self._execute_ladder(
            batch, x_in, rids, bucket_key, batch_index
        )
        dt = time.perf_counter() - t0
        t_done = time.perf_counter()
        self._n_batches += 1
        self._batch_walls.append(dt)
        if solo:
            self._n_solo_retries += 1
        self.monitor.record(self._n_batches, dt)

        if err is not None:
            if len(idxs) > 1:
                # the batch is poisoned but we don't know by whom: re-run
                # every member alone so the poison fails solo and healthy
                # neighbors still get served (bit-identical outputs — the
                # block-diagonal batch computes each graph independently)
                for i in idxs:
                    self._serve_batch(
                        requests, [i], bucket_key, results,
                        t_arrival=t_arrival, solo=True,
                    )
                return
            lat = t_done - t_arrival[idxs[0]]
            self._latencies.append(lat)
            self._record(
                results,
                idxs[0],
                Result(
                    rid=rids[0],
                    output=None,
                    bucket=bucket_key,
                    latency_s=lat,
                    status=err.status,
                    error=str(err),
                    error_type=err.code,
                    n_retries=n_retries,
                ),
                err,
            )
            return

        tier = self.ladder[tier_idx]
        if tier_idx > 0:
            self._n_downgrades += 1
        status = STATUS_DEGRADED if tier_idx > 0 else STATUS_OK
        for i, o in zip(idxs, outs):
            lat = t_done - t_arrival[i]
            self._latencies.append(lat)
            self._record(
                results,
                i,
                Result(
                    rid=requests[i].rid,
                    output=o,
                    bucket=bucket_key,
                    latency_s=lat,
                    status=status,
                    tier=tier.name,
                    n_retries=n_retries,
                ),
            )

    def _execute_ladder(
        self,
        batch: GraphBatch,
        x_in,
        rids: list[int],
        bucket_key: tuple[int, int],
        batch_index: int,
    ):
        """Walk the degradation ladder with bounded retries per tier.

        ``x_in`` is the assembled feature block, a host ``np.ndarray``:
        each attempt stages it anew, so a donated tensor never needs to
        survive a retry or a lower tier.

        Returns ``(outputs, tier_index, n_retries, error)`` — ``error`` is
        ``None`` on success, the (taxonomy-wrapped) last failure when every
        tier is exhausted.
        """
        last: BaseException | None = None
        n_retries = 0
        for tier_idx, tier in enumerate(self.ladder):
            for attempt in range(self.retry.max_attempts):
                try:
                    outs = self._attempt(
                        batch, x_in, rids, bucket_key, batch_index, tier
                    )
                    return outs, tier_idx, n_retries, None
                except CudaKernelError:
                    raise  # a broken kernel: no lower tier may hide it
                except Exception as e:  # noqa: BLE001 — isolate any fault
                    last = e
                    if attempt < self.retry.max_retries:
                        n_retries += 1
                        self._n_retries += 1
                        self.retry.sleep_for(attempt)
            # tier exhausted: fall through to the next rung of the ladder
        assert last is not None
        return None, len(self.ladder) - 1, n_retries, as_serving_error(last)

    def _attempt(
        self,
        batch: GraphBatch,
        x_in,
        rids: list[int],
        bucket_key: tuple[int, int],
        batch_index: int,
        tier: Tier,
    ) -> list[np.ndarray]:
        """One execution attempt on one tier (the unit of retry)."""
        prog = self._program_for(batch, tier)
        bound = prog.bind(batch.graph, pad_degree=batch.d_bucket)
        corrupt = None
        if self.injector is not None:
            corrupt = self.injector.on_run(
                bucket_key, batch_index, rids, tier.name
            )
        x = self._stage(x_in)
        traces_before = trace_count()
        t_run = time.perf_counter()
        if self.readout is None:
            out = bound.run(self.params, x, donate=self.donate)
        else:
            # readout over the padded slot count, not n_graphs: the
            # executable shape then depends only on the bucket, so tail
            # batches at any fill level reuse it (pad segments are sliced
            # off below)
            out = bound.run(
                self.params,
                x,
                segment_ids=self._segment_ids(batch),
                num_segments=batch.slots,
                readout=self.readout,
                donate=self.donate,
            )
        del x  # the engine's own reference: the block frees after the run
        arr = out.cpu().numpy()
        wall = time.perf_counter() - t_run
        traced = trace_count() > traces_before
        if traced:
            # first execution on a cold shape: this wall holds the
            # executable build (and, on the card, a first kernel build or
            # load), so attribute it to trace_s — that is exactly what
            # precompile() and the kernel cache save a revived engine.
            self._trace_s += wall
        if corrupt == "nan":
            arr = self.injector.corrupt_output(arr)
        if self.check_numerics and not np.isfinite(arr).all():
            raise NumericalFault(
                f"non-finite values in the output of bucket {bucket_key} "
                f"batch {batch_index} (tier {tier.name}, rids {rids})"
            )
        if not traced and corrupt is None:
            # clean warm run: fold the measured wall into the traffic
            # profile's observation ledger keyed by the schedule that
            # produced it — the feedback half of the predicted<->measured
            # loop that rerank_topk() re-scores candidates against.
            self.profile.record_wall(
                bucket_key, batch.slots, prog.schedule_digest, wall
            )
        if self.readout is None:
            return batch.split_nodes(arr)
        return list(arr[: batch.n_graphs])

    def stats(self) -> EngineStats:
        """The serving report over everything submitted so far."""
        lat_ms = np.asarray(self._latencies, dtype=np.float64) * 1e3
        n = len(self._latencies)
        return EngineStats(
            n_requests=self._n_requests,
            n_batches=self._n_batches,
            n_buckets=len(self._buckets_seen),
            wall_s=self._wall_s,
            graphs_per_sec=n / self._wall_s if self._wall_s > 0 else 0.0,
            p50_ms=float(np.percentile(lat_ms, 50)) if n else 0.0,
            p99_ms=float(np.percentile(lat_ms, 99)) if n else 0.0,
            batch_p50_ms=(
                float(np.median(self._batch_walls)) * 1e3
                if self._batch_walls else 0.0
            ),
            compile_s=self._search_s + self._trace_s,
            search_s=self._search_s,
            trace_s=self._trace_s,
            cache_hits=self.cache.hits,
            cache_misses=self.cache.misses,
            cache_evictions=self.cache.evictions,
            n_searches=self._n_searches,
            store_hits=self.store.hits if self.store is not None else 0,
            store_misses=self.store.misses if self.store is not None else 0,
            store_corrupt=self.store.corrupt if self.store is not None else 0,
            n_ok=self._status_counts[STATUS_OK],
            n_rejected=self._status_counts[STATUS_REJECTED],
            n_failed=self._status_counts[STATUS_FAILED],
            n_degraded=self._status_counts[STATUS_DEGRADED],
            n_retries=self._n_retries,
            n_downgrades=self._n_downgrades,
            n_solo_retries=self._n_solo_retries,
            n_stragglers=len(self.monitor.flagged),
            errors=dict(self._errors),
            n_partitioned=self._n_partitioned,
            partition_wall_s=self._partition_wall_s,
            partition_plans=dict(self._partition_plans),
        )
