"""Async continuous-batching front-end with multi-device bucket placement.

The port of :mod:`repro.runtime.scheduler`.
:meth:`~repro_torch.runtime.engine.InferenceEngine.submit` is synchronous
and single-device: requests only batch within one call, every bucket
executes serially on one device, and a request's latency is set by whoever
it happened to arrive with.  The paper's core claim is that spatial
accelerators win by running distinct phase dataflows *concurrently* on
partitioned compute; for a serving workload the analogous axis is
graph-level parallelism across independent inputs — distinct padding
buckets are independent programs, so they can run on distinct devices at
the same time.  This module is that front-end:

* :class:`AsyncEngine` — an arrival queue with a **batching window** per
  bucket: a window flushes when it holds ``policy.max_graphs`` graphs or
  when ``window_ms`` expires, whichever comes first.  ``submit_async``
  returns a :class:`concurrent.futures.Future` per request, so latency is
  measured per request (enqueue -> result), not per submit-chunk.
* :class:`BucketPlacer` — schedules buckets over a device list: distinct
  buckets land on distinct workers while workers remain (least-loaded by
  recorded heat), and buckets hotter than a fair share get up to
  ``replicas`` replicas, driven by the same
  :class:`~repro_torch.graphs.batching.TrafficProfile` heat the engine
  already records.
* **Overlapped transfers** — the flush path assembles the block-diagonal
  batch and stages its feature block on the target worker's **copy
  stream** (pinned host memory, a ``non_blocking`` copy, an event) *before*
  the group reaches the worker, whose compute stream waits on that event:
  the host-to-device copy overlaps the previous batch's compute.

Contracts carried over:

* Admission runs **before** queueing — a malformed, oversized or shed
  request resolves its future immediately with a typed ``rejected``
  :class:`~repro_torch.runtime.engine.Result` and never occupies a window
  slot.  Per-request deadlines are enforced at the batching window
  (:meth:`InferenceEngine.serve_group`), and the per-worker engines keep
  the full ladder + solo-retry quarantine, so a poisoned request still
  fails alone with a typed status.  No code path raises for a
  per-request cause; a CUDA kernel that fails to build, load or launch is
  not one, and reaches every waiting future as its exception.
* Every per-worker engine's LRU sits on the one shared
  :class:`~repro_torch.runtime.store.ProgramStore` (artifacts are keyed by
  shape, not device), and :meth:`AsyncEngine.precompile` warms **each
  worker's assigned buckets** on that worker's own thread.

Execution model: one worker thread per entry of the device list.  The
current CUDA device and stream are per thread in PyTorch, so each worker
sets its device and enters its own compute stream in ``run()``.  A device
may repeat in the list (several workers on one card, or on the CPU as the
tests run them); each worker then gets a label of its own,
``<device>#<k>``, which ``Result.device``, :meth:`AsyncEngine.placement`
and :meth:`AsyncEngine.stats` report.
"""
from __future__ import annotations

import contextlib
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Sequence

import numpy as np
import torch

from ..gnn.pp import mesh_devices
from ..graphs.batching import GraphBatch, TrafficProfile, assemble
from .engine import (
    EngineStats,
    InferenceEngine,
    PrecompileReport,
    Request,
    Result,
)
from .resilience import (
    STATUS_DEGRADED,
    STATUS_FAILED,
    STATUS_OK,
    STATUS_REJECTED,
    EngineOverloaded,
    OversizedGraph,
    ServingError,
    backlog_retry_after,
    validate_request,
)


@dataclass
class AsyncEngineStats:
    """The async front-end's serving report.

    ``p50_ms`` / ``p99_ms`` are per-request enqueue -> result wall times
    across every worker (front-end rejections included), so they are
    directly comparable to the sync engine's.  ``per_device`` holds each
    worker engine's own :class:`~repro_torch.runtime.engine.EngineStats`;
    ``placement`` records which workers each bucket was assigned to.
    """

    n_requests: int = 0
    n_devices: int = 0
    wall_s: float = 0.0
    graphs_per_sec: float = 0.0
    p50_ms: float = 0.0
    p99_ms: float = 0.0
    n_ok: int = 0
    n_rejected: int = 0
    n_failed: int = 0
    n_degraded: int = 0
    n_flushes_full: int = 0  # windows flushed because they filled
    n_flushes_deadline: int = 0  # windows flushed by the window_ms clock
    max_inflight: int = 0  # high-water mark of queued+running graphs
    errors: dict = field(default_factory=dict)
    placement: dict = field(default_factory=dict)  # "VxD" -> [worker labels]
    per_device: dict = field(default_factory=dict)  # label -> EngineStats dict

    def as_dict(self) -> dict:
        from dataclasses import asdict

        return asdict(self)


@dataclass
class AsyncPrecompileReport:
    """Per-worker precompile roll-up: each worker warmed its *assigned*
    buckets (placer plan over the persisted profile) on its own thread."""

    n_shapes: int = 0
    n_store_hits: int = 0
    n_compiled: int = 0
    n_searches: int = 0
    n_traces: int = 0
    wall_s: float = 0.0
    per_device: dict = field(default_factory=dict)  # label -> PrecompileReport

    def as_dict(self) -> dict:
        from dataclasses import asdict

        return asdict(self)


class BucketPlacer:
    """Bucket -> device assignment over a mesh, driven by traffic heat.

    Distinct buckets go to distinct devices while free devices remain:
    a new bucket is assigned to the device carrying the least cumulative
    heat (request count), so the first ``n_devices`` buckets spread one
    per device.  A bucket whose heat share exceeds a fair device share
    (``1 / n_devices``) is *hot* and gets additional replicas — up to
    ``replicas`` — on the least-loaded devices that don't already serve
    it.  Dispatch picks the assigned replica with the fewest outstanding
    graphs.

    The placer is deliberately greedy and incremental: assignments only
    grow (a bucket never migrates), so per-device executable caches stay
    warm and placement is deterministic for a given arrival order.  Not
    thread-safe by itself — the :class:`AsyncEngine` serializes calls
    under its own lock.
    """

    def __init__(
        self, n_devices: int, *, replicas: int = 1, min_heat: int = 32
    ):
        if n_devices < 1:
            raise ValueError(f"need at least one device, got {n_devices}")
        if replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {replicas}")
        self.n_devices = n_devices
        self.replicas = min(replicas, n_devices)
        #: minimum absolute heat before a bucket can widen — a bucket's
        #: first few arrivals dominate any share computation, so expansion
        #: waits for a statistically meaningful sample
        self.min_heat = min_heat
        #: bucket -> ordered device indices serving it (first = home)
        self.assignment: dict[tuple[int, int], list[int]] = {}
        #: cumulative request heat per bucket / per device
        self.heat: dict[tuple[int, int], int] = {}
        self.device_heat: list[int] = [0] * n_devices
        #: outstanding (queued or running) graphs per device
        self.outstanding: list[int] = [0] * n_devices

    def _least_loaded(self, exclude: Sequence[int] = ()) -> int:
        """Device with the least heat (ties -> lowest index) not excluded."""
        best = None
        for d in range(self.n_devices):
            if d in exclude:
                continue
            if best is None or self.device_heat[d] < self.device_heat[best]:
                best = d
        assert best is not None
        return best

    def record(self, bucket: tuple[int, int], n: int = 1) -> None:
        """Account ``n`` arrivals to ``bucket``: assign it on first sight,
        and widen hot buckets up to ``replicas`` devices."""
        self.heat[bucket] = self.heat.get(bucket, 0) + n
        homes = self.assignment.get(bucket)
        if homes is None:
            homes = [self._least_loaded()]
            self.assignment[bucket] = homes
        self.device_heat[homes[0]] += n
        if (
            self.replicas > 1
            and len(homes) < self.replicas
            and self.heat[bucket] >= self.min_heat
        ):
            total = sum(self.heat.values())
            if total > 0 and self.heat[bucket] / total > 1.0 / self.n_devices:
                extra = self._least_loaded(exclude=homes)
                if extra not in homes:
                    homes.append(extra)

    def plan(self, profile: TrafficProfile) -> None:
        """Seed the assignment from a recorded profile, hottest bucket
        first — the startup twin of :meth:`record`, so ``precompile`` can
        warm each device's buckets before traffic arrives."""
        for bucket, n in profile.heat():
            self.record(bucket, n)

    def pick(self, bucket: tuple[int, int], n_graphs: int) -> int:
        """The device index to dispatch this flush to: the bucket's
        assigned replica with the fewest outstanding graphs.  Registers
        the ``n_graphs`` as outstanding (release with :meth:`done`)."""
        homes = self.assignment.get(bucket)
        if homes is None:  # dispatch before record (defensive)
            self.record(bucket, 0)
            homes = self.assignment[bucket]
        d = min(homes, key=lambda i: (self.outstanding[i], homes.index(i)))
        self.outstanding[d] += n_graphs
        return d

    def done(self, device: int, n_graphs: int) -> None:
        self.outstanding[device] = max(0, self.outstanding[device] - n_graphs)

    def buckets_for(self, device: int) -> set[tuple[int, int]]:
        """Every bucket assigned (home or replica) to ``device``."""
        return {b for b, homes in self.assignment.items() if device in homes}


def worker_labels(devices: Sequence[torch.device]) -> list[str]:
    """One label per worker: ``str(device)``, or ``<device>#<k>`` (``k``
    counting that device's workers from 0) where the device repeats."""
    names = [str(d) for d in devices]
    seen: dict[str, int] = {}
    labels = []
    for name in names:
        if names.count(name) == 1:
            labels.append(name)
        else:
            labels.append(f"{name}#{seen.get(name, 0)}")
            seen[name] = seen.get(name, 0) + 1
    return labels


class _Window:
    """One open batching window: same-bucket requests waiting to flush."""

    __slots__ = ("bucket", "requests", "arrivals", "futures", "deadline")

    def __init__(self, bucket: tuple[int, int], deadline: float):
        self.bucket = bucket
        self.requests: list[Request] = []
        self.arrivals: list[float] = []
        self.futures: list[Future] = []
        self.deadline = deadline  # perf_counter time to force-flush


@dataclass
class _Staged:
    """A flushed window's batch, its features on the worker's device, the
    event after their copy (None on the CPU), and the pinned host block,
    kept alive until the worker has run the batch."""

    batch: GraphBatch
    x: torch.Tensor
    ready: "torch.cuda.Event | None"
    host: torch.Tensor


class _DeviceWorker(threading.Thread):
    """One worker's serving loop: owns an :class:`InferenceEngine` (its own
    LRU and executable caches, the shared store underneath) and drains
    dispatched groups in FIFO order on its device.  On a CUDA device it
    computes on a stream of its own and is staged for on a copy stream of
    its own."""

    def __init__(self, index: int, device: torch.device, label: str,
                 engine: InferenceEngine):
        super().__init__(name=f"repro-worker-{index}", daemon=True)
        self.index = index
        self.device = device
        self.label = label
        self.engine = engine
        self.inbox: "list" = []
        self.cv = threading.Condition()
        on_card = device.type == "cuda"
        self.stream = torch.cuda.Stream(device) if on_card else None
        self.copy_stream = torch.cuda.Stream(device) if on_card else None

    def dispatch(self, item) -> None:
        with self.cv:
            self.inbox.append(item)
            self.cv.notify()

    def stage(self, batch: GraphBatch, x_np: np.ndarray) -> _Staged:
        """Stage a flushed batch's features on this worker's device, from
        the flusher's thread: on a card, through pinned memory and a
        ``non_blocking`` copy on the copy stream, then an event the
        compute stream waits on; on the CPU, a copy."""
        host = torch.from_numpy(np.ascontiguousarray(x_np, dtype=np.float32))
        if self.copy_stream is None:
            return _Staged(batch, host.clone().to(self.device), None, host)
        host = host.pin_memory()
        with torch.cuda.stream(self.copy_stream):
            x = host.to(self.device, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(self.copy_stream)
        # read on the compute stream: the allocator must not hand the block
        # out again before that stream is done with it
        x.record_stream(self.stream)
        return _Staged(batch, x, ready, host)

    def run(self) -> None:
        if self.stream is not None:
            torch.cuda.set_device(self.device)
            ctx = torch.cuda.stream(self.stream)
        else:
            ctx = contextlib.nullcontext()
        with ctx:
            if self.engine.params is not None:
                # place the params once; every batch then reads them
                # device-locally instead of re-transferring
                self.engine.params = [
                    {k: v.to(self.device) for k, v in layer.items()}
                    for layer in self.engine.params
                ]
            while True:
                with self.cv:
                    while not self.inbox:
                        self.cv.wait()
                    item = self.inbox.pop(0)
                if item is None:
                    return
                kind, payload, fut = item
                try:
                    if kind == "group":
                        reqs, arrivals, staged = payload
                        pre = None
                        if staged is not None:
                            if staged.ready is not None:
                                self.stream.wait_event(staged.ready)
                            pre = (staged.batch, staged.x)
                        out = self.engine.serve_group(reqs, arrivals, pre=pre)
                        del pre, staged  # the batch has run: host block free
                    else:  # "call": run an arbitrary thunk on this worker
                        out = payload()
                    fut.set_result(out)
                except BaseException as e:  # the worker survives a fault
                    fut.set_exception(e)
                    if not isinstance(e, Exception):
                        raise


class AsyncEngine:
    """Continuous-batching serving front-end over a device list.

    ::

        engine = AsyncEngine(dims, params, window_ms=10)
        engine.start()
        futs = [engine.submit_async(r) for r in requests]
        results = [f.result() for f in futs]
        engine.close()

    ``devices`` (or ``mesh``) lists the workers' devices; left out, every
    CUDA device (raises when there is none).  ``submit_async`` admits the
    request (boundary checks + a ``max_queue_graphs`` backlog cap with a
    queue-depth-proportional ``retry_after_s``), then parks it in its
    bucket's batching window.  The window flushes to a worker when it
    fills to ``policy.max_graphs`` or its ``window_ms`` deadline expires —
    so under load p99 tracks the window, not the batch that happened to
    contain the request.

    Every per-worker engine is constructed with ``donate=False`` (staged
    feature tensors must survive ladder retries) and the shared ``store``;
    everything else mirrors the sync :class:`InferenceEngine` kwargs.
    """

    def __init__(
        self,
        dims: Sequence[tuple[int, int]],
        params=None,
        *,
        mesh: Sequence | None = None,
        devices: Sequence | None = None,
        window_ms: float = 10.0,
        replicas: int = 1,
        max_queue_graphs: int | None = None,
        **engine_kwargs,
    ):
        self.devices = mesh_devices(mesh, list(devices) if devices else None)
        if not self.devices:
            raise ValueError("no devices to place buckets on")
        self.labels = worker_labels(self.devices)
        self.window_s = float(window_ms) / 1e3
        self.max_queue_graphs = max_queue_graphs
        engine_kwargs.pop("donate", None)
        # admission is the front-end's job — per-engine shedding would
        # double-count a stream that is already capped at the queue
        engine_kwargs.pop("max_inflight_graphs", None)
        self.workers: list[_DeviceWorker] = []
        for i, (dev, label) in enumerate(zip(self.devices, self.labels)):
            eng = InferenceEngine(
                dims,
                params,
                donate=False,
                device_label=label,
                device=dev,
                **engine_kwargs,
            )
            self.workers.append(_DeviceWorker(i, dev, label, eng))
        e0 = self.workers[0].engine
        self.policy = e0.policy
        self.f_in = e0.f_in
        self.store = e0.store
        self.placer = BucketPlacer(len(self.devices), replicas=replicas)
        #: merged bucket heat across workers (persisted to the store on
        #: close; worker engines never save their partial profiles)
        self.profile: TrafficProfile = e0.profile
        for w in self.workers[1:]:
            w.engine.profile = TrafficProfile()  # don't double-seed heat
        self._lock = threading.Lock()
        self._windows: dict[tuple[int, int], _Window] = {}
        self._inflight = 0  # graphs admitted but not yet resolved
        self._max_inflight = 0
        self._rid = 0
        self._n_requests = 0
        self._n_flushes_full = 0
        self._n_flushes_deadline = 0
        self._fe_latencies: list[float] = []  # front-end rejections
        self._fe_status = {s: 0 for s in
                           (STATUS_OK, STATUS_REJECTED, STATUS_FAILED,
                            STATUS_DEGRADED)}
        self._fe_errors: dict[str, int] = {}
        #: host seconds the flush path spent assembling and staging each
        #: dispatched window (beside each worker engine's batch walls)
        self._stage_walls: list[float] = []
        self._wall_t0: float | None = None
        self._wall_t1: float = 0.0
        self._started = False
        self._closed = False
        self._flusher = threading.Thread(
            target=self._flush_loop, name="repro-flusher", daemon=True
        )
        self._flush_cv = threading.Condition(self._lock)

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "AsyncEngine":
        if self._started:
            return self
        self._started = True
        for w in self.workers:
            w.start()
        self._flusher.start()
        return self

    def close(self) -> None:
        """Flush every open window, drain the workers, persist the merged
        traffic profile.  Idempotent."""
        if self._closed or not self._started:
            self._closed = True
            return
        self._closed = True
        final: list[tuple[int, list]] = []
        with self._lock:
            for bucket in list(self._windows):
                flushed = self._flush_locked(bucket, "deadline")
                if flushed is not None:
                    final.append(flushed)
            self._flush_cv.notify_all()
        for widx, wins in final:
            self._stage_and_dispatch(widx, wins)
        self._flusher.join(timeout=10.0)
        # sentinel after all groups: workers drain FIFO then exit
        for w in self.workers:
            w.dispatch(None)
        for w in self.workers:
            w.join(timeout=30.0)
        self._persist_profile()

    def __enter__(self) -> "AsyncEngine":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    def _persist_profile(self) -> None:
        if self.store is not None:
            merged = self.profile
            for w in self.workers[1:]:
                merged = merged.merge(w.engine.profile)
            self.profile = merged
            for w in self.workers[1:]:
                w.engine.profile = TrafficProfile()
            self.store.save_profile(merged)

    # -- admission (before queueing) -----------------------------------------
    def _admission_error(self, req: Request) -> ServingError | None:
        try:
            validate_request(req, self.f_in)
            reason = self.workers[0].engine.oversized_reason(req.graph)
            if reason is not None:
                raise OversizedGraph(f"request {req.rid}: {reason}")
            if (
                self.max_queue_graphs is not None
                and self._inflight >= self.max_queue_graphs
            ):
                hint = backlog_retry_after(
                    self._inflight,
                    self._median_batch_wall(),
                    self.policy.max_graphs,
                )
                raise EngineOverloaded(
                    f"request {req.rid}: queue at max_queue_graphs="
                    f"{self.max_queue_graphs}; retry after {hint:.3f}s",
                    retry_after_s=hint,
                )
        except ServingError as e:
            return e
        return None

    def _median_batch_wall(self) -> float:
        walls: list[float] = []
        for w in self.workers:
            walls.extend(w.engine._batch_walls[-50:])
        if not walls:
            return 0.05
        return float(np.median(walls))

    # -- enqueue -------------------------------------------------------------
    def submit_async(self, req: Request) -> "Future[Result]":
        """Admit ``req`` and park it in its bucket's batching window.

        Returns a future resolving to this request's
        :class:`~repro_torch.runtime.engine.Result`.  Admission failures
        resolve immediately (typed ``rejected`` result, never an
        exception) — nothing inadmissible ever occupies a window slot.
        """
        if not self._started or self._closed:
            raise RuntimeError("AsyncEngine is not running (call start())")
        fut: "Future[Result]" = Future()
        t_arrival = time.perf_counter()
        flush_now: tuple[int, list] | None = None
        part_widx: int | None = None
        with self._lock:
            if self._wall_t0 is None:
                self._wall_t0 = t_arrival
            self._n_requests += 1
            err = self._admission_error(req)
            if (
                err is not None
                and isinstance(err, OversizedGraph)
                and self.workers[0].engine.partition_oversized
            ):
                # beyond-capacity single graph: route to the partitioned
                # lane on the least-loaded worker instead of rejecting
                res = None
                self._inflight += 1
                self._max_inflight = max(self._max_inflight, self._inflight)
                part_widx = min(
                    range(len(self.workers)),
                    key=lambda i: self.placer.outstanding[i],
                )
                self.placer.outstanding[part_widx] += 1
            elif err is not None:
                lat = time.perf_counter() - t_arrival
                res = Result(
                    rid=req.rid,
                    output=None,
                    bucket=None,
                    latency_s=lat,
                    status=err.status,
                    error=str(err),
                    error_type=err.code,
                    retry_after_s=getattr(err, "retry_after_s", None),
                )
                self._fe_status[err.status] += 1
                self._fe_errors[err.code] = self._fe_errors.get(err.code, 0) + 1
                self._fe_latencies.append(lat)
                self._wall_t1 = time.perf_counter()
            else:
                res = None
                bucket = self.policy.bucket_of(req.graph)
                self.placer.record(bucket)
                self._inflight += 1
                self._max_inflight = max(self._max_inflight, self._inflight)
                win = self._windows.get(bucket)
                if win is None:
                    win = _Window(bucket, t_arrival + self.window_s)
                    self._windows[bucket] = win
                    self._flush_cv.notify()  # new earliest deadline maybe
                win.requests.append(req)
                win.arrivals.append(t_arrival)
                win.futures.append(fut)
                if len(win.requests) >= self.policy.max_graphs:
                    flush_now = self._flush_locked(bucket, "full")
        if res is not None:
            fut.set_result(res)  # outside the lock
        elif part_widx is not None:
            worker = self.workers[part_widx]
            done: "Future[Result]" = Future()
            done.add_done_callback(
                self._make_partition_resolver(part_widx, fut)
            )
            worker.dispatch((
                "call",
                lambda e=worker.engine, r=req, t=t_arrival:
                    e.serve_partitioned(r, t),
                done,
            ))
        elif flush_now is not None:
            self._stage_and_dispatch(*flush_now)
        return fut

    def submit(self, requests: Sequence[Request]) -> list[Result]:
        """Synchronous convenience: enqueue everything, wait for all."""
        futs = [self.submit_async(r) for r in requests]
        return [f.result() for f in futs]

    def make_request(self, graph, x, **kw) -> Request:
        """A :class:`Request` with a fresh front-end-assigned rid."""
        with self._lock:
            rid = self._rid
            self._rid += 1
        return Request(graph=graph, x=x, rid=rid, **kw)

    # -- flush ---------------------------------------------------------------
    def _flush_locked(self, bucket: tuple[int, int], reason: str):
        """Pop the bucket's window (lock held) and pick its worker; the
        caller stages + dispatches outside the lock."""
        win = self._windows.pop(bucket, None)
        if win is None or not win.requests:
            return None
        widx = self.placer.pick(bucket, len(win.requests))
        if reason == "full":
            self._n_flushes_full += 1
        else:
            self._n_flushes_deadline += 1
        return widx, [win]

    def _stage_and_dispatch(self, widx: int, wins: list) -> None:
        """Assemble + stage each flushed window on its worker's device,
        then hand it to the worker.  Runs on the enqueueing/flusher thread
        so the host-to-device copy overlaps the worker's current batch."""
        worker = self.workers[widx]
        for win in wins:
            t0 = time.perf_counter()
            staged = None
            if len(win.requests) <= self.policy.max_graphs:
                try:
                    batch = assemble(
                        [r.graph for r in win.requests], self.policy
                    )
                    x_np = batch.batch_features([r.x for r in win.requests])
                    staged = worker.stage(batch, x_np)
                except Exception:  # noqa: BLE001 — the worker re-assembles
                    staged = None  # fall back to in-engine assembly
            with self._lock:
                self._stage_walls.append(time.perf_counter() - t0)
            done: "Future[list[Result]]" = Future()
            done.add_done_callback(
                self._make_resolver(widx, win.futures, len(win.requests))
            )
            worker.dispatch(
                ("group", (win.requests, win.arrivals, staged), done)
            )

    def _make_resolver(self, widx: int, futures: list, n: int):
        def _resolve(done: "Future") -> None:
            exc = done.exception()
            results = None if exc is not None else done.result()
            with self._lock:
                self._inflight -= n
                self.placer.done(widx, n)
                self._wall_t1 = time.perf_counter()
            if exc is not None:
                # an engine misconfiguration or a CUDA kernel that fails to
                # build, load or launch (serve_group's only raise paths);
                # surface it on every waiting future
                for f in futures:
                    f.set_exception(exc)
                return
            for f, r in zip(futures, results):
                f.set_result(r)

        return _resolve

    def _make_partition_resolver(self, widx: int, fut: "Future"):
        def _resolve(done: "Future") -> None:
            exc = done.exception()
            with self._lock:
                self._inflight -= 1
                self.placer.done(widx, 1)
                self._wall_t1 = time.perf_counter()
            if exc is not None:
                fut.set_exception(exc)
            else:
                fut.set_result(done.result())

        return _resolve

    def _flush_loop(self) -> None:
        """Deadline clock: sleep until the earliest open window expires,
        flush everything due, repeat."""
        while True:
            with self._lock:
                if self._closed and not self._windows:
                    return
                now = time.perf_counter()
                due: list[tuple[int, list]] = []
                next_deadline = None
                for bucket in list(self._windows):
                    win = self._windows[bucket]
                    if win.deadline <= now:
                        flushed = self._flush_locked(bucket, "deadline")
                        if flushed is not None:
                            due.append(flushed)
                    elif (
                        next_deadline is None or win.deadline < next_deadline
                    ):
                        next_deadline = win.deadline
                if not due:
                    timeout = (
                        None if next_deadline is None
                        else max(0.0, next_deadline - now)
                    )
                    self._flush_cv.wait(timeout=timeout)
                    continue
            for widx, wins in due:
                self._stage_and_dispatch(widx, wins)

    # -- startup warmth ------------------------------------------------------
    def precompile(
        self,
        profile: TrafficProfile | None = None,
        *,
        max_shapes: int | None = None,
    ) -> AsyncPrecompileReport:
        """Warm each worker's *assigned* buckets on its own thread.

        The placer is seeded from the (persisted) profile, then every
        worker precompiles the profile subset it was assigned — so a
        revived engine takes all of its executable builds off the request
        path, and no worker wastes startup warming a bucket it will never
        be handed.
        """
        if not self._started:
            raise RuntimeError("call start() before precompile()")
        if profile is None and self.store is not None:
            profile = self.store.load_profile()
        if profile is None:
            profile = self.profile
        with self._lock:
            self.placer.plan(profile)
            subsets = [
                profile.subset(self.placer.buckets_for(i))
                for i in range(len(self.workers))
            ]
        t0 = time.perf_counter()
        futs: list[Future] = []
        for w, sub in zip(self.workers, subsets):
            fut: Future = Future()
            futs.append(fut)
            w.dispatch((
                "call",
                (lambda e=w.engine, s=sub: e.precompile(
                    s, max_shapes=max_shapes
                )),
                fut,
            ))
        rep = AsyncPrecompileReport()
        for w, fut in zip(self.workers, futs):
            r: PrecompileReport = fut.result()
            rep.n_shapes += r.n_shapes
            rep.n_store_hits += r.n_store_hits
            rep.n_compiled += r.n_compiled
            rep.n_searches += r.n_searches
            rep.n_traces += r.n_traces
            rep.per_device[w.label] = r.as_dict()
        rep.wall_s = time.perf_counter() - t0
        return rep

    # -- reporting -----------------------------------------------------------
    def placement(self) -> dict[str, list[str]]:
        """Bucket -> worker labels, for inspection and tests."""
        with self._lock:
            return {
                f"{v}x{d}": [self.labels[i] for i in homes]
                for (v, d), homes in sorted(self.placer.assignment.items())
            }

    def stats(self) -> AsyncEngineStats:
        """Merged per-request report across every worker."""
        with self._lock:
            lat = list(self._fe_latencies)
            status = dict(self._fe_status)
            errors = dict(self._fe_errors)
            n_requests = self._n_requests
            wall = (
                (self._wall_t1 - self._wall_t0)
                if self._wall_t0 is not None else 0.0
            )
            n_full = self._n_flushes_full
            n_deadline = self._n_flushes_deadline
            max_inflight = self._max_inflight
        per_device: dict[str, EngineStats] = {}
        n_served = 0
        for w in self.workers:
            s = w.engine.stats()
            per_device[w.label] = s
            lat.extend(w.engine._latencies)
            status[STATUS_OK] += s.n_ok
            status[STATUS_REJECTED] += s.n_rejected
            status[STATUS_FAILED] += s.n_failed
            status[STATUS_DEGRADED] += s.n_degraded
            n_served += s.n_ok + s.n_degraded
            for code, n in s.errors.items():
                errors[code] = errors.get(code, 0) + n
        lat_ms = np.asarray(lat, dtype=np.float64) * 1e3
        return AsyncEngineStats(
            n_requests=n_requests,
            n_devices=len(self.devices),
            wall_s=wall,
            graphs_per_sec=n_served / wall if wall > 0 else 0.0,
            p50_ms=float(np.percentile(lat_ms, 50)) if len(lat_ms) else 0.0,
            p99_ms=float(np.percentile(lat_ms, 99)) if len(lat_ms) else 0.0,
            n_ok=status[STATUS_OK],
            n_rejected=status[STATUS_REJECTED],
            n_failed=status[STATUS_FAILED],
            n_degraded=status[STATUS_DEGRADED],
            n_flushes_full=n_full,
            n_flushes_deadline=n_deadline,
            max_inflight=max_inflight,
            errors=errors,
            placement=self.placement(),
            per_device={k: v.as_dict() for k, v in per_device.items()},
        )
