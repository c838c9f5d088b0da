"""Serving throughput: the bucketized engine vs naive per-graph compile+run.

    PYTHONPATH=src python -m repro_torch.bench.serve_gnn [--smoke] [--chaos] [--device cpu]

Drives a 1000-request synthetic molecule/ego stream (mutag- and
imdb-bin-structured graphs, Table 4) through
:class:`repro_torch.runtime.InferenceEngine` and through the naive
serving loop the engine replaces — one ``repro_torch.compile`` +
``Program.run`` per request.  The naive loop is handed its ModelSchedule
for free (no per-request mapper search), so the measured speedup is a
*lower* bound on what bucketized batching + the program cache buy.  Both
run the kernel tier (``use_pallas=True``: the hand-written CUDA kernels on
the card, their plain PyTorch versions on a CPU device) on ``--device``
(default: the current CUDA device).

Full runs commit ``experiments/benchmarks_torch/serve_gnn.json``
(graphs/sec, p50/p99 request latency, cache behavior, the naive
comparison, the kernels' launches, the card) and guard that the engine
beats naive per-graph serving by >= 10x wall-clock on the same stream;
``--smoke`` serves a short stream with no JSON / no guard.  Both modes
cross-check engine outputs against the naive per-graph outputs to 1e-5,
hold the whole stream against the eager tier (plain PyTorch, the same
weights) at ``CLOSE_TOL``, and hold every result ``ok`` on the top tier
with no downgrade.

``--chaos`` runs the fault-isolation lane instead: the same stream with a
seeded 10% fault mix (NaN / float64 features, broken CSR, oversized
graphs, sticky per-request kernel faults) through an engine with a
:class:`~repro_torch.runtime.FaultInjector` attached.  It proves the
resilience contract under load — ``submit()`` never raises, every fault
lands as a typed non-``ok`` status, healthy outputs stay **bit-identical**
to a fault-free run, and the chaos slowdown stays under
``CHAOS_SLOWDOWN_CEIL`` — and commits
``experiments/benchmarks_torch/serve_gnn_chaos.json``.

``--restart`` runs the zero-cold-start lane: a cold engine serves the
stream into a fresh :class:`~repro_torch.runtime.ProgramStore` (with the
persistent kernel cache, the ``nvcc``-built libraries, underneath), is
killed, and a revived engine on the same store ``precompile()``\\ s the
recorded bucket grid and serves the stream again.  It proves the restart
contract — the revived engine's first request runs with **zero mapper
searches, zero new executable builds and no** ``nvcc`` **started**,
first-request latency at warm-path speed (vs the cold p99), outputs
bit-identical across the restart, and a corrupted artifact degrades to a
recompile instead of an exception — and commits
``experiments/benchmarks_torch/serve_gnn_restart.json``.  Set
``REPRO_TORCH_STORE_DIR`` to persist the store across invocations.

``--async`` runs the continuous-batching lane on a list of workers: two
on the CPU (``cpu#0``, ``cpu#1``), two streams of one card
(``cuda:0#0``, ``cuda:0#1``), or every card where there are two or more.
An :class:`~repro_torch.runtime.AsyncEngine` serves the stream through
per-bucket batching windows placed over the workers, against the
synchronous per-arrival front-end it replaces (one ``submit([req])`` per
arrival).  It proves the async contract — blast-phase throughput >=
``ASYNC_SPEEDUP_FLOOR`` x the per-arrival sync engine with
**bit-identical** outputs, and a paced (sub-capacity, no-fault) phase
whose per-request p99 tracks the batching window (<=
``ASYNC_P99_WINDOW_FACTOR`` x ``window_ms``) — and commits
``experiments/benchmarks_torch/serve_gnn_async.json``.  The bulk-submit
sync engine (all requests in one call — an oracle no real front-end sees)
is reported alongside for context.

``--giant`` runs the beyond-capacity lane: banded graphs whose staged
V x F intermediate exceeds the modeled ``gb_capacity_bytes`` (a plain
engine rejects the entire stream) are served through the partitioned
lane — ``plan_partition`` picks ``row_stream`` under the ``edp``
objective, L-hop halo closures stream through one shared closure-bucket
Program (SP-Optimized/AC: the fused aggregation-combination kernel), and
stitched outputs must be **bit-identical** (``np.array_equal``) to the
monolithic per-graph fallback and within ``CLOSE_TOL`` of the monolith
on the eager tier.  Full runs commit
``experiments/benchmarks_torch/serve_gnn_giant.json`` and guard the
wall-clock win at ``GIANT_SPEEDUP_FLOOR`` x; ``--smoke`` serves two smaller
beyond-capacity graphs with the same bit-identity checks.

Every lane is ``measure_*`` (the run and its correctness guards, which
raise at once) and ``run_*`` (``measure_*``, then on full runs the
evidence JSON, each speed guard's value beside its limit and whether it
was met, and only then the speed guards): a miss still leaves the
numbers behind, and a missed guard exits non-zero.
"""
from __future__ import annotations

import os
import shutil
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

import repro_torch
from repro_torch.core import GNNLayerWorkload
from repro_torch.core.schedule import ModelSchedule
from repro_torch.device import resolve_device, worker_devices
from repro_torch.graphs import TABLE4, BucketPolicy, CSRGraph, from_edges
from repro_torch.graphs.datasets import make_graph
from repro_torch.kernels.common import nvcc_starts
from repro_torch.runtime import (
    FaultInjector,
    FaultRule,
    InferenceEngine,
    ProgramStore,
    Request,
    RetryPolicy,
)

from .common import emit, kernel_launches, launches_since, save_json, sync

DIMS = [(32, 16), (16, 8)]  # 2-layer GCN, Kipf-style widths
MIX = ("mutag", "imdb-bin")  # molecules + ego nets (paper Table 4)
#: the engine's cold cost is nearly fixed (per-bucket mapper searches +
#: one executable build per bucket shape) while naive serving scales
#: linearly, so the stream must be long enough to amortize cold start the
#: way real serving does.
N_FULL = 1000
N_SMOKE = 64
SPEEDUP_FLOOR = 10.0
SEED = 0
#: every lane serves on the kernel tier: the hand-written kernels on the
#: card (their plain versions on a CPU device), never the eager tier.
USE_KERNELS = True
#: where two runs may sum in different orders: the kernel tier against
#: the eager tier (``use_pallas=False``: plain PyTorch, no hand-written
#: kernel) on the same params and requests, or a traffic-warmed engine
#: against a precompiled one.  The lanes' other checks compare the kernel
#: tier with itself (the naive loops run the same kernels).
CLOSE_TOL = dict(rtol=2e-4, atol=2e-4)
#: the persistent store directory's environment variable (the port's own,
#: so a reference store and a port store never share a directory).
STORE_ENV = "REPRO_TORCH_STORE_DIR"


def make_stream(n: int, seed: int = SEED) -> list[Request]:
    """A seeded request stream alternating molecule / ego-net structure."""
    rng = np.random.default_rng(seed)
    f_in = DIMS[0][0]
    reqs = []
    for i in range(n):
        spec = TABLE4[MIX[i % len(MIX)]]
        g = make_graph(spec, rng)
        x = rng.normal(size=(g.n_nodes, f_in)).astype(np.float32)
        reqs.append(Request(graph=g, x=x, rid=i))
    return reqs


def init_params(engine: InferenceEngine, seed: int = 0):
    """The lanes' weights: the engine's init from a seeded generator."""
    return engine.init(torch.Generator().manual_seed(seed))


def check_top_tier(results, engine: InferenceEngine, what: str) -> None:
    """No hidden fallback: every result ``ok`` on the engine's top tier,
    and no micro-batch left it."""
    top = engine.ladder[0].name
    for r in results:
        if not (r.status == "ok" and r.tier == top):
            raise RuntimeError(
                f"{what}: rid {r.rid} ended {r.status} on {r.tier} "
                f"({r.error}); expected ok on {top}"
            )
    if engine.stats().n_downgrades:
        raise RuntimeError(
            f"{what}: {engine.stats().n_downgrades} downgrades"
        )


def hold_close(got, want, what: str) -> float:
    """Hold each output of ``got`` against ``want``'s at ``CLOSE_TOL``
    (same shape, no NaN); returns the largest |difference|."""
    worst = 0.0
    for i, (a, b) in enumerate(zip(got, want, strict=True)):
        a, b = np.asarray(a), np.asarray(b)
        if a.shape != b.shape:
            raise RuntimeError(f"{what}: output {i} is {a.shape}, not {b.shape}")
        if not np.allclose(a, b, **CLOSE_TOL):
            raise RuntimeError(
                f"{what}: output {i} differs by {np.abs(a - b).max():.3e}, "
                f"beyond rtol {CLOSE_TOL['rtol']:g}, atol {CLOSE_TOL['atol']:g}"
            )
        worst = max(worst, float(np.abs(a - b).max()))
    return worst


def naive_serve(requests, params, schedule: ModelSchedule, device):
    """The loop the engine replaces: per-request compile (schedule given —
    no mapper search, conservatively cheap) + bind + run + mean readout.
    Every request builds its own executable; nothing is shared."""
    outs = []
    t0 = time.perf_counter()
    for req in requests:
        wls = [
            GNNLayerWorkload(req.graph.nnz, fi, fo, name=f"layer{i}")
            for i, (fi, fo) in enumerate(DIMS)
        ]
        prog = repro_torch.compile(wls, graph=req.graph, schedule=schedule,
                                   use_pallas=USE_KERNELS, device=device)
        logits = prog.run(params, req.x)
        outs.append(logits.cpu().numpy().mean(axis=0))
    sync(device)
    return outs, time.perf_counter() - t0


def serve_stream(requests, device, params=None, use_pallas=USE_KERNELS):
    """One engine of the plain lane's configuration, its weights (seeded
    unless given) and its results on ``requests``."""
    engine = InferenceEngine(
        DIMS, params, policy=BucketPolicy(max_graphs=64), readout="mean",
        use_pallas=use_pallas, device=device,
    )
    if params is None:
        params = init_params(engine)
    return engine, params, engine.submit(requests)


def _guard(key: str, value: float, limit: float, kind: str, message: str,
           enforced: bool = True) -> dict:
    """A lane's speed guard: ``value`` against a ``floor`` (>=) or a
    ``ceiling`` (<=), and the message its miss raises."""
    met = value >= limit if kind == "floor" else value <= limit
    return {"key": key, "value": value, kind: limit, "met": met,
            "enforced": enforced, "message": message}


def _finish(name: str, smoke: bool, rows, payload: dict, guards: list):
    """Full runs write the evidence JSON (each guard's value beside its
    limit and whether it was met), then raise on a missed guard: the
    guard runs after the evidence lands, so a miss still leaves the
    numbers behind for diagnosis."""
    if not smoke:
        save_json(name, {**payload, "guards": [
            {k: v for k, v in g.items() if k != "message"} for g in guards]})
        missed = [g["message"] for g in guards if g["enforced"] and not g["met"]]
        if missed:
            raise RuntimeError("; ".join(missed))
    return rows


def run(smoke: bool = False, device=None):
    return _finish("serve_gnn", smoke, *measure(smoke, device))


def measure(smoke: bool = False, device=None):
    """The plain lane: ``(rows, evidence, speed guards)``; raises on a
    correctness guard."""
    dev = resolve_device(device)
    n = N_SMOKE if smoke else N_FULL
    requests = make_stream(n)
    launches0 = kernel_launches()

    traces_before = repro_torch.trace_count()
    engine, params, results = serve_stream(requests, dev)
    stats = engine.stats()
    cold_traces = repro_torch.trace_count() - traces_before
    check_top_tier(results, engine, "serve")

    # steady state: re-serving the same-shaped stream must hit only cached
    # programs and build nothing
    sync(dev)
    warm_engine_start = time.perf_counter()
    traces_before = repro_torch.trace_count()
    again = engine.submit(requests)
    sync(dev)
    warm_s = time.perf_counter() - warm_engine_start
    warm_traces = repro_torch.trace_count() - traces_before
    if warm_traces != 0:
        raise RuntimeError(
            f"serve: warm stream took {warm_traces} new traces; the "
            f"program cache must make steady-state serving trace-free"
        )
    check_top_tier(again, engine, "serve (warm)")

    # naive per-graph serving on the same (cold) stream; smoke mode only
    # checks parity on a slice so the lane stays fast
    naive_reqs = requests[: 8 if smoke else n]
    schedule = ModelSchedule.from_policies("sp_opt", "AC", DIMS)
    naive_outs, naive_s = naive_serve(naive_reqs, params, schedule, dev)

    diffs = [
        float(np.abs(results[i].output - naive_outs[i]).max())
        for i in range(len(naive_reqs))
    ]
    parity = max(diffs)
    if parity > 1e-5:
        raise RuntimeError(
            f"serve: engine vs per-graph outputs differ by {parity:.2e}"
        )

    # the whole stream on the eager tier with the same params: the naive
    # loop runs the same kernels as the engine, so this alone holds them
    eager_engine, _, eager_results = serve_stream(requests, dev, params,
                                                  use_pallas=False)
    check_top_tier(eager_results, eager_engine, "serve (eager tier)")
    if [r.rid for r in eager_results] != [r.rid for r in results]:
        raise RuntimeError("serve: the eager tier answered other requests")
    eager_diff = hold_close([r.output for r in results],
                            [r.output for r in eager_results],
                            "serve: kernel tier vs eager tier")

    engine_us = stats.wall_s / n * 1e6
    warm_us = warm_s / n * 1e6
    naive_us = naive_s / len(naive_reqs) * 1e6
    speedup = naive_us / engine_us
    launches = launches_since(launches0)
    rows = [
        ("serve/engine", engine_us,
         f"graphs_per_sec={stats.graphs_per_sec:.1f};p50_ms={stats.p50_ms:.1f};"
         f"p99_ms={stats.p99_ms:.1f};buckets={stats.n_buckets};"
         f"batches={stats.n_batches};traces={cold_traces}"),
        ("serve/engine_warm", warm_us,
         f"graphs_per_sec={n / warm_s:.1f};traces={warm_traces}"),
        ("serve/naive", naive_us,
         f"graphs_per_sec={1e6 / naive_us:.1f};n={len(naive_reqs)}"),
        ("serve/speedup", 0.0,
         f"x{speedup:.1f};parity={parity:.1e};eager={eager_diff:.1e}"),
    ]

    payload = {
        "stream": {
            "n_requests": n,
            "mix": list(MIX),
            "dims": [list(d) for d in DIMS],
            "seed": SEED,
            "lane_device": str(dev),
            "use_pallas": USE_KERNELS,
        },
        "engine": {
            **stats.as_dict(),
            "us_per_request": engine_us,
            "cold_traces": cold_traces,
            "warm_wall_s": warm_s,
            "warm_us_per_request": warm_us,
            "warm_traces": warm_traces,
            "warm_graphs_per_sec": n / warm_s,
        },
        "naive": {
            "n_requests": len(naive_reqs),
            "wall_s": naive_s,
            "us_per_request": naive_us,
            "graphs_per_sec": 1e6 / naive_us,
        },
        "speedup": speedup,
        "speedup_floor": SPEEDUP_FLOOR,
        "parity_max_abs_diff": parity,
        "eager_hold": {"n_requests": n, "max_abs_diff": eager_diff,
                       "tol": CLOSE_TOL},
        "launches": launches,
    }
    guards = [_guard(
        "speedup", speedup, SPEEDUP_FLOOR, "floor",
        f"serve: bucketized engine only {speedup:.1f}x faster than "
        f"naive per-graph compile+run (floor {SPEEDUP_FLOOR:.0f}x)")]
    return rows, payload, guards


# -- chaos lane --------------------------------------------------------------
#: 10% of the stream is poisoned (one request in CHAOS_FAULT_EVERY, the
#: five fault classes in rotation), mirroring the fault-injection tests at
#: benchmark scale.
N_CHAOS = 1000
N_CHAOS_SMOKE = 100
CHAOS_FAULT_EVERY = 10
#: healthy synthetic graphs top out around 32 nodes (Table 4 mutag /
#: imdb-bin structure), so a 128-node admission cap only ever rejects the
#: injected oversized graphs.
CHAOS_MAX_NODES = 128
CHAOS_OVERSIZED_NODES = 200
#: wall-clock ceiling for the chaos stream vs the fault-free run of the
#: same healthy requests: quarantine solo re-runs and ladder retries may
#: cost work, but isolation must not collapse throughput.
CHAOS_SLOWDOWN_CEIL = 5.0

CHAOS_CLASSES = ("nan_features", "float64_features", "broken_csr",
                 "oversized", "kernel_fault")


def _oversized_request(rid: int, rng: np.random.Generator) -> Request:
    """A ring graph far over the admission cap (rejected before compile)."""
    n = CHAOS_OVERSIZED_NODES
    src, dst = np.arange(n), (np.arange(n) + 1) % n
    g = from_edges(n, np.concatenate([src, dst]), np.concatenate([dst, src]))
    x = rng.normal(size=(n, DIMS[0][0])).astype(np.float32)
    return Request(graph=g, x=x, rid=rid)


def make_chaos_stream(n: int, seed: int = SEED):
    """The healthy stream with every CHAOS_FAULT_EVERY-th request poisoned.

    Returns ``(requests, kernel_rids, class_counts)`` — ``kernel_rids``
    need sticky injector rules; the other classes are malformed payloads.
    """
    rng = np.random.default_rng(seed + 1)
    requests = []
    kernel_rids: list[int] = []
    counts = {c: 0 for c in CHAOS_CLASSES}
    for req in make_stream(n, seed):
        rid = req.rid
        if rid % CHAOS_FAULT_EVERY != 0:
            requests.append(req)
            continue
        cls = CHAOS_CLASSES[(rid // CHAOS_FAULT_EVERY) % len(CHAOS_CLASSES)]
        counts[cls] += 1
        if cls == "nan_features":
            x = np.array(req.x, copy=True)
            x[0, 0] = np.nan
            req = Request(graph=req.graph, x=x, rid=rid)
        elif cls == "float64_features":
            req = Request(graph=req.graph, x=req.x.astype(np.float64), rid=rid)
        elif cls == "broken_csr":
            ci = np.array(req.graph.col_idx, copy=True)
            ci[0] = req.graph.n_nodes + 7  # dangling edge target
            req = Request(
                graph=CSRGraph(req.graph.row_ptr, ci, req.graph.values,
                               req.graph.n_nodes),
                x=req.x, rid=rid,
            )
        elif cls == "oversized":
            req = _oversized_request(rid, rng)
        else:  # kernel_fault: payload is healthy, the injector poisons it
            kernel_rids.append(rid)
        requests.append(req)
    return requests, kernel_rids, counts


def serve_chaos(n: int, device):
    """The chaos stream through an injected engine: ``(requests, poisoned
    rids, kernel rids, class counts, injector, engine, params, results)``."""
    requests, kernel_rids, class_counts = make_chaos_stream(n)
    poisoned = {r.rid for r in requests if r.rid % CHAOS_FAULT_EVERY == 0}
    injector = FaultInjector(
        seed=SEED,
        rules=[FaultRule(kind="exception", rid=r) for r in kernel_rids],
    )
    engine = InferenceEngine(
        DIMS,
        policy=BucketPolicy(max_graphs=64, max_nodes=CHAOS_MAX_NODES),
        readout="mean",
        fault_injector=injector,
        retry=RetryPolicy(max_retries=1),
        use_pallas=USE_KERNELS,
        device=device,
    )
    params = init_params(engine)
    # reaching the next statement at all IS the headline claim: submit()
    # never raises for a per-request cause, whatever the mix throws at it
    results = engine.submit(requests)
    return (requests, poisoned, kernel_rids, class_counts, injector, engine,
            params, results)


def run_chaos(smoke: bool = False, device=None):
    return _finish("serve_gnn_chaos", smoke, *measure_chaos(smoke, device))


def measure_chaos(smoke: bool = False, device=None):
    """The fault-isolation lane: seeded 10% fault mix through an injected
    engine, checked against a fault-free run of the same healthy stream;
    ``(rows, evidence, speed guards)``."""
    dev = resolve_device(device)
    n = N_CHAOS_SMOKE if smoke else N_CHAOS
    launches0 = kernel_launches()
    (requests, poisoned, kernel_rids, class_counts, injector, engine, params,
     results) = serve_chaos(n, dev)
    stats = engine.stats()
    policy = engine.policy
    top = engine.ladder[0].name

    by_status: dict[str, int] = {}
    for res in results:
        by_status[res.status] = by_status.get(res.status, 0) + 1
        if not res.ok and res.error_type is None:
            raise RuntimeError(
                f"chaos: rid {res.rid} ended {res.status} without a typed "
                f"error cause"
            )
        if res.rid not in poisoned and not (res.status == "ok"
                                            and res.tier == top):
            raise RuntimeError(
                f"chaos: healthy rid {res.rid} ended {res.status} on "
                f"{res.tier}; expected ok on {top}"
            )
    n_kernel = len(kernel_rids)
    n_rejected_exp = len(poisoned) - n_kernel
    if by_status.get("failed", 0) != n_kernel:
        raise RuntimeError(
            f"chaos: {by_status.get('failed', 0)} failed requests, expected "
            f"exactly the {n_kernel} kernel-poisoned rids"
        )
    if by_status.get("rejected", 0) != n_rejected_exp:
        raise RuntimeError(
            f"chaos: {by_status.get('rejected', 0)} rejected requests, "
            f"expected {n_rejected_exp} (malformed + oversized)"
        )
    healthy_ok = by_status.get("ok", 0) + by_status.get("degraded", 0)
    if healthy_ok != n - len(poisoned):
        raise RuntimeError(
            f"chaos: {healthy_ok} healthy completions of {n - len(poisoned)} "
            f"healthy requests — isolation leaked onto healthy neighbors"
        )
    if stats.n_downgrades:
        raise RuntimeError(
            f"chaos: {stats.n_downgrades} micro-batches served below the "
            f"top tier"
        )

    # fault-free reference over the same healthy requests: outputs must be
    # bit-identical (block-diagonal batching computes graphs independently,
    # so neither quarantine solo re-runs nor batch composition may change
    # a healthy answer)
    healthy_reqs = [r for r in requests if r.rid not in poisoned]
    ref_engine = InferenceEngine(
        DIMS, params, policy=policy, readout="mean",
        retry=RetryPolicy(max_retries=1), use_pallas=USE_KERNELS, device=dev,
    )
    ref_results = ref_engine.submit(healthy_reqs)
    check_top_tier(ref_results, ref_engine, "chaos fault-free reference")
    ref = {res.rid: res for res in ref_results}
    ref_stats = ref_engine.stats()
    n_compared = 0
    for res in results:
        if res.rid in poisoned:
            continue
        if not np.array_equal(res.output, ref[res.rid].output):
            raise RuntimeError(
                f"chaos: rid {res.rid} output differs from the fault-free "
                f"run — healthy answers must be bit-identical under chaos"
            )
        n_compared += 1

    slowdown = stats.wall_s / ref_stats.wall_s if ref_stats.wall_s > 0 else 1.0
    chaos_us = stats.wall_s / n * 1e6
    rows = [
        ("serve/chaos", chaos_us,
         f"ok={by_status.get('ok', 0)};rejected={by_status.get('rejected', 0)};"
         f"failed={by_status.get('failed', 0)};"
         f"degraded={by_status.get('degraded', 0)};"
         f"solo_retries={stats.n_solo_retries};retries={stats.n_retries};"
         f"bit_identical={n_compared};slowdown=x{slowdown:.2f}"),
    ]

    payload = {
        "stream": {
            "n_requests": n,
            "fault_every": CHAOS_FAULT_EVERY,
            "n_poisoned": len(poisoned),
            "classes": class_counts,
            "mix": list(MIX),
            "dims": [list(d) for d in DIMS],
            "seed": SEED,
            "max_nodes_cap": CHAOS_MAX_NODES,
            "lane_device": str(dev),
            "use_pallas": USE_KERNELS,
        },
        "engine": stats.as_dict(),
        "statuses": by_status,
        "injected": injector.counts(),
        "escaped_exceptions": 0,  # submit() returned; nothing escaped
        "healthy": {
            "n": n - len(poisoned),
            "n_served": healthy_ok,
            "n_bit_identical": n_compared,
        },
        "reference": {
            "wall_s": ref_stats.wall_s,
            "graphs_per_sec": ref_stats.graphs_per_sec,
        },
        "slowdown_vs_fault_free": slowdown,
        "slowdown_ceiling": CHAOS_SLOWDOWN_CEIL,
        "launches": launches_since(launches0),
    }
    guards = [_guard(
        "slowdown_vs_fault_free", slowdown, CHAOS_SLOWDOWN_CEIL, "ceiling",
        f"chaos: fault isolation cost x{slowdown:.2f} wall-clock vs "
        f"fault-free (ceiling x{CHAOS_SLOWDOWN_CEIL:.1f})")]
    return rows, payload, guards


# -- restart lane ------------------------------------------------------------
N_RESTART = 1000
N_RESTART_SMOKE = 64
#: first-request latency ceiling for a revived engine with a warm store:
#: warm-path speed (vs the cold p99), guarded on full runs against a store
#: that actually started cold.
RESTART_FIRST_MS_CEIL = 20.0
RESTART_SPEEDUP_FLOOR = 10.0


def _store_root() -> tuple[Path, bool]:
    """The store directory: ``REPRO_TORCH_STORE_DIR`` when set, else a
    throwaway temp dir so full runs always measure a genuinely cold
    start."""
    env = os.environ.get(STORE_ENV)
    if env:
        return Path(env).expanduser(), False
    return Path(tempfile.mkdtemp(prefix="repro-torch-store-")), True


def _serve_split(engine, requests):
    """First request solo, rest in bulk — the realistic arrival pattern,
    and it makes first-request latency a clean cold/warm probe (the solo
    micro-batch's shapes land in the traffic profile, so a revived
    engine's precompile warms exactly what the first arrival needs)."""
    return engine.submit(requests[:1]) + engine.submit(requests[1:])


def run_restart(smoke: bool = False, device=None):
    return _finish("serve_gnn_restart", smoke, *measure_restart(smoke, device))


def measure_restart(smoke: bool = False, device=None):
    """The zero-cold-start lane: serve -> kill -> revive -> serve again.

    Phase 1 streams into a fresh engine backed by a ProgramStore (the
    kernel cache underneath).  Phase 2 builds a new engine — new
    Programs, new executables, nothing of the engine survives except what
    the store holds — precompiles from the recorded traffic profile, and
    must serve its first request with zero mapper searches, zero new
    executable builds and no ``nvcc`` started, at warm-path latency.
    Phase 3 corrupts every stored artifact and proves the store degrades
    to a recompile.  Returns ``(rows, evidence, speed guards)``; the
    guards are enforced only where the store really started cold (a
    pre-warmed ``REPRO_TORCH_STORE_DIR`` makes the cold phase warm).
    """
    from repro_torch.kernels.common import set_build_dir

    dev = resolve_device(device)
    n = N_RESTART_SMOKE if smoke else N_RESTART
    requests = make_stream(n)
    root, is_temp = _store_root()
    policy = BucketPolicy(max_graphs=64)
    launches0 = kernel_launches()

    def engine_on(store, params=None):
        return InferenceEngine(DIMS, params, policy=policy, readout="mean",
                               store=store, use_pallas=USE_KERNELS,
                               device=dev)

    try:
        store = ProgramStore(root, kernel_cache=True)
        store_was_cold = len(store) == 0

        # -- phase 1: cold process ------------------------------------------
        engine = engine_on(store)
        params = init_params(engine)
        tc0 = repro_torch.trace_count()
        cold_results = _serve_split(engine, requests)
        cold_stats = engine.stats()
        cold_traces = repro_torch.trace_count() - tc0
        cold_first_ms = cold_results[0].latency_s * 1e3
        check_top_tier(cold_results, engine, "restart (cold)")

        # -- phase 2: kill + revive -----------------------------------------
        nvcc0 = nvcc_starts()
        revived = engine_on(ProgramStore(root, kernel_cache=True), params)
        rep = revived.precompile()
        if rep.n_searches != 0:
            raise RuntimeError(
                f"restart: precompile ran {rep.n_searches} mapper searches; "
                f"a warm store must satisfy every bucket"
            )
        tb = repro_torch.trace_count()
        first = revived.submit(requests[:1])
        first_ms = first[0].latency_s * 1e3
        first_traces = repro_torch.trace_count() - tb
        if not first[0].ok:
            raise RuntimeError(
                f"restart: revived first request ended {first[0].status}: "
                f"{first[0].error}"
            )
        if first_traces != 0 or revived.stats().n_searches != 0:
            raise RuntimeError(
                f"restart: revived first request took {first_traces} new "
                f"traces and {revived.stats().n_searches} mapper searches; "
                f"precompile must leave the request path trace-free"
            )
        rest = revived.submit(requests[1:])
        warm_traces = repro_torch.trace_count() - tb
        if warm_traces != 0:
            raise RuntimeError(
                f"restart: revived stream took {warm_traces} new traces; "
                f"the recorded traffic profile must cover every shape"
            )
        revival_nvcc = nvcc_starts() - nvcc0
        if revival_nvcc != 0:
            raise RuntimeError(
                f"restart: the revival started {revival_nvcc} nvcc builds; "
                f"the store's kernel cache must hold every library"
            )
        revived_results = first + rest
        check_top_tier(revived_results, revived, "restart (revived)")
        n_identical = sum(
            int(np.array_equal(c.output, r.output))
            for c, r in zip(cold_results, revived_results)
        )
        if n_identical != n:
            raise RuntimeError(
                f"restart: only {n_identical}/{n} outputs bit-identical "
                f"across the restart"
            )
        revived_stats = revived.stats()
        kernel_libs = sorted(p.name for p in (root / "kernels").glob("*.so"))

        # -- phase 3: corruption drill --------------------------------------
        for art in sorted(root.glob("*.program.json")):
            art.write_text("{ not a program artifact")
        drill_store = ProgramStore(root, kernel_cache=True)
        drill = engine_on(drill_store, params)
        drill_res = drill.submit(requests[:1])  # must recompile, not raise
        if not drill_res[0].ok:
            raise RuntimeError(
                f"restart: corrupted store ended the request "
                f"{drill_res[0].status} ({drill_res[0].error}); corruption "
                f"must degrade to a recompile"
            )
        if drill_store.corrupt == 0:
            raise RuntimeError(
                "restart: the drill never saw a corrupt artifact — the "
                "corruption injection missed the request's keys"
            )
        if not np.array_equal(drill_res[0].output, cold_results[0].output):
            raise RuntimeError(
                "restart: recompiled-after-corruption output differs from "
                "the cold run"
            )

        speedup = cold_first_ms / max(first_ms, 1e-9)
        rows = [
            ("serve/restart_cold", cold_stats.wall_s / n * 1e6,
             f"first_ms={cold_first_ms:.1f};p99_ms={cold_stats.p99_ms:.1f};"
             f"search_s={cold_stats.search_s:.2f};"
             f"trace_s={cold_stats.trace_s:.2f};traces={cold_traces};"
             f"store_cold={store_was_cold}"),
            ("serve/restart_precompile", rep.wall_s * 1e6,
             f"shapes={rep.n_shapes};store_hits={rep.n_store_hits};"
             f"compiled={rep.n_compiled};searches={rep.n_searches};"
             f"traces={rep.n_traces}"),
            ("serve/restart_revived", revived_stats.wall_s / n * 1e6,
             f"first_ms={first_ms:.2f};first_traces={first_traces};"
             f"searches={revived_stats.n_searches};"
             f"store_hits={revived_stats.store_hits};"
             f"nvcc={revival_nvcc};bit_identical={n_identical}"),
            ("serve/restart_speedup", 0.0,
             f"x{speedup:.1f};corrupt_recovered={drill_store.corrupt}"),
        ]

        payload = {
            "stream": {
                "n_requests": n,
                "mix": list(MIX),
                "dims": [list(d) for d in DIMS],
                "seed": SEED,
                "lane_device": str(dev),
                "use_pallas": USE_KERNELS,
            },
            "store": {
                "was_cold": store_was_cold,
                "kernel_libraries": kernel_libs,
                **drill_store.stats(),
            },
            "cold": {
                **cold_stats.as_dict(),
                "first_request_ms": cold_first_ms,
                "traces": cold_traces,
            },
            "precompile": rep.as_dict(),
            "revived": {
                **revived_stats.as_dict(),
                "first_request_ms": first_ms,
                "first_request_traces": first_traces,
                "stream_traces": warm_traces,
                "nvcc_started": revival_nvcc,
                "us_per_request": revived_stats.wall_s / n * 1e6,
                "n_bit_identical": n_identical,
            },
            "corruption_drill": {
                "artifacts_corrupted": True,
                "served_ok": bool(drill_res[0].ok),
                "corrupt_detected": drill_store.corrupt,
                "recompiles": drill.stats().n_searches,
            },
            "cold_start_speedup": speedup,
            "first_ms_ceiling": RESTART_FIRST_MS_CEIL,
            "speedup_floor": RESTART_SPEEDUP_FLOOR,
            "launches": launches_since(launches0),
        }
        guards = [
            _guard("first_request_ms", first_ms, RESTART_FIRST_MS_CEIL,
                   "ceiling",
                   f"restart: revived first request took {first_ms:.1f} "
                   f"ms (ceiling {RESTART_FIRST_MS_CEIL:.0f} ms)",
                   enforced=store_was_cold),
            _guard("cold_start_speedup", speedup, RESTART_SPEEDUP_FLOOR,
                   "floor",
                   f"restart: only x{speedup:.1f} cold-start speedup "
                   f"(floor x{RESTART_SPEEDUP_FLOOR:.0f})",
                   enforced=store_was_cold),
        ]
        return rows, payload, guards
    finally:
        if is_temp:
            shutil.rmtree(root, ignore_errors=True)
            set_build_dir()  # the store's kernel directory is gone


# -- async lane --------------------------------------------------------------
N_ASYNC = 600
N_ASYNC_SMOKE = 48
N_ASYNC_PACED = 200
N_ASYNC_PACED_SMOKE = 24
ASYNC_WINDOW_MS = 20.0
#: blast throughput floor vs the per-arrival sync front-end.
ASYNC_SPEEDUP_FLOOR = 1.5
#: paced-phase per-request p99 ceiling, as a multiple of window_ms: an
#: in-window request waits at most its window plus one micro-batch.
ASYNC_P99_WINDOW_FACTOR = 2.0
#: paced arrival spacing — well under capacity, so every request is
#: in-window by construction.
ASYNC_PACE_S = 0.004


def run_async(smoke: bool = False, device=None):
    return _finish("serve_gnn_async", smoke, *measure_async(smoke, device))


def measure_async(smoke: bool = False, device=None):
    """The continuous-batching lane: AsyncEngine over a worker list vs
    the per-arrival sync front-end it replaces.

    Phase 1 (blast): every request enqueued as fast as the front-end
    accepts it; windows fill to ``max_graphs`` and flush across workers.
    Phase 2 (paced): sub-capacity arrivals every ``ASYNC_PACE_S`` so each
    request's latency is its window wait plus one micro-batch — p99 must
    track ``window_ms``, not whole-batch wall.  Outputs are checked
    bit-identical to the single-worker sync engine precompiled on the same
    profile, and within ``CLOSE_TOL`` of a sync engine warmed by traffic
    alone (its bitwise agreement reported).  Returns
    ``(rows, evidence, speed guards)``.
    """
    from repro_torch.graphs.batching import TrafficProfile
    from repro_torch.runtime import AsyncEngine

    dev = resolve_device(device)
    devices = worker_devices(dev)
    n = N_ASYNC_SMOKE if smoke else N_ASYNC
    n_paced = N_ASYNC_PACED_SMOKE if smoke else N_ASYNC_PACED
    requests = make_stream(n)
    paced_reqs = make_stream(n_paced, seed=SEED + 1)
    policy = BucketPolicy(max_graphs=64)
    launches0 = kernel_launches()

    # every pow2 slot variant of every bucket both streams can produce:
    # paced windows flush at arbitrary fill levels, and a cold build
    # mid-paced-phase would charge it to the p99-tracks-window guard
    warm_prof = TrafficProfile()
    for req in list(requests) + list(paced_reqs):
        warm_prof.record_request(policy.bucket_of(req.graph))
    for bucket in list(warm_prof.requests):
        slots = 1
        while slots <= policy.max_graphs:
            warm_prof.record_batch(bucket, slots)
            slots *= 2

    # single-worker sync reference (the engine every prior lane measures),
    # precompiled on the same profile as the async front-end: a precompiled
    # shape's schedule is searched on a synthetic batch, a shape met first
    # in traffic on the real one, and the two searches can pick different
    # dataflows (seq/AC against sp_opt/AC at these widths), whose kernels
    # sum in different orders.  With the schedules shared, the bit-identity
    # check below compares continuous batching alone.  Then warm both the
    # bulk slot shapes and the per-arrival slots=1 shapes so neither timed
    # sync pass pays a build the async engine doesn't
    sync_engine = InferenceEngine(DIMS, policy=policy, readout="mean",
                                  use_pallas=USE_KERNELS, device=dev)
    params = init_params(sync_engine)
    sync_engine.precompile(warm_prof)
    sync_engine.submit(requests)
    for req in requests:
        sync_engine.submit([req])

    # bulk-submit oracle: all n requests in one call — ideal batching no
    # real arrival process delivers; reported, not guarded against
    sync(dev)
    t0 = time.perf_counter()
    sync_results = sync_engine.submit(requests)
    sync(dev)
    sync_bulk_s = time.perf_counter() - t0
    check_top_tier(sync_results, sync_engine, "async: sync reference")

    # per-arrival sync front-end: what submit() actually does when
    # requests arrive one at a time — the baseline the async engine
    # replaces (continuous batching is exactly this gap)
    t0 = time.perf_counter()
    for req in requests:
        sync_engine.submit([req])
    sync(dev)
    sync_arrival_s = time.perf_counter() - t0

    # REPRO_TORCH_STORE_DIR persists a store: the async engine's
    # per-worker precompile then loads programs (and kernel libraries)
    # from disk.  Unset -> no store, the warm-up just costs in-process
    # builds off the clock.
    env_root = os.environ.get(STORE_ENV)
    store = (
        ProgramStore(Path(env_root).expanduser(), kernel_cache=True)
        if env_root else None
    )
    engine = AsyncEngine(
        DIMS, params, devices=devices, window_ms=ASYNC_WINDOW_MS,
        policy=policy, readout="mean", store=store, use_pallas=USE_KERNELS,
    )
    engine.start()
    try:
        # the same shapes, on each bucket's assigned worker
        engine.precompile(warm_prof)
        engine.submit(requests)  # end-to-end warm pass through the windows

        # -- phase 1: blast -------------------------------------------------
        tc0 = repro_torch.trace_count()
        t0 = time.perf_counter()
        futs = [engine.submit_async(r) for r in requests]
        async_results = [f.result() for f in futs]
        blast_s = time.perf_counter() - t0

        n_identical = sum(
            int(
                a.ok and s.ok and np.array_equal(a.output, s.output)
            )
            for a, s in zip(async_results, sync_results)
        )
        if n_identical != n:
            raise RuntimeError(
                f"async: only {n_identical}/{n} outputs bit-identical to "
                f"the single-worker sync engine"
            )

        # -- phase 2: paced (no-fault, sub-capacity, in-window) -------------
        paced_futs = []
        t0 = time.perf_counter()
        for req in paced_reqs:
            paced_futs.append(engine.submit_async(req))
            time.sleep(ASYNC_PACE_S)
        paced_results = [f.result() for f in paced_futs]
        paced_s = time.perf_counter() - t0
        timed_traces = repro_torch.trace_count() - tc0
        stats = engine.stats()
        worker_downgrades = {
            w.label: w.engine.stats().n_downgrades for w in engine.workers
        }
    finally:
        engine.close()

    if not all(r.ok for r in paced_results):
        bad = next(r for r in paced_results if not r.ok)
        raise RuntimeError(
            f"async: paced no-fault request {bad.rid} ended "
            f"{bad.status}: {bad.error}"
        )
    if stats.n_degraded or any(worker_downgrades.values()):
        raise RuntimeError(
            f"async: served below the top tier ({stats.n_degraded} degraded "
            f"results, downgrades {worker_downgrades})"
        )
    if timed_traces != 0:
        raise RuntimeError(
            f"async: the timed phases built {timed_traces} executables; "
            f"precompile must cover every shape"
        )
    # a sync engine warmed by traffic alone, as the reference lane's is: a
    # shape met first in traffic is searched on its real batch, a
    # precompiled one on a synthetic batch, and the two searches can pick
    # dataflows whose kernels sum in different orders (ROADMAP Queue 3).
    # Held at CLOSE_TOL; how many outputs agree bitwise is reported
    traffic_engine = InferenceEngine(DIMS, params, policy=policy,
                                     readout="mean", use_pallas=USE_KERNELS,
                                     device=dev)
    traffic_results = traffic_engine.submit(requests)
    check_top_tier(traffic_results, traffic_engine,
                   "async: traffic-warmed sync engine")
    traffic_diff = hold_close([r.output for r in async_results],
                              [r.output for r in traffic_results],
                              "async: blast vs the traffic-warmed sync engine")
    traffic_equal = [np.array_equal(a.output, t.output)
                     for a, t in zip(async_results, traffic_results)]
    traffic_buckets = sorted({str(a.bucket) for a, same in
                              zip(async_results, traffic_equal) if not same})

    paced_lat_ms = np.asarray(
        [r.latency_s for r in paced_results]
    ) * 1e3
    paced_p50 = float(np.percentile(paced_lat_ms, 50))
    paced_p99 = float(np.percentile(paced_lat_ms, 99))

    async_gps = n / blast_s
    arrival_gps = n / sync_arrival_s
    bulk_gps = n / sync_bulk_s
    speedup = async_gps / arrival_gps
    devices_used = sorted(
        {r.device for r in async_results if r.device is not None}
    )
    rows = [
        ("serve/async_blast", blast_s / n * 1e6,
         f"graphs_per_sec={async_gps:.1f};devices={len(devices_used)};"
         f"flushes_full={stats.n_flushes_full};"
         f"flushes_deadline={stats.n_flushes_deadline};"
         f"bit_identical={n_identical};"
         f"traffic_warmed_identical={sum(traffic_equal)}"),
        ("serve/async_paced", paced_s / n_paced * 1e6,
         f"p50_ms={paced_p50:.1f};p99_ms={paced_p99:.1f};"
         f"window_ms={ASYNC_WINDOW_MS:.0f};pace_ms={ASYNC_PACE_S * 1e3:.0f}"),
        ("serve/sync_per_arrival", sync_arrival_s / n * 1e6,
         f"graphs_per_sec={arrival_gps:.1f}"),
        ("serve/sync_bulk_oracle", sync_bulk_s / n * 1e6,
         f"graphs_per_sec={bulk_gps:.1f}"),
        ("serve/async_speedup", 0.0,
         f"x{speedup:.1f}_vs_per_arrival;x{async_gps / bulk_gps:.2f}"
         f"_vs_bulk_oracle"),
    ]

    payload = {
        "stream": {
            "n_requests": n,
            "n_paced": n_paced,
            "mix": list(MIX),
            "dims": [list(d) for d in DIMS],
            "seed": SEED,
            "lane_device": str(dev),
            "use_pallas": USE_KERNELS,
        },
        "mesh": {
            "n_workers": len(devices),
            "n_devices": len(set(devices)),
            "workers": list(engine.labels),
            "devices_used": devices_used,
            "placement": stats.placement,
            "note": (
                "two workers on one device run on two CUDA streams of "
                "that card (two threads on a CPU device); with two or "
                "more cards, one worker a card"
            ),
        },
        "async": {
            **stats.as_dict(),
            "window_ms": ASYNC_WINDOW_MS,
            "blast_wall_s": blast_s,
            "blast_graphs_per_sec": async_gps,
            "paced": {
                "n": n_paced,
                "pace_s": ASYNC_PACE_S,
                "wall_s": paced_s,
                "p50_ms": paced_p50,
                "p99_ms": paced_p99,
            },
        },
        "sync": {
            "per_arrival_wall_s": sync_arrival_s,
            "per_arrival_graphs_per_sec": arrival_gps,
            "bulk_oracle_wall_s": sync_bulk_s,
            "bulk_oracle_graphs_per_sec": bulk_gps,
        },
        "n_bit_identical": n_identical,
        "traffic_warmed_sync": {
            "n_bit_identical": sum(traffic_equal),
            "max_abs_diff": traffic_diff,
            "tol": CLOSE_TOL,
            "buckets_differing": traffic_buckets,
        },
        "throughput_speedup_vs_per_arrival": speedup,
        "speedup_floor": ASYNC_SPEEDUP_FLOOR,
        "p99_window_factor": paced_p99 / ASYNC_WINDOW_MS,
        "p99_window_factor_ceiling": ASYNC_P99_WINDOW_FACTOR,
        "launches": launches_since(launches0),
    }
    guards = [
        _guard("throughput_speedup_vs_per_arrival", speedup,
               ASYNC_SPEEDUP_FLOOR, "floor",
               f"async: only x{speedup:.2f} throughput vs the per-arrival "
               f"sync engine (floor x{ASYNC_SPEEDUP_FLOOR:.1f})"),
        _guard("p99_window_factor", paced_p99 / ASYNC_WINDOW_MS,
               ASYNC_P99_WINDOW_FACTOR, "ceiling",
               f"async: paced p99 {paced_p99:.1f} ms does not track the "
               f"{ASYNC_WINDOW_MS:.0f} ms batching window (ceiling "
               f"{ASYNC_P99_WINDOW_FACTOR:.0f}x)"),
    ]
    return rows, payload, guards


# -- giant lane --------------------------------------------------------------
#: banded giant graphs at distinct sizes spanning several pow2 buckets, so
#: the monolithic fallback builds one executable per shape while the
#: partitioned lane reuses a single closure-bucket Program for everything.
GIANT_SIZES = (5000, 6500, 8000, 9500, 11000, 13000)
GIANT_SIZES_SMOKE = (3000, 4200)
#: modeled global-buffer capacity: every giant graph's staged V x F
#: intermediate (V * 32 * 4 bytes) exceeds it, so admission routes the
#: whole stream to the partitioned lane.
GIANT_CAP_BYTES = 256 * 1024
GIANT_MAX_NODES = 2048  # admission cap == the closure bucket's ceiling
GIANT_SPEEDUP_FLOOR = 1.5
GIANT_SCHEDULE = ModelSchedule.from_policies("sp_opt", "AC", DIMS)


def make_giant_stream(sizes, seed: int = SEED) -> list[Request]:
    """Banded (ring +/-1) giant graphs: tiny halos, honest row_stream win."""
    rng = np.random.default_rng(seed)
    reqs = []
    for i, v in enumerate(sizes):
        rows = np.repeat(np.arange(v), 2)
        cols = (rows + np.tile(np.array([-1, 1]), v)) % v
        g = from_edges(v, rows, cols)
        x = rng.normal(size=(v, DIMS[0][0])).astype(np.float32)
        reqs.append(Request(graph=g, x=x, rid=i))
    return reqs


def _naive_giant(requests, params, schedule: ModelSchedule, device,
                 use_pallas=USE_KERNELS):
    """The monolithic fallback the partitioned lane replaces: compile the
    whole beyond-capacity graph as one Program per request (schedule given
    for free) and run it.  Every distinct V builds its own executable."""
    outs = []
    t0 = time.perf_counter()
    for req in requests:
        wls = [
            GNNLayerWorkload(req.graph.nnz, fi, fo, name=f"layer{i}")
            for i, (fi, fo) in enumerate(DIMS)
        ]
        prog = repro_torch.compile(wls, graph=req.graph, schedule=schedule,
                                   use_pallas=use_pallas, device=device)
        logits = prog.run(params, req.x)
        outs.append(logits.cpu().numpy())
    sync(device)
    return outs, time.perf_counter() - t0


def run_giant(smoke: bool = False, device=None):
    return _finish("serve_gnn_giant", smoke, *measure_giant(smoke, device))


def measure_giant(smoke: bool = False, device=None):
    """The beyond-capacity lane: spill-model-planned partitioned serving
    vs the monolithic per-graph fallback, bit-identical outputs.

    Every request's staged intermediate exceeds the modeled
    ``gb_capacity_bytes``, so a plain engine would reject it and the only
    alternative is one monolithic compile+run per graph.  The partitioned
    engine instead plans once per bucket (``plan_partition`` under the
    ``edp`` objective), streams L-hop halo closures through a single
    shared closure-bucket Program, and stitches ``[:n_own]`` slices —
    outputs must be **bit-identical** to the monolithic fallback
    (``np.array_equal``), and the full lane guards the wall-clock win at
    ``GIANT_SPEEDUP_FLOOR`` x after the evidence JSON lands.  Returns
    ``(rows, evidence, speed guards)``.
    """
    import dataclasses

    from repro_torch.core.hw import DEFAULT_ACCEL
    from repro_torch.graphs.partition import plan_partition

    dev = resolve_device(device)
    sizes = GIANT_SIZES_SMOKE if smoke else GIANT_SIZES
    n = len(sizes)
    requests = make_giant_stream(sizes)
    hw = dataclasses.replace(DEFAULT_ACCEL, gb_capacity_bytes=GIANT_CAP_BYTES)
    policy = BucketPolicy(max_nodes=GIANT_MAX_NODES)
    launches0 = kernel_launches()

    env_root = os.environ.get(STORE_ENV)
    store = (
        ProgramStore(Path(env_root).expanduser(), kernel_cache=True)
        if env_root else None
    )
    engine = InferenceEngine(
        DIMS,
        policy=policy,
        hw=hw,
        schedule=GIANT_SCHEDULE,
        objective="edp",
        partition_oversized=True,
        readout=None,
        store=store,
        use_pallas=USE_KERNELS,
        device=dev,
    )
    params = init_params(engine)

    # a plain engine under the same capacity rejects the whole stream —
    # that's the gap this lane closes
    plain = InferenceEngine(
        DIMS, params, policy=policy, hw=hw, schedule=GIANT_SCHEDULE,
        store=None, use_pallas=USE_KERNELS, device=dev,
    )
    n_rejected = sum(
        int(r.status == "rejected") for r in plain.submit(requests)
    )
    if n_rejected != n:
        raise RuntimeError(
            f"giant: plain engine rejected {n_rejected}/{n} beyond-capacity "
            f"requests; the stream must be inadmissible without partitioning"
        )

    top = engine.ladder[0].name
    tc0 = repro_torch.trace_count()
    t0 = time.perf_counter()
    results = engine.submit(requests)
    sync(dev)
    part_s = time.perf_counter() - t0
    part_traces = repro_torch.trace_count() - tc0
    stats = engine.stats()
    for res in results:
        if res.status != "ok" or res.tier != top:
            raise RuntimeError(
                f"giant: rid {res.rid} ended {res.status} on {res.tier}: "
                f"{res.error}"
            )
        if res.plan != "row_stream" or res.n_partitions < 2:
            raise RuntimeError(
                f"giant: rid {res.rid} served as {res.plan} with "
                f"{res.n_partitions} partitions; expected a multi-partition "
                f"row_stream plan"
            )
    if stats.n_downgrades:
        raise RuntimeError(f"giant: {stats.n_downgrades} downgrades")

    # steady state: same stream again — plans and the shared closure
    # Program are cached, so the warm pass must build nothing
    tc0 = repro_torch.trace_count()
    t0 = time.perf_counter()
    engine.submit(requests)
    sync(dev)
    warm_s = time.perf_counter() - t0
    warm_traces = repro_torch.trace_count() - tc0
    if warm_traces != 0:
        raise RuntimeError(
            f"giant: warm partitioned stream took {warm_traces} new traces"
        )

    naive_outs, naive_s = _naive_giant(requests, params, GIANT_SCHEDULE, dev)
    n_identical = sum(
        int(np.array_equal(np.asarray(results[i].output), naive_outs[i]))
        for i in range(n)
    )
    if n_identical != n:
        raise RuntimeError(
            f"giant: only {n_identical}/{n} partitioned outputs "
            f"bit-identical to the monolithic fallback"
        )
    # every graph monolithic on the eager tier: the fallback above runs the
    # same fused kernel as the closures, so this alone holds it
    eager_outs, _ = _naive_giant(requests, params, GIANT_SCHEDULE, dev,
                                 use_pallas=False)
    eager_diff = hold_close([r.output for r in results], eager_outs,
                            "giant: kernel tier vs eager tier")

    speedup = naive_s / part_s
    total_parts = sum(r.n_partitions for r in results)
    rows = [
        ("serve/giant_partitioned", part_s / n * 1e6,
         f"graphs={n};partitions={total_parts};traces={part_traces};"
         f"plans={','.join(sorted(stats.partition_plans))};"
         f"search_s={stats.search_s:.2f}"),
        ("serve/giant_warm", warm_s / n * 1e6,
         f"traces={warm_traces}"),
        ("serve/giant_naive", naive_s / n * 1e6,
         f"graphs={n}"),
        ("serve/giant_speedup", 0.0,
         f"x{speedup:.1f};bit_identical={n_identical}/{n};"
         f"rejected_without_flag={n_rejected}/{n};eager={eager_diff:.1e}"),
    ]

    biggest = requests[-1].graph
    plan = plan_partition(
        biggest, DIMS, hw, objective="edp", allow_monolithic=False,
        max_block_rows=GIANT_MAX_NODES,
    )
    payload = {
        "stream": {
            "sizes": list(sizes),
            "dims": [list(d) for d in DIMS],
            "seed": SEED,
            "gb_capacity_bytes": GIANT_CAP_BYTES,
            "max_nodes_cap": GIANT_MAX_NODES,
            "lane_device": str(dev),
            "use_pallas": USE_KERNELS,
        },
        "admission": {
            "rejected_without_flag": n_rejected,
            "footprint_bytes_largest": plan.footprint_bytes,
        },
        "plan_largest": plan.as_dict(),
        "partitioned": {
            **stats.as_dict(),
            "wall_s": part_s,
            "us_per_graph": part_s / n * 1e6,
            "traces": part_traces,
            "warm_wall_s": warm_s,
            "warm_us_per_graph": warm_s / n * 1e6,
            "warm_traces": warm_traces,
            "total_partitions": total_parts,
        },
        "naive_monolithic": {
            "wall_s": naive_s,
            "us_per_graph": naive_s / n * 1e6,
        },
        "speedup": speedup,
        "speedup_floor": GIANT_SPEEDUP_FLOOR,
        "n_bit_identical": n_identical,
        "eager_hold": {"n_graphs": n, "max_abs_diff": eager_diff,
                       "tol": CLOSE_TOL},
        "launches": launches_since(launches0),
    }
    guards = [_guard(
        "speedup", speedup, GIANT_SPEEDUP_FLOOR, "floor",
        f"giant: partitioned serving only x{speedup:.2f} vs the "
        f"monolithic fallback (floor x{GIANT_SPEEDUP_FLOOR:.1f})")]
    return rows, payload, guards


def main(argv: list[str] | None = None) -> int:
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="64-request stream, parity-checked, no JSON/guard")
    ap.add_argument("--chaos", action="store_true",
                    help="fault-isolation lane: seeded 10%% fault mix, "
                         "bit-identical healthy outputs, typed statuses")
    ap.add_argument("--restart", action="store_true",
                    help="zero-cold-start lane: serve -> kill -> revive; "
                         "revived first request must be trace-free")
    ap.add_argument("--async", dest="async_", action="store_true",
                    help="continuous-batching lane: AsyncEngine over two "
                         "workers (or every card) vs the per-arrival sync "
                         "front-end; p99 must track the batching window")
    ap.add_argument("--giant", action="store_true",
                    help="beyond-capacity lane: spill-model-planned "
                         "partitioned serving vs the monolithic fallback; "
                         "outputs bit-identical, wall-clock guarded")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device)")
    args = ap.parse_args(argv)
    kw = dict(smoke=args.smoke, device=args.device)
    if args.giant:
        rows = run_giant(**kw)
    elif args.async_:
        rows = run_async(**kw)
    elif args.restart:
        rows = run_restart(**kw)
    elif args.chaos:
        rows = run_chaos(**kw)
    else:
        rows = run(**kw)
    emit(rows)
    return 0


if __name__ == "__main__":
    sys.exit(main())
