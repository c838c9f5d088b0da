"""The port's async front-end (``repro_torch.runtime.scheduler``) on the
CPU, held to what ``tests/test_scheduler.py`` asserts of the reference:
the ``BucketPlacer`` policy (the same assignments as the reference's on
the same sequences), the single-device ``AsyncEngine`` contract (async
bit-identical to sync, admission before queueing, queue-cap shedding,
flush on fill, deadlines at the window, latency from arrival, precompile
from the store), and the multi-device lane in process: four workers on
``["cpu"] * 4`` (the reference forces four host devices in a subprocess).
Cross-package: the port's ``AsyncEngine``, ``serve_group`` and
``serve_partitioned`` against the reference's on the same requests at
2e-4, with the same statuses."""
import dataclasses
import threading

import jax
import numpy as np
import pytest
import torch

import repro.runtime as ref_rt
from repro.graphs import TABLE4 as REF_TABLE4
from repro.graphs import BucketPolicy as RefPolicy
from repro.graphs.batching import TrafficProfile as RefProfile
from repro.graphs.datasets import make_graph as ref_make_graph
from repro_torch.api import trace_count
from repro_torch.core.registry import pop_kernel_hook, push_kernel_hook
from repro_torch.gnn import params_from_numpy
from repro_torch.graphs import TABLE4, BucketPolicy, assemble, from_edges
from repro_torch.graphs.batching import TrafficProfile
from repro_torch.graphs.datasets import make_graph
from repro_torch.kernels.common import CudaKernelError
from repro_torch.runtime import (
    AsyncEngine,
    BucketPlacer,
    FaultInjector,
    FaultRule,
    InferenceEngine,
    ProgramStore,
    Request,
    RetryPolicy,
)
from repro_torch.runtime.resilience import backlog_retry_after
from repro_torch.runtime.scheduler import worker_labels

DIMS = [(16, 8)]
TOL_REF = dict(rtol=2e-4, atol=2e-4)  # the cross-package layer tolerance
CPU4 = ["cpu"] * 4


# ---------------------------------------------------------------------------
# BucketPlacer policy
# ---------------------------------------------------------------------------


def test_placer_distinct_buckets_distinct_devices():
    p = BucketPlacer(4)
    for b in [(32, 8), (64, 8), (128, 16), (256, 16)]:
        p.record(b, 10)
    homes = [p.assignment[b][0] for b in p.assignment]
    assert sorted(homes) == [0, 1, 2, 3]


def test_placer_hot_bucket_gets_replica():
    p = BucketPlacer(4, replicas=2)
    p.record((32, 8), 1)
    p.record((64, 8), 1)
    p.record((32, 8), 100)
    assert len(p.assignment[(32, 8)]) == 2
    assert len(set(p.assignment[(32, 8)])) == 2
    assert len(p.assignment[(64, 8)]) == 1


def test_placer_replicas_capped_by_knob_and_devices():
    p = BucketPlacer(2, replicas=8)
    assert p.replicas == 2
    p.record((32, 8), 1000)
    p.record((32, 8), 1000)
    assert len(p.assignment[(32, 8)]) <= 2


def test_placer_pick_prefers_least_outstanding_replica():
    p = BucketPlacer(2, replicas=2)
    p.record((32, 8), 100)
    p.record((32, 8), 100)
    assert len(p.assignment[(32, 8)]) == 2
    d0 = p.pick((32, 8), 10)
    d1 = p.pick((32, 8), 1)
    assert d1 != d0
    p.done(d0, 10)
    p.done(d1, 1)
    assert p.outstanding == [0, 0]


def test_placer_buckets_for_covers_assignment():
    p = BucketPlacer(2)
    p.record((32, 8), 1)
    p.record((64, 8), 1)
    assert p.buckets_for(0) | p.buckets_for(1) == {(32, 8), (64, 8)}


@pytest.mark.parametrize("seed,n_devices,replicas", [
    (0, 1, 1), (1, 2, 2), (2, 4, 1), (3, 4, 2), (4, 3, 3)])
def test_placer_matches_the_reference(seed, n_devices, replicas):
    """The same seeded plan / record / pick / done sequence on both
    packages' placers gives the same assignment and outstanding counts
    after every step."""
    rng = np.random.default_rng(seed)
    buckets = [(int(2 ** rng.integers(4, 10)), int(2 ** rng.integers(2, 7)))
               for _ in range(6)]
    mine = BucketPlacer(n_devices, replicas=replicas, min_heat=8)
    ref = ref_rt.BucketPlacer(n_devices, replicas=replicas, min_heat=8)
    prof, ref_prof = TrafficProfile(), RefProfile()
    for b in buckets[:3]:
        n = int(rng.integers(1, 20))
        prof.record_request(b, n)
        ref_prof.record_request(b, n)
    mine.plan(prof)
    ref.plan(ref_prof)
    picked = []
    for _ in range(60):
        b = buckets[int(rng.integers(len(buckets)))]
        op = rng.integers(3)
        if op == 0:
            n = int(rng.integers(1, 40))
            mine.record(b, n)
            ref.record(b, n)
        elif op == 1:
            n = int(rng.integers(1, 8))
            d = mine.pick(b, n)
            assert d == ref.pick(b, n)
            picked.append((d, n))
        elif picked:
            d, n = picked.pop(int(rng.integers(len(picked))))
            mine.done(d, n)
            ref.done(d, n)
        assert mine.assignment == ref.assignment
        assert mine.outstanding == ref.outstanding
        assert mine.device_heat == ref.device_heat
    for d in range(n_devices):
        assert mine.buckets_for(d) == ref.buckets_for(d)


def test_worker_labels_are_unique_where_a_device_repeats():
    dev = [torch.device("cuda", 0), torch.device("cuda", 0), torch.device("cuda", 1)]
    assert worker_labels(dev) == ["cuda:0#0", "cuda:0#1", "cuda:1"]
    assert worker_labels([torch.device("cpu")]) == ["cpu"]


# ---------------------------------------------------------------------------
# Backlog-proportional retry_after + profile helpers
# ---------------------------------------------------------------------------


def test_backlog_retry_after_scales_with_queue_depth():
    assert backlog_retry_after(10, 0.02, 64) == pytest.approx(0.02)
    assert backlog_retry_after(640, 0.02, 64) == pytest.approx(0.2)
    assert backlog_retry_after(0, 0.02, 64) == pytest.approx(0.02)


def test_profile_heat_orders_hottest_first():
    prof = TrafficProfile()
    prof.record_request((32, 8), 5)
    prof.record_request((64, 8), 50)
    assert prof.heat()[0] == ((64, 8), 50)


def test_profile_subset_filters_both_ledgers():
    prof = TrafficProfile()
    prof.record_request((32, 8), 5)
    prof.record_request((64, 8), 7)
    prof.record_batch((32, 8), 4)
    prof.record_batch((64, 8), 8)
    sub = prof.subset({(32, 8)})
    assert sub.requests == {(32, 8): 5}
    assert sub.batches == {(32, 8, 4): 1}
    assert prof.requests[(64, 8)] == 7


# ---------------------------------------------------------------------------
# AsyncEngine, one worker
# ---------------------------------------------------------------------------


def _stream(n, f_in=16, seed=0, names=("mutag", "imdb-bin"), pkg=None):
    """``n`` seeded requests; ``pkg=ref_rt`` builds the reference's
    requests from the same numbers."""
    rng = np.random.default_rng(seed)
    mk, table, req = ((ref_make_graph, REF_TABLE4, ref_rt.Request) if pkg is ref_rt
                      else (make_graph, TABLE4, Request))
    reqs = []
    for i in range(n):
        g = mk(table[names[i % len(names)]], rng)
        x = rng.normal(size=(g.n_nodes, f_in)).astype(np.float32)
        reqs.append(req(graph=g, x=x, rid=i))
    return reqs


@pytest.fixture(scope="module")
def params():
    return InferenceEngine(DIMS, device="cpu").init(torch.Generator().manual_seed(0))


def front(params, **kw):
    kw.setdefault("devices", ["cpu"])
    kw.setdefault("window_ms", 5.0)
    return AsyncEngine(DIMS, params, **kw)


def test_async_single_worker_matches_sync(params):
    reqs = _stream(8)
    sync_res = InferenceEngine(DIMS, params, device="cpu").submit(reqs)
    with front(params) as a:
        res = a.submit(reqs)
    for r, s in zip(res, sync_res):
        assert r.status == s.status == "ok"
        assert r.device == "cpu"
        np.testing.assert_array_equal(r.output, s.output)
    st = a.stats()
    assert (st.n_requests, st.n_ok, st.n_devices) == (8, 8, 1)
    assert st.p99_ms >= st.p50_ms > 0
    assert len(a._stage_walls) == st.n_flushes_full + st.n_flushes_deadline


def test_async_without_devices_needs_cuda(params, monkeypatch):
    """Left out, the devices are every CUDA device; without one it
    raises rather than running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        AsyncEngine(DIMS, params)


def test_async_admission_before_queueing(params):
    """Malformed and oversized requests resolve immediately as rejected —
    they never occupy a window slot or reach a worker."""
    policy = BucketPolicy(max_nodes=64)
    good = _stream(1, names=("mutag",))[0]
    big = from_edges(100, np.arange(99), np.arange(1, 100))
    oversized = Request(graph=big, x=np.zeros((100, 16), np.float32), rid=100)
    bad_x = Request(graph=good.graph, x=np.zeros((3, 16), np.float32), rid=101)
    with front(params, policy=policy) as a:
        f_bad = a.submit_async(bad_x)
        f_big = a.submit_async(oversized)
        assert f_bad.done() and f_big.done()
        assert f_bad.result().status == "rejected"
        assert f_big.result().status == "rejected"
        assert a.submit_async(good).result(timeout=60).status == "ok"
    st = a.stats()
    assert st.n_rejected == 2
    assert st.errors.get("invalid_request") == 1
    assert st.errors.get("oversized_graph") == 1


def test_async_queue_cap_sheds_with_backlog_hint(params):
    reqs = _stream(6, names=("mutag",))
    with front(params, window_ms=200.0, max_queue_graphs=4) as a:
        futs = [a.submit_async(r) for r in reqs]
        shed = [f.result(timeout=120) for f in futs[4:]]
        served = [f.result(timeout=120) for f in futs[:4]]
    assert all(r.status == "rejected" for r in shed)
    assert all(r.error_type == "engine_overloaded" for r in shed)
    assert all(r.retry_after_s is not None and r.retry_after_s > 0 for r in shed)
    assert all(r.status == "ok" for r in served)


def test_async_window_flushes_on_fill_before_deadline(params):
    """A window that reaches max_graphs flushes at once — a huge
    window_ms must not delay a full batch."""
    reqs = _stream(4, names=("mutag",))
    with front(params, window_ms=60_000.0, policy=BucketPolicy(max_graphs=4)) as a:
        res = [f.result(timeout=60) for f in [a.submit_async(r) for r in reqs]]
        assert all(r.status == "ok" for r in res)
        assert a.stats().n_flushes_full >= 1


def test_async_deadline_enforced_at_window(params):
    req = _stream(1, names=("mutag",))[0]
    expired = Request(graph=req.graph, x=req.x, rid=0, deadline_s=1e-9)
    with front(params, window_ms=30.0) as a:
        r = a.submit_async(expired).result(timeout=60)
    assert r.status == "failed"
    assert r.error_type == "deadline_exceeded"


def test_async_per_request_latency_includes_queue_wait(params):
    req = _stream(1, names=("mutag",))[0]
    with front(params, window_ms=80.0) as a:
        a.submit([req])  # warm the bucket off the clock
        r = a.submit_async(Request(graph=req.graph, x=req.x, rid=1)).result(timeout=60)
    assert r.status == "ok"
    assert r.latency_s >= 0.05


def test_async_precompile_warms_assigned_buckets(tmp_path, params):
    """precompile() on a revived front-end loads from the shared store and
    leaves the first real request build-free."""
    reqs = _stream(6)
    with front(params, store=ProgramStore(tmp_path)) as a:
        assert all(r.ok for r in a.submit(reqs))
    with front(params, devices=["cpu", "cpu"], store=ProgramStore(tmp_path)) as b:
        rep = b.precompile()
        assert rep.n_shapes > 0
        assert rep.n_searches == 0
        assert set(rep.per_device) == {"cpu#0", "cpu#1"}
        before = trace_count()
        res = b.submit(reqs)
        assert all(r.ok for r in res)
        assert trace_count() == before


def test_async_kernel_build_failure_reaches_every_future(params):
    """A CUDA kernel that fails to build is no request's fault: it is never
    served degraded, and every future of its window gets the exception."""
    reqs = _stream(3, names=("mutag",))

    def broken(key, impl):
        if not key[2]:
            return impl

        def fail(*args, **kwargs):
            raise CudaKernelError("nvcc failed on fused_agg_cmb.cu (exit 1)")

        return fail

    push_kernel_hook(broken)
    try:
        with front(params, use_pallas=True, window_ms=20.0) as a:
            futs = [a.submit_async(r) for r in reqs]
            for f in futs:
                with pytest.raises(CudaKernelError, match="nvcc failed"):
                    f.result(timeout=60)
            # the worker survives: the next window is served
            pop_kernel_hook(broken)
            assert a.submit(reqs[:1])[0].status == "ok"
    finally:
        pop_kernel_hook(broken)
    assert a.stats().n_degraded == 0


def test_async_partitions_oversized_requests(params):
    """With ``partition_oversized`` an oversized request goes to
    ``serve_partitioned`` on the least-loaded worker, and its output is
    the sync engine's."""
    n = 300
    rows = np.repeat(np.arange(n), 2)
    g = from_edges(n, rows, (rows + np.tile(np.array([-1, 1]), n)) % n)
    x = np.random.default_rng(7).normal(size=(n, 16)).astype(np.float32)
    kw = dict(policy=BucketPolicy(max_nodes=128), partition_oversized=True,
              readout=None)
    (want,) = InferenceEngine(DIMS, params, device="cpu", **kw).submit(
        [Request(graph=g, x=x)])
    with front(params, devices=CPU4, **kw) as a:
        (got,) = a.submit([Request(graph=g, x=x)])
    assert got.status == want.status == "ok"
    assert got.plan == want.plan and got.n_partitions == want.n_partitions > 1
    np.testing.assert_array_equal(got.output, want.output)


# ---------------------------------------------------------------------------
# Multi-worker lane (in process, four workers on the CPU)
# ---------------------------------------------------------------------------


def _multi_stream():
    return _stream(24, names=("mutag", "imdb-bin", "collab"))


def test_multi_worker_placement_and_bit_identity(params):
    reqs = _multi_stream()
    sync_res = InferenceEngine(DIMS, params, device="cpu").submit(reqs)
    with front(params, devices=CPU4, window_ms=10.0) as a:
        res = a.submit(reqs)
    placement = a.placement()
    homes = [devs[0] for devs in placement.values()]
    assert len(placement) >= 3, placement
    assert len(set(homes)) == min(len(homes), 4), placement
    for r, s in zip(res, sync_res):
        assert r.status == s.status == "ok", (r.rid, r.status, r.error)
        assert np.array_equal(r.output, s.output), r.rid
    assert len({r.device for r in res}) >= 3
    assert set(a.stats().per_device) == {"cpu#0", "cpu#1", "cpu#2", "cpu#3"}


def test_multi_worker_fault_isolation_by_bucket(params):
    """A sticky injected fault pinned to one bucket (so one worker) fails
    exactly that bucket's requests, typed, and every other request stays
    bit-identical to the fault-free run on the same worker."""
    reqs = _multi_stream()
    with front(params, devices=CPU4, window_ms=10.0) as a:
        clean = a.submit(reqs)
    target = sorted({r.bucket for r in clean})[0]
    inj = FaultInjector(rules=[FaultRule(kind="exception", bucket=tuple(target),
                                         max_fires=None)])
    with front(params, devices=CPU4, window_ms=10.0, fault_injector=inj,
               check_numerics=True) as c:
        chaos = c.submit(reqs)
    n_failed = 0
    for r, ok in zip(chaos, clean):
        if ok.bucket == target:
            assert r.status == "failed" and r.error_type == "kernel_fault", r.rid
            n_failed += 1
        else:
            assert r.status == "ok", (r.rid, r.status, r.error)
            assert r.device == ok.device
            assert np.array_equal(r.output, ok.output), r.rid
    assert n_failed > 0


def test_multi_worker_stress_keeps_counts(params):
    """Several submitting threads into four workers: every future
    resolves, the in-flight count returns to 0, nothing is lost."""
    import sys

    reqs = _multi_stream()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with front(params, devices=CPU4, window_ms=2.0) as a:
            out: list = [None] * 4

            def client(k):
                out[k] = a.submit(reqs[k::4])

            threads = [threading.Thread(target=client, args=(k,)) for k in range(4)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert sum(len(o) for o in out) == len(reqs)
    assert all(r.status == "ok" for o in out for r in o)
    assert a._inflight == 0 and a.placer.outstanding == [0] * 4
    assert a.stats().n_ok == len(reqs)


# ---------------------------------------------------------------------------
# Against the reference
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def both_params():
    ref_params = ref_rt.InferenceEngine(DIMS).init(jax.random.PRNGKey(1))
    return ref_params, params_from_numpy(
        jax.tree_util.tree_map(np.asarray, ref_params), device="cpu")


def test_async_matches_the_reference_async_engine(both_params):
    ref_params, port_params = both_params
    mine = _stream(10, names=("mutag", "imdb-bin", "collab"))
    theirs = _stream(10, names=("mutag", "imdb-bin", "collab"), pkg=ref_rt)
    with ref_rt.AsyncEngine(DIMS, ref_params, window_ms=10.0) as r:
        want = r.submit(theirs)
    with front(port_params, window_ms=10.0) as a:
        got = a.submit(mine)
    for g, w in zip(got, want):
        assert (g.rid, g.status, g.bucket) == (w.rid, w.status, w.bucket)
        np.testing.assert_allclose(np.asarray(g.output), np.asarray(w.output), **TOL_REF)
    s, t = a.stats(), r.stats()
    assert (s.n_requests, s.n_ok, s.n_rejected) == (t.n_requests, t.n_ok, t.n_rejected)
    assert set(s.placement) == set(t.placement)


def test_serve_group_matches_the_reference(both_params):
    """``serve_group`` on one pre-admitted same-bucket group, one member
    already past its deadline: the same statuses as the reference's, the
    served outputs at 2e-4."""
    ref_params, port_params = both_params
    pol = BucketPolicy(min_nodes=64, min_degree=8)
    ref_pol = RefPolicy(min_nodes=64, min_degree=8)
    mine = _stream(5, names=("mutag",))
    theirs = _stream(5, names=("mutag",), pkg=ref_rt)
    mine[2] = dataclasses.replace(mine[2], deadline_s=1e-9)
    theirs[2] = dataclasses.replace(theirs[2], deadline_s=1e-9)
    assert len({pol.bucket_of(r.graph) for r in mine}) == 1
    got = InferenceEngine(DIMS, port_params, policy=pol, device="cpu").serve_group(mine)
    want = ref_rt.InferenceEngine(DIMS, ref_params, policy=ref_pol).serve_group(theirs)
    assert [(r.status, r.error_type, r.bucket) for r in got] == [
        (r.status, r.error_type, r.bucket) for r in want]
    assert got[2].status == "failed" and got[2].error_type == "deadline_exceeded"
    for g, w in zip(got, want):
        if g.ok:
            np.testing.assert_allclose(g.output, np.asarray(w.output), **TOL_REF)


def test_serve_partitioned_matches_the_reference(both_params):
    from repro.graphs import from_edges as ref_from_edges

    ref_params, port_params = both_params

    def ring(fe, n=300):
        rows = np.repeat(np.arange(n), 2)
        return fe(n, rows, (rows + np.tile(np.array([-1, 1]), n)) % n)

    x = np.random.default_rng(3).normal(size=(300, 16)).astype(np.float32)
    kw = dict(partition_oversized=True)
    got = InferenceEngine(DIMS, port_params, policy=BucketPolicy(max_nodes=128),
                          device="cpu", **kw).serve_partitioned(
        Request(graph=ring(from_edges), x=x, rid=4))
    want = ref_rt.InferenceEngine(DIMS, ref_params, policy=RefPolicy(max_nodes=128),
                                  **kw).serve_partitioned(
        ref_rt.Request(graph=ring(ref_from_edges), x=x, rid=4))
    assert (got.rid, got.status, got.tier, got.plan, got.n_partitions) == (
        want.rid, want.status, want.tier, want.plan, want.n_partitions)
    assert got.status == "ok" and got.n_partitions > 1
    np.testing.assert_allclose(got.output, np.asarray(want.output), **TOL_REF)


def test_staged_batch_survives_an_injected_retry(params):
    """A staged feature tensor (the front-end's ``pre``) is never donated:
    a NaN injected into the first attempt's output is retried on the same
    tensor, which still owns its storage afterwards, and the served output
    is the fault-free one."""
    reqs = _stream(3, names=("mutag",))
    policy = BucketPolicy()
    batch = assemble([r.graph for r in reqs], policy)
    staged = torch.as_tensor(batch.batch_features([r.x for r in reqs])).clone()
    nbytes = staged.untyped_storage().nbytes()
    inj = FaultInjector(rules=[FaultRule(kind="nan", batch_index=0, max_fires=1)])
    eng = InferenceEngine(DIMS, params, device="cpu", donate=True, policy=policy,
                          retry=RetryPolicy(max_retries=1, backoff_s=0.0),
                          fault_injector=inj)
    res = eng.serve_group(reqs, pre=(batch, staged))
    assert staged.untyped_storage().nbytes() == nbytes
    clean = InferenceEngine(DIMS, params, device="cpu").submit(reqs)
    for r, c in zip(res, clean):
        assert r.status == "ok" and r.n_retries == 1
        np.testing.assert_array_equal(r.output, c.output)
    assert inj.counts().get("nan") == 1
