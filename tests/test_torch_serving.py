"""The port's serving engine on the CPU (``repro_torch.runtime.engine``),
held to what ``tests/test_serving.py`` asserts of the reference: the
program cache, the zero-build warm stream, batched outputs within 1e-6 of
solo runs, tail fill levels sharing one executable, one mapper search a
bucket, partition-aware admission and measured re-ranking.  Cross-package:
the same seeded stream through both engines gives the same statuses,
buckets and counters, outputs within 2e-4 (weights carried across by
``params_from_numpy``)."""
import jax
import numpy as np
import pytest
import torch

import repro.runtime as ref_rt
import repro_torch
from repro.graphs import BucketPolicy as RefPolicy
from repro.graphs import from_edges as ref_from_edges
from repro_torch.core import GNNLayerWorkload
from repro_torch.core.schedule import ModelSchedule
from repro_torch.gnn import params_from_numpy
from repro_torch.graphs import BucketPolicy, from_edges
from repro_torch.runtime import InferenceEngine, ProgramCache, Request

DIMS = [(12, 16), (16, 4)]
SCHEDULE = ModelSchedule.from_policies("sp_opt", "AC", DIMS)
POL = BucketPolicy(min_nodes=16, min_degree=4, max_graphs=4)
TOL_REF = dict(rtol=2e-4, atol=2e-4)  # tests/test_torch_api.py's


def ring_graph(n: int, chords: int = 0, seed: int = 0, from_edges=from_edges):
    rng = np.random.default_rng(seed)
    src = np.arange(n)
    dst = (src + 1) % n
    if chords:
        src = np.concatenate([src, rng.integers(0, n, size=chords)])
        dst = np.concatenate([dst, rng.integers(0, n, size=chords)])
    return from_edges(n, np.concatenate([src, dst]), np.concatenate([dst, src]))


def make_request(n: int, seed: int, rid: int = 0, chords: int = 0,
                 pkg=None) -> Request:
    x = np.random.default_rng(seed).normal(size=(n, DIMS[0][0])).astype(np.float32)
    if pkg is ref_rt:
        return ref_rt.Request(graph=ring_graph(n, chords, seed, ref_from_edges),
                              x=x, rid=rid)
    return Request(graph=ring_graph(n, chords, seed), x=x, rid=rid)


def compiled(graph, schedule=SCHEDULE):
    wls = [GNNLayerWorkload(graph.nnz, fi, fo) for fi, fo in DIMS]
    return repro_torch.compile(wls, graph=graph, schedule=schedule, device="cpu")


def engine(pinned=True, **kw):
    kw.setdefault("policy", POL)
    if pinned:
        kw.setdefault("schedule", SCHEDULE)
    eng = InferenceEngine(DIMS, device="cpu", **kw)
    eng.init(torch.Generator().manual_seed(0))
    return eng


def test_engine_needs_cuda_or_an_explicit_device():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device exists")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceEngine(DIMS)


def test_params_are_placed_on_the_engine_device():
    eng = engine()
    assert all(v.device.type == "cpu" for layer in eng.params
               for v in layer.values())


def test_program_cache_lru():
    cache = ProgramCache(capacity=2)
    progs = {k: compiled(ring_graph(8 + k)) for k in range(3)}
    cache.put(("a",), progs[0])
    cache.put(("b",), progs[1])
    assert cache.get(("a",)) is progs[0]
    cache.put(("c",), progs[2])
    assert cache.get(("b",)) is None
    assert cache.get(("a",)) is progs[0] and cache.get(("c",)) is progs[2]
    assert cache.evictions == 1 and (cache.hits, cache.misses) == (3, 1)
    with pytest.raises(ValueError, match="capacity"):
        ProgramCache(capacity=0)


def test_stream_end_to_end():
    eng = engine()
    reqs = [make_request(8 + (i % 3) * 9, seed=i, rid=100 + i) for i in range(10)]
    results = eng.submit(reqs)
    assert [r.rid for r in results] == [100 + i for i in range(10)]
    assert all(r.output.shape == (DIMS[-1][1],) and r.status == "ok"
               for r in results)
    stats = eng.stats()
    assert stats.n_requests == 10 and stats.n_buckets >= 2
    assert stats.p99_ms >= stats.p50_ms > 0


def test_warm_stream_builds_nothing_and_hits_cache():
    eng = engine()
    cold = eng.submit([make_request(12, seed=i, rid=i) for i in range(6)])
    misses = eng.cache.misses
    before = repro_torch.trace_count()
    warm = eng.submit([make_request(12, seed=i + 50, rid=i) for i in range(6)])
    assert repro_torch.trace_count() == before
    assert eng.cache.misses == misses
    assert not np.allclose(cold[0].output, warm[0].output)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_engine_matches_per_graph_runs(use_pallas):
    eng = engine(use_pallas=use_pallas)
    reqs = [make_request(11, seed=i, rid=i, chords=3) for i in range(5)]
    for req, res in zip(reqs, eng.submit(reqs)):
        single = compiled(req.graph).degraded(use_pallas).run(eng.params, req.x)
        np.testing.assert_allclose(res.output, single.numpy().mean(axis=0),
                                   atol=1e-6, rtol=0)


def test_node_level_readout_none():
    eng = engine(readout=None)
    reqs = [make_request(9, seed=i, rid=i) for i in range(3)]
    for req, res in zip(reqs, eng.submit(reqs)):
        assert res.output.shape == (req.graph.n_nodes, DIMS[-1][1])
        want = compiled(req.graph).run(eng.params, req.x).numpy()
        np.testing.assert_allclose(res.output, want, atol=1e-6, rtol=0)


def test_feature_shape_rejected_and_params_required():
    (res,) = engine().submit(
        [Request(graph=ring_graph(9), x=np.zeros((9, 3), np.float32), rid=7)])
    assert res.status == "rejected" and res.error_type == "invalid_request"
    assert "request 7" in res.error
    with pytest.raises(ValueError, match="params"):
        InferenceEngine(DIMS, policy=POL, device="cpu").submit(
            [make_request(9, seed=0)])


def test_tail_fill_levels_share_the_executable():
    eng = engine()
    eng.submit([make_request(12, seed=i, rid=i) for i in range(3)])
    before = repro_torch.trace_count()
    for fill in (4, 3):
        res = eng.submit([make_request(12, seed=10 * fill + i, rid=i)
                          for i in range(fill)])
        assert len(res) == fill
    assert repro_torch.trace_count() == before


def test_colliding_v_totals_keep_distinct_programs():
    eng = engine()
    eng.submit([make_request(12, seed=0, rid=0), make_request(12, seed=1, rid=1)])
    misses = eng.cache.misses
    eng.submit([make_request(20, seed=2, rid=2)])
    assert eng.cache.misses == misses + 1


def test_mapper_search_runs_once_per_bucket():
    eng = engine(pinned=False)
    eng.submit([make_request(12, seed=i, rid=i) for i in range(5)])
    assert eng.cache.misses == 2 and len(eng._schedules) == 1
    assert eng.stats().n_searches == 1


def test_outputs_do_not_depend_on_the_batch():
    """A graph's output is the same bits alone and beside others: the
    eager products and the readout reduce each row and each segment in an
    order of its own."""
    eng = engine(pinned=False)
    reqs = [make_request(12, seed=i, rid=i, chords=2) for i in range(4)]
    together = eng.submit(reqs)
    for req, res in zip(reqs, together):
        (alone,) = eng.submit([req])
        assert np.array_equal(alone.output, res.output)


class TestPartitionAwareAdmission:
    POL = BucketPolicy(min_nodes=16, min_degree=4, max_nodes=64)

    def engine(self, cap):
        eng = InferenceEngine(DIMS, policy=self.POL, partition_oversized=True,
                              max_inflight_graphs=cap, device="cpu")
        eng.init(torch.Generator().manual_seed(0))
        return eng

    def test_giant_charges_partition_units(self):
        res = self.engine(4).submit(
            [make_request(200, seed=7, rid=100)]
            + [make_request(24, seed=i + 1, rid=i) for i in range(3)])
        g = res[0]
        assert g.ok and g.n_partitions >= 2
        n_shed = sum(r.status == "rejected" for r in res[1:])
        assert n_shed == max(0, 3 - max(0, 4 - g.n_partitions))
        assert all(r.error_type == "engine_overloaded" and r.retry_after_s > 0
                   for r in res[1:] if r.status == "rejected")

    def test_giant_behind_full_batch_is_shed(self):
        res = self.engine(4).submit(
            [make_request(24, seed=i + 1, rid=i) for i in range(4)]
            + [make_request(200, seed=7, rid=100)])
        assert all(r.ok for r in res[:-1])
        assert res[-1].status == "rejected" and "partition units" in res[-1].error

    def test_empty_engine_always_admits_one_giant(self):
        (res,) = self.engine(2).submit([make_request(200, seed=7, rid=1)])
        assert res.ok and res.n_partitions > 2


def test_warm_submit_records_walls_and_rerank_builds_nothing_after():
    eng = engine(pinned=False)
    reqs = [make_request(12, seed=i, rid=i) for i in range(4)]
    eng.submit(reqs)
    assert not eng.profile.observed
    eng.submit(reqs)
    (v, d, slots, digest), (n, tot) = next(iter(eng.profile.observed.items()))
    assert (v, d) in eng._buckets_seen and n >= 1 and tot > 0
    rep = eng.rerank_topk(top_k=2, iters=2, warmup=1)
    assert rep.n_buckets >= 1 and rep.n_candidates >= 1
    before = repro_torch.trace_count()
    assert all(r.ok for r in eng.submit(reqs))
    assert repro_torch.trace_count() == before


# ---------------------------------------------------------------------------
# The same stream through both packages
# ---------------------------------------------------------------------------


def _both(**kw):
    ref_eng = ref_rt.InferenceEngine(
        DIMS, policy=RefPolicy(min_nodes=16, min_degree=4, max_graphs=4), **kw)
    ref_params = ref_eng.init(jax.random.PRNGKey(1))
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, ref_params),
                               device="cpu")
    port = InferenceEngine(DIMS, params, policy=POL, device="cpu", **kw)
    return ref_eng, port


STREAM = [(8 + (i % 3) * 9, i, 2 * (i % 2)) for i in range(10)]


@pytest.mark.parametrize("readout,use_pallas,pinned", [
    ("mean", False, False), ("mean", True, False), ("sum", False, True),
    ("max", True, True), (None, False, True)])
def test_stream_matches_the_reference_engine(readout, use_pallas, pinned):
    """Unpinned, each bucket's first batch runs the mapper in both
    packages; pinned, both serve one fixed sp_opt/AC schedule."""
    from repro.core.schedule import ModelSchedule as RefSchedule

    kw = dict(readout=readout, use_pallas=use_pallas)
    ref_eng, port = _both(**kw, **(
        dict(schedule=RefSchedule.from_policies("sp_opt", "AC", DIMS))
        if pinned else {}))
    if pinned:
        port.schedule = SCHEDULE
    got = port.submit([make_request(n, s, rid=s, chords=c) for n, s, c in STREAM])
    want = ref_eng.submit([make_request(n, s, rid=s, chords=c, pkg=ref_rt)
                           for n, s, c in STREAM])
    for a, b in zip(got, want):
        assert (a.rid, a.status, a.bucket, a.tier) == (b.rid, b.status,
                                                       b.bucket, b.tier)
        np.testing.assert_allclose(np.asarray(a.output), np.asarray(b.output),
                                   **TOL_REF)
    s, r = port.stats(), ref_eng.stats()
    for k in ("n_requests", "n_batches", "n_buckets", "n_ok", "n_searches",
              "cache_hits", "cache_misses", "n_downgrades"):
        assert getattr(s, k) == getattr(r, k), k
    # the mapper picked the same schedule for every bucket
    assert {k: v.to_json() for k, v in port._schedules.items()} == {
        k: v.to_json() for k, v in ref_eng._schedules.items()}


def test_partitioned_lane_matches_the_reference():
    import dataclasses

    from repro.core.hw import DEFAULT_ACCEL as REF_ACCEL
    from repro_torch.core.hw import DEFAULT_ACCEL

    def band(v, fe):
        rows = np.repeat(np.arange(v), 2)
        return fe(v, rows, (rows + np.tile(np.array([-1, 1]), v)) % v)

    kw = dict(objective="edp", partition_oversized=True)
    ref_eng = ref_rt.InferenceEngine(
        [(16, 16), (16, 8)], policy=RefPolicy(max_nodes=1024),
        hw=dataclasses.replace(REF_ACCEL, gb_capacity_bytes=64 * 1024), **kw)
    ref_params = ref_eng.init(jax.random.PRNGKey(2))
    port = InferenceEngine(
        [(16, 16), (16, 8)],
        params_from_numpy(jax.tree_util.tree_map(np.asarray, ref_params), "cpu"),
        policy=BucketPolicy(max_nodes=1024),
        hw=dataclasses.replace(DEFAULT_ACCEL, gb_capacity_bytes=64 * 1024),
        device="cpu", **kw)
    x = np.random.default_rng(3).normal(size=(1500, 16)).astype(np.float32)
    (b,) = ref_eng.submit([ref_rt.Request(graph=band(1500, ref_from_edges), x=x)])
    (a,) = port.submit([Request(graph=band(1500, from_edges), x=x)])
    assert (a.status, a.plan, a.n_partitions, a.tier) == (
        b.status, b.plan, b.n_partitions, b.tier)
    np.testing.assert_allclose(a.output, b.output, **TOL_REF)
    assert {k: p.as_dict() for k, p in port._plans.items()} == {
        k: p.as_dict() for k, p in ref_eng._plans.items()}
