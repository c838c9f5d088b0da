"""The port's persistent program store on the CPU
(``repro_torch.runtime.store``), held to what ``tests/test_store.py``
asserts of the reference: atomic saves, corrupt artifacts as counted
misses, traffic profiles, and a revived engine that serves bit-identical
outputs with no mapper search and, after ``precompile()``, no executable
build on its first request.  Cross-package: keys and digests are the
reference's, and a store written by ``repro``'s engine revives
``repro_torch``'s with no mapper search (and the other way round)."""
import json
import os

import jax
import numpy as np
import pytest
import torch

import repro
import repro.runtime as ref_rt
import repro_torch
from repro.core.schedule import ModelSchedule as RefSchedule
from repro.graphs import BucketPolicy as RefPolicy
from repro.graphs import from_edges as ref_from_edges
from repro_torch.core import GNNLayerWorkload
from repro_torch.core.schedule import ModelSchedule
from repro_torch.gnn import params_from_numpy
from repro_torch.graphs import BucketPolicy, TrafficProfile, from_edges
from repro_torch.kernels import common
from repro_torch.runtime import (
    InferenceEngine,
    ProgramStore,
    Request,
    key_digest,
    store_key,
)

DIMS = [(12, 16), (16, 4)]
SCHEDULE = ModelSchedule.from_policies("sp_opt", "AC", DIMS)
POLICY = BucketPolicy(min_nodes=16, min_degree=4, max_graphs=4)


def ring_graph(n: int):
    src = np.arange(n)
    dst = (src + 1) % n
    return from_edges(n, np.concatenate([src, dst]), np.concatenate([dst, src]))


def make_request(n: int, seed: int, rid: int = 0) -> Request:
    x = np.random.default_rng(seed).normal(size=(n, DIMS[0][0])).astype(np.float32)
    return Request(graph=ring_graph(n), x=x, rid=rid)


def compiled(graph, schedule=SCHEDULE):
    wls = [GNNLayerWorkload(graph.nnz, fi, fo) for fi, fo in DIMS]
    return repro_torch.compile(wls, graph=graph, schedule=schedule, device="cpu")


def engine(params=None, **kw):
    kw.setdefault("policy", POLICY)
    kw.setdefault("readout", "mean")
    return InferenceEngine(DIMS, params, device="cpu", **kw)


@pytest.fixture(scope="module")
def prog():
    return compiled(ring_graph(16))


@pytest.fixture(scope="module")
def params(prog):
    return prog.init(torch.Generator().manual_seed(0))


def a_key(bucket=(16, 4), v_total=16, **kw):
    kw.setdefault("kind", "gcn")
    kw.setdefault("objective", "cycles")
    kw.setdefault("use_pallas", False)
    return store_key(DIMS, bucket, v_total, **kw)


@pytest.mark.parametrize("first_write", [False, True])
def test_injected_failure_leaves_previous_artifact(tmp_path, prog, monkeypatch,
                                                   first_write):
    target = tmp_path / "prog.json"
    if not first_write:
        prog.save(target)
    before = target.read_text() if not first_write else None

    def boom(src, dst):
        raise OSError("injected: disk full")

    monkeypatch.setattr(os, "replace", boom)
    with pytest.raises(OSError, match="injected"):
        prog.save(target)
    monkeypatch.undo()
    assert (target.read_text() if target.exists() else None) == before
    assert not list(tmp_path.glob("*.tmp.*"))


def test_round_trip_serves_bit_identical(tmp_path, prog, params):
    store = ProgramStore(tmp_path)
    store.put(a_key(), prog)
    revived = ProgramStore(tmp_path)
    loaded = revived.get(a_key())
    assert loaded is not None and revived.hits == 1
    g = ring_graph(16)
    x = np.ones((16, DIMS[0][0]), np.float32)
    want = prog.run(params, x)
    got = loaded.bind(g, pad_degree=g.max_degree, device="cpu").run(params, x)
    assert torch.equal(want, got)
    twin = loaded.bind(g, pad_degree=g.max_degree, device="cpu").degraded(True)
    assert torch.equal(prog.degraded(True).run(params, x), twin.run(params, x))


def test_absent_key_is_plain_miss(tmp_path):
    store = ProgramStore(tmp_path)
    assert store.get(a_key(bucket=(32, 4), v_total=32)) is None
    assert store.misses == 1 and store.corrupt == 0


@pytest.mark.parametrize("mangle", ["garbage", "truncated", "format"])
def test_bad_artifact_is_counted_miss_never_raises(tmp_path, prog, mangle):
    store = ProgramStore(tmp_path)
    path = store.put(a_key(), prog)
    text = path.read_text()
    if mangle == "garbage":
        path.write_text("{ not json at all")
    elif mangle == "truncated":
        path.write_text(text[: len(text) // 2])
    else:
        d = json.loads(text)
        d["format"] = "repro.program/v0"
        path.write_text(json.dumps(d))
    assert store.get(a_key()) is None
    assert store.corrupt == 1 and store.misses == 1
    store.put(a_key(), prog)
    assert store.get(a_key()) is not None


def test_corrupt_index_is_cosmetic(tmp_path, prog):
    store = ProgramStore(tmp_path)
    k1, k2 = a_key(), a_key(v_total=32)
    store.put(k1, prog)
    store.put(k2, prog)
    (tmp_path / "index.json").write_text("not an index {{{")
    revived = ProgramStore(tmp_path)
    assert len(revived) == 2
    assert revived.get(k1) is not None and revived.get(k2) is not None
    revived.put(k1, prog)
    assert json.loads((tmp_path / "index.json").read_text())["format"] == \
        "repro.store/v1"


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("v_total", [16, 32])
def test_keys_and_digests_match_the_reference(use_pallas, v_total):
    from repro.core.hw import DEFAULT_ACCEL as REF_ACCEL
    from repro_torch.core.hw import DEFAULT_ACCEL

    kw = dict(kind="gcn", objective="cycles", use_pallas=use_pallas)
    mine = store_key(DIMS, (16, 4), v_total, hw=DEFAULT_ACCEL, **kw)
    ref = ref_rt.store_key(DIMS, (16, 4), v_total, hw=REF_ACCEL, **kw)
    assert mine == ref and key_digest(mine) == ref_rt.key_digest(ref)
    k = a_key()
    assert key_digest(k) == key_digest(dict(reversed(list(k.items()))))
    assert key_digest(k) != key_digest(a_key(use_pallas=True))


def test_traffic_profile_record_merge_round_trip(tmp_path):
    p = TrafficProfile()
    p.record_request((16, 4), n=10)
    p.record_request((32, 4), n=2)
    p.record_batch((16, 4), slots=4)
    p.record_batch((16, 4), slots=1)
    p.record_batch((32, 4), slots=2)
    assert [b for b, _ in p.hot_shapes()] == [(16, 4), (16, 4), (32, 4)]
    q = TrafficProfile.load(p.save(tmp_path / "traffic.json"))
    assert q.requests == p.requests and q.batches == p.batches
    assert p.merge(q).batches[(16, 4, 4)] == 2
    store = ProgramStore(tmp_path / "s")
    store.profile_path.write_text("}} nope")
    assert store.load_profile() is None and store.corrupt == 1


@pytest.mark.parametrize("kind,use_pallas", [("gcn", False), ("sage", False),
                                             ("gcn", True)])
def test_revived_engine_is_bit_identical_and_search_free(tmp_path, kind,
                                                         use_pallas):
    reqs = [make_request(12, seed=i, rid=i) for i in range(4)]
    cold = engine(kind=kind, use_pallas=use_pallas, store=ProgramStore(tmp_path))
    params = cold.init(torch.Generator().manual_seed(0))
    got_cold = cold.submit(reqs)
    assert cold.stats().n_searches >= 1
    revived = engine(params, kind=kind, use_pallas=use_pallas,
                     store=ProgramStore(tmp_path))
    got = revived.submit(reqs)
    assert revived.stats().n_searches == 0 and revived.stats().store_hits >= 1
    for a, b in zip(got_cold, got):
        assert a.ok and b.ok and np.array_equal(a.output, b.output)


def test_first_request_after_precompile_builds_nothing(tmp_path):
    reqs = [make_request(12, seed=i, rid=i) for i in range(5)]
    cold = engine(store=ProgramStore(tmp_path))
    params = cold.init(torch.Generator().manual_seed(0))
    cold.submit(reqs[:1])
    got_cold = cold.submit(reqs[1:])
    revived = engine(params, store=ProgramStore(tmp_path))
    rep = revived.precompile()
    assert rep.n_shapes >= 2 and rep.n_store_hits == rep.n_shapes
    assert rep.n_searches == 0 and rep.n_compiled == 0 and rep.n_traces >= 1
    before = repro_torch.trace_count()
    got = revived.submit(reqs[1:])
    assert repro_torch.trace_count() == before
    assert revived.stats().n_searches == 0
    for a, b in zip(got_cold, got):
        assert np.array_equal(a.output, b.output)


def test_precompile_needs_params_and_honors_max_shapes(tmp_path):
    with pytest.raises(ValueError, match="params"):
        engine(store=ProgramStore(tmp_path)).precompile()
    profile = TrafficProfile()
    profile.record_request((16, 4), n=9)
    profile.record_batch((16, 4), slots=1)
    profile.record_batch((16, 4), slots=2)
    eng = engine(store=ProgramStore(tmp_path))
    eng.init(torch.Generator().manual_seed(0))
    assert eng.precompile(profile, max_shapes=1).n_shapes == 1


def test_compile_time_splits_into_search_and_build(tmp_path):
    eng = engine(store=ProgramStore(tmp_path))
    eng.init(torch.Generator().manual_seed(0))
    eng.submit([make_request(12, seed=i, rid=i) for i in range(3)])
    stats = eng.stats()
    assert stats.search_s > 0.0 and stats.trace_s > 0.0
    assert stats.compile_s == pytest.approx(stats.search_s + stats.trace_s)


def test_kernel_cache_points_the_builds_at_the_store(tmp_path, monkeypatch):
    """``ProgramStore(kernel_cache=True)`` (the reference's ``jax_cache``)
    points the CUDA kernel builds at ``<root>/kernels``; the environment
    variable wins over it, as REPRO_JAX_CACHE_DIR does in the reference."""
    default = common.BUILD_DIR
    try:
        ProgramStore(tmp_path / "a", kernel_cache=True)
        assert common.BUILD_DIR == tmp_path / "a" / "kernels"
        assert common.BUILD_DIR.is_dir()
        from repro_torch.kernels.spmm.ops import LIBRARY

        assert LIBRARY.so_path().parent == tmp_path / "a" / "kernels"
        monkeypatch.setenv(common.BUILD_DIR_ENV, str(tmp_path / "env"))
        ProgramStore(tmp_path / "b", kernel_cache=True)
        assert common.BUILD_DIR == tmp_path / "env"
        monkeypatch.delenv(common.BUILD_DIR_ENV)
        assert common.set_build_dir() == default
    finally:
        common.set_build_dir(default)


def _ref_stream(n_req=4):
    def ring(n):
        src = np.arange(n)
        dst = (src + 1) % n
        return ref_from_edges(n, np.concatenate([src, dst]),
                              np.concatenate([dst, src]))

    return [
        ref_rt.Request(
            graph=ring(12),
            x=np.random.default_rng(i).normal(size=(12, DIMS[0][0])).astype(
                np.float32),
            rid=i,
        )
        for i in range(n_req)
    ]


def test_store_written_by_reference_revives_the_port(tmp_path):
    """A store the reference's engine wrote (searched schedules, traffic
    profile) serves the port's engine with no mapper search and outputs
    within 2e-4; the port's writes revive the reference the same way."""
    ref_reqs = _ref_stream()
    ref_eng = ref_rt.InferenceEngine(
        DIMS, policy=RefPolicy(min_nodes=16, min_degree=4, max_graphs=4),
        readout="mean", store=ref_rt.ProgramStore(tmp_path / "ref"),
    )
    ref_params = ref_eng.init(jax.random.PRNGKey(0))
    want = ref_eng.submit(ref_reqs)
    assert ref_eng.stats().n_searches >= 1
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, ref_params),
                               device="cpu")
    port = engine(params, store=ProgramStore(tmp_path / "ref"))
    assert port.precompile().n_searches == 0
    got = port.submit([Request(graph=ring_graph(12), x=r.x, rid=r.rid)
                       for r in ref_reqs])
    assert port.stats().n_searches == 0 and port.stats().store_hits >= 1
    for a, b in zip(got, want):
        assert a.ok and b.ok and a.bucket == b.bucket
        np.testing.assert_allclose(a.output, b.output, rtol=2e-4, atol=2e-4)

    # and back: the port's artifacts revive the reference search-free
    cold = engine(params, store=ProgramStore(tmp_path / "port"))
    cold.submit([Request(graph=ring_graph(12), x=r.x, rid=r.rid)
                 for r in ref_reqs])
    ref_revived = ref_rt.InferenceEngine(
        DIMS, ref_params,
        policy=RefPolicy(min_nodes=16, min_degree=4, max_graphs=4),
        readout="mean", store=ref_rt.ProgramStore(tmp_path / "port"),
    )
    ref_revived.submit(ref_reqs)
    assert ref_revived.stats().n_searches == 0


def test_pinned_schedule_artifacts_are_byte_equal(tmp_path):
    """One bucket's artifact, written by each package's engine under a
    pinned schedule: the same key file and the same bytes."""
    ref_eng = ref_rt.InferenceEngine(
        DIMS, policy=RefPolicy(min_nodes=16, min_degree=4, max_graphs=4),
        schedule=RefSchedule.from_policies("sp_opt", "AC", DIMS),
        store=ref_rt.ProgramStore(tmp_path / "ref"),
    )
    ref_eng.init(jax.random.PRNGKey(0))
    ref_eng.submit(_ref_stream(2))
    eng = engine(schedule=SCHEDULE, readout="mean",
                 store=ProgramStore(tmp_path / "port"))
    eng.init(torch.Generator().manual_seed(0))
    eng.submit([make_request(12, seed=i, rid=i) for i in range(2)])
    ref_files = sorted(p.name for p in (tmp_path / "ref").glob("*.program.json"))
    files = sorted(p.name for p in (tmp_path / "port").glob("*.program.json"))
    assert files == ref_files and files
    for name in files:
        assert (tmp_path / "port" / name).read_text() == \
            (tmp_path / "ref" / name).read_text()


def test_donated_features_are_released(tmp_path):
    """``donate=True`` acts: the fed tensor's storage is released once the
    forward is dispatched, and a view cannot be donated."""
    prog = compiled(ring_graph(16))
    p = prog.init(torch.Generator().manual_seed(0))
    x = torch.ones((16, DIMS[0][0]))
    want = prog.run(p, x.clone())
    out = prog.run(p, x, donate=True)
    assert torch.equal(out, want)
    assert x.untyped_storage().nbytes() == 0
    big = torch.ones((32, DIMS[0][0]))
    with pytest.raises(ValueError, match="own its whole storage"):
        prog.run(p, big[:16], donate=True)
    with pytest.raises(ValueError, match="own its whole storage"):
        prog.run(p, torch.from_numpy(np.ones((16, DIMS[0][0]), np.float32)),
                 donate=True)
    before = repro_torch.trace_count()
    prog.run(p, torch.ones((16, DIMS[0][0])), donate=True)
    assert repro_torch.trace_count() == before  # donate is part of the key
    prog.run(p, torch.ones((16, DIMS[0][0])), donate=False)
    assert repro_torch.trace_count() == before


def test_engine_donate_modes_agree(tmp_path):
    reqs = [make_request(12, seed=i, rid=i) for i in range(3)]
    outs = []
    for donate in (True, False):
        eng = engine(donate=donate)
        eng.init(torch.Generator().manual_seed(0))
        outs.append([r.output for r in eng.submit(reqs)])
    for a, b in zip(*outs):
        assert np.array_equal(a, b)


def test_build_counts_follow_the_reference_traces():
    """The port's builds follow the reference's traces on the same engine
    calls: a cold stream (4- and 1-slot batches), a warm stream, and a
    precompile of a revived engine."""
    kw = dict(min_nodes=16, min_degree=4, max_graphs=4)
    ref_eng = ref_rt.InferenceEngine(
        DIMS, policy=RefPolicy(**kw), readout="mean",
        schedule=RefSchedule.from_policies("sp_opt", "AC", DIMS))
    ref_eng.init(jax.random.PRNGKey(0))
    eng = engine(schedule=SCHEDULE)
    eng.init(torch.Generator().manual_seed(0))
    reqs = [make_request(12, seed=i, rid=i) for i in range(5)]
    for _ in range(2):
        r0, p0 = repro.trace_count(), repro_torch.trace_count()
        ref_eng.submit(_ref_stream(5))
        eng.submit(reqs)
        assert repro_torch.trace_count() - p0 == repro.trace_count() - r0
    assert eng.stats().cache_misses == ref_eng.stats().cache_misses
