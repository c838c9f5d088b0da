"""The port's partitioned execution on the CPU
(``repro_torch.graphs.partition``, ``mapper.search_execution_plans``),
held to what ``tests/test_partition.py`` asserts of the reference: the
planner's choice, the halo closures, ``row_stream`` stitched back
bit-identical to the whole-graph forward (every kind, policy and order),
``feature_chunk`` within 1e-5, ``spmm_streamed`` bitwise, and the
engine's partitioned lane.  Cross-package: the same plans and the same
closure arrays as the reference, and the row-count regression at the
paper's cora width (F = 1433)."""
import dataclasses

import numpy as np
import pytest
import torch

import repro.graphs.partition as ref_part
from repro.core.hw import DEFAULT_ACCEL as REF_ACCEL
from repro.graphs import from_edges as ref_from_edges
from repro_torch.core.hw import DEFAULT_ACCEL
from repro_torch.core.mapper import search_execution_plans
from repro_torch.core.schedule import ExecSpec, ModelSchedule
from repro_torch.core.simulator import PARTITION_KINDS, intermediate_footprint_bytes
from repro_torch.gnn.layers import EllAdjacency, init_layer
from repro_torch.gnn.model import forward_layers
from repro_torch.graphs import BucketPolicy, from_edges
from repro_torch.graphs.partition import (
    extract_row_partitions,
    feature_chunk_forward,
    plan_partition,
    pp_shard_forward,
    row_stream_forward,
)
from repro_torch.kernels.common import ROW_TILE, row_matmul
from repro_torch.runtime import InferenceEngine, Request

DIMS = [(16, 16), (16, 8)]


def band_graph(v: int, from_edges=from_edges):
    """Ring-of-bands graph: every row touches its +/-1 neighbours."""
    rows = np.repeat(np.arange(v), 2)
    cols = (rows + np.tile(np.array([-1, 1]), v)) % v
    return from_edges(v, rows, cols)


def wide_band_graph(v: int, width: int = 3):
    """Rows touch their neighbours up to ``width`` apart (no wrap)."""
    src, dst = [], []
    for k in range(1, width + 1):
        s = np.arange(v - k)
        src += [s, s + k]
        dst += [s + k, s]
    return from_edges(v, np.concatenate(src), np.concatenate(dst))


def dense_block_graph(v: int, seed: int = 0, from_edges=from_edges):
    rng = np.random.default_rng(seed)
    return from_edges(v, rng.integers(0, v, size=v * 8),
                      rng.integers(0, v, size=v * 8))


def make_params(kind: str, dims=DIMS, seed: int = 0):
    gen = torch.Generator().manual_seed(seed)
    return [init_layer(kind, gen, fi, fo, device="cpu") for fi, fo in dims]


def features(g, f_in: int = DIMS[0][0], seed: int = 1) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(
        (g.n_nodes, f_in)).astype(np.float32)


def capped(bytes_: int, base=DEFAULT_ACCEL):
    return dataclasses.replace(base, gb_capacity_bytes=bytes_)


def whole_graph(g, x, params, kind, policy, order, band_size=128,
                use_pallas=False):
    adj = EllAdjacency.from_csr(g, device="cpu")
    specs = [ExecSpec(policy, order, band_size, None, 1, use_pallas)] * len(params)
    return forward_layers(kind, params, adj, torch.as_tensor(x), specs).numpy()


# ---------------------------------------------------------------------------
# Closures and the planner, against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("v,block,hops", [(300, 128, 2), (200, 64, 1),
                                          (50, 64, 2), (700, 96, 3)])
def test_row_partitions_equal_the_reference(v, block, hops):
    mine = extract_row_partitions(band_graph(v), block, hops)
    ref = ref_part.extract_row_partitions(band_graph(v, ref_from_edges), block, hops)
    assert len(mine) == len(ref)
    for a, b in zip(mine, ref):
        assert a.n_own == b.n_own
        assert np.array_equal(a.nodes, b.nodes)
        for k in ("row_ptr", "col_idx", "values"):
            assert np.array_equal(getattr(a.graph, k), getattr(b.graph, k)), k
    own = np.concatenate([p.nodes[: p.n_own] for p in mine])
    assert np.array_equal(own, np.arange(v))


def test_row_partition_bad_args_rejected():
    with pytest.raises(ValueError):
        extract_row_partitions(band_graph(10), 0, 1)
    with pytest.raises(ValueError):
        extract_row_partitions(band_graph(10), 4, 0)


PLAN_CASES = {
    "fits": (lambda fe: band_graph(64, fe), 1 << 20, {}),
    "band_overflow": (lambda fe: band_graph(700, fe), 16 * 1024, {}),
    "no_mono": (lambda fe: band_graph(700, fe), 16 * 1024,
                dict(allow_monolithic=False)),
    "pp_4": (lambda fe: dense_block_graph(700, from_edges=fe), 16 * 1024,
             dict(n_devices=4)),
    "giant_block_cap": (lambda fe: band_graph(1500, fe), 64 * 1024,
                        dict(allow_monolithic=False, max_block_rows=1024)),
}


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_plan_equals_the_reference(case):
    make, cap, kw = PLAN_CASES[case]
    mine = plan_partition(make(from_edges), DIMS, capped(cap), **kw)
    ref = ref_part.plan_partition(make(ref_from_edges), DIMS,
                                  capped(cap, REF_ACCEL), **kw)
    assert (mine.kind, mine.block_rows, mine.n_partitions, mine.n_hops,
            mine.halo_nodes, mine.chunk_f, mine.footprint_bytes) == (
        ref.kind, ref.block_rows, ref.n_partitions, ref.n_hops,
        ref.halo_nodes, ref.chunk_f, ref.footprint_bytes)
    assert mine.as_dict() == ref.as_dict()
    assert search_execution_plans(make(from_edges), DIMS, capped(cap), **kw) \
        == mine


def test_planner_choices_and_evidence():
    plan = plan_partition(band_graph(700), DIMS, capped(16 * 1024))
    assert plan.kind == "row_stream" and plan.n_partitions > 1
    assert plan.n_hops == len(DIMS) and plan.halo_nodes > 0
    assert {c.kind for c in plan.candidates} == set(PARTITION_KINDS)
    vals = [c.objective_value for c in plan.candidates if c.feasible]
    assert vals == sorted(vals)
    assert plan.footprint_bytes == intermediate_footprint_bytes(
        700, 16, capped(16 * 1024))
    with pytest.raises(ValueError, match="no feasible"):
        plan_partition(dense_block_graph(700), DIMS, capped(256),
                       allow_monolithic=False, max_partitions=2)


# ---------------------------------------------------------------------------
# Bit-exact row streaming
# ---------------------------------------------------------------------------

V, BLOCK = 200, 96  # v_pad % band_size != 0 on the whole graph and closures


@pytest.mark.parametrize("kind", ["gcn", "sage", "gin"])
@pytest.mark.parametrize("use_pallas", [False, True])
def test_row_stream_kinds_bit_identical(kind, use_pallas):
    g = band_graph(V)
    x, params = features(g), make_params(kind)
    ref = whole_graph(g, x, params, kind, "sp_opt", "AC", use_pallas=use_pallas)
    if use_pallas:  # the kernel tier streams closures in the engine's lane
        eng = InferenceEngine(DIMS, params, kind=kind, policy=BucketPolicy(max_nodes=BLOCK),
                              schedule=SCHEDULE, readout=None, partition_oversized=True,
                              use_pallas=True, device="cpu")
        (res,) = eng.submit([Request(graph=g, x=x, rid=0)])
        assert (res.status, res.tier, res.plan) == ("ok", "pallas+searched", "row_stream")
        assert res.n_partitions > 1
        out = res.output
    else:
        out = row_stream_forward(g, x, params, kind=kind, block_rows=BLOCK)
    assert np.array_equal(out, ref)


@pytest.mark.parametrize("policy", ["seq", "sp_generic", "sp_opt"])
@pytest.mark.parametrize("order", ["AC", "CA"])
def test_row_stream_policies_orders_bit_identical(policy, order):
    g = band_graph(V)
    x, params = features(g), make_params("gcn")
    ref = whole_graph(g, x, params, "gcn", policy, order)
    out = row_stream_forward(g, x, params, policy=policy, order=order,
                             block_rows=BLOCK)
    assert np.array_equal(out, ref)


@pytest.mark.parametrize("policy", ["seq", "sp_generic", "sp_opt"])
@pytest.mark.parametrize("order", ["AC", "CA"])
def test_row_count_regression_at_cora_width(policy, order):
    """The fault this pins: at F = 1433 a plain ``torch.matmul`` gives a
    row a result that depends on the call's row count, so 4 of these 6
    cases differed (up to 4.8e-7) before the eager products went through
    ``row_matmul``'s fixed row tiles.  GCN 1433 -> 16 -> 8 on a 2,000-node
    band graph, blocks of 96 rows with 2-hop halos."""
    g = wide_band_graph(2000)
    x = features(g, f_in=1433, seed=0)
    params = make_params("gcn", dims=[(1433, 16), (16, 8)])
    ref = whole_graph(g, x, params, "gcn", policy, order)
    out = row_stream_forward(g, x, params, policy=policy, order=order,
                             block_rows=96, n_hops=2)
    assert np.array_equal(out, ref)


def test_row_matmul_rows_do_not_depend_on_the_row_count():
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.normal(size=(700, 1433)).astype(np.float32))
    w = torch.as_tensor(rng.normal(size=(1433, 16)).astype(np.float32))
    full = row_matmul(x, w)
    for s, e in [(0, 96), (5, 300), (100, 700), (1, 2), (ROW_TILE - 3, ROW_TILE + 9)]:
        assert torch.equal(row_matmul(x[s:e], w), full[s:e])
    np.testing.assert_allclose(full.numpy(), (x @ w).numpy(), rtol=1e-5, atol=1e-4)


def test_row_stream_readout_bit_identical():
    from repro_torch.gnn.layers import segment_readout

    g = band_graph(V)
    x, params = features(g), make_params("gcn")
    ref = torch.as_tensor(whole_graph(g, x, params, "gcn", "sp_opt", "AC"))
    want = segment_readout(ref, torch.zeros(V, dtype=torch.int32), 1, "mean")[0]
    out = row_stream_forward(g, x, params, block_rows=BLOCK, readout="mean")
    assert np.array_equal(out, want.numpy())


@pytest.mark.parametrize("order", ["AC", "CA"])
def test_feature_chunk_within_1e5(order):
    g = band_graph(120)
    x, params = features(g), make_params("gcn")
    ref = whole_graph(g, x, params, "gcn", "seq", "AC")
    out = feature_chunk_forward(g, x, params, order=order, chunk_f=5)
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


def test_pp_shard_one_device_is_sp_generic():
    g = band_graph(150)
    x, params = features(g), make_params("gcn")
    ref = whole_graph(g, x, params, "gcn", "sp_generic", "AC")
    assert np.array_equal(pp_shard_forward(g, x, params), ref)


@pytest.mark.parametrize("v,block", [(300, 128), (64, 4096)])
def test_spmm_streamed_matches_spmm_bitwise(v, block):
    from repro_torch.kernels.spmm.ops import spmm, spmm_streamed

    g = band_graph(v)
    adj = EllAdjacency.from_csr(g, device="cpu")
    x = torch.as_tensor(features(g, f_in=24))
    assert torch.equal(
        spmm_streamed(adj.indices, adj.weights, x, block_rows=block),
        spmm(adj.indices, adj.weights, x))


def test_oversized_reason_footprint():
    assert "max_nodes" in BucketPolicy(max_nodes=64).oversized_reason(band_graph(100))
    pol = BucketPolicy(max_nodes=4096)
    reason = pol.oversized_reason(band_graph(1500), f=16, hw=capped(64 * 1024))
    assert reason is not None and "gb_capacity_bytes" in reason
    assert pol.oversized_reason(band_graph(1500), f=16, hw=DEFAULT_ACCEL) is None


# ---------------------------------------------------------------------------
# The engine's partitioned lane
# ---------------------------------------------------------------------------

SCHEDULE = ModelSchedule.from_policies("sp_opt", "AC", DIMS)
HW = capped(64 * 1024)
POL = BucketPolicy(max_nodes=1024)


@pytest.fixture(scope="module")
def giantish():
    g = band_graph(1500)
    return g, features(g), make_params("gcn")


def lane_engine(params, **kw):
    return InferenceEngine(DIMS, params, policy=POL, hw=HW, schedule=SCHEDULE,
                           objective="edp", partition_oversized=True,
                           device="cpu", **kw)


def test_oversized_without_flag_rejects(giantish):
    g, x, params = giantish
    eng = InferenceEngine(DIMS, params, policy=POL, hw=HW, schedule=SCHEDULE,
                          device="cpu")
    (res,) = eng.submit([Request(graph=g, x=x, rid=0)])
    assert res.status == "rejected" and res.error_type == "oversized_graph"


def test_partitioned_lane_raises_a_kernel_build_failure(giantish):
    """The oversized lane's ladder, like the batched one, re-raises a
    kernel that fails to build instead of serving the eager tier."""
    from repro_torch.core.registry import pop_kernel_hook, push_kernel_hook
    from repro_torch.kernels.common import CudaKernelError

    def hook(key, impl):
        def broken(*args, **kwargs):
            raise CudaKernelError("nvcc failed on fused_agg_cmb.cu (exit 1)")

        return broken if key[2] else impl

    g, x, params = giantish
    eng = lane_engine(params, use_pallas=True)
    push_kernel_hook(hook)
    try:
        with pytest.raises(CudaKernelError, match="nvcc failed"):
            eng.submit([Request(graph=g, x=x, rid=0)])
    finally:
        pop_kernel_hook(hook)
    st = eng.stats()
    assert st.n_downgrades == 0 and st.n_degraded == 0


@pytest.mark.parametrize("readout", ["mean", None])
@pytest.mark.parametrize("use_pallas", [False, True])
def test_partitioned_lane_bit_identical_to_monolithic(giantish, readout,
                                                      use_pallas):
    g, x, params = giantish
    eng = lane_engine(params, readout=readout, use_pallas=use_pallas)
    (res,) = eng.submit([Request(graph=g, x=x, rid=0)])
    assert res.status == "ok", res.error
    assert res.plan == "row_stream" and res.n_partitions > 1
    assert res.partition_wall_s > 0
    mono = InferenceEngine(DIMS, params, policy=BucketPolicy(max_nodes=2048),
                           schedule=SCHEDULE, readout=readout,
                           use_pallas=use_pallas, device="cpu")
    (ref,) = mono.submit([Request(graph=g, x=x, rid=0)])
    assert ref.status == "ok"
    assert np.array_equal(res.output, ref.output)
    st = eng.stats()
    assert st.n_partitioned == 1 and st.partition_plans == {"row_stream": 1}
    assert st.n_downgrades == 0


def test_mixed_submit_serves_both_lanes_and_caches_the_plan(giantish):
    g, x, params = giantish
    small = band_graph(100)
    eng = lane_engine(params)
    results = eng.submit([Request(graph=small, x=features(small), rid=0),
                          Request(graph=g, x=x, rid=1)])
    assert [r.status for r in results] == ["ok", "ok"]
    assert results[0].n_partitions == 0 and results[1].n_partitions > 1
    searches = eng.stats().n_searches
    eng.submit([Request(graph=g, x=x, rid=2)])
    assert eng.stats().n_searches == searches
    assert eng.stats().n_partitioned == 2
