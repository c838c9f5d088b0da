"""Parity of the port's framework-free core (its own copies of taxonomy,
hw, registry, cost model, simulator, schedule, mapper and graphs) with the
reference: the same searches give byte-equal schedules, the same
simulations equal arrays, the same graphs identical ELL layouts."""
import json

import numpy as np
import pytest

import repro.core as rc
import repro.graphs as rg
import repro_torch.core as tc
import repro_torch.graphs as tg


def _workloads(core, g, dims):
    return [
        core.GNNLayerWorkload(g.nnz, fi, fo, name=f"layer{i}")
        for i, (fi, fo) in enumerate(dims)
    ]


CASES = {
    "cora": [(1433, 16), (16, 8)],
    "mutag": [(28, 16), (16, 2)],
}


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("objective", ["cycles", "energy"])
def test_search_model_schedule_json_byte_equal(name, objective):
    g_ref, _ = rg.load_dataset(name)
    g_port, _ = tg.load_dataset(name)
    ref = rc.search_model(_workloads(rc, g_ref, CASES[name]), objective=objective)
    port = tc.search_model(_workloads(tc, g_port, CASES[name]), objective=objective)
    assert port.to_json() == ref.to_json()
    assert port.lower(use_pallas=True) == [
        tc.ExecSpec(**vars(s)) for s in ref.lower(use_pallas=True)
    ]


@pytest.mark.parametrize("name", sorted(CASES))
def test_simulate_batch_arrays_equal(name):
    g_ref, _ = rg.load_dataset(name)
    g_port, _ = tg.load_dataset(name)
    (fi, fo) = CASES[name][0]
    tiles = dict(T_V_AGG=16, T_N=1, T_F_AGG=8, T_V_CMB=16, T_G=8, T_F_CMB=8)
    out = []
    for core, g in ((rc, g_ref), (tc, g_port)):
        dfs = [core.named_dataflow(n, **tiles) for n in core.TABLE5_NAMES]
        wl = core.GNNLayerWorkload(g.nnz, fi, fo, name="layer0")
        out.append(core.simulate_batch(dfs, wl))
    ref, port = out
    for field in ("cycles", "energy_pj", "legal", "agg_cycles", "cmb_cycles", "macs"):
        np.testing.assert_array_equal(getattr(port, field), getattr(ref, field))


@pytest.mark.parametrize("name", ["cora", "mutag", "reddit-bin"])
@pytest.mark.parametrize("block_rows,pad_to", [(1, None), (8, None), (128, 512)])
def test_to_ell_identical(name, block_rows, pad_to):
    g_ref, _ = rg.load_dataset(name)
    g_port, _ = tg.load_dataset(name)
    np.testing.assert_array_equal(g_port.row_ptr, g_ref.row_ptr)
    np.testing.assert_array_equal(g_port.col_idx, g_ref.col_idx)
    for a, b in zip(
        g_port.to_ell(block_rows, pad_to=pad_to),
        g_ref.to_ell(block_rows, pad_to=pad_to),
    ):
        np.testing.assert_array_equal(a, b)
        assert np.asarray(a).dtype == np.asarray(b).dtype


def test_bucketize_and_assemble_identical():
    rng_ref, rng_port = np.random.default_rng(3), np.random.default_rng(3)
    spec = rg.TABLE4["mutag"]
    from repro.graphs.datasets import make_graph as ref_make
    from repro_torch.graphs.datasets import make_graph as port_make

    graphs_ref = [ref_make(spec, rng_ref) for _ in range(20)]
    graphs_port = [port_make(tg.TABLE4["mutag"], rng_port) for _ in range(20)]
    routed_ref = rg.bucketize(graphs_ref)
    routed_port = tg.bucketize(graphs_port)
    assert routed_port == routed_ref
    for key, ids in routed_ref.items():
        b_ref = rg.assemble([graphs_ref[i] for i in ids])
        b_port = tg.assemble([graphs_port[i] for i in ids])
        np.testing.assert_array_equal(b_port.segment_ids, b_ref.segment_ids)
        np.testing.assert_array_equal(b_port.graph.col_idx, b_ref.graph.col_idx)
        assert (b_port.slots, b_port.d_bucket) == (b_ref.slots, b_ref.d_bucket)


def test_model_schedule_json_round_trips_across_packages():
    g, _ = rg.load_dataset("mutag")
    ref = rc.search_model(_workloads(rc, g, CASES["mutag"]))
    port = tc.ModelSchedule.from_json(ref.to_json())
    assert port.to_json() == ref.to_json()
    assert json.loads(port.to_json()) == json.loads(ref.to_json())
    assert port.digest() == ref.digest()
