"""Parity of the port's ``compile`` / ``Program`` with the reference's, on
the CPU: searched schedules, unbatched and batched runs from the same
weights, Program JSON that loads across packages byte for byte, the
executable cache's zero-rebuild contract, and device placement."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro.gnn import GNNConfig as RefConfig
from repro.graphs import assemble as ref_assemble
from repro.graphs import load_dataset as ref_load
from repro.graphs.datasets import make_graph as ref_make
from repro_torch.core.schedule import ExecSpec
from repro_torch.gnn import GNNConfig, params_from_numpy
from repro_torch.graphs import TABLE4, assemble, load_dataset
from repro_torch.graphs.datasets import make_graph

TOL = dict(rtol=2e-4, atol=2e-4)
CFG = dict(kind="gcn", f_in=28, hidden=16, n_classes=4)


def _pair(graph_port, graph_ref, use_pallas=False, **cfg):
    c = {**CFG, **cfg}
    ref = repro.compile(RefConfig(**c, use_pallas=use_pallas), graph=graph_ref)
    port = repro_torch.compile(GNNConfig(**c, use_pallas=use_pallas),
                               graph=graph_port, device="cpu")
    return ref, port


def _params(ref_prog, seed=0):
    p = ref_prog.init(jax.random.PRNGKey(seed))
    return p, params_from_numpy(
        jax.tree_util.tree_map(np.asarray, p), device="cpu"
    )


@pytest.fixture(scope="module")
def mutag():
    return load_dataset("mutag")[0], ref_load("mutag")[0]


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("kind", ["gcn", "sage", "gin"])
def test_compile_run_matches_reference(mutag, kind, use_pallas):
    g_port, g_ref = mutag
    ref, port = _pair(g_port, g_ref, use_pallas=use_pallas, kind=kind)
    assert port.to_json() == ref.to_json()
    assert port.specs == [ExecSpec(**vars(s)) for s in ref.specs]
    p_ref, p_port = _params(ref)
    x = np.random.default_rng(0).normal(size=(g_ref.n_nodes, 28)).astype(np.float32)
    out_ref = np.asarray(ref.run(p_ref, jnp.asarray(x)))
    out = port.run(p_port, x)  # numpy input is copied to the device
    assert out.shape == out_ref.shape
    np.testing.assert_allclose(out.numpy(), out_ref, **TOL)


@pytest.mark.parametrize("readout", ["sum", "mean", "max"])
def test_batched_run_with_segment_ids_matches_reference(readout):
    spec_p, spec_r = TABLE4["mutag"], repro.graphs.TABLE4["mutag"]
    gp = [make_graph(spec_p, np.random.default_rng(100 + i)) for i in range(5)]
    gr = [ref_make(spec_r, np.random.default_rng(100 + i)) for i in range(5)]
    bp, br = assemble(gp[:3]), ref_assemble(gr[:3])  # 3 graphs in 4 slots
    assert bp.slots == br.slots == 4
    ref, port = _pair(bp.graph, br.graph)
    port = port.bind(bp.graph, pad_degree=bp.d_bucket)
    ref = ref.bind(br.graph, pad_degree=br.d_bucket)
    p_ref, p_port = _params(ref, seed=1)
    rng = np.random.default_rng(7)
    x = bp.batch_features([rng.normal(size=(g.n_nodes, 28)).astype(np.float32)
                           for g in gp[:3]])
    out_ref = np.asarray(ref.run(p_ref, jnp.asarray(x),
                                 segment_ids=jnp.asarray(br.segment_ids),
                                 num_segments=br.slots, readout=readout))
    out = port.run(p_port, torch.from_numpy(x),
                   segment_ids=torch.from_numpy(bp.segment_ids),
                   num_segments=bp.slots, readout=readout).numpy()
    assert out.shape == (4, 4)
    # rows 0..2 are the member graphs; row 3 reduces the pad rows, which
    # carry id n_graphs and which a server slices off
    np.testing.assert_allclose(out, out_ref, **TOL)


def test_program_json_loads_across_packages(mutag, tmp_path):
    g_port, g_ref = mutag
    ref, port = _pair(g_port, g_ref, use_pallas=True)
    ref_path = ref.save(tmp_path / "ref.program.json")
    loaded = repro_torch.Program.load(ref_path, graph=g_port, device="cpu")
    assert loaded.to_json() == ref.to_json()
    assert loaded.use_pallas is True and loaded.adj is not None
    port_path = port.save(tmp_path / "port.program.json")
    assert port_path.read_bytes() == ref_path.read_bytes()
    back = repro.Program.load(port_path, graph=g_ref)
    assert back.to_json() == port.to_json()
    with pytest.raises(ValueError, match="fingerprint"):
        repro_torch.Program.load(port_path, graph=load_dataset("cora")[0],
                                 device="cpu")


def test_second_same_shape_run_builds_nothing(mutag):
    g_port, _ = mutag
    prog = repro_torch.compile(GNNConfig(**CFG), graph=g_port, device="cpu")
    params = prog.init(torch.Generator().manual_seed(0))
    x = torch.zeros(g_port.n_nodes, 28)
    assert prog.prime(params) == 1
    before = repro_torch.trace_count()
    prog.run(params, x)
    prog.bind(g_port).run(params, x)  # a same-shape rebind shares the cache
    assert repro_torch.trace_count() == before
    assert prog.degraded(use_pallas=True).prime(params) == 1  # own cache


def test_no_device_without_cuda_raises(mutag):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device, so the default is valid")
    g_port, _ = mutag
    with pytest.raises(RuntimeError, match="no CUDA device"):
        repro_torch.compile(GNNConfig(**CFG), graph=g_port)
    prog = repro_torch.compile(GNNConfig(**CFG), graph=g_port, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        repro_torch.Program.from_json(prog.to_json()).bind(g_port)


def test_tensor_on_another_device_raises(mutag):
    g_port, _ = mutag
    prog = repro_torch.compile(GNNConfig(**CFG), graph=g_port, device="cpu")
    params = prog.init(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="program runs on cpu"):
        prog.run(params, torch.zeros(g_port.n_nodes, 28, device="meta"))
    params[0]["w"] = params[0]["w"].to("meta")
    with pytest.raises(ValueError, match="params"):
        prog.run(params, torch.zeros(g_port.n_nodes, 28))


def test_loss_matches_reference(mutag):
    g_port, g_ref = mutag
    ref, port = _pair(g_port, g_ref)
    p_ref, p_port = _params(ref, seed=3)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(g_ref.n_nodes, 28)).astype(np.float32)
    labels = rng.integers(0, 4, g_ref.n_nodes).astype(np.int32)
    mask = (rng.random(g_ref.n_nodes) < 0.3).astype(np.float32)
    l_ref = float(ref.loss(p_ref, jnp.asarray(x), jnp.asarray(labels),
                           jnp.asarray(mask)))
    l_port = float(port.loss(p_port, x, labels, mask))
    np.testing.assert_allclose(l_port, l_ref, **TOL)
