"""Parity of the port's GNN training with the reference's, on the CPU:
``Program.train_step`` for every kind x policy x order from the same
JAX-converted weights, the executable cache's zero-build contract for warm
steps, the refusal of the kernel tier (no hand-written kernel has a
backward, as no Pallas kernel has one), and the eager tier's dense
product and aggregation: differentiable, with the same forward bits with
and without autograd."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro.core.cost_model import GNNLayerWorkload as RefWorkload
from repro.core.schedule import ModelSchedule as RefSchedule
from repro.gnn.model import make_node_classification_task as ref_task
from repro.graphs import from_edges as ref_from_edges
from repro_torch.core.cost_model import GNNLayerWorkload
from repro_torch.core.schedule import ModelSchedule
from repro_torch.gnn import make_node_classification_task, params_from_numpy
from repro_torch.gnn.layers import aggregate_band, kernel_matmul
from repro_torch.graphs import from_edges
from repro_torch.kernels.common import ROW_TILE, row_matmul
from repro_torch.kernels.flash_attention import attend, flash_attention
from repro_torch.kernels.fused_agg_cmb import fused_agg_cmb
from repro_torch.kernels.gemm_dataflow import gemm
from repro_torch.kernels.spmm import spmm

TOL = dict(rtol=2e-4, atol=2e-4)
DIMS = [(12, 16), (16, 4)]
KERNELS = (spmm, fused_agg_cmb, gemm, flash_attention)


def _edges(v=40):
    src = np.arange(v)
    s = np.concatenate([src, (src + 1) % v, src])
    d = np.concatenate([(src + 1) % v, src, (src * 7) % v])
    return v, s, d


@pytest.fixture(scope="module")
def graphs():
    v, s, d = _edges()
    return from_edges(v, s, d), ref_from_edges(v, s, d)


def _pair(graphs, kind="gcn", policy="sp_opt", order="AC", band=16, use_pallas=False):
    gp, gr = graphs
    ref = repro.compile(
        [RefWorkload(gr.nnz, fi, fo) for fi, fo in DIMS], graph=gr, kind=kind,
        use_pallas=use_pallas,
        schedule=RefSchedule.from_policies(policy, order, DIMS, band_size=band),
    )
    port = repro_torch.compile(
        [GNNLayerWorkload(gp.nnz, fi, fo) for fi, fo in DIMS], graph=gp,
        kind=kind, use_pallas=use_pallas, device="cpu",
        schedule=ModelSchedule.from_policies(policy, order, DIMS, band_size=band),
    )
    p_ref = ref.init(jax.random.PRNGKey(0))
    p_port = params_from_numpy(jax.tree_util.tree_map(np.asarray, p_ref), device="cpu")
    return ref, port, p_ref, p_port


def _task(graphs, seed=0):
    gp, gr = graphs
    return ref_task(gr, 12, 4, seed=seed), make_node_classification_task(
        gp, 12, 4, seed=seed, device="cpu")


def test_task_is_the_reference_task_bit_for_bit(graphs):
    ref, port = _task(graphs, seed=3)
    for a, b in zip(ref, port):
        assert b.device.type == "cpu"
        assert np.array_equal(np.asarray(a), b.numpy())
        assert np.asarray(a).dtype == b.numpy().dtype


@pytest.mark.parametrize("order", ["AC", "CA"])
@pytest.mark.parametrize("policy", ["seq", "sp_generic", "sp_opt", "pp"])
@pytest.mark.parametrize("kind", ["gcn", "sage", "gin"])
def test_train_step_matches_reference(graphs, kind, policy, order):
    ref, port, p_ref, p_port = _pair(graphs, kind, policy, order)
    (x, l, m), (xp, lp, mp) = _task(graphs)
    loss_ref, new_ref = ref.train_step(p_ref, x, l, m, lr=0.05)
    loss, new = port.train_step(p_port, xp, lp, mp, lr=0.05)
    assert loss.grad_fn is None and loss.shape == ()
    np.testing.assert_allclose(float(loss), float(loss_ref), **TOL)
    for a, b in zip(new_ref, new):
        assert sorted(a) == sorted(b)
        for k in a:
            assert b[k].grad_fn is None and not b[k].requires_grad
            np.testing.assert_allclose(b[k].numpy(), np.asarray(a[k]), **TOL)


@pytest.mark.parametrize("order", ["AC", "CA"])
@pytest.mark.parametrize("policy", ["seq", "sp_generic", "sp_opt", "pp"])
def test_loss_backward_matches_reference_grads(graphs, policy, order):
    """``Program.loss(...).backward()`` works on the eager tier and gives
    the reference's gradients."""
    ref, port, p_ref, p_port = _pair(graphs, "sage", policy, order)
    (x, l, m), (xp, lp, mp) = _task(graphs, seed=1)
    g_ref = jax.grad(lambda p: ref.loss(p, x, l, m))(p_ref)
    for layer in p_port:
        for v in layer.values():
            v.requires_grad_()
    port.loss(p_port, xp, lp, mp).backward()
    for a, b in zip(g_ref, p_port):
        for k in a:
            assert b[k].grad is not None, k
            np.testing.assert_allclose(b[k].grad.numpy(), np.asarray(a[k]), **TOL)


def test_warm_steps_build_nothing_and_loss_falls(graphs):
    """The port of tests/test_calibrate.py's TestTrainStep: the first step
    builds the executable, three warm steps build nothing, the loss falls;
    a same-shape rebind shares the cache and builds nothing either."""
    _, port, _, params = _pair(graphs)
    _, (x, l, m) = _task(graphs)
    loss0, params = port.train_step(params, x, l, m)
    builds = repro_torch.trace_count()
    for _ in range(3):
        loss, params = port.train_step(params, x, l, m)
    assert repro_torch.trace_count() == builds
    assert float(loss) < float(loss0)
    rebound = port.bind(graphs[0])
    rebound.train_step(params, x, l, m)
    assert repro_torch.trace_count() == builds
    port.train_step(params, x, l, m, lr=0.01)  # lr is part of the key
    assert repro_torch.trace_count() == builds + 1


def test_train_step_on_a_host_mesh_matches_no_mesh(graphs):
    """PP on a two-group CPU mesh (the producer/consumer band hand-off in
    program order) differentiates, and gives the one-device fallback's
    step."""
    _, port, _, params = _pair(graphs, "gcn", "pp", "AC")
    _, (x, l, m) = _task(graphs)
    loss_a, new_a = port.train_step(params, x, l, m)
    loss_b, new_b = port.train_step(params, x, l, m, mesh=["cpu", "cpu"])
    assert torch.equal(loss_a, loss_b)
    for a, b in zip(new_a, new_b):
        for k in a:
            torch.testing.assert_close(b[k], a[k], **TOL)


def test_train_step_on_a_cuda_mesh_is_refused(graphs):
    _, port, _, params = _pair(graphs, "gcn", "pp", "AC")
    _, (x, l, m) = _task(graphs)
    builds = repro_torch.trace_count()
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 6b"):
        port.train_step(params, x, l, m, mesh=["cuda:0", "cuda:0"])
    assert repro_torch.trace_count() == builds


@pytest.mark.parametrize("policy,order", [("sp_opt", "AC"), ("seq", "CA"), ("seq", "AC")])
def test_kernel_tier_training_is_refused_in_both_packages(graphs, policy, order):
    ref, port, p_ref, p_port = _pair(graphs, "gcn", policy, order, use_pallas=True)
    (x, l, m), (xp, lp, mp) = _task(graphs)
    with pytest.raises(ValueError):
        ref.train_step(p_ref, x, l, m)
    for k in KERNELS:
        k.launches = 0
    builds = repro_torch.trace_count()
    with pytest.raises(ValueError, match=r"degraded\(use_pallas=False\)"):
        port.train_step(p_port, xp, lp, mp)
    assert repro_torch.trace_count() == builds
    assert all(k.launches == 0 for k in KERNELS)
    # the named way out trains, and agrees with the reference's eager tier
    loss_ref, _ = ref.degraded(use_pallas=False).train_step(p_ref, x, l, m)
    loss, _ = port.degraded(use_pallas=False).train_step(p_port, xp, lp, mp)
    np.testing.assert_allclose(float(loss), float(loss_ref), **TOL)


@pytest.mark.parametrize("policy,order", [
    ("sp_generic", "AC"), ("sp_generic", "CA"), ("sp_opt", "CA"), ("pp", "AC"), ("pp", "CA"),
])
def test_kernel_tier_trains_where_no_kernel_is_reached(graphs, policy, order):
    """With ``use_pallas=True`` the schedules that have no kernel run the
    eager path and train in both packages, alike, with no launch."""
    ref, port, p_ref, p_port = _pair(graphs, "gcn", policy, order, use_pallas=True)
    (x, l, m), (xp, lp, mp) = _task(graphs)
    loss_ref, new_ref = ref.train_step(p_ref, x, l, m)
    for k in KERNELS:
        k.launches = 0
    loss, new = port.train_step(p_port, xp, lp, mp)
    assert all(k.launches == 0 for k in KERNELS)
    np.testing.assert_allclose(float(loss), float(loss_ref), **TOL)
    for a, b in zip(new_ref, new):
        for k in a:
            np.testing.assert_allclose(b[k].numpy(), np.asarray(a[k]), **TOL)


def test_a_failed_first_train_step_is_not_cached(graphs):
    """As in ``run``: a step whose first run raises is built again next
    time; a wrong layer count raises before any build."""
    _, port, _, params = _pair(graphs, "gcn", "sp_opt", "CA")
    _, (x, l, m) = _task(graphs)
    lr = 0.0375  # a key no other test builds
    builds = repro_torch.trace_count()
    with pytest.raises(ValueError, match="layers"):
        port.train_step(params[:1], x, l, m, lr=lr)
    assert repro_torch.trace_count() == builds
    bad = [dict(params[0], w=torch.zeros(3, 3)), params[1]]
    with pytest.raises(RuntimeError):
        port.train_step(bad, x, l, m, lr=lr)
    assert repro_torch.trace_count() == builds + 1
    port.train_step(params, x, l, m, lr=lr)
    assert repro_torch.trace_count() == builds + 2
    port.train_step(params, x, l, m, lr=lr)
    assert repro_torch.trace_count() == builds + 2


def _kernel_calls():
    """Each kernel wrapper (and the kernel tier's dense product) on small
    CPU operands: name -> (fn, tensor args, index of the float args)."""
    rng = np.random.default_rng(0)
    f = lambda *s: torch.tensor(rng.normal(size=s).astype(np.float32))  # noqa: E731
    idx = torch.tensor(rng.integers(0, 6, (8, 3)).astype(np.int32))
    wts = torch.tensor(rng.uniform(size=(8, 3)).astype(np.float32))
    q, k = f(1, 2, 8, 8), f(1, 2, 8, 8)
    return {
        "spmm": (spmm, [idx, wts, f(6, 5)]),
        "fused_agg_cmb": (fused_agg_cmb, [idx, wts, f(6, 5), f(5, 4)]),
        "gemm": (gemm, [f(6, 5), f(5, 4)]),
        "kernel_matmul": (kernel_matmul, [f(6, 5), f(5, 4)]),
        "flash_attention": (flash_attention, [q, k, f(1, 2, 8, 8)]),
        "attend": (lambda a, b, c: attend(a, b, c, torch.arange(8), torch.arange(8)),
                   [q.transpose(1, 2), k.transpose(1, 2), f(1, 8, 2, 8)]),
    }


@pytest.mark.parametrize("name", sorted(_kernel_calls()))
def test_kernel_wrappers_refuse_gradients(name):
    fn, args = _kernel_calls()[name]
    floats = [i for i, a in enumerate(args) if a.is_floating_point()]
    want = fn(*args)  # nothing requires grad: the plain version runs
    for i in floats:
        grad_args = [a.clone().requires_grad_(j == i) for j, a in enumerate(args)]
        with pytest.raises(RuntimeError, match="no backward"):
            fn(*grad_args)
        with torch.no_grad():  # the same call with autograd off runs
            assert torch.equal(fn(*grad_args), want)


def test_row_matmul_and_aggregate_band_bits_do_not_depend_on_grad_mode():
    """The eager tier's forward bits are the same with autograd on (inputs
    that require grad, the custom backward recorded) and off, so training
    support changes no served bit."""
    rng = np.random.default_rng(5)
    for n in (1, 37, ROW_TILE, 2 * ROW_TILE + 5):
        x = torch.tensor(rng.normal(size=(n, 33)).astype(np.float32))
        w = torch.tensor(rng.normal(size=(33, 7)).astype(np.float32))
        off = row_matmul(x, w)
        on = row_matmul(x.clone().requires_grad_(), w.clone().requires_grad_())
        assert on.grad_fn is not None
        assert torch.equal(on.detach(), off)
        idx = torch.tensor(rng.integers(0, 40, (n, 9)).astype(np.int32))
        wts = torch.tensor(rng.uniform(size=(n, 9)).astype(np.float32))
        feats = torch.tensor(rng.normal(size=(40, 6)).astype(np.float32))
        off = aggregate_band(idx, wts, feats)
        on = aggregate_band(idx, wts.clone().requires_grad_(),
                            feats.clone().requires_grad_())
        assert on.grad_fn is not None
        assert torch.equal(on.detach(), off)


def test_row_matmul_and_aggregate_band_gradients_are_exact():
    """Both backwards against finite differences, in float64."""
    rng = np.random.default_rng(6)
    d = lambda *s: torch.tensor(rng.normal(size=s), requires_grad=True)  # noqa: E731
    assert torch.autograd.gradcheck(row_matmul, (d(ROW_TILE + 3, 5), d(5, 4)))
    idx = torch.tensor(rng.integers(0, 7, (11, 5)).astype(np.int32))
    assert torch.autograd.gradcheck(
        lambda w, x: aggregate_band(idx, w, x), (d(11, 5), d(7, 3)))
