"""Parity of the port's GNN layers with the reference's, on the CPU: the
``tests/test_layers_numerics.py`` matrix (V=157, band 32, policy x order x
kind, both tiers) from the same JAX-initialized weights, the segment
readout (pad ids, empty segments) and the ExecSpec conflict check."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.gnn as rgnn
import repro_torch.gnn as tgnn
from repro.graphs import from_edges as ref_from_edges
from repro_torch.core.schedule import ExecSpec
from repro_torch.graphs import from_edges

V = 157  # prime: v_pad % band_size != 0 for every power-of-two band
F_IN, F_OUT = 20, 12
BAND = 32
TOL = dict(rtol=2e-4, atol=2e-4)


def _edges():
    rng = np.random.default_rng(11)
    return rng.integers(0, V, 600), rng.integers(0, V, 600)


@pytest.fixture(scope="module")
def adjs():
    src, dst = _edges()
    ref = rgnn.EllAdjacency.from_csr(ref_from_edges(V, src, dst))
    port = tgnn.EllAdjacency.from_csr(from_edges(V, src, dst), device="cpu")
    return ref, port


@pytest.fixture(scope="module")
def x_np():
    return np.random.default_rng(12).normal(size=(V, F_IN)).astype(np.float32)


def test_adjacency_identical(adjs):
    ref, port = adjs
    assert port.indices.dtype == torch.int32
    np.testing.assert_array_equal(port.indices.numpy(), np.asarray(ref.indices))
    np.testing.assert_array_equal(port.weights.numpy(), np.asarray(ref.weights))
    assert (port.n_nodes, port.v_pad) == (ref.n_nodes, ref.v_pad)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("kind", sorted(rgnn.LAYER_FNS))
@pytest.mark.parametrize("order", ["AC", "CA"])
@pytest.mark.parametrize("policy", rgnn.POLICIES)
def test_policy_order_kind_matrix(kind, order, policy, use_pallas, adjs, x_np):
    ref_adj, adj = adjs
    params = rgnn.init_layer(kind, jax.random.PRNGKey(42), F_IN, F_OUT)
    ref = rgnn.LAYER_FNS[kind](
        params, ref_adj, jnp.asarray(x_np), policy=policy, order=order,
        band_size=BAND, use_pallas=use_pallas,
    )
    (p,) = tgnn.params_from_numpy(
        [jax.tree_util.tree_map(np.asarray, params)], device="cpu"
    )
    out = tgnn.LAYER_FNS[kind](
        p, adj, torch.from_numpy(x_np), policy=policy, order=order,
        band_size=BAND, use_pallas=use_pallas,
    )
    assert tuple(out.shape) == tuple(ref.shape)
    np.testing.assert_allclose(
        out.numpy(), np.asarray(ref), **TOL,
        err_msg=f"{kind}/{policy}/{order}/pallas={use_pallas}",
    )


@pytest.mark.parametrize("band", [7, 13, 32, 100, 1024])
def test_ragged_band_sizes_match_reference(band, adjs, x_np):
    ref_adj, adj = adjs
    w = np.random.default_rng(14).normal(size=(F_IN, F_OUT)).astype(np.float32)
    ref = rgnn.multiphase_matmul(ref_adj, jnp.asarray(x_np), jnp.asarray(w),
                                 policy="sp_generic", order="AC", band_size=band)
    out = tgnn.multiphase_matmul(adj, torch.from_numpy(x_np), torch.from_numpy(w),
                                 policy="sp_generic", order="AC", band_size=band)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_spec_conflict_raises(adjs, x_np):
    _, adj = adjs
    x = torch.from_numpy(x_np)
    w = torch.zeros(F_IN, F_OUT)
    spec = ExecSpec(policy="seq", order="AC", band_size=32)
    with pytest.raises(ValueError, match="conflicting"):
        tgnn.multiphase_matmul(adj, x, w, policy="sp_opt", spec=spec)
    with pytest.raises(ValueError, match="conflicting"):
        tgnn.multiphase_matmul(adj, x, w, band_size=64, spec=spec)
    out = tgnn.multiphase_matmul(adj, x, w, policy="seq", band_size=32, spec=spec)
    assert out.shape == (V, F_OUT)
    with pytest.raises(ValueError, match="policy must be one of"):
        tgnn.multiphase_matmul(adj, x, w, policy="nope")


@pytest.mark.parametrize("reduce", ["sum", "mean", "max"])
def test_segment_readout_matches_reference(reduce):
    rng = np.random.default_rng(21)
    h = rng.normal(size=(40, 6)).astype(np.float32)
    num_segments = 8
    # segments 0..4 populated, 5..7 empty; pad rows carry num_segments
    ids = np.sort(rng.integers(0, 5, 32)).astype(np.int32)
    ids = np.concatenate([ids, np.full(8, num_segments, np.int32)])
    ref = np.asarray(rgnn.segment_readout(jnp.asarray(h), jnp.asarray(ids),
                                          num_segments, reduce=reduce))
    out = tgnn.segment_readout(torch.from_numpy(h), torch.from_numpy(ids),
                               num_segments, reduce=reduce).numpy()
    assert out.shape == (num_segments, 6)
    empty = np.setdiff1d(np.arange(num_segments), ids)
    assert len(empty) >= 3
    if reduce == "max":
        assert np.all(np.isneginf(out[empty])) and np.all(np.isneginf(ref[empty]))
    else:
        assert np.all(out[empty] == 0)
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)


def test_segment_readout_rejects_unknown_reduce():
    with pytest.raises(ValueError, match="reduce must be one of"):
        tgnn.segment_readout(torch.zeros(3, 2), torch.zeros(3, dtype=torch.int32),
                             2, reduce="median")


def test_init_layer_is_seeded_and_device_explicit():
    a = tgnn.init_layer("sage", torch.Generator().manual_seed(3), 8, 4, device="cpu")
    b = tgnn.init_layer("sage", torch.Generator().manual_seed(3), 8, 4, device="cpu")
    assert set(a) == {"w_top", "w_bottom", "b"}
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert a["w_top"].shape == (8, 4) and a["w_top"].device.type == "cpu"
    with pytest.raises(KeyError):
        tgnn.init_layer("gat", torch.Generator(), 8, 4, device="cpu")
