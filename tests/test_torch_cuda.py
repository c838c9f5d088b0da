"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Marked ``cuda``; each test skips where no CUDA device is present
(there is no way to run a CUDA kernel on the CPU).  This file imports no
JAX, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.gnn import GNNConfig
from repro_torch.graphs import from_edges, load_dataset
from repro_torch.kernels.fused_agg_cmb import fused_agg_cmb, fused_ref
from repro_torch.kernels.spmm import spmm, spmm_ref, spmm_streamed

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


def ell(v, deg, seed, dev, d_pad=None):
    rng = np.random.default_rng(seed)
    n = v * deg // 2
    g = from_edges(v, rng.integers(0, v, n), rng.integers(0, v, n))
    idx, wts, _ = g.to_ell(pad_to=d_pad)
    return (torch.as_tensor(idx, device=dev), torch.as_tensor(wts, device=dev))


def randn(shape, seed, dev, dtype=torch.float32):
    a = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return torch.as_tensor(a, device=dev).to(dtype)


# (V, degree, F): ragged rows and columns, a width-1 table, a wide table
SPMM_SHAPES = [(64, 4, 32), (200, 8, 96), (17, 3, 5), (333, 6, 1), (130, 5, 1433)]
# (V, degree, F, G): G within one tile, G over several tiles, ragged F
FUSED_SHAPES = [(64, 4, 32, 16), (130, 6, 48, 8), (257, 5, 1433, 16),
                (90, 3, 70, 100), (40, 2, 3, 1)]


@pytest.mark.parametrize("v,deg,f", SPMM_SHAPES)
def test_spmm_kernel_matches_plain(dev, v, deg, f):
    idx, wts = ell(v, deg, v, dev)
    x = randn((v, f), v + 1, dev)
    before = spmm.launches
    out = spmm(idx, wts, x)
    torch.cuda.synchronize()
    assert spmm.launches == before + 1
    torch.testing.assert_close(out, spmm_ref(idx, wts, x), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("v,deg,f,g", FUSED_SHAPES)
def test_fused_kernel_matches_plain(dev, v, deg, f, g):
    idx, wts = ell(v, deg, v, dev)
    x, w = randn((v, f), v + 1, dev), randn((f, g), v + 2, dev)
    before = fused_agg_cmb.launches
    out = fused_agg_cmb(idx, wts, x, w, band_size=32, block_f=16)
    torch.cuda.synchronize()
    assert fused_agg_cmb.launches == before + 1
    torch.testing.assert_close(out, fused_ref(idx, wts, x, w), rtol=2e-4, atol=2e-4)


def test_bf16_kernels_match_plain(dev):
    idx, wts = ell(300, 6, 7, dev)
    x = randn((300, 200), 8, dev, torch.bfloat16)
    w = randn((200, 16), 9, dev, torch.bfloat16)
    out = spmm(idx, wts, x)
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(out, spmm_ref(idx, wts, x), rtol=2e-2, atol=2e-2)
    out = fused_agg_cmb(idx, wts, x, w)
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(out, fused_ref(idx, wts, x, w), rtol=2e-2, atol=2e-2)


def test_spmm_streamed_is_bit_identical(dev):
    idx, wts = ell(3000, 6, 11, dev, d_pad=16)
    x = randn((3000, 40), 12, dev)
    assert torch.equal(spmm_streamed(idx, wts, x, block_rows=1024),
                       spmm(idx, wts, x))


@pytest.mark.parametrize("policy,order", [("sp_opt", "AC"), ("seq", "AC"),
                                          ("seq", "CA")])
def test_kernel_tier_matches_eager_tier_on_card(dev, policy, order):
    from repro_torch.core.schedule import ModelSchedule

    g, _ = load_dataset("mutag")
    dims = [(28, 16), (16, 4)]
    prog = repro_torch.compile(
        GNNConfig(f_in=28, n_classes=4, use_pallas=True), graph=g, device=dev,
        schedule=ModelSchedule.from_policies(policy, order, dims),
    )
    params = prog.init(torch.Generator().manual_seed(0))
    x = randn((g.n_nodes, 28), 1, dev)
    counter = fused_agg_cmb if policy == "sp_opt" else spmm
    before = counter.launches
    out = prog.run(params, x)
    assert counter.launches == before + 2  # one launch per layer
    eager = prog.degraded(use_pallas=False).run(params, x)
    torch.testing.assert_close(out, eager, rtol=2e-4, atol=2e-4)
