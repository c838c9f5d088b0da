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
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import (
    attend,
    attend_chunked,
    attention_ref,
    flash_attention,
)
from repro_torch.kernels.fused_agg_cmb import fused_agg_cmb, fused_ref
from repro_torch.kernels.gemm_dataflow import DATAFLOWS, gemm, gemm_ref
from repro_torch.kernels.spmm import spmm, spmm_ref, spmm_streamed
from repro_torch.models import forward, init_params, make_inputs

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


def skewed_ell(v, seed, d=256):
    """A padded ELL of skewed degree: one hub row of full D, the rest of
    degree 1-2; row 5 has all-zero weights (its indices point at real rows)
    and row 7 a weight-0 slot in the middle of its real slots."""
    rng = np.random.default_rng(seed)
    idx = np.zeros((v, d), np.int32)
    wts = np.zeros((v, d), np.float32)
    deg = rng.integers(1, 3, v)
    deg[v // 3] = d
    for r in range(v):
        idx[r, :deg[r]] = rng.integers(0, v, deg[r])
        wts[r, :deg[r]] = rng.uniform(0.1, 1.0, deg[r])
    idx[5, :3], wts[5] = (1, 2, 3), 0.0
    idx[7, :3], wts[7, :3] = (4, 9, 11), (0.5, 0.0, 0.25)
    return idx, wts


def ell(v, deg, seed, dev, d_pad=None):
    """A random graph's padded ELL of mean degree ``deg``; with
    ``deg="skewed"`` the ELL of :func:`skewed_ell`; with ``deg="dense"``
    every row holds 256 real slots (more real slots in a CTA's rows than the
    kernels stage in shared memory: the rest are read from the ELL); with
    ``deg="padded"`` a serving batch's layout: a graph on the first half of
    the rows, then pad rows whose one slot is a weight-0 self-loop (whole
    CTAs without a real slot)."""
    if deg == "skewed":
        return tuple(torch.as_tensor(a, device=dev) for a in skewed_ell(v, seed))
    if deg == "padded":
        rng = np.random.default_rng(seed)
        half = v // 2
        g = from_edges(half, rng.integers(0, half, 3 * half), rng.integers(0, half, 3 * half))
        gi, gw, _ = g.to_ell(pad_to=32)
        idx, wts = np.zeros((v, 32), np.int32), np.zeros((v, 32), np.float32)
        idx[:half], wts[:half] = gi, gw
        idx[half:, 0] = np.arange(half, v)
        return torch.as_tensor(idx, device=dev), torch.as_tensor(wts, device=dev)
    if deg == "dense":
        rng = np.random.default_rng(seed)
        idx = rng.integers(0, v, (v, 256)).astype(np.int32)
        wts = rng.uniform(0.1, 1.0, (v, 256)).astype(np.float32)
        return torch.as_tensor(idx, device=dev), torch.as_tensor(wts, device=dev)
    rng = np.random.default_rng(seed)
    n = v * deg // 2
    g = from_edges(v, rng.integers(0, v, n), rng.integers(0, v, n))
    idx, wts, _ = g.to_ell(pad_to=d_pad)
    return (torch.as_tensor(idx, device=dev), torch.as_tensor(wts, device=dev))


def randn(shape, seed, dev, dtype=torch.float32):
    a = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return torch.as_tensor(a, device=dev).to(dtype)


TOL = {"f32": {"spmm": dict(rtol=1e-4, atol=1e-5), "fused": dict(rtol=2e-4, atol=2e-4)},
       "bf16": {"spmm": dict(rtol=2e-2, atol=2e-2), "fused": dict(rtol=2e-2, atol=2e-2)}}
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}

# (V, degree, F, dtype): ragged rows and columns, a width-1 table, a wide table;
# skewed degree (a hub row of D = 256) with odd F (one-element loads), F of
# 8- and 16-byte loads, and narrow F; V = 1001 is a multiple of no CTA's rows;
# rows of 256 real slots, more than a CTA stages
SPMM_SHAPES = [(64, 4, 32, "f32"), (200, 8, 96, "f32"), (17, 3, 5, "f32"),
               (333, 6, 1, "f32"), (130, 5, 1433, "f32"), (1001, "skewed", 1001, "f32"),
               (601, "skewed", 1002, "f32"), (257, 5, 1000, "f32"),
               (1001, "skewed", 16, "f32"), (1001, "skewed", 1, "f32"),
               (300, "dense", 1, "f32"), (2000, "padded", 1002, "f32"),
               # bfloat16: 16-byte loads (8 elements), 4-byte (2), and one element
               (300, 6, 512, "bf16"), (300, 6, 130, "bf16"), (601, "skewed", 1001, "bf16")]
# (V, degree, F, G, dtype): G within one tile, G over several tiles, ragged F;
# skewed degree with F odd and G of 8, 16 and 100, and F even (two-element
# loads); narrow F; rows of 256 real slots, more than a CTA stages; pad rows
# filling whole CTAs; bfloat16 with two-element and one-element loads
FUSED_SHAPES = [(64, 4, 32, 16, "f32"), (130, 6, 48, 8, "f32"), (257, 5, 1433, 16, "f32"),
                (90, 3, 70, 100, "f32"), (40, 2, 3, 1, "f32"),
                (601, "skewed", 1001, 8, "f32"), (601, "skewed", 1001, 16, "f32"),
                (601, "skewed", 1001, 100, "f32"), (601, "skewed", 1002, 16, "f32"),
                (1001, "skewed", 16, 8, "f32"), (1001, "skewed", 1, 16, "f32"),
                (2200, "dense", 40, 16, "f32"), (2000, "padded", 1002, 16, "f32"),
                (300, 6, 512, 16, "bf16"), (601, "skewed", 1001, 16, "bf16")]


@pytest.mark.parametrize("v,deg,f,dtype", SPMM_SHAPES)
def test_spmm_kernel_matches_plain(dev, v, deg, f, dtype):
    idx, wts = ell(v, deg, v, dev)
    x = randn((v, f), v + 1, dev, DTYPES[dtype])
    before = spmm.launches
    out = spmm(idx, wts, x)
    torch.cuda.synchronize()
    assert spmm.launches == before + 1
    assert out.dtype == x.dtype
    torch.testing.assert_close(out, spmm_ref(idx, wts, x), **TOL[dtype]["spmm"])
    assert torch.equal(out, spmm(idx, wts, x))
    assert spmm.launches == before + 2


@pytest.mark.parametrize("v,deg,f,g,dtype", FUSED_SHAPES)
def test_fused_kernel_matches_plain(dev, v, deg, f, g, dtype):
    idx, wts = ell(v, deg, v, dev)
    x, w = randn((v, f), v + 1, dev, DTYPES[dtype]), randn((f, g), v + 2, dev, DTYPES[dtype])
    before = fused_agg_cmb.launches
    out = fused_agg_cmb(idx, wts, x, w, band_size=32, block_f=16)
    torch.cuda.synchronize()
    assert fused_agg_cmb.launches == before + 1
    assert out.dtype == x.dtype
    torch.testing.assert_close(out, fused_ref(idx, wts, x, w), **TOL[dtype]["fused"])
    assert torch.equal(out, fused_agg_cmb(idx, wts, x, w, band_size=32, block_f=16))
    assert fused_agg_cmb.launches == before + 2


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


def test_spmm_streamed_is_bit_identical_on_skewed_ell(dev):
    idx, wts = ell(3001, "skewed", 13, dev)
    x = randn((3001, 1001), 14, dev)
    assert torch.equal(spmm_streamed(idx, wts, x, block_rows=1024), spmm(idx, wts, x))


def test_zero_rows_are_exactly_zero_and_middle_zero_slots_are_walked(dev):
    """Rows whose weights are all 0 come out exactly 0 from both kernels;
    a weight-0 slot in the middle of a row does not end the row."""
    idx, wts = ell(601, "skewed", 15, dev)
    x, w = randn((601, 300), 16, dev), randn((300, 16), 17, dev)
    zero = (wts == 0).all(dim=1)
    assert bool(zero[5]) and int(zero.sum()) == 1
    out_s, out_f = spmm(idx, wts, x), fused_agg_cmb(idx, wts, x, w)
    assert bool((out_s[zero] == 0).all()) and bool((out_f[zero] == 0).all())
    row7 = 0.5 * x[4] + 0.25 * x[11]
    torch.testing.assert_close(out_s[7], row7, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(out_f[7], row7 @ w, rtol=2e-4, atol=2e-4)


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


# (B, Hq, Hkv, Sq, Sk, D): the reference's kernel-test shapes, GQA, a ragged
# length, every head_dim class of the kernel (8 .. 256)
FLASH_SHAPES = [(2, 4, 2, 96, 96, 32), (1, 8, 1, 64, 128, 16), (2, 2, 2, 33, 33, 64),
                (1, 9, 3, 200, 200, 64), (1, 4, 4, 70, 45, 8), (1, 2, 1, 130, 130, 128),
                (1, 3, 3, 17, 300, 40), (1, 5, 1, 150, 150, 256), (1, 2, 2, 70, 90, 200)]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("b,hq,hkv,sq,sk,d", FLASH_SHAPES)
def test_flash_kernel_matches_plain(dev, b, hq, hkv, sq, sk, d, causal):
    q, k, v = (randn(s, i, dev) for i, s in
               enumerate([(b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, d)]))
    before = flash_attention.launches
    out = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    rep = hq // hkv
    kr = k.repeat_interleave(rep, dim=1).reshape(b * hq, sk, d)
    vr = v.repeat_interleave(rep, dim=1).reshape(b * hq, sk, d)
    ref = attention_ref(q.reshape(b * hq, sq, d), kr, vr, causal=causal)
    torch.testing.assert_close(out.reshape(b * hq, sq, d), ref, rtol=2e-4, atol=2e-5)


def test_flash_kernel_bf16_matches_plain(dev):
    q, k, v = (randn((2, 9, 256, 64), i, dev, torch.bfloat16) for i in range(3))
    out = flash_attention(q, k[:, :3], v[:, :3], causal=True)
    assert out.dtype == torch.bfloat16
    plain = attend_chunked(q.transpose(1, 2), k[:, :3].transpose(1, 2),
                           v[:, :3].transpose(1, 2), torch.arange(256, device=dev),
                           torch.arange(256, device=dev))
    torch.testing.assert_close(out, plain.transpose(1, 2), rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("window,offset", [(0, 0), (0, 9), (7, 3)])
def test_attend_kernel_masks_on_positions(dev, window, offset):
    b, s, hq, hkv, d = 2, 150, 6, 2, 32
    q = randn((b, s, hq, d), 1, dev)
    k, v = randn((b, s, hkv, d), 2, dev), randn((b, s, hkv, d), 3, dev)
    pos = torch.arange(s, device=dev, dtype=torch.int32) + offset
    out = attend(q, k, v, pos, pos, window, 64)
    plain = attend_chunked(q, k, v, pos, pos, window, 64)
    torch.testing.assert_close(out, plain, rtol=2e-4, atol=2e-5)


GEMM_SHAPES = [(128, 128, 128, 32), (96, 80, 72, 32), (33, 17, 5, 32), (256, 64, 512, 32),
               (700, 300, 200, 128), (2708, 1433, 16, 128)]


@pytest.mark.parametrize("dataflow", DATAFLOWS)
@pytest.mark.parametrize("v,f,g,blk", GEMM_SHAPES)
def test_gemm_kernel_matches_plain(dev, dataflow, v, f, g, blk):
    x, w = randn((v, f), v, dev), randn((f, g), g, dev)
    before = gemm.launches
    out = gemm(x, w, dataflow=dataflow, block_v=blk, block_g=blk, block_f=blk)
    torch.cuda.synchronize()
    assert gemm.launches == before + 1
    torch.testing.assert_close(out, gemm_ref(x, w), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dataflow", DATAFLOWS)
def test_gemm_kernel_bf16_matches_plain_and_is_deterministic(dev, dataflow):
    x = randn((300, 200), 1, dev, torch.bfloat16)
    w = randn((200, 150), 2, dev, torch.bfloat16)
    out = gemm(x, w, dataflow=dataflow)
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(out, gemm_ref(x, w), rtol=3e-2, atol=3e-2)
    xf, wf = randn((1000, 700), 3, dev), randn((700, 300), 4, dev)
    assert torch.equal(gemm(xf, wf, dataflow=dataflow), gemm(xf, wf, dataflow=dataflow))


def test_lm_forward_launches_flash_per_layer_and_matches_plain_twin(dev):
    cfg = get_config("smollm-135m").reduced(n_layers=3)
    params = init_params(cfg, torch.Generator().manual_seed(0), device=dev)
    toks = make_inputs(cfg, 2, 100, seed=1, device=dev)
    before = flash_attention.launches
    logits, _ = forward(cfg, params, toks)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + cfg.n_layers
    plain, _ = forward(cfg, params, toks, use_kernels=False)
    torch.testing.assert_close(logits, plain, rtol=1e-3, atol=1e-3)


# bf16 edges of the tensor-core routes, each held against the plain version
# at the bf16 tolerance of chip_smoke.py (2e-2)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
# (V, F, G, route): ragged V/G/F tails; F = 704 is 11 K tiles, not a
# multiple of the 4-stage ring; F = 1216 is 19 K tiles, past one 9-tile
# resident slab (partials through the f32 workspace); rows TMA refuses
# (G = 150: 300-byte rows; F = 60: 120-byte rows) take the CUDA cores
GEMM_BF16_EDGES = [(300, 200, 152, "tensor_cores"), (1000, 704, 72, "tensor_cores"),
                   (129, 1216, 264, "tensor_cores"), (300, 200, 150, "cuda_cores"),
                   (64, 60, 64, "cuda_cores")]


@pytest.mark.parametrize("dataflow", DATAFLOWS)
@pytest.mark.parametrize("v,f,g,route", GEMM_BF16_EDGES)
def test_gemm_bf16_edges_match_plain(dev, dataflow, v, f, g, route):
    from repro_torch.kernels.gemm_dataflow import plan

    x = randn((v, f), v, dev, torch.bfloat16)
    w = randn((f, g), g, dev, torch.bfloat16) / np.sqrt(f)
    p = plan(v, f, g, x.dtype, dataflow, x_ptr=x.data_ptr(), w_ptr=w.data_ptr())
    assert p.route == route
    out = gemm(x, w, dataflow=dataflow)
    torch.testing.assert_close(out, gemm_ref(x, w), **BF16_TOL)
    assert torch.equal(out, gemm(x, w, dataflow=dataflow))


def test_gemm_bf16_misaligned_base_takes_cuda_cores(dev):
    """A contiguous operand whose base is not 16-byte aligned cannot be a
    TMA source: the CUDA-core route runs it, with the right numbers."""
    from repro_torch.kernels.gemm_dataflow import plan

    x = randn((256 * 128 + 1,), 1, dev, torch.bfloat16)[1:].view(256, 128)
    w = randn((128, 64), 2, dev, torch.bfloat16) / 12
    assert x.data_ptr() % 16
    assert plan(256, 128, 64, x.dtype, "output_stationary",
                x_ptr=x.data_ptr(), w_ptr=w.data_ptr()).route == "cuda_cores"
    torch.testing.assert_close(gemm(x, w), gemm_ref(x, w), **BF16_TOL)


# (B, Hq, Hkv, Sq, Sk, D): GQA 7, D 8 and 128, Sq != Sk both ways
# bf16 flash against the f32 plain version on the same bf16 inputs: the
# largest relative L2 error of one output row (chip_smoke.py's
# FLASH_ROW_REL_L2).  The output's and P's bf16 roundings give ~2e-3-6e-3;
# a key block dropped or counted twice moves a row by far more.
FLASH_ROW_REL_L2 = 1e-2


def assert_rows_close_to_f32(out, ref32):
    row = (out.float() - ref32).norm(dim=-1) / ref32.norm(dim=-1)
    assert float(row.max()) <= FLASH_ROW_REL_L2, float(row.max())


FLASH_BF16_EDGES = [(1, 14, 2, 130, 130, 128), (2, 7, 1, 200, 200, 8),
                    (1, 4, 2, 70, 300, 64), (1, 6, 3, 300, 45, 40),
                    (1, 10, 1, 200, 200, 256), (1, 4, 2, 130, 70, 136)]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("b,hq,hkv,sq,sk,d", FLASH_BF16_EDGES)
def test_flash_bf16_edges_match_plain(dev, b, hq, hkv, sq, sk, d, causal):
    q = randn((b, hq, sq, d), 1, dev, torch.bfloat16)
    k, v = randn((b, hkv, sk, d), 2, dev, torch.bfloat16), randn((b, hkv, sk, d), 3, dev,
                                                                   torch.bfloat16)
    out = flash_attention(q, k, v, causal=causal)
    plain = attend_chunked(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                           torch.arange(sq, device=dev), torch.arange(sk, device=dev),
                           causal=causal)
    torch.testing.assert_close(out, plain.transpose(1, 2), **BF16_TOL)
    plain32 = attend_chunked(q.float().transpose(1, 2), k.float().transpose(1, 2),
                             v.float().transpose(1, 2), torch.arange(sq, device=dev),
                             torch.arange(sk, device=dev), causal=causal)
    assert_rows_close_to_f32(out, plain32.transpose(1, 2))


@pytest.mark.parametrize("window", [0, 7, 100])
def test_attend_bf16_offset_positions_and_window(dev, window):
    """The model route in bf16: a query chunk at the end of a longer key
    range (Sq != Sk, positions offset), GQA 3, with and without a window."""
    b, sq, sk, hq, hkv, d = 2, 70, 200, 6, 2, 64
    q = randn((b, sq, hq, d), 4, dev, torch.bfloat16)
    k = randn((b, sk, hkv, d), 5, dev, torch.bfloat16)
    v = randn((b, sk, hkv, d), 6, dev, torch.bfloat16)
    q_pos = torch.arange(sk - sq, sk, device=dev, dtype=torch.int32) + 5
    k_pos = torch.arange(sk, device=dev, dtype=torch.int32) + 5
    out = attend(q, k, v, q_pos, k_pos, window, 64)
    torch.testing.assert_close(out, attend_chunked(q, k, v, q_pos, k_pos, window, 64),
                               **BF16_TOL)
    assert_rows_close_to_f32(out, attend_chunked(q.float(), k.float(), v.float(), q_pos,
                                                 k_pos, window, 64))


def test_flash_d256_mqa_window_matches_plain(dev):
    """recurrentgemma-2b's local blocks on the model route: D 256, MQA 10 / 1,
    S 4096 under a 2048 window (so the window masks and key blocks behind
    it are skipped), bf16 on the tensor cores."""
    b, s, hq, hkv, d, win = 1, 4096, 10, 1, 256, 2048
    q = randn((b, s, hq, d), 7, dev, torch.bfloat16)
    k, v = randn((b, s, hkv, d), 8, dev, torch.bfloat16), randn((b, s, hkv, d), 9, dev,
                                                                 torch.bfloat16)
    pos = torch.arange(s, device=dev, dtype=torch.int32)
    before = flash_attention.launches
    out = attend(q, k, v, pos, pos, win)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    torch.testing.assert_close(out, attend_chunked(q, k, v, pos, pos, win), **BF16_TOL)
    assert_rows_close_to_f32(out, attend_chunked(q.float(), k.float(), v.float(), pos,
                                                 pos, win))


def test_flash_head_dim_past_256_raises(dev):
    """A head_dim the kernel cannot take raises; it never runs the plain
    version on a CUDA tensor."""
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = (randn((1, 2, 64, 264), i, dev, dtype) for i in range(3))
        before = flash_attention.launches
        with pytest.raises(ValueError, match="head_dim"):
            flash_attention(q, k, v, causal=True)
        pos = torch.arange(64, device=dev, dtype=torch.int32)
        with pytest.raises(ValueError, match="head_dim"):
            attend(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), pos, pos)
        assert flash_attention.launches == before


def test_moe_ragged_is_bit_stable_on_card(dev):
    """granite-moe-1b-a400m's MoE layer at its published widths (bf16, 32
    experts top 8, 1024 tokens): two calls and two backwards give the same
    bits (the combine sums each token's 8 rows, with no atomics)."""
    from repro_torch.models.moe import init_moe, moe_ragged

    cfg = get_config("granite-moe-1b-a400m")
    p = init_moe(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    x = randn((2, 512, cfg.d_model), 3, dev, torch.bfloat16)
    outs, grads = [], []
    for _ in range(2):
        xg = x.clone().requires_grad_()
        pg = {k: t.clone().requires_grad_() for k, t in p.items()}
        out, aux = moe_ragged(cfg, pg, xg)
        (out.float().square().mean() + aux).backward()
        outs.append((out.detach(), aux.detach()))
        grads.append([xg.grad] + [pg[k].grad for k in sorted(pg)])
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])
    assert all(torch.equal(a, b) for a, b in zip(*grads))


def test_flash_bf16_strides_tma_refuses_take_cuda_cores(dev):
    """k and v views with 136-byte rows (D 64 of a 68-wide buffer): TMA
    cannot address them, the CUDA-core route runs them."""
    from repro_torch.kernels.flash_attention import route

    q = randn((1, 4, 100, 64), 1, dev, torch.bfloat16)
    k = randn((1, 2, 100, 68), 2, dev, torch.bfloat16)[..., :64]
    v = randn((1, 2, 100, 68), 3, dev, torch.bfloat16)[..., :64]
    views = [(t.shape, t.stride()) for t in (q, k, v, q)]
    assert route(torch.bfloat16, views, [q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                         q.data_ptr()]) == "cuda_cores"
    out = flash_attention(q, k, v, causal=True)
    plain = attend_chunked(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                           torch.arange(100, device=dev), torch.arange(100, device=dev))
    torch.testing.assert_close(out, plain.transpose(1, 2), **BF16_TOL)


# ---------------------------------------------------------------------------
# Row-count independence, the kernel-tier partitioned lane and the engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("f,g", [(1433, 16), (3782, 16), (64, 8), (500, 40)])
def test_fused_rows_do_not_depend_on_the_rows_launched(dev, f, g):
    """The same 64 rows launched alone and as the first rows of 8,192
    (which pick different rows per CTA): bit-identical outputs."""
    from repro_torch.kernels.fused_agg_cmb.ops import plan

    idx, wts = ell(64, 6, 40, dev)
    rng = np.random.default_rng(41)
    big_i = torch.as_tensor(rng.integers(0, 64, (8192, idx.shape[1])).astype(np.int32),
                            device=dev)
    big_w = torch.as_tensor(rng.uniform(0.1, 1.0, (8192, idx.shape[1])).astype(
        np.float32), device=dev)
    big_i[:64], big_w[:64] = idx, wts
    x = torch.randn(64, f, device=dev)
    w = torch.randn(f, g, device=dev) / f ** 0.5
    assert plan(idx, x, w)["rows"] != plan(big_i, x, w)["rows"]
    small = fused_agg_cmb(idx, wts, x, w)
    big = fused_agg_cmb(big_i, big_w, x, w)
    assert torch.equal(small, big[:64])


def test_fused_rows_match_across_every_rows_per_cta(dev):
    """The same 64 rows as the first rows of launches of 64, 1,024, 2,708
    and 8,192 rows, which take 4, 8, 16 and 32 rows a CTA (every height of
    a thread's combination block): bit-identical outputs."""
    from repro_torch.kernels.fused_agg_cmb.ops import plan

    idx, wts = ell(64, 6, 40, dev)
    rng = np.random.default_rng(42)
    big_i = torch.as_tensor(rng.integers(0, 64, (8192, idx.shape[1])).astype(np.int32),
                            device=dev)
    big_w = torch.as_tensor(rng.uniform(0.1, 1.0, (8192, idx.shape[1])).astype(
        np.float32), device=dev)
    big_i[:64], big_w[:64] = idx, wts
    x = torch.randn(64, 1433, device=dev)
    w = torch.randn(1433, 16, device=dev) / 1433 ** 0.5
    counts = (64, 1024, 2708, 8192)
    assert [plan(big_i[:n], x, w)["rows"] for n in counts] == [4, 8, 16, 32]
    outs = [fused_agg_cmb(big_i[:n].contiguous(), big_w[:n].contiguous(), x, w)[:64]
            for n in counts]
    assert all(torch.equal(o, outs[0]) for o in outs[1:])


@pytest.mark.parametrize("f,g", [(1433, 16), (16, 8), (3782, 16), (500, 40)])
def test_kernel_matmul_rows_are_bit_stable_on_card(dev, f, g):
    """The kernel tier's dense product (the gemm kernel): a row's result
    does not depend on the call's row count or the row's offset."""
    from repro_torch.gnn.layers import kernel_matmul

    x = torch.randn(4096, f, device=dev)
    w = torch.randn(f, g, device=dev) / f ** 0.5
    g0 = gemm.launches
    full = kernel_matmul(x, w)
    assert gemm.launches == g0 + 1
    for s, e in [(0, 96), (5, 1000), (100, 2708), (1, 2), (3, 4096)]:
        assert torch.equal(kernel_matmul(x[s:e], w), full[s:e])


def test_row_matmul_rows_are_bit_stable_on_card(dev):
    from repro_torch.kernels.common import row_matmul

    x = torch.randn(2708, 1433, device=dev)
    w = torch.randn(1433, 16, device=dev)
    full = row_matmul(x, w)
    for s, e in [(0, 96), (5, 1000), (100, 2708), (1, 2)]:
        assert torch.equal(row_matmul(x[s:e], w), full[s:e])


def test_segment_readout_is_deterministic_on_card(dev):
    from repro_torch.gnn.layers import segment_readout

    h = torch.randn(16384, 8, device=dev)
    ids = torch.arange(16384, device=dev) // 512
    a = segment_readout(h, ids, 32, "mean")
    assert all(torch.equal(a, segment_readout(h, ids, 32, "mean")) for _ in range(5))
    assert torch.equal(a[3], segment_readout(h[1536:2048], ids[:512], 1, "mean")[0])


@pytest.mark.parametrize("policy,order", [("sp_opt", "AC"), ("seq", "CA"),
                                          ("seq", "AC")])
def test_kernel_tier_row_stream_is_bit_identical(dev, policy, order):
    """cora served as a giant through the engine's partitioned lane
    (row_stream closures of 1,024 rows) on the kernel tier: bit-identical
    to the monolithic kernel-tier forward."""
    import dataclasses

    from repro_torch.core.hw import DEFAULT_ACCEL
    from repro_torch.core.schedule import ModelSchedule
    from repro_torch.graphs import BucketPolicy
    from repro_torch.runtime import InferenceEngine, Request

    g, _ = load_dataset("cora")
    dims = [(1433, 16), (16, 8)]
    sched = ModelSchedule.from_policies(policy, order, dims)
    eng = InferenceEngine(dims, use_pallas=True, readout=None, schedule=sched,
                          hw=dataclasses.replace(DEFAULT_ACCEL, gb_capacity_bytes=None),
                          objective="edp", policy=BucketPolicy(max_nodes=1024),
                          partition_oversized=True, device=dev)
    params = eng.init(torch.Generator().manual_seed(0))
    x = np.random.default_rng(0).normal(size=(g.n_nodes, 1433)).astype(np.float32)
    mono = repro_torch.compile(GNNConfig("gcn", 1433, 16, 8, use_pallas=True), graph=g,
                               schedule=sched, device=dev).run(params, x).cpu().numpy()
    fused0, spmm0 = fused_agg_cmb.launches, spmm.launches
    (res,) = eng.submit([Request(graph=g, x=x)])
    assert (res.status, res.tier, res.plan) == ("ok", "pallas+searched", "row_stream")
    assert res.n_partitions > 1 and eng.stats().n_downgrades == 0
    assert (fused_agg_cmb.launches > fused0) if policy == "sp_opt" else (
        spmm.launches > spmm0)
    assert np.array_equal(res.output, mono)


def test_engine_serves_on_the_kernel_tier_without_downgrades(dev):
    from repro_torch.graphs import TABLE4, BucketPolicy, sample_graphs
    from repro_torch.runtime import InferenceEngine, Request

    eng = InferenceEngine([(28, 16), (16, 4)], use_pallas=True, device=dev,
                          policy=BucketPolicy(max_graphs=8))
    eng.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    reqs = [Request(graph=gr, x=rng.normal(size=(gr.n_nodes, 28)).astype(np.float32),
                    rid=i) for i, gr in enumerate(sample_graphs(TABLE4["mutag"], 12))]
    fused0 = fused_agg_cmb.launches
    first = eng.submit(reqs)
    assert fused_agg_cmb.launches > fused0
    assert all(r.status == "ok" and r.tier == "pallas+searched" for r in first)
    assert eng.stats().n_downgrades == 0
    before = repro_torch.trace_count()
    again = eng.submit(reqs)
    assert repro_torch.trace_count() == before
    assert all(np.array_equal(a.output, b.output) for a, b in zip(first, again))


def test_pp_two_streams_over_256_bands_bit_identical(dev):
    """The Parallel Pipeline on two streams of one card, 256 bands of 128
    rows: the eager tier is the one-device fallback bit for bit, the
    kernel tier within 2e-4, on every repeat (a band read before its
    producer finished, or a slot refilled early, would show here)."""
    from repro_torch.gnn import EllAdjacency, multiphase_matmul

    v = 256 * 128
    rng = np.random.default_rng(11)
    g = from_edges(v, rng.integers(0, v, 3 * v), rng.integers(0, v, 3 * v))
    adj = EllAdjacency.from_csr(g, device=dev)
    x = torch.as_tensor(rng.normal(size=(v, 96)).astype(np.float32), device=dev)
    w = torch.as_tensor(rng.normal(size=(96, 16)).astype(np.float32), device=dev)
    want = multiphase_matmul(adj, x, w, policy="pp")
    spmm0, gemm0 = spmm.launches, gemm.launches
    for _ in range(3):
        got = multiphase_matmul(adj, x, w, policy="pp", mesh=[dev, dev])
        kern = multiphase_matmul(adj, x, w, policy="pp", mesh=[dev, dev], use_pallas=True)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        torch.testing.assert_close(kern, want, rtol=2e-4, atol=2e-4)
    assert spmm.launches - spmm0 == 3 * 256 and gemm.launches - gemm0 == 3 * 256


def test_pp_shard_forward_serves_on_two_cards(dev):
    """``pp_shard_forward`` on 2 or more cards used to raise (the engine
    plans ``pp_shard`` whenever it sees 2 cards); now the producer group
    runs on card 0 and the consumer on card 1, bands handed over by a peer
    copy."""
    from repro_torch.gnn import EllAdjacency, multiphase_matmul
    from repro_torch.graphs.partition import pp_shard_forward

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    cards = [torch.device("cuda", 0), torch.device("cuda", 1)]
    rng = np.random.default_rng(12)
    v = 40 * 128 + 17
    g = from_edges(v, rng.integers(0, v, 4 * v), rng.integers(0, v, 4 * v))
    x = rng.normal(size=(v, 48)).astype(np.float32)
    params = [{"w": torch.as_tensor(rng.normal(size=(48, 16)).astype(np.float32) / 7,
                                    device=cards[0]),
               "b": torch.zeros(16, device=cards[0])}]
    out = pp_shard_forward(g, x, params, n_devices=2)
    adj = EllAdjacency.from_csr(g, device=cards[0])
    xt = torch.as_tensor(x, device=cards[0])
    want = torch.relu(multiphase_matmul(adj, xt, params[0]["w"], policy="pp")
                      + params[0]["b"]).cpu().numpy()
    np.testing.assert_allclose(out, want, rtol=2e-4, atol=2e-4)
    for tier in (False, True):
        got = multiphase_matmul(adj, xt, params[0]["w"], policy="pp", mesh=cards,
                                use_pallas=tier)
        torch.cuda.synchronize()
        assert got.device == cards[0]
        np.testing.assert_allclose(torch.relu(got + params[0]["b"]).cpu().numpy(), want,
                                   rtol=2e-4, atol=2e-4)


def test_staged_batch_is_read_after_the_copy_stream(dev):
    """A worker stages a block on its copy stream; its compute stream,
    after waiting on the copy's event, reads exactly the host block.  Two
    workers on one card (labels ``cuda:N#0`` / ``#1``) serve a stream
    bit-identically to the sync engine."""
    from repro_torch.graphs import TABLE4, sample_graphs
    from repro_torch.runtime import AsyncEngine, InferenceEngine, Request

    dims = [(512, 16), (16, 4)]
    sync = InferenceEngine(dims, use_pallas=True, device=dev)
    params = sync.init(torch.Generator().manual_seed(0))
    front = AsyncEngine(dims, params, devices=[dev, dev], use_pallas=True, window_ms=20.0)
    worker = front.workers[0]
    host = np.random.default_rng(13).normal(size=(8192, 512)).astype(np.float32)
    staged = worker.stage(None, host)
    with torch.cuda.stream(worker.stream):
        worker.stream.wait_event(staged.ready)
        seen = staged.x * 1.0
    torch.cuda.synchronize()
    assert np.array_equal(seen.cpu().numpy(), host)

    rng = np.random.default_rng(14)
    reqs = [Request(graph=gr, x=rng.normal(size=(gr.n_nodes, 512)).astype(np.float32),
                    rid=i) for i, gr in enumerate(sample_graphs(TABLE4["imdb-bin"], 24))]
    want = sync.submit(reqs)
    with front:
        got = front.submit(reqs)
    assert front.labels == [f"{dev}#0", f"{dev}#1"]
    for a, b in zip(got, want):
        assert a.status == b.status == "ok" and a.tier == "pallas+searched"
        assert np.array_equal(a.output, b.output)


def test_two_threads_build_a_kernel_once(dev, tmp_path):
    """Two threads' first use of one kernel runs ``nvcc`` once and loads
    one library."""
    import threading

    from repro_torch.kernels import common
    from repro_torch.kernels.spmm import ops as spmm_ops

    old = common.BUILD_DIR
    common.set_build_dir(tmp_path)
    try:
        lib = common.CudaLibrary(spmm_ops.LIBRARY.source, spmm_ops.LIBRARY.functions)
        started, real = [], lib.start_build

        def counting():
            proc = real()
            started.append(proc is not None)
            return proc

        lib.start_build = counting
        barrier = threading.Barrier(2)
        loaded = [None, None]

        def first_use(k):
            barrier.wait()
            loaded[k] = lib.load()

        threads = [threading.Thread(target=first_use, args=(k,)) for k in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in threads)
        assert started == [True] and loaded[0] is loaded[1] is not None
        assert not list(tmp_path.glob("*.tmp.*"))
    finally:
        common.set_build_dir(old)


def _ring(v=64):
    src = np.arange(v)
    return from_edges(v, np.concatenate([src, (src + 1) % v, src]),
                      np.concatenate([(src + 1) % v, src, (src * 7) % v]))


@pytest.mark.parametrize("policy,order", [("sp_opt", "AC"), ("seq", "CA"), ("pp", "AC")])
def test_train_step_on_the_card_matches_the_cpu(dev, policy, order):
    """One GNN SGD step on the card (the eager tier through autograd)
    within 2e-4 of the same step on the CPU, from the same weights; a warm
    step builds nothing and launches no kernel."""
    from repro_torch.core.cost_model import GNNLayerWorkload
    from repro_torch.core.schedule import ModelSchedule
    from repro_torch.gnn import make_node_classification_task

    g, dims = _ring(), [(24, 16), (16, 4)]
    wls = [GNNLayerWorkload(g.nnz, fi, fo) for fi, fo in dims]
    sched = ModelSchedule.from_policies(policy, order, dims, band_size=32)
    progs = {d: repro_torch.compile(wls, graph=g, schedule=sched, device=d)
             for d in ("cpu", dev)}
    params = progs["cpu"].init(torch.Generator().manual_seed(0))
    out = {}
    for d, prog in progs.items():
        task = make_node_classification_task(g, 24, 4, device=d)
        p = [{k: v.to(d) for k, v in layer.items()} for layer in params]
        loss, new = prog.train_step(p, *task)
        builds = repro_torch.trace_count()
        for kern in (spmm, fused_agg_cmb, gemm):
            kern.launches = 0
        loss2, _ = prog.train_step(new, *task)
        assert repro_torch.trace_count() == builds
        assert spmm.launches == fused_agg_cmb.launches == gemm.launches == 0
        assert float(loss2) < float(loss)
        out[d] = (loss, new)
    torch.testing.assert_close(out[dev][0].cpu(), out["cpu"][0], rtol=2e-4, atol=2e-4)
    for a, b in zip(out[dev][1], out["cpu"][1]):
        for k in a:
            torch.testing.assert_close(a[k].cpu(), b[k], rtol=2e-4, atol=2e-4)


def test_lm_training_resumes_bitwise_on_the_card(dev, tmp_path):
    """3 AdamW steps + save + restore + 3 steps == 6 straight steps, bit
    for bit, on the card (bf16 parameters, f32 optimizer state)."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.data import LMDataPipeline
    from repro_torch.launch.train import build_trainer
    from repro_torch.tree import leaves

    cfg = get_config("smollm-135m").reduced(dtype="bfloat16")
    data = LMDataPipeline(cfg, 4, 64, seed=1, device=dev)
    init_opt, step = build_trainer(cfg, lr=1e-3, total_steps=6)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    opt = init_opt(params)

    def run(p, o, steps):
        for s in steps:
            _, p, o, _ = step(p, o, None, data.peek(s))
        return p, o

    p1, o1 = run(params, opt, range(6))
    p2, o2 = run(params, opt, range(3))
    ck = Checkpointer(tmp_path / "ck")
    ck.save(3, {"params": p2, "opt": o2})
    state = ck.restore({"params": p2, "opt": o2})
    assert leaves(state["params"])[0].device == leaves(p2)[0].device
    p3, o3 = run(state["params"], state["opt"], range(3, 6))
    assert all(torch.equal(a, b) for a, b in zip(leaves(p1), leaves(p3)))
    assert all(torch.equal(a, b) for a, b in zip(leaves(o1), leaves(o3)))


# ---------------------------------------------------------------------------
# The LM on a device mesh (DTensor): one card as a (1, 1) NCCL mesh in this
# process; over two or more cards, one spawned process a card
# ---------------------------------------------------------------------------


@pytest.fixture
def mesh_1x1(dev):
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_process_group, make_mesh_for

    fresh = not dist.is_initialized()
    init_process_group("cuda")
    yield make_mesh_for(1, 1)
    if fresh:
        dist.destroy_process_group()


def _rel_l2(a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm())


def test_flash_through_local_map_on_a_mesh_matches_plain(dev, mesh_1x1):
    """The sharded prefill launches the hand-written flash kernel once an
    attention layer on each shard's heads, and its f32 logits are within
    relative L2 1e-3 of the plain route's (two sum orders of one f32
    function; in bf16 the routes' roundings flip top-k expert choices)."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.models import param_shardings, production_rules, use_sharding
    from repro_torch.models.sharding import distribute

    cfg = get_config("granite-moe-1b-a400m").reduced(n_layers=3)
    rules = production_rules()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    tokens = torch.randint(0, cfg.vocab, (2, 96), generator=torch.Generator().manual_seed(1)).to(dev)
    sp = distribute(params, param_shardings(params, mesh_1x1, rules))
    with torch.no_grad(), use_sharding(mesh_1x1, rules):
        flash_ops.flash_attention.launches = 0
        got, _ = forward(cfg, sp, tokens)
        assert flash_ops.flash_attention.launches == cfg.n_layers
        plain, _ = forward(cfg, sp, tokens, use_kernels=False)
    assert _rel_l2(got.full_tensor(), plain.full_tensor()) <= 1e-3


@pytest.mark.parametrize("hq,hkv", [(16, 8), (8, 4), (4, 2)],
                         ids=["granite_heads", "granite_heads_over_2", "granite_heads_over_4"])
def test_bf16_flash_through_local_map_matches_plain(dev, mesh_1x1, hq, hkv):
    """bf16 flash through ``on_shards`` (``local_map``) on a (1, 1) mesh at
    granite-moe's attention shape (B 2, S 512, D 64) and at the head counts
    one shard holds on 2 and 4 cards: the tensor-core route, against the
    plain version on the same inputs at 2e-2 (rtol and atol), and each
    output row within relative L2 1e-2 of the f32 plain version."""
    from torch.distributed.tensor import Replicate, distribute_tensor

    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention import route
    from repro_torch.models import production_rules, use_sharding
    from repro_torch.models.sharding import on_shards

    g = torch.Generator(device=dev).manual_seed(hq)
    b, s, d = 2, 512, 64
    q, k, v = (torch.randn(b, s, h, d, generator=g, device=dev).to(torch.bfloat16)
               for h in (hq, hkv, hkv))
    pos = torch.arange(s, dtype=torch.int32, device=dev)
    views = [t.transpose(1, 2) for t in (q, k, v, torch.empty_like(q))]
    assert route(torch.bfloat16, [(t.shape, t.stride()) for t in views],
                 [t.data_ptr() for t in views]) == "tensor_cores"
    with torch.no_grad(), use_sharding(mesh_1x1, production_rules()):
        dq, dk, dv = (distribute_tensor(t, mesh_1x1, [Replicate(), Replicate()])
                      for t in (q, k, v))
        flash_ops.flash_attention.launches = 0
        out = on_shards(attend, dq, dk, dv, extra=(pos, pos, 0, 512)).to_local()
        assert flash_ops.flash_attention.launches == 1
    torch.testing.assert_close(out, attend_chunked(q, k, v, pos, pos), rtol=2e-2, atol=2e-2)
    ref32 = attend_chunked(q.float(), k.float(), v.float(), pos, pos)
    assert float(((out.float() - ref32).norm(dim=-1) / ref32.norm(dim=-1)).max()) <= 1e-2


def test_moe_ep_is_bit_stable_on_card(dev, mesh_1x1):
    """``moe_ep`` on the card twice, forward and backward: the same bits
    (no atomics in its combine or its scatter)."""
    from repro_torch.models import production_rules, use_sharding
    from repro_torch.models.moe import init_moe, moe_ffn
    from repro_torch.models.sharding import distribute, param_shardings

    cfg = get_config("granite-moe-1b-a400m").reduced(dtype="bfloat16")
    rules = production_rules()
    p = init_moe(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    x = torch.randn(4, 64, cfg.d_model, generator=torch.Generator(device=dev).manual_seed(2),
                    device=dev).to(torch.bfloat16)

    def once():
        with use_sharding(mesh_1x1, rules):
            sp = {k: v.requires_grad_() for k, v in
                  distribute(p, param_shardings(p, mesh_1x1, rules)).items()}
            out, aux = moe_ffn(cfg, sp, x)
            loss = (out.float().square().mean() + aux).full_tensor()
            grads = torch.autograd.grad(loss, list(sp.values()))
        return [out.full_tensor(), aux.full_tensor()] + [g.full_tensor() for g in grads]

    a, b = once(), once()
    assert all(torch.equal(u, v) for u, v in zip(a, b))


def _ep_over_cards(x, tree):
    """One rank: ``moe_ffn`` under a (1, world) mesh, whole, as numpy."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.models import params_from_numpy, production_rules, use_sharding
    from repro_torch.models.moe import moe_ffn

    from repro_torch.models.config import MoEConfig

    world = dist.get_world_size()
    cfg = get_config("granite-moe-1b-a400m").reduced(moe=MoEConfig(n_experts=8, top_k=2))
    mesh = make_mesh_for(world, world)
    with torch.no_grad(), use_sharding(mesh, production_rules()):
        out, aux = moe_ffn(cfg, params_from_numpy(tree), torch.as_tensor(x).cuda())
    return out.full_tensor().cpu().numpy(), float(aux.full_tensor())


def test_moe_ep_over_cards_matches_one_card(dev, mesh_1x1):
    """EP with the experts split over 2 or 4 cards (one process a card,
    NCCL) against EP on this card's (1, 1) mesh: the same local capacity
    (the data axis is 1), f32, rtol 1e-4, atol 1e-5."""
    from repro_torch.launch.mesh import spawn
    from repro_torch.models import production_rules, use_sharding
    from repro_torch.models.config import MoEConfig
    from repro_torch.models.moe import init_moe, moe_ffn

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA devices")
    world = 4 if torch.cuda.device_count() >= 4 else 2
    cfg = get_config("granite-moe-1b-a400m").reduced(moe=MoEConfig(n_experts=8, top_k=2))
    p = init_moe(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    x = torch.randn(2, 32, cfg.d_model, generator=torch.Generator(device=dev).manual_seed(1),
                    device=dev)
    with torch.no_grad(), use_sharding(mesh_1x1, production_rules()):
        want, want_aux = moe_ffn(cfg, p, x)
    tree = {k: v.cpu().numpy() for k, v in p.items()}
    got, aux = spawn(_ep_over_cards, world, x.cpu().numpy(), tree, device_type="cuda",
                     join_timeout_s=300)[0]
    np.testing.assert_allclose(got, want.full_tensor().cpu().numpy(), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(aux, float(want_aux.full_tensor()), rtol=1e-5)


def _save_on_every_card(root):
    import torch.distributed as dist

    from repro_torch.checkpoint import Checkpointer
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.models import param_shardings, production_rules
    from repro_torch.models.sharding import distribute

    cfg = get_config("granite-moe-1b-a400m").reduced()
    world = dist.get_world_size()
    mesh = make_mesh_for(world, 2)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    sp = distribute(params, param_shardings(params, mesh, production_rules()))
    Checkpointer(root).save(1, {"params": sp})
    return True


def _restore_on_this_group(root):
    import torch.distributed as dist

    from repro_torch.checkpoint import Checkpointer
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.models import param_shardings, production_rules
    from repro_torch.tree import leaves

    cfg = get_config("granite-moe-1b-a400m").reduced()
    world = dist.get_world_size()
    mesh = make_mesh_for(world, 1)
    like = init_params(cfg, torch.Generator(device="cuda").manual_seed(5), "cuda")
    got = Checkpointer(root).restore(
        {"params": like}, shardings={"params": param_shardings(like, mesh, production_rules())})
    return [t.full_tensor().cpu() for t in leaves(got["params"])]


def test_checkpoint_from_every_card_restores_on_half_of_them(dev, tmp_path):
    """Saved by 2 or 4 ranks ((1, 2) or (2, 2)), restored on half as many:
    the parameters ``torch.equal`` to the ones saved."""
    from repro_torch.launch.mesh import spawn
    from repro_torch.tree import leaves

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA devices")
    world = 4 if torch.cuda.device_count() >= 4 else 2
    spawn(_save_on_every_card, world, str(tmp_path / "ck"), device_type="cuda",
          join_timeout_s=300)
    got = spawn(_restore_on_this_group, world // 2, str(tmp_path / "ck"), device_type="cuda",
                join_timeout_s=300)[0]
    cfg = get_config("granite-moe-1b-a400m").reduced()
    want = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    assert all(torch.equal(a, b.cpu()) for a, b in zip(got, leaves(want)))
