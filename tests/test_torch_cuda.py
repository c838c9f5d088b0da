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
    # one launch per layer in the capture's warm-up, one in its replay
    assert counter.launches == before + 4
    again = prog.run(params, x)
    assert counter.launches == before + 6  # a replay: one per layer
    assert torch.equal(again, out)
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


# Head dims 72..128 run the pingpong schedule (128-row q tiles, two consumer
# warpgroups of 64 rows): Sq 1, 63, 64, 65, 127, 129 and 300 leave the
# second warpgroup no rows, some or all of them; GQA 32 / 4, MHA, B 2.
FLASH_BF16_EDGES = [(1, 14, 2, 130, 130, 128), (2, 7, 1, 200, 200, 8),
                    (1, 4, 2, 70, 300, 64), (1, 6, 3, 300, 45, 40),
                    (1, 10, 1, 200, 200, 256), (1, 4, 2, 130, 70, 136),
                    (1, 32, 4, 1, 300, 128), (2, 8, 8, 63, 63, 120),
                    (1, 32, 4, 64, 129, 128), (2, 4, 4, 65, 65, 120),
                    (1, 8, 2, 127, 300, 128), (1, 32, 4, 129, 64, 120),
                    (2, 6, 2, 300, 127, 128), (1, 32, 4, 300, 300, 120)]


def pingpong_launches():
    return repro_torch.trace.counters().get("flash.tc_pingpong_launches", 0)


def assert_one_launch(launches, pingpong, d):
    """One kernel launch since the counts ``launches`` and ``pingpong``; the
    pingpong schedule's counter moved with it exactly for head dims 72..128
    (64 and below, and past 128, keep the 64-row kernel)."""
    assert flash_attention.launches == launches + 1
    assert pingpong_launches() == pingpong + (72 <= d <= 128)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("b,hq,hkv,sq,sk,d", FLASH_BF16_EDGES)
def test_flash_bf16_edges_match_plain(dev, b, hq, hkv, sq, sk, d, causal):
    q = randn((b, hq, sq, d), 1, dev, torch.bfloat16)
    k, v = randn((b, hkv, sk, d), 2, dev, torch.bfloat16), randn((b, hkv, sk, d), 3, dev,
                                                                   torch.bfloat16)
    launches, pingpong = flash_attention.launches, pingpong_launches()
    out = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert_one_launch(launches, pingpong, d)
    plain = attend_chunked(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                           torch.arange(sq, device=dev), torch.arange(sk, device=dev),
                           causal=causal)
    torch.testing.assert_close(out, plain.transpose(1, 2), **BF16_TOL)
    plain32 = attend_chunked(q.float().transpose(1, 2), k.float().transpose(1, 2),
                             v.float().transpose(1, 2), torch.arange(sq, device=dev),
                             torch.arange(sk, device=dev), causal=causal)
    assert_rows_close_to_f32(out, plain32.transpose(1, 2))


# (B, Sq, Sk, Hq, Hkv, D, window, layout): the model's (B, S, H, D) tensors,
# or views of the op's (B, H, S, D) storage; the last two are the prefill
# cell's own shapes (Mellum2's windowed and full layers)
ATTEND_BF16_CASES = [(2, 70, 200, 6, 2, 64, 0, "bshd"), (2, 70, 200, 6, 2, 64, 7, "bshd"),
                     (2, 70, 200, 6, 2, 64, 100, "bshd")] + [
    (2, 300, 1500, 32, 4, 128, w, layout) for w in (0, 100, 1024)
    for layout in ("bshd", "bhsd")] + [
    (1, 129, 1100, 8, 8, 120, 100, "bhsd"), (1, 16384, 16384, 32, 4, 128, 1024, "bshd"),
    (1, 16384, 16384, 32, 4, 128, 0, "bshd")]


@pytest.mark.parametrize("b,sq,sk,hq,hkv,d,window,layout", ATTEND_BF16_CASES)
def test_attend_bf16_offset_positions_and_window(dev, b, sq, sk, hq, hkv, d, window, layout):
    """The model route in bf16: a query chunk at the end of a longer key
    range (Sq != Sk, positions offset), GQA and MHA, with and without a
    window, read in either layout."""
    def make(s, h, seed):
        if layout == "bshd":
            return randn((b, s, h, d), seed, dev, torch.bfloat16)
        return randn((b, h, s, d), seed, dev, torch.bfloat16).transpose(1, 2)

    q, k, v = make(sq, hq, 4), make(sk, hkv, 5), make(sk, hkv, 6)
    q_pos = torch.arange(sk - sq, sk, device=dev, dtype=torch.int32) + 5
    k_pos = torch.arange(sk, device=dev, dtype=torch.int32) + 5
    launches, pingpong = flash_attention.launches, pingpong_launches()
    out = attend(q, k, v, q_pos, k_pos, window, 64)
    torch.cuda.synchronize()
    assert_one_launch(launches, pingpong, d)
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
    launches, pingpong = flash_attention.launches, pingpong_launches()
    out = attend(q, k, v, pos, pos, win)
    torch.cuda.synchronize()
    assert_one_launch(launches, pingpong, d)
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


@pytest.mark.parametrize("seed", [7, 8])
def test_aggregate_backward_on_the_card_equals_the_earlier_formulation(dev, seed):
    """A band of the cora training cell's layer 1 (128 rows x 82 slots over
    2,816 source rows, most slots padding): the backward, whose padded
    slots are keyed by position, gives ``gw`` and ``gx`` ``torch.equal`` to
    the earlier formulation's, which keyed them all to row 0."""
    from aggregate_oracle import backward_before, cora_band
    from repro_torch.gnn.layers import aggregate_band

    idx, wts, x, g = (t.to(dev) for t in cora_band(seed))
    w, xs = wts.clone().requires_grad_(), x.clone().requires_grad_()
    gw, gx = torch.autograd.grad(aggregate_band(idx, w, xs), (w, xs), g)
    want_w, want_x = backward_before(idx, wts, x, g)
    assert torch.equal(gw, want_w) and torch.equal(gx, want_x)


def _pp_train_steps(dev, mesh):
    """Two SGD steps of a GCN under a ``pp`` schedule on ``dev`` (the
    ring's 300 nodes in 10 bands of 32 a layer): with ``mesh`` and with
    ``mesh=None``, and the first step once more from the same state."""
    from repro_torch.core.cost_model import GNNLayerWorkload
    from repro_torch.core.schedule import ModelSchedule
    from repro_torch.gnn import make_node_classification_task

    g, dims = _ring(300), [(24, 16), (16, 4)]
    wls = [GNNLayerWorkload(g.nnz, fi, fo) for fi, fo in dims]
    sched = ModelSchedule.from_policies("pp", "AC", dims, band_size=32)
    prog = repro_torch.compile(wls, graph=g, schedule=sched, device=dev)
    params = prog.init(torch.Generator().manual_seed(0))
    task = make_node_classification_task(g, 24, 4, device=dev)
    runs = {}
    for m in (None, mesh):
        loss, new = prog.train_step(params, *task, mesh=m)
        loss2, new2 = prog.train_step(new, *task, mesh=m)
        runs[m is None] = (loss, new, loss2, new2)
    again = prog.train_step(params, *task, mesh=mesh)
    return runs[True], runs[False], again


def _held_pp_training(plain, piped, again):
    """The pipelined steps against ``mesh=None``'s: the same loss, the
    parameters within 2e-4; the repeated step bit-identical."""
    for i in (0, 2):
        assert torch.equal(piped[i], plain[i]), (i, float(piped[i]), float(plain[i]))
    for a, b in zip(piped[1] + piped[3], plain[1] + plain[3]):
        for k in a:
            torch.testing.assert_close(a[k], b[k], rtol=2e-4, atol=2e-4)
    assert torch.equal(again[0], piped[0])
    for a, b in zip(again[1], piped[1]):
        for k in a:
            assert torch.equal(a[k], b[k]), k


def test_pp_training_on_two_streams_of_one_card(dev):
    """``train_step`` through the two-stream Parallel Pipeline on one card
    (``mesh=[cuda:0, cuda:0]``): autograd runs each band's backward on the
    stream its forward ran on."""
    _held_pp_training(*_pp_train_steps(dev, [dev, dev]))


def test_pp_training_on_two_cards(dev):
    """The same on two cards: the producer on card 0, the consumer on card
    1, each band handed over by a peer copy (and its gradient back)."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    cards = [torch.device("cuda", 0), torch.device("cuda", 1)]
    _held_pp_training(*_pp_train_steps(cards[0], cards))


def test_lm_training_resumes_bitwise_on_the_card(dev, tmp_path):
    """3 AdamW steps + save + restore + 3 steps == 6 straight steps, bit
    for bit, on the card (bf16 parameters, f32 optimizer state)."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.data import LMDataPipeline
    from repro_torch.launch.train import build_trainer
    from repro_torch.tree import leaves, tree_map

    cfg = get_config("smollm-135m").reduced(dtype="bfloat16")
    data = LMDataPipeline(cfg, 4, 64, seed=1, device=dev)
    init_opt, step = build_trainer(cfg, lr=1e-3, total_steps=6)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    opt = init_opt(params)

    def run(p, o, steps):
        for s in steps:
            _, p, o, _ = step(p, o, None, data.peek(s))
        return p, o

    # the captured step owns the state it is given: each run starts from
    # its own copy, and the straight run's end is copied out of the graph
    p1, o1 = tree_map(torch.clone, run(*tree_map(torch.clone, (params, opt)), range(6)))
    p2, o2 = run(*tree_map(torch.clone, (params, opt)), range(3))
    assert len(step.graphs) == 1
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


# ---------------------------------------------------------------------------
# Captured executables: Program.run and the LM's decode step as CUDA graphs
# ---------------------------------------------------------------------------


def captured_program(dev, policy, order, use_pallas, v=120, f_in=28, seed=0):
    """A GCN f_in -> 16 -> 4 Program bound to a random graph of ``v`` nodes
    (ELL padded to 16), its parameters, and a maker of more graphs of the
    same shape."""
    from repro_torch.core.schedule import ModelSchedule

    def graph(s):
        rng = np.random.default_rng(s)
        return from_edges(v, rng.integers(0, v, 3 * v), rng.integers(0, v, 3 * v))

    dims = [(f_in, 16), (16, 4)]
    prog = repro_torch.compile(
        GNNConfig(f_in=f_in, n_classes=4, use_pallas=use_pallas), graph=graph(seed),
        device=dev, schedule=ModelSchedule.from_policies(policy, order, dims))
    prog = prog.bind(graph(seed), pad_degree=16)
    return prog, prog.init(torch.Generator().manual_seed(seed)), graph


def the_executable(prog):
    (exe,) = prog._exec_cache.values()
    return exe


SEGMENTS = torch.as_tensor(np.repeat([0, 1, 2, 3, 5], [30, 40, 10, 25, 15]).astype(np.int32))


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("policy,order", [("sp_opt", "AC"), ("seq", "AC"), ("seq", "CA")])
@pytest.mark.parametrize("readout", [None, "mean", "max"])
def test_a_replay_equals_the_direct_call(dev, use_pallas, policy, order, readout):
    """The captured graph against the uncaptured forward it was captured
    from, called directly on the same inputs: the same kernels with the
    same launches, so ``torch.equal``; on the eager tier too."""
    from repro_torch.api import CapturedForward

    prog, params, _ = captured_program(dev, policy, order, use_pallas)
    x = randn((120, 28), 3, dev)
    seg = SEGMENTS.to(dev)
    kw = {} if readout is None else dict(segment_ids=seg, num_segments=8, readout=readout)
    out = prog.run(params, x, **kw)
    again = prog.run(params, x, **kw)
    exe = the_executable(prog)
    assert isinstance(exe, CapturedForward) and exe.graph is not None
    direct = exe.eager(params, prog.adj.indices, prog.adj.weights, x,
                       seg if readout else None)
    assert torch.equal(out, direct) and torch.equal(again, direct)


def test_two_batches_of_one_shape_go_through_one_graph(dev):
    """Two graphs and feature sets of one shape: one capture, and each
    result equal to its own uncaptured run."""
    prog, params, graph = captured_program(dev, "sp_opt", "AC", True)
    other = prog.bind(graph(7), pad_degree=16)
    xa, xb = randn((120, 28), 4, dev), randn((120, 28), 5, dev)
    before = repro_torch.trace_count()
    a = prog.run(params, xa)
    b = other.run(params, xb)
    assert repro_torch.trace_count() == before + 1
    eager = the_executable(prog).eager
    assert torch.equal(a, eager(params, prog.adj.indices, prog.adj.weights, xa, None))
    assert torch.equal(b, eager(params, other.adj.indices, other.adj.weights, xb, None))
    assert not torch.equal(a, b)


def test_a_parameter_updated_in_place_is_seen_by_the_next_run(dev):
    prog, params, _ = captured_program(dev, "seq", "AC", True)
    x = randn((120, 28), 6, dev)
    first = prog.run(params, x)
    params[0]["w"].mul_(2.0)
    params[1]["b"].add_(0.5)
    second = prog.run(params, x)
    want = the_executable(prog).eager(params, prog.adj.indices, prog.adj.weights, x, None)
    assert torch.equal(second, want) and not torch.equal(first, second)


def test_a_returned_output_survives_the_next_replay(dev):
    prog, params, _ = captured_program(dev, "sp_opt", "AC", True)
    xa, xb = randn((120, 28), 8, dev), randn((120, 28), 9, dev)
    a = prog.run(params, xa)
    kept = a.clone()
    prog.run(params, xb)
    torch.cuda.synchronize()
    assert torch.equal(a, kept)


def test_launch_counts_include_replays(dev):
    """The capture's launches are not counted (nothing ran); its warm-up's
    and every replay's are."""
    prog, params, _ = captured_program(dev, "seq", "CA", True)
    x = randn((120, 28), 10, dev)
    before = (spmm.launches, gemm.launches)
    prog.run(params, x)
    assert (spmm.launches, gemm.launches) == (before[0] + 4, before[1] + 4)
    assert the_executable(prog).graph.launches == {"spmm": 2, "gemm": 2}
    for _ in range(3):
        prog.run(params, x)
    assert (spmm.launches, gemm.launches) == (before[0] + 10, before[1] + 10)


def _counted_since(before):
    from repro_torch import trace

    after = trace.counters()
    return {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}


@pytest.mark.parametrize("policy,use_pallas,walks", [
    ("sp_opt", True, 0), ("sp_opt", False, 2), ("pp", True, 2)])
def test_replays_add_the_captures_tally_of_the_program_counters(dev, policy, use_pallas,
                                                                walks):
    """A capture tallies the eager tier's slot walks (the fused kernel
    walks none; ``pp`` without a mesh is the eager fallback on either
    tier), and each replay adds that tally and counts the bytes it copies
    into the static buffers; a cold run counts its warm-up's walks too."""
    from repro_torch import trace

    prog, params, _ = captured_program(dev, policy, "AC", use_pallas)
    x = randn((120, 28), 12, dev)
    walk = prog.adj.v_pad * 16
    before = trace.counters()
    prog.run(params, x)
    graph = the_executable(prog).graph
    assert graph.tally.get("agg.slots", 0) == walks * walk
    assert _counted_since(before).get("agg.slots", 0) == 2 * walks * walk
    before = trace.counters()
    prog.run(params, x)
    prog.run(params, x)
    got = _counted_since(before)
    assert got.get("agg.slots", 0) == 2 * walks * walk
    assert got["ell.nonzero"] == 2 * prog.adj.nonzero
    nbytes = sum(t.numel() * t.element_size() for t in graph.static)
    assert got["replay.calls"] == 2 and got["replay.bytes_in"] == 2 * nbytes
    assert "setup.capture_s" not in got and "setup.bind_s" not in got


def test_a_captured_train_step_tallies_its_backward_walk(dev):
    """The backward runs on autograd's device thread, on the capturing
    stream: its walk goes to the capture's tally, so each replay counts
    the two forward walks and layer 1's backward walk."""
    from repro_torch import trace
    from repro_torch.gnn import make_node_classification_task

    prog, params, _ = captured_program(dev, "sp_opt", "AC", False)
    task = make_node_classification_task(_ring(120), 28, 4, device=dev)
    walk = prog.adj.v_pad * 16
    before = trace.counters()
    _, new = prog.train_step(params, *task)
    assert the_executable(prog).graph.tally["agg.slots"] == 3 * walk
    assert _counted_since(before)["agg.slots"] == 6 * walk
    before = trace.counters()
    prog.train_step(new, *task)
    prog.train_step(new, *task)
    assert _counted_since(before)["agg.slots"] == 6 * walk


def test_donate_releases_the_callers_storage(dev):
    prog, params, _ = captured_program(dev, "sp_opt", "AC", True)
    x = randn((120, 28), 11, dev)
    want = prog.run(params, x.clone())
    given = x.clone()
    out = prog.run(params, given, donate=True)
    assert given.untyped_storage().nbytes() == 0
    assert torch.equal(out, want)
    with pytest.raises(ValueError, match="own its whole storage"):
        prog.run(params, torch.cat([x, x])[:120], donate=True)  # a view
    out2 = prog.run(params, x, donate=True)
    assert x.untyped_storage().nbytes() == 0 and torch.equal(out2, want)


@pytest.mark.parametrize("arch", ["smollm-135m", "recurrentgemma-2b", "xlstm-1.3b"])
def test_captured_prefill_cache_matches_the_eager_replay(dev, arch):
    """``prefill`` replays one captured ``decode_step``; the cache it builds
    against the same positions replayed eagerly (float32, reduced width),
    at the decode tolerance."""
    from repro_torch.models import decode_step, init_cache, prefill
    from repro_torch.models.transformer import captures_decode
    from repro_torch.tree import leaves

    cfg = get_config(arch).reduced().with_(dtype="float32")
    assert captures_decode(cfg, dev)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(2), dev)
    inputs = make_inputs(cfg, 2, 24, seed=3, device=dev)
    _, captured = prefill(cfg, params, inputs)
    eager = init_cache(cfg, 2, 24, dev)
    for i in range(24):
        decode_step(cfg, params, eager, inputs[:, i:i + 1], i)
    for a, b in zip(leaves(captured), leaves(eager)):
        torch.testing.assert_close(a, b, rtol=2e-4, atol=2e-5)


# ---------------------------------------------------------------------------
# Captured training: Program.train_step and launch.train's step as CUDA graphs
# ---------------------------------------------------------------------------


def _train_program(dev, kind, policy, order, f_in=24, v=300):
    from repro_torch.core.cost_model import GNNLayerWorkload
    from repro_torch.core.schedule import ModelSchedule
    from repro_torch.gnn import make_node_classification_task

    g, dims = _ring(v), [(f_in, 16), (16, 4)]
    prog = repro_torch.compile(
        [GNNLayerWorkload(g.nnz, fi, fo) for fi, fo in dims], graph=g, kind=kind,
        device=dev, schedule=ModelSchedule.from_policies(policy, order, dims, band_size=32))
    return (prog, prog.init(torch.Generator().manual_seed(0)),
            make_node_classification_task(g, f_in, 4, device=dev))


def _train_executables(prog):
    return [e for k, e in prog._exec_cache.items() if k[0] == "train"]


@pytest.mark.parametrize("kind,policy,order", [("gcn", "sp_opt", "AC"), ("sage", "seq", "CA"),
                                               ("gin", "sp_generic", "AC"), ("gcn", "pp", "CA")])
def test_captured_train_steps_equal_the_uncaptured_step(dev, kind, policy, order):
    """Three captured SGD steps (forward, backward and update in one graph)
    against the uncaptured step they were captured from: loss and
    parameters ``torch.equal``, the parameters moved; one capture, and a
    second epoch of three steps captures nothing."""
    from repro_torch.api import CapturedForward

    prog, params, task = _train_program(dev, kind, policy, order)
    before = repro_torch.trace_count()
    p = q = params
    for s in range(3):
        loss, p = prog.train_step(p, *task)
        (exe,) = _train_executables(prog)
        want_loss, q = exe.eager(q, prog.adj.indices, prog.adj.weights, *task)
        assert torch.equal(loss, want_loss), s
        assert all(torch.equal(a[k], b[k]) for a, b in zip(p, q) for k in a), s
    assert isinstance(exe, CapturedForward) and exe.graph is not None
    assert repro_torch.trace_count() == before + 1
    assert not torch.equal(p[0][sorted(p[0])[-1]], params[0][sorted(params[0])[-1]])
    for _ in range(3):
        loss, p = prog.train_step(p, *task)
    assert repro_torch.trace_count() == before + 1
    assert bool(torch.isfinite(loss))


def test_a_second_train_shape_makes_a_second_graph(dev):
    """A new feature width is a new shape key: a second capture, whose
    steps equal its own uncaptured step; the first key's graph is kept."""
    prog, params, task = _train_program(dev, "gcn", "sp_opt", "AC")
    wide, wide_params, wide_task = _train_program(dev, "gcn", "sp_opt", "AC", f_in=40)
    before = repro_torch.trace_count()
    prog.train_step(params, *task)
    loss, new = prog.train_step(wide_params, *wide_task)
    assert repro_torch.trace_count() == before + 2
    exes = _train_executables(prog)
    assert len(exes) == 2 and all(e.graph is not None for e in exes)
    want_loss, want = exes[1].eager(wide_params, prog.adj.indices, prog.adj.weights, *wide_task)
    assert torch.equal(loss, want_loss)
    assert all(torch.equal(a[k], b[k]) for a, b in zip(new, want) for k in a)


def _lm_trainer(dev, arch, compression, **reduce):
    from repro_torch.data import LMDataPipeline
    from repro_torch.launch.train import build_trainer
    from repro_torch.optim import init_error_feedback

    cfg = get_config(arch).reduced(**reduce)
    init_opt, step = build_trainer(cfg, lr=1e-3, total_steps=10, grad_compression=compression)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    ef = init_error_feedback(params) if compression else None
    return cfg, step, (params, init_opt(params), ef), LMDataPipeline(cfg, 4, 64, seed=1, device=dev)


@pytest.mark.parametrize("compression", [None, "int8"])
def test_captured_lm_steps_equal_the_uncaptured_step(dev, compression):
    """Three captured AdamW steps (reduced smollm-135m, bf16) against the
    uncaptured step: loss, parameters, both moments, the step counter and
    the int8 residual ``torch.equal``.  The captured step returns the very
    tensors it was given (the donated state, written in place), and a call
    with them copies nothing in."""
    from repro_torch.tree import leaves, tree_map

    _, step, state, data = _lm_trainer(dev, "smollm-135m", compression, dtype="bfloat16")
    fresh = tree_map(torch.clone, state)
    owned = tree_map(torch.clone, state)
    for s in range(3):
        loss, *out = step(*owned, data.peek(s))
        assert all(a is b for a, b in zip(leaves(out), leaves(owned))), s
        owned = out
        want_loss, *fresh = step.eager(*fresh, data.peek(s))
        assert torch.equal(loss, want_loss), s
    assert len(step.graphs) == 1
    assert int(owned[1].step) == 3
    assert all(torch.equal(a, b) for a, b in zip(leaves(owned), leaves(fresh)))
    assert not torch.equal(leaves(owned[0])[0], leaves(state[0])[0])


@pytest.mark.parametrize("arch,layers", [("recurrentgemma-2b", 3), ("xlstm-1.3b", 8)])
def test_captured_lm_families_equal_the_uncaptured_step(dev, arch, layers):
    """The RG-LRU scan and the xLSTM loops inside a captured step (reduced
    width, one period of blocks): three steps ``torch.equal`` to the
    uncaptured step."""
    from repro_torch.tree import leaves, tree_map

    _, step, state, data = _lm_trainer(dev, arch, None, n_layers=layers)
    fresh, owned = tree_map(torch.clone, state), state
    for s in range(3):
        loss, *owned = step(*owned, data.peek(s))
        want_loss, *fresh = step.eager(*fresh, data.peek(s))
        assert torch.equal(loss, want_loss), s
    assert len(step.graphs) == 1
    assert all(torch.equal(a, b) for a, b in zip(leaves(owned), leaves(fresh)))


def test_a_second_lm_shape_makes_a_second_graph(dev):
    from repro_torch.tree import leaves, tree_map

    _, step, state, data = _lm_trainer(dev, "smollm-135m", None)
    _, *state = step(*state, data.peek(0))
    short = {k: v[:, :32] for k, v in data.peek(1).items()}
    kept = tree_map(torch.clone, state)
    loss, *new = step(*state, short)
    assert len(step.graphs) == 2
    want_loss, *want = step.eager(*kept, short)
    assert torch.equal(loss, want_loss)
    assert all(torch.equal(a, b) for a, b in zip(leaves(new), leaves(want)))


def _granite_cut(dev, layers=2):
    """granite-moe-1b-a400m at its published widths (bf16, 32 experts top
    8), cut to ``layers`` layers, and its weights."""
    cfg = get_config("granite-moe-1b-a400m").with_(n_layers=layers)
    return cfg, init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)


def test_moe_captured_decode_equals_the_uncaptured_decode(dev):
    """granite-moe (2 layers, full width, bf16) decodes through one
    captured ``decode_step``: a prompt of 16 positions and 4 greedy tokens,
    every position's logits ``torch.equal`` to ``decode_step`` run
    uncaptured on its own cache, the greedy tokens equal."""
    from repro_torch.models import decode_step, init_cache
    from repro_torch.models.transformer import captures_decode, decoder

    cfg, params = _granite_cut(dev)
    assert captures_decode(cfg, dev)
    prompts = make_inputs(cfg, 2, 16, seed=1, device=dev)
    runs = []
    for captured in (True, False):
        cache = init_cache(cfg, 2, 20, dev)
        step = (decoder(cfg, params, cache, prompts[:, :1]) if captured else
                lambda tok, i, c=cache: decode_step(cfg, params, c, tok, i)[0])
        logits = [step(prompts[:, i:i + 1], i) for i in range(16)]
        tok = torch.argmax(logits[-1][:, -1], dim=-1)[:, None].to(torch.int32)
        for i in range(4):
            logits.append(step(tok, 16 + i))
            tok = torch.argmax(logits[-1][:, -1], dim=-1)[:, None].to(torch.int32)
        runs.append(logits)
    assert all(torch.equal(a, b) for a, b in zip(*runs))


def test_moe_captured_train_steps_equal_the_uncaptured_step(dev):
    """granite-moe (2 layers, full width, bf16) trains through a captured
    AdamW step (the router's aux loss and the grouped products' backward
    in the graph): three steps ``torch.equal`` to the uncaptured step in
    the loss and every leaf of params, m, v and the step counter; one
    graph."""
    from repro_torch.data import LMDataPipeline
    from repro_torch.launch.train import build_trainer
    from repro_torch.models.transformer import captures_train
    from repro_torch.tree import leaves, tree_map

    cfg, params = _granite_cut(dev)
    assert captures_train(cfg, dev)
    init_opt, step = build_trainer(cfg, lr=1e-3, total_steps=10)
    data = LMDataPipeline(cfg, 2, 128, seed=1, device=dev)
    state = (params, init_opt(params), None)
    fresh, owned = tree_map(torch.clone, state), state
    for s in range(3):
        loss, *owned = step(*owned, data.peek(s))
        want_loss, *fresh = step.eager(*fresh, data.peek(s))
        assert torch.equal(loss, want_loss), s
    assert len(step.graphs) == 1
    assert int(owned[1].step) == 3
    assert all(torch.equal(a, b) for a, b in zip(leaves(owned), leaves(fresh)))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_moe_ragged_reads_the_host_only_in_float32(dev, dtype):
    """``moe_ragged`` at granite's widths (2 x 512 tokens), forward and
    backward, under ``set_sync_debug_mode("error")``: in bf16 the grouped
    products read their expert ends on the device, so nothing synchronises
    and the MoE captures; PyTorch's float32 route copies the ends to the
    host, which is why ``captures_decode`` leaves a float32 MoE
    uncaptured."""
    from repro_torch.models.moe import init_moe, moe_ragged
    from repro_torch.models.transformer import captures_decode

    cfg = get_config("granite-moe-1b-a400m").with_(dtype=dtype)
    p = {k: t.requires_grad_() for k, t in
         init_moe(cfg, torch.Generator(device=dev).manual_seed(0), dev).items()}
    x = randn((2, 512, cfg.d_model), 4, dev, p["experts_gate"].dtype).requires_grad_()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out, aux = moe_ragged(cfg, p, x)
        (out.float().square().mean() + aux).backward()
        synced = False
    except RuntimeError as err:
        assert "synchronizing" in str(err)
        synced = True
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert synced == (dtype == "float32") == (not captures_decode(cfg, dev))


def test_a_cpu_rebind_does_not_replay_the_cards_graph(dev):
    """A Program bound on the card and rebound on the CPU share one
    executable cache; the device is part of the key, so the CPU's run and
    training step run on the CPU (the card's graphs are not replayed
    there) and agree with the card's within 2e-4."""
    prog, params, task = _train_program(dev, "gcn", "sp_opt", "AC")
    cpu = prog.bind(_ring(300), device="cpu")
    on_cpu = [{k: v.cpu() for k, v in layer.items()} for layer in params]
    task_cpu = [t.cpu() for t in task]
    out = {"card": (prog.run(params, task[0]), *prog.train_step(params, *task)),
           "cpu": (cpu.run(on_cpu, task_cpu[0]), *cpu.train_step(on_cpu, *task_cpu))}
    logits, loss, new = out["cpu"]
    assert logits.device.type == loss.device.type == new[0]["w"].device.type == "cpu"
    torch.testing.assert_close(out["card"][0].cpu(), logits, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(out["card"][1].cpu(), loss, rtol=2e-4, atol=2e-4)
    for a, b in zip(out["card"][2], new):
        for k in a:
            torch.testing.assert_close(a[k].cpu(), b[k], rtol=2e-4, atol=2e-4)


# ---------------------------------------------------------------------------
# The runs over a mesh, captured: two-stream PP on one card, and the LM on
# the (1, 1) NCCL mesh
# ---------------------------------------------------------------------------


def _pp_program(dev, use_pallas, v=300, f_in=24, band=32):
    """A GCN f_in -> 16 -> 4 under a ``pp`` schedule (``band``-row bands),
    its parameters and features."""
    from repro_torch.core.schedule import ModelSchedule

    dims = [(f_in, 16), (16, 4)]
    prog = repro_torch.compile(
        GNNConfig(f_in=f_in, n_classes=4, use_pallas=use_pallas), graph=_ring(v),
        device=dev, schedule=ModelSchedule.from_policies("pp", "AC", dims, band_size=band))
    return prog, prog.init(torch.Generator().manual_seed(0)), randn((v, f_in), 8, dev)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_pp_run_on_two_streams_is_captured_and_equals_uncaptured(dev, use_pallas):
    """``Program.run`` with ``mesh=[cuda:0, cuda:0]`` builds one CUDA graph
    (both streams forked from and joined into the capture): two replays
    ``torch.equal`` to the uncaptured forward; the eager tier equal to
    ``mesh=None``'s fallback, the kernel tier within 2e-4 of it; a replay
    launches ``spmm`` and ``gemm`` once a band of each layer."""
    from repro_torch.api import CapturedForward

    prog, params, x = _pp_program(dev, use_pallas)
    mesh = [dev, dev]
    before = repro_torch.trace_count()
    out = prog.run(params, x, mesh=mesh)
    (exe,) = prog._exec_cache.values()
    assert isinstance(exe, CapturedForward) and exe.graph is not None
    spmm0, gemm0 = spmm.launches, gemm.launches
    again = prog.run(params, x, mesh=mesh)
    assert repro_torch.trace_count() == before + 1
    bands = 2 * -(-prog.adj.v_pad // 32) if use_pallas else 0
    assert (spmm.launches - spmm0, gemm.launches - gemm0) == (bands, bands)
    direct = exe.eager(params, prog.adj.indices, prog.adj.weights, x, None)
    torch.cuda.synchronize()
    assert torch.equal(out, direct) and torch.equal(again, direct)
    fallback = prog.run(params, x)
    if use_pallas:
        torch.testing.assert_close(out, fallback, rtol=2e-4, atol=2e-4)
    else:
        assert torch.equal(out, fallback)


def test_pp_train_step_on_two_streams_is_captured_and_equals_uncaptured(dev):
    """Three SGD steps through the two-stream pipeline on one card, captured
    (each band's backward on its forward's stream, inside the graph):
    ``torch.equal`` to the uncaptured step in the loss and every
    parameter; one capture for the three."""
    from repro_torch.api import CapturedForward

    prog, params, task = _train_program(dev, "gcn", "pp", "AC")
    mesh = [dev, dev]
    before = repro_torch.trace_count()
    p = q = params
    for s in range(3):
        loss, p = prog.train_step(p, *task, mesh=mesh)
        (exe,) = _train_executables(prog)
        want_loss, q = exe.eager(q, prog.adj.indices, prog.adj.weights, *task)
        assert torch.equal(loss, want_loss), s
        assert all(torch.equal(a[k], b[k]) for a, b in zip(p, q) for k in a), s
    assert isinstance(exe, CapturedForward) and exe.graph is not None
    assert repro_torch.trace_count() == before + 1


def _mesh_trainer(dev, mesh, arch, **reduce):
    from repro_torch.data import LMDataPipeline
    from repro_torch.launch.train import build_trainer
    from repro_torch.models import param_shardings, production_rules
    from repro_torch.models.sharding import distribute

    cfg = (get_config(arch).reduced(**reduce) if reduce.pop("reduced", True)
           else get_config(arch).with_(**reduce))
    rules = production_rules()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    params = distribute(params, param_shardings(params, mesh, rules))
    init_opt, step = build_trainer(cfg, mesh, rules, lr=1e-3, total_steps=10)
    return cfg, step, (params, init_opt(params), None), LMDataPipeline(cfg, 2, 128, seed=1,
                                                                      device=dev)


def _local_equal(a, b) -> bool:
    return torch.equal(getattr(a, "_local_tensor", a), getattr(b, "_local_tensor", b))


@pytest.mark.parametrize("arch,reduce", [
    ("smollm-135m", dict(dtype="bfloat16")),
    ("granite-moe-1b-a400m", dict(reduced=False, n_layers=2)),
], ids=["smollm_reduced_bf16", "granite_moe_2_layers"])
def test_mesh_trainer_is_captured_and_equals_the_eager_step(dev, mesh_1x1, arch, reduce):
    """``launch.train``'s AdamW step on the (1, 1) NCCL mesh, captured (the
    batch's ``shard``, the loss's ``full_tensor`` and the gradients'
    ``redistribute`` in the graph): three steps, the loss and every leaf's
    shard ``torch.equal`` to ``TrainStep.eager``; the state comes back as
    DTensors on their placements, the very ones donated; one graph."""
    from torch.distributed.tensor import DTensor

    from repro_torch.models.transformer import captures_train
    from repro_torch.tree import leaves, tree_map

    cfg, step, state, data = _mesh_trainer(dev, mesh_1x1, arch, **reduce)
    assert captures_train(cfg, dev, mesh_1x1)
    fresh, owned = tree_map(torch.clone, state), state
    for s in range(3):
        loss, *out = step(*owned, data.peek(s))
        assert all(a is b for a, b in zip(leaves(out), leaves(owned))), s
        owned = out
        want_loss, *fresh = step.eager(*fresh, data.peek(s))
        assert torch.equal(loss, want_loss), s
    assert len(step.graphs) == 1
    assert all(isinstance(t, DTensor) for t in leaves(owned[0]))
    assert all(a.placements == b.placements for a, b in zip(leaves(owned[0]), leaves(fresh[0])))
    assert all(_local_equal(a, b) for a, b in zip(leaves(owned), leaves(fresh)))


def test_mesh_decode_is_captured_and_equals_the_uncaptured_decode(dev, mesh_1x1):
    """granite-moe (2 layers, full width, bf16) decodes on the (1, 1) NCCL
    mesh through one captured ``decode_step`` over the heads-placed DTensor
    cache: 12 positions, each position's logits and then the cache
    ``torch.equal`` to ``decode_step`` run uncaptured on a cache of its own."""
    from repro_torch.models import decode_step, init_cache, param_shardings, production_rules
    from repro_torch.models import use_sharding
    from repro_torch.models.sharding import distribute
    from repro_torch.models.transformer import captures_decode, decoder
    from repro_torch.tree import leaves

    cfg, params = _granite_cut(dev)
    rules = production_rules()
    sp = distribute(params, param_shardings(params, mesh_1x1, rules))
    prompts = make_inputs(cfg, 2, 12, seed=1, device=dev)
    runs, caches = [], []
    with torch.no_grad(), use_sharding(mesh_1x1, rules):
        for captured in (True, False):
            cache = init_cache(cfg, 2, 12, dev)
            assert captures_decode(cfg, dev, cache)
            step = (decoder(cfg, sp, cache, prompts[:, :1]) if captured else
                    lambda tok, i, c=cache: decode_step(cfg, sp, c, tok, i)[0])
            runs.append([step(prompts[:, i:i + 1], i).to_local() for i in range(12)])
            caches.append(cache)
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    assert all(_local_equal(a, b) for a, b in zip(*(leaves(c) for c in caches)))


def test_eager_mesh_step_never_synchronizes(dev, mesh_1x1):
    """One eager AdamW step on the (1, 1) NCCL mesh (granite-moe, 2 layers,
    bf16), forward and backward, under ``set_sync_debug_mode("error")``:
    nothing the captured step records reads the device on the host."""
    _, step, state, data = _mesh_trainer(dev, mesh_1x1, "granite-moe-1b-a400m",
                                         reduced=False, n_layers=2)
    step.eager(*state, data.peek(0))  # NCCL's communicator, the tables
    batch = data.peek(1)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        loss, *_ = step.eager(*state, batch)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert bool(torch.isfinite(loss))
