"""Parity of the flash-attention and dataflow-GEMM wrappers with the
reference's, on the CPU.

On a CPU tensor each wrapper runs its plain PyTorch version; the reference
runs its Pallas kernel in interpret mode, as ``tests/test_kernels.py``
does, at that file's shapes and tolerances.  The CUDA kernels are held
against the plain versions on the card by ``tests/test_torch_cuda.py``
and ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import attention_ref as ref_attention_ref
from repro.kernels.flash_attention import flash_attention as ref_flash
from repro.kernels.gemm_dataflow.ops import gemm as ref_gemm
from repro.models.attention import _attend_chunked as ref_attend_chunked
from repro_torch.kernels.flash_attention import (
    attend,
    attend_chunked,
    attention_ref,
    flash_attention,
)
from repro_torch.kernels import profile as kernel_profile
from repro_torch.kernels.common import CudaLibrary
from repro_torch.kernels.flash_attention import route as flash_route
from repro_torch.kernels.gemm_dataflow import DATAFLOWS, gemm, gemm_ref, plan, tma_ok


def rand(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


FLASH_SHAPES = [(2, 4, 2, 96, 96, 32), (1, 8, 1, 64, 128, 16), (2, 2, 2, 33, 33, 64)]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("b,hq,hkv,sq,sk,d", FLASH_SHAPES)
def test_flash_matches_reference(b, hq, hkv, sq, sk, d, causal):
    q, k, v = rand((b, hq, sq, d), 1), rand((b, hkv, sk, d), 2), rand((b, hkv, sk, d), 3)
    ref = ref_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    causal=causal, block_q=32, block_k=32)
    out = flash_attention(t(q), t(k), t(v), causal=causal, block_q=32, block_k=32)
    assert out.shape == ref.shape and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-4, atol=2e-5)


def test_flash_bf16_matches_reference_oracle():
    q, k, v = (rand((1, 2, 64, 32), s) for s in (4, 5, 6))
    qb, kb, vb = (t(a).to(torch.bfloat16) for a in (q, k, v))
    out = flash_attention(qb, kb, vb, causal=True, block_q=32, block_k=32)
    assert out.dtype == torch.bfloat16
    ref = ref_attention_ref(*(jnp.asarray(a, jnp.bfloat16).reshape(2, 64, 32)
                              for a in (q, k, v)), causal=True)
    np.testing.assert_allclose(out.float().numpy().reshape(2, 64, 32),
                               np.asarray(ref, np.float32), rtol=5e-2, atol=5e-2)


@pytest.mark.parametrize("causal", [False, True])
def test_attention_oracle_matches_reference(causal):
    q, k, v = rand((3, 20, 8), 7), rand((3, 28, 8), 8), rand((3, 28, 8), 9)
    ref = ref_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            causal=causal)
    out = attention_ref(t(q), t(k), t(v), causal=causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("window", [0, 5])
@pytest.mark.parametrize("offset", [0, 7])
@pytest.mark.parametrize("chunk", [8, 13, 512])
def test_attend_chunked_matches_reference(window, offset, chunk):
    """The model route's plain version on positions that are not 0..S-1
    (a shifted block of positions), with GQA and ragged chunks."""
    b, s, hq, hkv, d = 2, 30, 6, 2, 16
    q, k, v = rand((b, s, hq, d), 10), rand((b, s, hkv, d), 11), rand((b, s, hkv, d), 12)
    pos = (np.arange(s) + offset).astype(np.int32)
    ref = ref_attend_chunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             jnp.asarray(pos), jnp.asarray(pos), window, chunk)
    out = attend(t(q), t(k), t(v), t(pos), t(pos), window, chunk)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)
    same = attend_chunked(t(q), t(k), t(v), t(pos), t(pos), window, chunk)
    assert torch.equal(out, same)


def test_flash_gqa_reads_kv_head_h_over_rep():
    """Query head h must read KV head h // (Hq // Hkv): with Hkv < Hq and
    distinct KV heads, any other mapping gives another answer."""
    b, hq, hkv, s, d = 1, 6, 3, 10, 8
    q, k, v = rand((b, hq, s, d), 13), rand((b, hkv, s, d), 14), rand((b, hkv, s, d), 15)
    out = flash_attention(t(q), t(k), t(v), causal=True)
    kr = np.repeat(k, hq // hkv, axis=1).reshape(b * hq, s, d)
    vr = np.repeat(v, hq // hkv, axis=1).reshape(b * hq, s, d)
    ref = attention_ref(t(q).reshape(b * hq, s, d), t(kr), t(vr), causal=True)
    np.testing.assert_allclose(out.reshape(b * hq, s, d).numpy(), ref.numpy(),
                               rtol=1e-5, atol=1e-6)


def test_flash_rejects_bad_operands():
    q = torch.zeros(1, 4, 8, 16)
    with pytest.raises(ValueError):
        flash_attention(q, torch.zeros(1, 3, 8, 16), torch.zeros(1, 3, 8, 16))
    with pytest.raises(TypeError):
        flash_attention(q, torch.zeros(1, 2, 8, 16).double(), torch.zeros(1, 2, 8, 16))
    with pytest.raises(ValueError, match="no kernel"):
        flash_attention(q.to("meta"), q.to("meta"), q.to("meta"))


@pytest.mark.parametrize("dataflow", DATAFLOWS)
@pytest.mark.parametrize("v,f,g", [(128, 128, 128), (96, 80, 72), (33, 17, 5), (256, 64, 512)])
def test_gemm_matches_reference(dataflow, v, f, g):
    x, w = rand((v, f), v), rand((f, g), g)
    ref = ref_gemm(jnp.asarray(x), jnp.asarray(w), dataflow=dataflow,
                   block_v=32, block_g=32, block_f=32)
    out = gemm(t(x), t(w), dataflow=dataflow, block_v=32, block_g=32, block_f=32)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)


def test_gemm_bf16_matches_reference():
    x, w = rand((64, 64), 16), rand((64, 64), 17)
    ref = ref_gemm(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16),
                   block_v=32, block_g=32, block_f=32)
    out = gemm(t(x).to(torch.bfloat16), t(w).to(torch.bfloat16),
               block_v=32, block_g=32, block_f=32)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                               rtol=3e-2, atol=3e-2)


def test_gemm_cpu_runs_plain_version_and_counts_no_launch():
    x, w = t(rand((20, 12), 18)), t(rand((12, 7), 19))
    before = gemm.launches
    assert torch.equal(gemm(x, w, dataflow="input_stationary"), gemm_ref(x, w))
    assert gemm.launches == before


def test_gemm_rejects_unknown_dataflow_and_bad_operands():
    x, w = torch.zeros(4, 3), torch.zeros(3, 2)
    with pytest.raises(ValueError, match="dataflow must be one of"):
        gemm(x, w, dataflow="row_stationary")
    with pytest.raises(ValueError):
        gemm(x, torch.zeros(4, 2))
    with pytest.raises(TypeError):
        gemm(x, w.to(torch.bfloat16))


def test_gemm_tile_sizes_clip_to_matrix_registers_and_smem():
    """The CTA tiles ``plan`` gives: 16 x 16 on the CUDA cores with the
    whole F resident up to 1536 rows (2 x 96 KB per SM), 128 x 128 on the
    tensor cores with at most 9 resident 64-deep tiles (144 KB); the
    paper's block sizes do not change them."""
    bf16, f32 = torch.bfloat16, torch.float32
    cora = plan(2708, 1433, 16, f32, "output_stationary")
    assert (cora.route, cora.tile_v, cora.tile_g, cora.slab, cora.nslab) == \
        ("cuda_cores", 16, 16, 1433, 1)
    assert cora.grid == (170, 1) and cora.grid[0] >= 132  # fills the card
    for df in DATAFLOWS:
        p = plan(4096, 576, 1536, bf16, df)
        assert (p.route, p.tile_v, p.tile_g, p.nslab) == ("tensor_cores", 128, 128, 1)
        assert p.grid[0] * p.grid[1] <= 132  # one wave, one CTA per SM
    wide = plan(4096, 4096, 4096, bf16, "weight_stationary")
    assert (wide.slab, wide.nslab) == (9 * 64, 8)  # 144 KB slabs, 8 of them
    assert plan(4096, 4096, 4096, f32, "input_stationary")[3:5] == (1536, 3)
    assert plan(33, 17, 5, bf16, "output_stationary").route == "cuda_cores"


@pytest.mark.parametrize("dataflow", DATAFLOWS)
@pytest.mark.parametrize("v,f,g", [(2708, 1433, 16), (4096, 576, 1536), (33, 17, 5),
                                   (1000, 1216, 264), (5000, 64, 8)])
def test_gemm_plan_covers_every_tile_once(dataflow, v, f, g):
    """Each CTA's walk (blockIdx + k * split along the temporal axis) and
    the grid together cover every output tile exactly once, within CUDA's
    grid limits."""
    for dtype in (torch.float32, torch.bfloat16):
        p = plan(v, f, g, dtype, dataflow)
        nv, ng = -(-v // p.tile_v), -(-g // p.tile_g)
        gx, gy = p.grid
        assert 1 <= gy <= 65535 and gx >= 1
        if dataflow == "output_stationary" and p.route == "tensor_cores":
            tiles = [t for b in range(gx) for t in range(b, nv * ng, gx)]
        elif dataflow == "output_stationary":
            # the weight-stationary walk with one row group per CTA
            assert p.split == nv == gx
            tiles = [i * ng + j for b in range(gx) for j in range(gy)
                     for i in range(b, nv, p.split)]
        elif dataflow == "weight_stationary":
            tiles = [i * ng + j for b in range(gx) for j in range(gy)
                     for i in range(b, nv, p.split)]
        else:
            tiles = [i * ng + j for i in range(gx) for b in range(gy)
                     for j in range(b, ng, p.split)]
        assert sorted(tiles) == list(range(nv * ng))
        assert p.nslab == -(-f // p.slab)


def test_gemm_tma_eligibility():
    """TMA takes a bf16 operand only when each row is a multiple of 16
    bytes and its base is 16-byte aligned; anything else runs on CUDA
    cores (never on wrong numbers)."""
    assert tma_ok(4096, 576, 1536)
    assert not tma_ok(300, 200, 150)   # w rows of 300 bytes
    assert not tma_ok(2708, 1433, 16)  # x rows of 2866 bytes
    assert not tma_ok(64, 64, 64, x_ptr=8)
    assert plan(64, 64, 64, torch.bfloat16, "output_stationary", w_ptr=2).route == "cuda_cores"
    assert plan(64, 64, 64, torch.float32, "output_stationary").route == "cuda_cores"


def _views(*ts):
    return [(t.shape, t.stride()) for t in ts]


def test_flash_route_needs_bf16_and_tma_strides():
    b, s, hq, hkv, d = 2, 40, 6, 2, 64
    q = torch.zeros(b, s, hq, d, dtype=torch.bfloat16).transpose(1, 2)  # model layout
    k = torch.zeros(b, s, hkv, d, dtype=torch.bfloat16).transpose(1, 2)
    ptrs = [0, 0, 0, 0]
    assert flash_route(torch.bfloat16, _views(q, k, k, q), ptrs) == "tensor_cores"
    assert flash_route(torch.float32, _views(q, k, k, q), ptrs) == "cuda_cores"
    assert flash_route(torch.bfloat16, _views(q, k, k, q), [0, 16, 8, 0]) == "cuda_cores"
    odd = torch.zeros(b, hkv, s, d + 4, dtype=torch.bfloat16)[..., :d]  # 136-byte rows
    assert flash_route(torch.bfloat16, _views(q, odd, k, q), ptrs) == "cuda_cores"
    assert flash_route(torch.bfloat16, _views(q, k, k, q), [0, 0, 0, 2]) == "cuda_cores"
    one = torch.zeros(1, 1, 1, 8, dtype=torch.bfloat16)  # extent-1 dims never step
    assert flash_route(torch.bfloat16, _views(one, one, one, one), ptrs) == "tensor_cores"


def test_kernel_build_key_covers_included_headers(tmp_path):
    """An edit to a header the .cu includes changes the library's key, so
    a stale build is never loaded."""
    (tmp_path / "k").mkdir()
    cu, hdr = tmp_path / "k" / "lib.cu", tmp_path / "common.cuh"
    hdr.write_text("// v1\n")
    cu.write_text('#include <cuda_runtime.h>\n#include "../common.cuh"\nint x;\n')
    lib = CudaLibrary(cu, {})
    assert lib.sources() == [cu.resolve(), hdr.resolve()]
    before = lib.so_path()
    hdr.write_text("// v2\n")
    assert lib.so_path() != before


@pytest.mark.parametrize("file,variant", sorted(kernel_profile.ABLATIONS))
def test_profile_ablation_sites_occur_once_in_the_kernel_source(file, variant):
    """Each ablation of ``python -m repro_torch.kernels.profile`` patches a
    text that occurs exactly once in the kernel it copies, so an edit to
    the kernel cannot leave it timing an unpatched copy."""
    text = (kernel_profile.KERNELS / file / f"{file}.cu").read_text()
    for old, _ in kernel_profile.ABLATIONS[(file, variant)]:
        assert text.count(old) == 1, old


def test_profile_resident_ctas_by_each_limit():
    """CTAs an SM holds: registers by whole warps in units of 256, shared
    memory with 1 KB reserved per CTA."""
    flash = kernel_profile.resident_ctas(110, 160, 58624)
    assert (flash["ctas_per_sm"], flash["ctas_per_sm_by_limit"]["registers"]) == (3, 3)
    cora = kernel_profile.resident_ctas(125, 128, 1433 * 16 * 4)
    assert (cora["ctas_per_sm"], cora["limited_by"]) == (2, "shared_memory")
    assert kernel_profile.resident_ctas(32, 1024, 0)["ctas_per_sm"] == 2  # threads, registers
