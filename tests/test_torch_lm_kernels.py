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
from repro_torch.kernels.gemm_dataflow import DATAFLOWS, gemm, gemm_ref, tile_sizes


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
    assert tile_sizes(2708, 1433, 16) == (128, 16, 128)
    assert tile_sizes(33, 17, 5, 32, 32, 32) == (32, 5, 17)
    bv, bg, bf = tile_sizes(4096, 4096, 4096, 512, 512, 4096)
    assert (bv, bg) == (128, 128)
    assert (128 * (bf + 1) + bf * 128) * 4 <= 232448 < (128 * (bf + 2) + (bf + 1) * 128) * 4
