"""Parity of the port's kernel wrappers with the reference's, on the CPU.

On a CPU tensor each wrapper runs its plain PyTorch version; the reference
runs its Pallas kernel in interpret mode, as ``tests/test_kernels.py``
does.  Shapes and tolerances are those of ``tests/test_kernels.py``.  The
CUDA kernels themselves are held against the plain versions on the card
by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.graphs import from_edges
from repro.kernels import fused_agg_cmb as ref_fused
from repro.kernels import spmm as ref_spmm
from repro.kernels.spmm.ops import spmm_streamed as ref_spmm_streamed
from repro_torch.kernels.common import BUILD_DIR, CudaLibrary, cdiv, measure_wall
from repro_torch.kernels.fused_agg_cmb import fused_agg_cmb, fused_ref
from repro_torch.kernels.spmm import spmm, spmm_ref, spmm_streamed


def random_ell(v, max_deg, seed=0):
    rng = np.random.default_rng(seed)
    extra = rng.integers(0, v * max_deg // 2 + 1)
    g = from_edges(v, rng.integers(0, v, extra), rng.integers(0, v, extra))
    idx, wts, _ = g.to_ell()
    return idx, wts


def rand(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("v,f,deg", [(64, 32, 4), (200, 96, 8), (17, 5, 3)])
def test_spmm_matches_reference(v, f, deg):
    idx, wts = random_ell(v, deg, seed=v)
    x = rand((v, f), seed=v + 1)
    ref = ref_spmm.spmm(jnp.asarray(idx), jnp.asarray(wts), jnp.asarray(x),
                        block_v=32, block_f=32)
    out = spmm(t(idx), t(wts), t(x), block_v=32, block_f=32)
    assert out.shape == ref.shape and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("block_rows", [64, 128])
def test_spmm_streamed_matches_reference(block_rows):
    idx, wts = random_ell(200, 8, seed=5)
    x = rand((200, 24), seed=6)
    ref = ref_spmm_streamed(jnp.asarray(idx), jnp.asarray(wts), jnp.asarray(x),
                            block_rows=block_rows, block_v=32, block_f=32)
    out = spmm_streamed(t(idx), t(wts), t(x), block_rows=block_rows)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-5)
    whole = spmm(t(idx), t(wts), t(x))
    np.testing.assert_allclose(out.numpy(), whole.numpy(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("v,f,g,deg", [(64, 32, 16, 4), (130, 48, 8, 6)])
def test_fused_matches_reference(v, f, g, deg):
    idx, wts = random_ell(v, deg, seed=v)
    x, w = rand((v, f), seed=v + 1), rand((f, g), seed=v + 2)
    ref = ref_fused.fused_agg_cmb(jnp.asarray(idx), jnp.asarray(wts),
                                  jnp.asarray(x), jnp.asarray(w), band_size=32)
    out = fused_agg_cmb(t(idx), t(wts), t(x), t(w), band_size=32)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("block_f", [8, 16, 33])
def test_fused_chunked_f_matches_reference(block_f):
    """block_f < F: the reference scans F chunks and sums f32 partials;
    the port walks F inside one kernel — same function, other order."""
    idx, wts = random_ell(96, 5, seed=1)
    x, w = rand((96, 40), seed=2), rand((40, 12), seed=3)
    ref = ref_fused.fused_agg_cmb(jnp.asarray(idx), jnp.asarray(wts),
                                  jnp.asarray(x), jnp.asarray(w),
                                  band_size=32, block_f=block_f)
    out = fused_agg_cmb(t(idx), t(wts), t(x), t(w), band_size=32, block_f=block_f)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)


def test_fused_equals_two_phase():
    idx, wts = random_ell(96, 5, seed=1)
    x, w = t(rand((96, 40), seed=2)), t(rand((40, 12), seed=3))
    fused = fused_agg_cmb(t(idx), t(wts), x, w, band_size=32)
    seq = spmm(t(idx), t(wts), x) @ w
    np.testing.assert_allclose(fused.numpy(), seq.numpy(), rtol=1e-4, atol=1e-4)


def test_plain_versions_bf16_match_reference_oracles():
    idx, wts = random_ell(64, 4, seed=9)
    x, w = rand((64, 32), seed=10), rand((32, 16), seed=11)
    xb, wb = jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
    xt, wt = t(x).to(torch.bfloat16), t(w).to(torch.bfloat16)
    pairs = [
        (spmm(t(idx), t(wts), xt),
         ref_spmm.spmm_ref(jnp.asarray(idx), jnp.asarray(wts), xb)),
        (fused_agg_cmb(t(idx), t(wts), xt, wt),
         ref_fused.fused_ref(jnp.asarray(idx), jnp.asarray(wts), xb, wb)),
    ]
    for out, ref in pairs:
        assert out.dtype == torch.bfloat16
        np.testing.assert_allclose(out.float().numpy(),
                                   np.asarray(ref, np.float32),
                                   rtol=2e-2, atol=2e-2)


def test_cpu_calls_use_plain_version_and_count_no_launch():
    idx, wts = random_ell(40, 4, seed=4)
    x, w = t(rand((40, 8), seed=5)), t(rand((8, 4), seed=6))
    before = (spmm.launches, fused_agg_cmb.launches)
    assert torch.equal(spmm(t(idx), t(wts), x), spmm_ref(t(idx), t(wts), x))
    assert torch.equal(fused_agg_cmb(t(idx), t(wts), x, w),
                       fused_ref(t(idx), t(wts), x, w))
    assert (spmm.launches, fused_agg_cmb.launches) == before


@pytest.mark.parametrize("bad", ["idx_dtype", "wts_dtype", "x_dtype", "w_dtype",
                                 "shape", "w_shape", "noncontig", "device"])
def test_wrappers_reject_bad_operands(bad):
    idx, wts = random_ell(40, 4, seed=4)
    idx, wts = t(idx), t(wts)
    x, w = t(rand((40, 8), seed=5)), t(rand((8, 4), seed=6))
    if bad == "idx_dtype":
        idx = idx.long()
    elif bad == "wts_dtype":
        wts = wts.double()
    elif bad == "x_dtype":
        x, w = x.double(), w.double()
    elif bad == "w_dtype":
        w = w.to(torch.bfloat16)
    elif bad == "shape":
        wts = wts[:, :-1].contiguous()
    elif bad == "w_shape":
        w = w[:-1].contiguous()
    elif bad == "noncontig":
        x = t(rand((8, 40), seed=5)).T
    elif bad == "device":
        x = x.to("meta")
    with pytest.raises((TypeError, ValueError)):
        fused_agg_cmb(idx, wts, x, w)
    if bad not in ("w_dtype", "w_shape"):
        with pytest.raises((TypeError, ValueError)):
            spmm(idx, wts, x)


def test_cdiv_and_measure_wall_on_cpu():
    assert [cdiv(a, 4) for a in (0, 1, 4, 5)] == [0, 1, 1, 2]
    calls = []
    seconds = measure_wall(lambda: calls.append(1), warmup=2, iters=3, reduce="min")
    assert len(calls) == 5 and seconds >= 0.0
    with pytest.raises(ValueError, match="reduce"):
        measure_wall(lambda: None, reduce="max")


def test_built_library_is_keyed_by_its_source(tmp_path):
    src = tmp_path / "k.cu"
    src.write_text("// one")
    lib = CudaLibrary(src, {})
    first = lib.so_path()
    assert first.parent == BUILD_DIR and first.name.startswith("k-")
    src.write_text("// two")
    assert lib.so_path() != first
