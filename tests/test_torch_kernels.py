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
from repro_torch.kernels.common import (
    BUILD_DIR,
    CudaKernelError,
    CudaLibrary,
    cdiv,
    measure_wall,
)
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


def test_libraries_of_the_same_sources_build_once(tmp_path, monkeypatch):
    """Two libraries whose sources hash alike (an unchanged kernel of
    another checkout) start one ``nvcc``: two would race for one file."""
    from repro_torch.kernels.common import build_libraries

    for sub in ("a", "b"):
        (tmp_path / sub).mkdir()
        (tmp_path / sub / "k.cu").write_text("// same")
    libs = [CudaLibrary(tmp_path / sub / "k.cu", {}) for sub in ("a", "b")]
    started = []
    monkeypatch.setattr(CudaLibrary, "start_build", lambda self: started.append(self))
    build_libraries(libs)
    assert started == libs[:1]


def test_a_library_that_cannot_build_raises_cuda_kernel_error(tmp_path):
    """A kernel that does not build raises ``CudaKernelError`` (the type the
    serving ladder re-raises), whether ``nvcc`` is missing, as on a
    CPU-only host, or refuses the source; no library is left behind."""
    src = tmp_path / "broken.cu"
    src.write_text('extern "C" int broken_launch( {\n')
    lib = CudaLibrary(src, {"broken_launch": []})
    with pytest.raises(CudaKernelError, match="nvcc"):
        lib.load()
    assert not lib.so_path().exists()


# -- the padded-ELL layout the CUDA kernels rely on --------------------------
# Both kernels walk only a row's real slots, found inside the launch as the
# slots before the row's trailing run of weight-0 slots.  That is exact only
# because every producer of the ELL puts a row's real slots first and pads
# after them with index 0 and weight 0.


def assert_real_slots_first(g, idx, wts):
    """Row r of (idx, wts) holds g's neighbor list of r in its first
    deg(r) slots, then index 0 and weight 0; rows past V are all padding."""
    deg = g.nnz
    for r in range(idx.shape[0]):
        n = int(deg[r]) if r < g.n_nodes else 0
        s = int(g.row_ptr[r]) if r < g.n_nodes else 0
        np.testing.assert_array_equal(idx[r, :n], g.col_idx[s:s + n])
        np.testing.assert_array_equal(wts[r, :n], g.values[s:s + n])
        assert not idx[r, n:].any() and not wts[r, n:].any(), f"row {r}"


def _csr_graph(kind):
    from repro_torch.graphs import from_edges as torch_from_edges
    from repro_torch.graphs import load_dataset

    if kind == "cora":
        return load_dataset("cora")[0]
    rng = np.random.default_rng(3)
    return torch_from_edges(300, rng.integers(0, 300, 900), rng.integers(0, 300, 900))


@pytest.mark.parametrize("kind,block_rows", [("random", 1), ("random", 8), ("cora", 128)])
def test_to_ell_puts_real_slots_first_and_pads_with_zero(kind, block_rows):
    g = _csr_graph(kind)
    idx, wts, msk = g.to_ell(block_rows)
    assert idx.shape[0] % block_rows == 0 and idx.shape[1] == g.max_degree
    assert_real_slots_first(g, idx, wts)
    np.testing.assert_array_equal(msk.sum(1)[:g.n_nodes], g.nnz)


def test_ell_adjacency_pad_to_pads_with_zero():
    from repro_torch.gnn.layers import EllAdjacency

    g = _csr_graph("random")
    adj = EllAdjacency.from_csr(g, pad_to=g.max_degree + 37, device="cpu")
    assert adj.indices.shape == (g.n_nodes, g.max_degree + 37)
    assert_real_slots_first(g, adj.indices.numpy(), adj.weights.numpy())


def test_assembled_batch_ell_puts_real_slots_first():
    """A serving micro-batch: member graphs, then zero-weight pad rows, each
    row padded to the bucket's degree with index 0 and weight 0; the pad
    rows' one real slot (a self-loop) has weight 0, so their trimmed length
    is 0."""
    from repro_torch.graphs import TABLE4, BucketPolicy, assemble, bucketize
    from repro_torch.graphs.datasets import make_graph

    rng = np.random.default_rng(0)
    graphs = [make_graph(TABLE4["imdb-bin"], rng) for _ in range(6)]
    policy = BucketPolicy()
    for key, ids in bucketize(graphs, policy).items():
        batch = assemble([graphs[i] for i in ids], policy)
        idx, wts, _ = batch.graph.to_ell(pad_to=batch.d_bucket)
        assert idx.shape == (batch.graph.n_nodes, key[1])
        assert_real_slots_first(batch.graph, idx, wts)
        real = int(batch.sizes.sum())
        assert not wts[real:].any()


@pytest.mark.parametrize("block_rows", [64, 128])
def test_spmm_streamed_slabs_keep_the_padding(monkeypatch, block_rows):
    """Each slab spmm_streamed hands to ``spmm`` keeps its rows' weights as
    they were, and its remapped indices still point the padded (weight-0)
    slots at a row of x and the real slots at the same rows as before."""
    from repro_torch.kernels.spmm import ops

    g = _csr_graph("random")
    idx, wts, _ = g.to_ell(pad_to=g.max_degree + 5)
    x = t(rand((g.n_nodes, 12), seed=4))
    slabs = []
    real_spmm = ops.spmm

    def recording_spmm(i, w, xs, **kw):
        slabs.append((i, w, xs))
        return real_spmm(i, w, xs, **kw)

    monkeypatch.setattr(ops, "spmm", recording_spmm)
    out = ops.spmm_streamed(t(idx), t(wts), x, block_rows=block_rows)
    assert len(slabs) == -(-g.n_nodes // block_rows)
    for k, (i, w, xs) in enumerate(slabs):
        rows = slice(k * block_rows, (k + 1) * block_rows)
        assert torch.equal(w, t(wts[rows]))
        # the slab's x is the closure's rows, so xs[i] == x[idx] slot by slot
        assert torch.equal(xs[i.long()], x[t(idx[rows]).long()])
        pad = w == 0
        assert bool((i[pad] == 0).all())  # row 0 of x is in every closure
    np.testing.assert_allclose(out.numpy(), spmm_ref(t(idx), t(wts), x).numpy(),
                               rtol=1e-6, atol=1e-6)


def test_micro_batches_serve_every_graph_once_in_bucket_order():
    """``micro_batches`` is the serving loop's batching: bucketize, then
    each bucket's members in chunks of ``max_graphs``, assembled."""
    from repro_torch.graphs import TABLE4, BucketPolicy, bucketize, micro_batches, sample_graphs

    graphs = sample_graphs(TABLE4["reddit-bin"], 32, seed=0)
    policy = BucketPolicy(max_graphs=8)
    got = list(micro_batches(graphs, policy))
    want = [(key, ids[s:s + 8]) for key, ids in bucketize(graphs, policy).items()
            for s in range(0, len(ids), 8)]
    assert [(k, list(c)) for k, c, _ in got] == [(k, list(c)) for k, c in want]
    assert sorted(i for _, c, _ in got for i in c) == list(range(32))
    for key, chunk, batch in got:
        assert batch.n_graphs == len(chunk) and (batch.v_bucket, batch.d_bucket) == key
        np.testing.assert_array_equal(batch.sizes, [graphs[i].n_nodes for i in chunk])


def test_bucket_ell_is_the_ell_a_served_batch_binds():
    """``bucket_ell`` gives the first batch of a bucket and the ELL that
    binding it at the bucket's degree builds (``EllAdjacency.from_csr``)."""
    from repro_torch.gnn.layers import EllAdjacency
    from repro_torch.graphs import TABLE4, bucket_ell, micro_batches, sample_graphs

    graphs = sample_graphs(TABLE4["reddit-bin"], 32, seed=0)
    first = {}
    for key, chunk, _ in micro_batches(graphs):
        first.setdefault(key, chunk)
    for key, chunk in first.items():
        batch, idx, wts = bucket_ell(graphs, key)
        np.testing.assert_array_equal(batch.sizes, [graphs[i].n_nodes for i in chunk])
        adj = EllAdjacency.from_csr(batch.graph, pad_to=batch.d_bucket, device="cpu")
        np.testing.assert_array_equal(idx, adj.indices.numpy())
        np.testing.assert_array_equal(wts, adj.weights.numpy())
        assert_real_slots_first(batch.graph, idx, wts)


@pytest.mark.parametrize("kind", ["random", "cora"])
def test_to_torch_csr_is_the_graph(kind):
    from repro_torch.graphs import to_torch_csr

    g = _csr_graph(kind)
    a = to_torch_csr(g, "cpu")
    assert a.layout == torch.sparse_csr and a.shape == (g.n_nodes, g.n_nodes)
    np.testing.assert_array_equal(a.to_dense().numpy(), g.to_dense())
