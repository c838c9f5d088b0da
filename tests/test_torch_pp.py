"""The port's Parallel Pipeline (``repro_torch.gnn.pp``) on the CPU, held
to what ``tests/test_gnn_pp.py`` asserts of the reference: the two-group
AC pipeline, its CA direction and the one-device fallback.  The port's two
groups run on a device list; ``["cpu", "cpu"]`` interleaves them in
program order (on a card they are two CUDA streams, in
``tests/test_torch_cuda.py``).  Cross-package: the reference's pipelined
output under two forced host devices, from a subprocess, at 2e-4."""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.gnn import EllAdjacency, multiphase_matmul
from repro_torch.gnn.pp import mesh_devices, pp_multiphase_matmul
from repro_torch.graphs import from_edges, load_dataset

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL_REF = dict(rtol=2e-4, atol=2e-4)  # the cross-package layer tolerance
MESH = ["cpu", "cpu"]


def mutag_inputs(g_out=16, seed=0):
    g, spec = load_dataset("mutag")
    adj = EllAdjacency.from_csr(g, device="cpu")
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(g.n_nodes, spec.n_features)).astype(np.float32)
    w = rng.normal(size=(spec.n_features, g_out)).astype(np.float32)
    return adj, torch.as_tensor(x), torch.as_tensor(w)


def test_mesh_devices_takes_a_sequence_as_it_is():
    assert mesh_devices(devices=["cpu", "cpu"]) == [torch.device("cpu")] * 2
    assert mesh_devices(mesh=[torch.device("cpu")]) == [torch.device("cpu")]
    with pytest.raises(ValueError, match="not both"):
        mesh_devices(mesh=["cpu"], devices=["cpu"])


def test_mesh_devices_raises_without_cuda(monkeypatch):
    """Neither mesh nor devices means every CUDA device; with none there
    is no quiet move to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh_devices()


@pytest.mark.parametrize("band", [64, 128, 5])
def test_two_group_eager_is_the_fallback_bit_for_bit(band):
    """The pipeline used to raise for a 2-entry mesh (it is what
    ``pp_shard_forward`` runs on 2 or more cards).  Rows are independent and
    ``row_matmul`` is row-stable, so any band size gives the fallback's
    bits, ragged last band included."""
    adj, x, w = mutag_inputs()
    want = pp_multiphase_matmul(adj, x, w, order="AC", mesh=None)
    got = pp_multiphase_matmul(adj, x, w, order="AC", mesh=MESH, band_size=band)
    assert got.shape == (adj.n_nodes, 16)
    assert np.array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("band", [64, 128])
def test_two_group_kernel_tier_within_2e4(band):
    """On the kernel tier the producer runs ``spmm`` and the consumer the
    ``gemm`` kernel (their plain versions on a CPU tensor)."""
    adj, x, w = mutag_inputs()
    want = pp_multiphase_matmul(adj, x, w, mesh=None)
    got = pp_multiphase_matmul(adj, x, w, mesh=MESH, band_size=band, use_kernels=True)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL_REF)


def test_pp_registry_entry_passes_the_tier_on(monkeypatch):
    """``multiphase_matmul(policy="pp", use_pallas=...)`` reaches the
    pipeline with the layer's tier."""
    import repro_torch.gnn.pp as pp_mod

    seen = []
    real = pp_mod.pp_multiphase_matmul

    def spy(*args, **kw):
        seen.append(kw["use_kernels"])
        return real(*args, **kw)

    monkeypatch.setattr(pp_mod, "pp_multiphase_matmul", spy)
    adj, x, w = mutag_inputs(8)
    for tier in (False, True):
        out = multiphase_matmul(adj, x, w, policy="pp", mesh=MESH, use_pallas=tier)
        assert out.shape == (adj.n_nodes, 8)
    assert seen == [False, True]


def test_ca_is_unchanged_by_the_mesh():
    adj, x, w = mutag_inputs()
    want = multiphase_matmul(adj, x, w, policy="sp_generic", order="CA", band_size=64)
    got = pp_multiphase_matmul(adj, x, w, order="CA", mesh=MESH, band_size=64)
    assert np.array_equal(got.numpy(), want.numpy())


def test_mixed_cpu_and_cuda_groups_raise():
    adj, x, w = mutag_inputs()
    with pytest.raises(ValueError, match="CUDA devices or neither"):
        pp_multiphase_matmul(adj, x, w, mesh=["cpu", "cuda:0"])


def test_isolated_rows_and_single_band():
    """A graph with isolated nodes and fewer rows than one band."""
    g = from_edges(7, np.array([0, 1, 2]), np.array([1, 2, 0]))
    adj = EllAdjacency.from_csr(g, device="cpu")
    rng = np.random.default_rng(3)
    x = torch.as_tensor(rng.normal(size=(7, 5)).astype(np.float32))
    w = torch.as_tensor(rng.normal(size=(5, 3)).astype(np.float32))
    want = pp_multiphase_matmul(adj, x, w, mesh=None)
    got = pp_multiphase_matmul(adj, x, w, mesh=MESH, band_size=128)
    assert np.array_equal(got.numpy(), want.numpy())


REFERENCE_SCRIPT = textwrap.dedent(
    """
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    import jax, jax.numpy as jnp, numpy as np
    from repro.gnn import EllAdjacency
    from repro.gnn.pp import pp_multiphase_matmul
    from repro.graphs import load_dataset

    assert jax.device_count() == 2, jax.devices()
    g, spec = load_dataset("mutag")
    adj = EllAdjacency.from_csr(g)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(g.n_nodes, spec.n_features)).astype(np.float32)
    w = rng.normal(size=(spec.n_features, 16)).astype(np.float32)
    mesh = jax.make_mesh((2,), ("phase",))
    for band in (64, 128):
        out = pp_multiphase_matmul(adj, jnp.asarray(x), jnp.asarray(w),
                                   order="AC", mesh=mesh, band_size=band)
        np.save(os.path.join(sys.argv[1], f"pp_{band}.npy"), np.asarray(out))
    print("PP-REFERENCE-OK")
    """
)


def test_two_group_pipeline_matches_the_reference(tmp_path):
    """The reference's two-device pipelined output (``shard_map`` +
    ``ppermute`` under two forced host devices) against the port's two
    groups, at two band sizes, at 2e-4."""
    env = dict(os.environ, PYTHONPATH="src")
    env.pop("XLA_FLAGS", None)
    r = subprocess.run(
        [sys.executable, "-c", REFERENCE_SCRIPT, str(tmp_path)],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300,
    )
    assert "PP-REFERENCE-OK" in r.stdout, r.stderr[-2000:]
    adj, x, w = mutag_inputs()
    for band in (64, 128):
        want = np.load(tmp_path / f"pp_{band}.npy")
        for tier in (False, True):
            got = pp_multiphase_matmul(adj, x, w, mesh=MESH, band_size=band,
                                       use_kernels=tier)
            np.testing.assert_allclose(got.numpy(), want, **TOL_REF,
                                       err_msg=f"band {band}, kernels {tier}")
