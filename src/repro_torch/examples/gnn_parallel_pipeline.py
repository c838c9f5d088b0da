"""The paper's Parallel-Pipeline dataflow across two device groups.

Group 0 aggregates row band i while group 1 runs the combination GEMM on
band i-1, handing each band over by an event (two CUDA streams of one
card: ``[cuda:0, cuda:0]``) or a peer copy (two cards, where there are
two) — Table 2's "NoC connecting Agg and Cmb units".  The eager tier on
the two groups is bit-identical to the one-device fallback
(``mesh=None``); the kernel tier (``spmm`` + ``gemm``) is held within 2e-4.

    PYTHONPATH=src python -m repro_torch.examples.gnn_parallel_pipeline [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.device import resolve_device, worker_devices
from repro_torch.gnn import EllAdjacency, multiphase_matmul
from repro_torch.graphs import load_dataset


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device)")
    dev = resolve_device(ap.parse_args(argv).device)

    g, spec = load_dataset("mutag")
    adj = EllAdjacency.from_csr(g, device=dev)
    rng = np.random.default_rng(0)
    x = torch.as_tensor(
        rng.normal(size=(g.n_nodes, spec.n_features)).astype(np.float32),
        device=dev)
    w = torch.as_tensor(
        rng.normal(size=(spec.n_features, 16)).astype(np.float32), device=dev)

    mesh = worker_devices(dev)[:2]
    ref = multiphase_matmul(adj, x, w, policy="seq").cpu().numpy()
    out = multiphase_matmul(adj, x, w, policy="pp", mesh=mesh).cpu().numpy()
    fallback = multiphase_matmul(adj, x, w, policy="pp").cpu().numpy()
    kern = multiphase_matmul(adj, x, w, policy="pp", mesh=mesh,
                             use_pallas=True).cpu().numpy()
    err = float(np.abs(out - ref).max())
    same = bool(np.array_equal(out, fallback))
    kern_err = float(np.abs(kern - out).max())
    groups = ", ".join(str(d) for d in mesh)
    print(f"PP across 2 device groups ({groups}): V={g.n_nodes} bands handed "
          f"over band by band")
    print(f"max |PP - Seq| = {err:.2e}  ({'OK' if err < 1e-3 else 'MISMATCH'})")
    print(f"PP on two groups == one-device fallback: {same}; kernel tier "
          f"max |Δ| = {kern_err:.2e}")
    if not same:
        raise SystemExit("PP on two groups differs from the one-device fallback")
    np.testing.assert_allclose(kern, out, rtol=2e-4, atol=2e-4)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
