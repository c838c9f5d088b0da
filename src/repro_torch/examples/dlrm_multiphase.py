"""Beyond GNNs: the taxonomy on a DLRM-style SpMM->GEMM chain (paper Sec. 6).

DLRM's embedding-bag lookup is an SpMM over a (batch x table) incidence
matrix; the MLP stack is dense GEMMs.  The same inter-phase question —
where does the pooled-embedding intermediate live? — is answered by the
same cost model (on the host; nothing runs on a device).

    PYTHONPATH=src python -m repro_torch.examples.dlrm_multiphase
"""
import argparse

import numpy as np

from repro_torch.core import GNNLayerWorkload, named_skeleton, optimize_tiles


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="accepted for a uniform command line; the cost "
                         "model runs on the host")
    ap.parse_args(argv)
    # batch of 4096 requests, each pooling ~40 of 1M embedding rows (F=64),
    # followed by a 64->256 MLP layer: aggregation = pooled lookup (nnz =
    # bag size), combination = the first MLP GEMM.
    rng = np.random.default_rng(0)
    bag_sizes = rng.poisson(40, size=4096).clip(1)
    wl = GNNLayerWorkload(bag_sizes, f_in=64, g_out=256, name="dlrm-bag")

    print("DLRM embedding-bag + MLP as a multiphase workload:")
    for name in ("Seq-Nt", "SP-FsNt-Fs", "SP-VsNt-Vs", "PP-Nt-Vsh"):
        r = optimize_tiles(named_skeleton(name), wl, objective="edp",
                           pe_splits=(0.25, 0.5, 0.75))
        s = r.stats
        print(f"  {name:12s} cycles={s.cycles:9.0f} "
              f"energy={s.energy_pj/1e6:7.1f}uJ "
              f"buffer={s.buffering_elems:8.0f}  {r.dataflow}")
    print("\n-> the same SP-opt fusion that wins for GNN aggregation keeps the")
    print("   pooled embeddings in-registers through the first MLP GEMM.")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
