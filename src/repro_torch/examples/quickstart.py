"""Quickstart: the paper in 40 lines.

Describe a GNN dataflow with the taxonomy, simulate it on the spatial
accelerator model, then let `repro_torch.compile()` do the whole pipeline —
mapper search, lowering to executable knobs, and packaging into a frozen,
cacheable Program — and execute it on the card (the kernel tier: the
hand-written CUDA kernels; ``--device cpu`` runs their plain versions).

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
import argparse
import tempfile
from pathlib import Path

import numpy as np
import torch

import repro_torch
from repro_torch.core import (
    AcceleratorConfig,
    GNNLayerWorkload,
    named_dataflow,
    search_dataflows,
    simulate,
)
from repro_torch.device import resolve_device
from repro_torch.gnn import EllAdjacency, multiphase_matmul
from repro_torch.graphs import load_dataset


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device)")
    dev = resolve_device(ap.parse_args(argv).device)

    # --- 1. a workload: one GCN layer over Cora ----------------------------
    graph, spec = load_dataset("cora")
    wl = GNNLayerWorkload(graph.nnz, f_in=spec.n_features, g_out=16, name="cora")
    print(f"cora: V={wl.v} E={wl.e} F={wl.f_in} max_deg={graph.max_degree}")

    # --- 2. describe + simulate one dataflow (HyGCN's, Table 2 row 5) ------
    hygcn = named_dataflow("HyGCN", T_F_AGG=32, T_V_CMB=8, T_G=16, T_F_CMB=2)
    stats = simulate(hygcn, wl, AcceleratorConfig())
    print(f"\nHyGCN dataflow {hygcn}\n  cycles={stats.cycles:.0f} "
          f"energy={stats.energy_pj/1e6:.1f}uJ util={stats.pe_utilization:.2f}")

    # --- 3. the mapper searches tile sizes + dataflows (paper Sec. 6) ------
    # the whole Table-5 sweep runs on the batched, cache-backed engine; ask
    # for top_k > 1 to see near-optimal alternatives per skeleton
    ranked = search_dataflows(wl, objective="edp", top_k=2)
    print("\nmapper ranking (EDP):")
    for r in ranked[:4]:
        print(f"  {r.skeleton:12s} cycles={r.stats.cycles:9.0f} "
              f"E={r.stats.energy_pj/1e6:8.1f}uJ  {r.dataflow}")

    # --- 4. repro_torch.compile(): search -> lower -> execute in one call --
    # the 2-layer Kipf GCN shrinks 1433 -> 16 -> 8, so the optimal dataflow
    # changes per layer; compile runs the model-level DP (transition costs
    # priced), lowers the winning schedule, and binds the graph
    wls = [
        GNNLayerWorkload(graph.nnz, spec.n_features, 16, name="layer0"),
        GNNLayerWorkload(graph.nnz, 16, 8, name="layer1"),
    ]
    program = repro_torch.compile(wls, graph=graph, objective="cycles",
                                  use_pallas=True, device=dev)
    homo = program.schedule.shared_baseline  # best shared dataflow, same sweep
    print(f"\ncompiled program ({program.stats.cycles:.0f} cycles vs "
          f"{homo.stats.cycles:.0f} homogeneous):")
    print(program)

    # the Program is a cacheable artifact: serving paths save it once and
    # skip the mapper forever after
    with tempfile.TemporaryDirectory() as td:
        path = program.save(Path(td) / "cora.program.json")
        reloaded = repro_torch.Program.load(path, graph=graph, device=dev)
        assert reloaded.schedule == program.schedule
        assert reloaded.stats == program.stats
        print(f"saved + reloaded artifact: {path.name} "
              f"({path.stat().st_size} bytes, byte-stable JSON)")

    # --- 5. execute the compiled program, and each policy by hand ----------
    params = program.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    x = torch.as_tensor(
        rng.normal(size=(graph.n_nodes, spec.n_features)).astype(np.float32),
        device=dev)
    logits = program.run(params, x)
    print(f"\nprogram.run -> logits {tuple(logits.shape)}")

    adj = EllAdjacency.from_csr(graph, device=dev)
    w = torch.as_tensor(
        rng.normal(size=(spec.n_features, 16)).astype(np.float32), device=dev)
    outs = {
        p: multiphase_matmul(adj, x, w, policy=p, use_pallas=True)
        for p in ("seq", "sp_generic", "sp_opt")
    }
    ref = outs["seq"].cpu().numpy()
    for p, o in outs.items():
        err = np.abs(o.cpu().numpy() - ref).max()
        print(f"policy {p:10s} max|Δ| vs seq = {err:.2e}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
