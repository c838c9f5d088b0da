"""Roofline terms of a dry-run cell, on the H100's spec constants.

The port of :mod:`repro.launch.roofline`.  Per (arch x shape x mesh) cell:

    compute term    = FLOPs / (chips x peak_FLOP/s)
    memory term     = HBM bytes / (chips x HBM_bw)
    collective term = collective link bytes / (chips x link_bw)

The dry-run's numbers describe ONE rank's program, so the chip count
cancels inside each term.  As in the reference, the compute term uses the
exact analytic FLOPs (:mod:`.analytic`) and the memory term the analytic
HBM floor; the per-rank graph's FLOPs are kept as a cross-check.  The
graph's counts already include every loop's runs, so ``_scan_scale`` is 1
(no trip counts are recorded).

The collective term takes the link by the group's span
(``result["collectives"]["link_bytes_by_span"]``): a group inside one
8-GPU node moves at NVLink's rate, a group across nodes at the network's.
On both production meshes every group spans nodes (the 16-wide model
axis covers two nodes).  The terms are predictions from spec constants
(:data:`~repro_torch.core.hw.H100_SXM`), not measurements.
"""
from __future__ import annotations

from ..core.hw import H100_SXM, GPUChipConfig
from ..models.config import ArchConfig
from .analytic import cell_flops, cell_hbm_floor_bytes


def model_flops(cfg: ArchConfig, shape) -> float:
    """6·N·D (dense) / 6·N_active·D (MoE) canonical model FLOPs."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch  # decode: one token per sequence


def _scan_scale(result: dict, cfg: ArchConfig) -> float:
    """Trip-count multiplier for once-counted while bodies (layer scan);
    1 for the port's graphs, whose counts include every loop's runs."""
    trips = [t for t in result.get("while_trip_counts", []) if t > 1]
    if not trips:
        return 1.0
    reps = max(cfg.n_layers // len(cfg.block_pattern), 1)
    return float(reps) if reps in trips else float(max(trips))


def roofline_report(cfg: ArchConfig, shape, result: dict,
                    chip: GPUChipConfig = H100_SXM) -> dict:
    chips = result["n_chips"]
    model_shards = result["mesh_shape"]["model"]  # 16 on both production meshes
    scale = _scan_scale(result, cfg)

    flops_global = cell_flops(cfg, shape)
    flops_dev = flops_global / chips
    hlo_flops_scaled = result["cost"]["flops_per_device"] * scale

    # memory: analytic HBM traffic model (params/opt/cache/activations);
    # the graph's bytes accessed kept for reference
    bytes_dev = cell_hbm_floor_bytes(cfg, shape, chips, model_shards)
    coll = result["collectives"]
    coll_dev = coll["link_bytes_per_device"]
    span = coll["link_bytes_by_span"]

    t_compute = flops_dev / chip.peak_bf16_flops
    t_memory = bytes_dev / chip.hbm_bandwidth
    t_collective = (span["intra_node"] / chip.nvlink_bandwidth
                    + span["inter_node"] / chip.network_bandwidth)

    terms = {"compute": t_compute, "memory": t_memory, "collective": t_collective}
    dominant = max(terms, key=terms.get)
    bound = max(terms.values())
    mf = model_flops(cfg, shape)

    return {
        "scan_scale_applied": scale,
        "compute_term_s": t_compute,
        "memory_term_s": t_memory,
        "collective_term_s": t_collective,
        "dominant_term": dominant,
        "bound_s": bound,
        "analytic_flops_global": flops_global,
        "hlo_flops_scaled_global": hlo_flops_scaled * chips,
        "model_flops_global": mf,
        "useful_flops_ratio": mf / max(flops_global, 1.0),
        "hbm_bytes_per_device": bytes_dev,
        "collective_link_bytes_per_device": coll_dev,
        # fraction of the compute roofline achieved if the dominant term
        # set the runtime — the score the perf loop pushes up
        "roofline_fraction": t_compute / max(bound, 1e-30),
    }


def format_table(results: list[dict]) -> str:
    rows = []
    hdr = (
        f"{'arch':24s} {'shape':12s} {'mesh':10s} {'compute_s':>11s} "
        f"{'memory_s':>11s} {'collect_s':>11s} {'bound':>10s} "
        f"{'RF':>6s} {'useful':>7s}"
    )
    rows.append(hdr)
    rows.append("-" * len(hdr))
    for r in results:
        if r.get("skipped"):
            rows.append(f"{r['arch']:24s} {r['shape']:12s} SKIP ({r['reason']})")
            continue
        rf = r["roofline"]
        rows.append(
            f"{r['arch']:24s} {r['shape']:12s} {r['mesh']:10s} "
            f"{rf['compute_term_s']:11.5f} {rf['memory_term_s']:11.5f} "
            f"{rf['collective_term_s']:11.5f} {rf['dominant_term']:>10s} "
            f"{rf['roofline_fraction']:6.2f} {rf['useful_flops_ratio']:7.2f}"
        )
    return "\n".join(rows)
