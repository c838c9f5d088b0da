"""Paper Fig. 12: PP runtimes under 25-75 / 50-50 / 75-25 PE allocations
(load balancing across the aggregation/combination engines).

Rebuilt on the batched allocation axis: `sweep_pe_splits` prices the whole
(tiling x split) grid in one vectorized pass per dataset, against the
legacy per-point loop (one scalar-engine `optimize_tiles` per allocation)
it must beat by >= SPEEDUP_FLOOR x — the wall-clock guard raises *after*
the evidence JSON is saved.
"""
from __future__ import annotations

from repro_torch.core import TileStats, named_skeleton, optimize_tiles, sweep_pe_splits

from .common import check_speedup, emit, save_json, speedup_entry, timed, workloads

DATASETS = ["collab", "mutag", "citeseer"]
SKELETON = "PP-Nt-Vt/sl"
SPLITS = (0.25, 0.5, 0.75)
SPEEDUP_FLOOR = 10.0


def _scalar_loop(wl):
    """The pre-batch sweep: one full scalar-engine search per allocation."""
    for split in SPLITS:
        optimize_tiles(
            named_skeleton(SKELETON), wl, objective="cycles",
            pe_splits=(split,), engine="scalar",
        )


def run(with_baseline: bool = True):
    rows, table, errors = [], {}, []
    for name, spec, wl in workloads(DATASETS):
        ts = TileStats(wl.nnz)
        per_split, us = timed(
            sweep_pe_splits, named_skeleton(SKELETON), wl,
            objective="cycles", pe_splits=SPLITS, tile_stats=ts,
        )
        entry = {}
        for split in SPLITS:
            alloc = f"{int(split * 100)}-{100 - int(split * 100)}"
            if split not in per_split:  # sweep omits infeasible splits
                raise RuntimeError(
                    f"fig12/{name}: no legal tiling for the {alloc} allocation"
                )
            cyc = per_split[split].stats.cycles
            entry[alloc] = cyc
            rows.append((f"fig12/{name}/{alloc}", us / len(SPLITS),
                         f"cycles={cyc:.0f}"))
        best = min(entry, key=entry.get)
        rows.append((f"fig12/{name}/best_alloc", 0.0, best))
        table[name] = {"cycles": entry, "best_alloc": best}
        if with_baseline:
            _, base_us = timed(_scalar_loop, wl)
            table[name].update(speedup_entry(us, base_us, len(SPLITS)))
            speedup = table[name]["speedup"]
            rows.append((f"fig12/{name}/speedup", us,
                         f"scalar_us={base_us:.0f};speedup={speedup:.1f}x"))
            errors += check_speedup("fig12", name, speedup, SPEEDUP_FLOOR)
    if with_baseline:
        # only a full (baseline-measured) run refreshes the committed
        # evidence — a --fast run would silently drop the speedup fields
        save_json("fig12_pe_allocation", table)
    if errors:
        raise RuntimeError("; ".join(errors))
    return rows


def main():
    emit(run())


if __name__ == "__main__":
    main()
