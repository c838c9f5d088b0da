"""Paper Fig. 13: runtime vs Global-Buffer bandwidth, tiles FIXED at the
bw=512 optimum — PP suffers most because both phases share the bandwidth.

Rebuilt on the batched hardware axis: the whole (dataflow x bandwidth) grid
is priced by ONE `simulate_batch(HWGrid)` call per dataset (1e-6 oracle
parity with the scalar path is pinned by tests/test_codesign.py), on a
bandwidth axis denser than the paper's four points.  The legacy per-point
loop (one scalar `simulate` per flow per bandwidth) is timed alongside and
must be beaten by >= SPEEDUP_FLOOR x — the guard raises *after* the
evidence JSON is saved.
"""
from __future__ import annotations

from repro_torch.core import (
    AcceleratorConfig,
    HWGrid,
    TileStats,
    named_skeleton,
    optimize_tiles,
    simulate,
    simulate_batch,
)

from .common import check_speedup, emit, save_json, speedup_entry, timed, workloads

FLOWS = ("Seq-Nt", "Seq-Ns", "SP-FsNt-Fs", "PP-Nt-Vt/sl", "PP-Nt-Vsh")
#: Dense sweep (the batch call's cost is nearly flat in grid size, the
#: legacy loop's is linear); the paper's canonical 512/256/128/64 points
#: are a subset.
BANDWIDTHS = tuple(range(512, 24, -8))  # 512, 504, ..., 40, 32
SPEEDUP_FLOOR = 10.0


def _scalar_loop(dfs, wl):
    """The pre-batch sweep: one scalar simulate per (flow, bandwidth)."""
    for df in dfs:
        for bw in BANDWIDTHS:
            simulate(df, wl, AcceleratorConfig(gb_bandwidth=bw))


def run(with_baseline: bool = True):
    rows, table, errors = [], {}, []
    grid = HWGrid(gb_bandwidth=BANDWIDTHS)
    for name, spec, wl in workloads(["citeseer", "collab"]):
        ts = TileStats(wl.nnz)
        chosen = [
            optimize_tiles(
                named_skeleton(sk), wl, AcceleratorConfig(gb_bandwidth=512),
                objective="cycles", pe_splits=(0.5,), tile_stats=ts,
            )
            for sk in FLOWS
        ]
        dfs = [r.dataflow for r in chosen]
        batch, us = timed(simulate_batch, dfs, wl, grid, tile_stats=ts)
        table[name] = {"series": {}}
        for i, sk in enumerate(FLOWS):
            ref = batch.cycles[i, 0]  # bw = 512
            series = {bw: batch.cycles[i, j] / ref
                      for j, bw in enumerate(BANDWIDTHS)}
            table[name]["series"][sk] = series
            rows.append((f"fig13/{name}/{sk}", us / len(FLOWS),
                         f"slowdown@64={series[64]:.2f}x"))
        if with_baseline:
            _, base_us = timed(_scalar_loop, dfs, wl)
            table[name].update(
                speedup_entry(us, base_us, len(FLOWS) * len(BANDWIDTHS))
            )
            speedup = table[name]["speedup"]
            rows.append((f"fig13/{name}/speedup", us,
                         f"scalar_us={base_us:.0f};speedup={speedup:.1f}x"))
            errors += check_speedup("fig13", name, speedup, SPEEDUP_FLOOR)
    if with_baseline:
        # only a full (baseline-measured) run refreshes the committed
        # evidence — a --fast run would silently drop the speedup fields
        save_json("fig13_bandwidth", table)
    if errors:
        raise RuntimeError("; ".join(errors))
    return rows


def main():
    emit(run())


if __name__ == "__main__":
    main()
