"""Paper Fig. 9: runtimes of the Table-5 dataflows, normalized to Seq-Nt,
across the Table-4 datasets (GCN layer, mapper-chosen tile sizes)."""
from __future__ import annotations

from .common import emit, save_json, skeleton_sweep, workloads


def run(datasets=None):
    rows, table = [], {}
    for name, spec, wl in workloads(datasets):
        base = None
        table[name] = {}
        for sk, res, us in skeleton_sweep(wl):
            cyc = res.stats.cycles
            base = base or cyc
            table[name][sk] = {
                "cycles": cyc,
                "norm_to_seq_nt": cyc / base,
                "mapping": str(res.dataflow),
            }
            rows.append(
                (f"fig9/{name}/{sk}", us, f"norm={cyc / base:.3f}")
            )
        best = min(table[name], key=lambda k: table[name][k]["cycles"])
        rows.append((f"fig9/{name}/best", 0.0, best))
    save_json("fig9_runtime", table)
    return rows


def main():
    emit(run())


if __name__ == "__main__":
    main()
