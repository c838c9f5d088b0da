"""Paper Fig. 11: Global Buffer access breakdown by operand (Adj/Inp/Int/
Wt/Op/Psum) for Mutag (LEF) and Citeseer (HF)."""
from __future__ import annotations

from .common import emit, save_json, skeleton_sweep, workloads


def run():
    rows, table = [], {}
    for name, spec, wl in workloads(["mutag", "citeseer"]):
        table[name] = {}
        for sk, res, us in skeleton_sweep(wl):
            acc = res.stats.gb_accesses
            table[name][sk] = acc
            top = max(acc, key=acc.get)
            rows.append((f"fig11/{name}/{sk}", us, f"dominant={top}"))
    save_json("fig11_gb_breakdown", table)
    return rows


def main():
    emit(run())


if __name__ == "__main__":
    main()
