"""Paper Fig. 10: on-chip buffer access energy (GB vs RF breakdown) of the
Table-5 dataflows across datasets (same runtime-optimal mappings as Fig 9)."""
from __future__ import annotations

from .common import emit, save_json, skeleton_sweep, workloads


def run(datasets=None):
    rows, table = [], {}
    for name, spec, wl in workloads(datasets):
        base = None
        table[name] = {}
        for sk, res, us in skeleton_sweep(wl):
            s = res.stats
            base = base or s.energy_pj
            gb = sum(v for k, v in s.energy_breakdown.items() if k.startswith("gb"))
            table[name][sk] = {
                "energy_pj": s.energy_pj,
                "gb_pj": gb,
                "rf_pj": s.energy_breakdown.get("rf", 0.0),
                "norm": s.energy_pj / base,
            }
            rows.append((f"fig10/{name}/{sk}", us,
                         f"uJ={s.energy_pj/1e6:.2f};gb_frac={gb/s.energy_pj:.2f}"))
    save_json("fig10_energy", table)
    return rows


def main():
    emit(run())


if __name__ == "__main__":
    main()
