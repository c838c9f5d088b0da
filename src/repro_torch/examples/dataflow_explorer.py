"""Design-space exploration: sweep the Table-5 dataflows over every
Table-4 dataset and print the full comparison (the paper's Figs 9-10 as
one table), then package each dataset's winner into a compiled Program
via `repro_torch.compile(..., schedule=...)` — the sweep is reused, not
re-run.  Search and lowering run on the host; each Program is made for
``--device`` and nothing is bound or run on it.

    PYTHONPATH=src python -m repro_torch.examples.dataflow_explorer [--device cpu]
"""
import argparse

import repro_torch
from repro_torch.core import (
    GNNLayerWorkload,
    ModelSchedule,
    TABLE5_NAMES,
    TileStats,
    named_skeleton,
    optimize_tiles,
)
from repro_torch.graphs import TABLE4, load_dataset

G_HIDDEN = 16


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device of the Programs (default: the "
                         "current CUDA device)")
    device = ap.parse_args(argv).device

    print(f"{'dataset':12s} {'cat':4s} | "
          + " ".join(f"{n:>12s}" for n in TABLE5_NAMES))
    programs = {}
    for name in TABLE4:
        g, spec = load_dataset(name)
        wl = GNNLayerWorkload(g.nnz, spec.n_features, G_HIDDEN, name=name)
        ts = TileStats(wl.nnz)  # tile ladder shared by all skeleton searches
        base = None
        cells = []
        best = (None, float("inf"))
        for sk in TABLE5_NAMES:
            try:
                r = optimize_tiles(named_skeleton(sk), wl, objective="cycles",
                                   pe_splits=(0.25, 0.5, 0.75), tile_stats=ts)
                c = r.stats.cycles
                base = base or c
                cells.append(f"{c / base:12.2f}")
                if c < best[1]:
                    best = (r.dataflow, c)
            except Exception:
                cells.append(f"{'—':>12s}")
        # package the sweep's winner into a Program: compile with an
        # explicit schedule skips the search and just prices + lowers it
        schedule = ModelSchedule.from_dataflows(
            [best[0]], [(wl.f_in, wl.g_out)], v=wl.v, names=[name]
        )
        programs[name] = repro_torch.compile([wl], schedule=schedule,
                                             device=device)
        print(f"{name:12s} {spec.category:4s} | " + " ".join(cells))

    print("\ncompiled winners (repro_torch.compile over each sweep's best "
          "dataflow):")
    for name, prog in programs.items():
        layer = prog.schedule.layers[0]
        print(f"  {name:12s} {prog.stats.cycles:12.0f} cycles "
              f"{prog.stats.energy_pj / 1e6:8.1f} uJ  "
              f"{layer.dataflow.to_string()}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
