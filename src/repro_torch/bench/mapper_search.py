"""Mapper search latency: `search_dataflows` over synthetic Poisson graphs
(small/medium/large) plus the Table 4 datasets.

This is the regression guard for the batched, cache-backed search engine:
the `large` case (50k vertices, Poisson(8) degrees, f_in=128, g_out=16)
must stay <= 2.5s with the batch engine (the reference package recorded
~52s a sweep for the scalar per-candidate loop on its own host).  Pass ``--with-baseline`` to also time the scalar
reference engine and report the measured speedup (slow: re-runs the legacy
O(V)-per-candidate path).

The ``synth-model-3layer`` case times the compiler front-end
(`repro_torch.compile`: per-layer top-k candidates + DP over inter-layer
transition costs, lowered and packaged into a Program) on a 3-layer,
50k-vertex Kipf-style chain, asserts the heterogeneous result never loses
to the homogeneous shared-dataflow baseline, guards its wall clock, and
emits ``experiments/benchmarks_torch/search_model.json``.  The search
and the lowering run on the host; the Program is made for ``device``
(the CUDA device unless ``--device`` names another) and nothing is bound
or run on it.

    PYTHONPATH=src python -m repro_torch.bench.mapper_search [--with-baseline] [--device cpu]
"""
from __future__ import annotations

import numpy as np

import repro_torch
from repro_torch.core import GNNLayerWorkload, TABLE5_NAMES, TileStats, named_skeleton
from repro_torch.core.mapper import optimize_tiles, search_dataflows

from .common import emit, save_json, timed, workloads

#: v, mean degree, f_in, g_out for the synthetic Poisson cases.
SYNTH_CASES = {
    "synth-small": (5_000, 8, 128, 16),
    "synth-medium": (20_000, 8, 128, 16),
    "synth-large": (50_000, 8, 128, 16),
}

#: Threshold (us) the large synthetic sweep must stay under (>= 20x the
#: reference package's recorded ~52.6s scalar baseline).
LARGE_BUDGET_US = 2.5e6

#: Wall-clock guard for the 3-layer model-level search (DP over per-layer
#: top-k candidates + homogeneous baseline, one shared TileStats ladder).
MODEL_CASE = "synth-model-3layer"
MODEL_WIDTHS = (128, 16, 16, 8)  # Kipf-style 3-layer feature chain
MODEL_BUDGET_US = 10e6

PE_SPLITS = (0.25, 0.5, 0.75)


def synth_workload(name: str) -> GNNLayerWorkload:
    v, deg, f_in, g_out = SYNTH_CASES[name]
    rng = np.random.default_rng(0)
    nnz = np.maximum(1, rng.poisson(deg, size=v))
    return GNNLayerWorkload(nnz, f_in, g_out, name=name)


def model_workloads(v: int = 50_000, deg: int = 8) -> list[GNNLayerWorkload]:
    """The 3-layer, 50k-vertex model-search case (one shared graph)."""
    rng = np.random.default_rng(0)
    nnz = np.maximum(1, rng.poisson(deg, size=v))
    return [
        GNNLayerWorkload(nnz, MODEL_WIDTHS[i], MODEL_WIDTHS[i + 1],
                         name=f"layer{i}")
        for i in range(len(MODEL_WIDTHS) - 1)
    ]


def run_model_case(device=None) -> tuple[list[tuple[str, float, str]], dict, list[str]]:
    """Time `repro_torch.compile` (heterogeneous DP + homogeneous baseline, both
    from one sweep, packaged into a Program) on the 3-layer 50k-vertex
    workload; emit evidence JSON + regression guard."""
    wls = model_workloads()
    prog, het_us = timed(repro_torch.compile, wls, objective="cycles",
                         device=device)
    het = prog.schedule
    homo = het.shared_baseline
    entry = {
        "v": wls[0].v,
        "widths": list(MODEL_WIDTHS),
        "het_us": het_us,
        "het_cycles": het.stats.cycles,
        "homo_cycles": homo.stats.cycles,
        "het_energy_pj": het.stats.energy_pj,
        "homo_energy_pj": homo.stats.energy_pj,
        "transition_cycles": het.stats.transition_cycles,
        "relayouts": het.stats.n_relayouts,
        "heterogeneous": het.is_heterogeneous,
        "dataflows": [df.to_string() for df in het.dataflows],
        "shared_dataflow": homo.dataflows[0].to_string(),
        "budget_us": MODEL_BUDGET_US,
    }
    gain = homo.stats.cycles / max(het.stats.cycles, 1e-9)
    rows = [
        (
            f"mapper/{MODEL_CASE}",
            het_us,
            f"v={wls[0].v};layers=3;het_cycles={het.stats.cycles:.0f};"
            f"homo_cycles={homo.stats.cycles:.0f};gain={gain:.3f}x",
        ),
        (
            f"mapper/{MODEL_CASE}/budget",
            het_us,
            f"budget_us={MODEL_BUDGET_US:.0f};ok={het_us <= MODEL_BUDGET_US}",
        ),
    ]
    # guard failures are reported to the caller so evidence JSON is saved
    # before anything raises
    errors = []
    if het.stats.cycles > homo.stats.cycles * (1 + 1e-9):
        errors.append(
            f"model search regression: heterogeneous {het.stats.cycles:.0f} "
            f"cycles > homogeneous {homo.stats.cycles:.0f}"
        )
    if het_us > MODEL_BUDGET_US:
        errors.append(
            f"model search regression: {het_us:.0f}us > {MODEL_BUDGET_US:.0f}us"
        )
    return rows, entry, errors


def _scalar_sweep(wl: GNNLayerWorkload) -> None:
    """The pre-batch search: one scalar simulate() per candidate."""
    for sk in TABLE5_NAMES:
        try:
            optimize_tiles(
                named_skeleton(sk), wl, objective="edp", pe_splits=PE_SPLITS,
                engine="scalar",
            )
        except (RuntimeError, ValueError):
            continue


def run(cases: list[str] | None = None, with_baseline: bool = False, device=None):
    rows, table = [], {}
    run_model = cases is None or MODEL_CASE in cases
    if cases is None:
        synth_names = list(SYNTH_CASES)
        dataset_names = None  # all of Table 4
    else:
        cases = [c for c in cases if c != MODEL_CASE]
        synth_names = [c for c in cases if c in SYNTH_CASES]
        dataset_names = [c for c in cases if c not in SYNTH_CASES]

    wls = [(n, synth_workload(n)) for n in synth_names]
    if dataset_names is None or dataset_names:
        wls += [(n, wl) for n, _, wl in workloads(dataset_names)]

    for name, wl in wls:
        res, us = timed(search_dataflows, wl, objective="edp", pe_splits=PE_SPLITS)
        best = res[0]
        entry = {
            "v": wl.v,
            "e": wl.e,
            "batch_us": us,
            "results": len(res),
            "best": best.skeleton,
            "best_cycles": best.stats.cycles,
        }
        derived = f"v={wl.v};best={best.skeleton};cycles={best.stats.cycles:.0f}"
        if with_baseline:
            _, base_us = timed(_scalar_sweep, wl)
            entry["scalar_us"] = base_us
            entry["speedup"] = base_us / us
            derived += f";speedup={base_us / us:.1f}x"
        table[name] = entry
        rows.append((f"mapper/{name}", us, derived))
        if name == "synth-large":
            ok = us <= LARGE_BUDGET_US
            rows.append(
                (f"mapper/{name}/budget", us,
                 f"budget_us={LARGE_BUDGET_US:.0f};ok={ok}")
            )
    model_errors: list[str] = []
    if run_model:
        model_rows, model_entry, model_errors = run_model_case(device)
        rows.extend(model_rows)
        save_json("search_model", model_entry)
    if cases is None:
        # only a full sweep refreshes the committed evidence — a partial
        # (--fast / --only) run would silently truncate it
        save_json("mapper_search", table)
    slow = table.get("synth-large", {}).get("batch_us", 0.0)
    if slow > LARGE_BUDGET_US:
        raise RuntimeError(
            f"mapper search regression: {slow:.0f}us > {LARGE_BUDGET_US:.0f}us"
        )
    if model_errors:
        raise RuntimeError("; ".join(model_errors))
    return rows


def main(argv: list[str] | None = None):
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--with-baseline", action="store_true",
                    help="also time the scalar reference engine (slow)")
    ap.add_argument("--only", default=None,
                    help="comma-separated case subset (synth-* or dataset names)")
    ap.add_argument("--device", default=None,
                    help="torch device of the model case's Program "
                         "(default: the current CUDA device)")
    args = ap.parse_args(argv)
    cases = args.only.split(",") if args.only else None
    emit(run(cases, with_baseline=args.with_baseline, device=args.device))


if __name__ == "__main__":
    main()
