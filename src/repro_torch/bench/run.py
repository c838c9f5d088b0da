"""Benchmark harness entrypoint of the port — one module per paper
table/figure and one per serving lane, the reference harness's names.

    PYTHONPATH=src python -m repro_torch.bench.run [--only fig9,...] [--fast] [--device cpu]

Prints ``name,us_per_call,derived`` CSV rows (assignment format).  The
serving lanes and ``calibrate`` run on ``--device`` (default: the current
CUDA device); the analytic lanes run on the host.
"""
from __future__ import annotations

import argparse
import sys
import time

from . import (
    calibrate_model,
    fig9_runtime,
    fig10_energy,
    fig11_gb_breakdown,
    fig12_pe_allocation,
    fig13_bandwidth,
    hw_codesign,
    mapper_search,
    serve_gnn,
    table3_validation,
    roofline,
)
from .common import emit

MODULES = {
    "fig9": fig9_runtime,
    "fig10": fig10_energy,
    "fig11": fig11_gb_breakdown,
    "fig12": fig12_pe_allocation,
    "fig13": fig13_bandwidth,
    "codesign": hw_codesign,
    "mapper": mapper_search,
    "serve": serve_gnn,
    "serve_chaos": serve_gnn,
    "serve_restart": serve_gnn,
    "serve_async": serve_gnn,
    "serve_giant": serve_gnn,
    "calibrate": calibrate_model,
    "table3": table3_validation,
    "roofline": roofline,
}

FAST_DATASETS = ["mutag", "collab", "citeseer"]
FAST_MAPPER_CASES = ["synth-small", "mutag", "citeseer",
                     mapper_search.MODEL_CASE]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default=None, help="comma-separated subset")
    ap.add_argument("--fast", action="store_true",
                    help="3 representative datasets for fig9/fig10")
    ap.add_argument("--device", default=None,
                    help="torch device of the serving lanes and calibrate "
                         "(default: the current CUDA device)")
    args = ap.parse_args(argv)
    names = args.only.split(",") if args.only else list(MODULES)
    dev = args.device
    print("name,us_per_call,derived")
    failures = []
    for n in names:
        mod = MODULES[n]
        t0 = time.time()
        try:
            if n in ("fig9", "fig10") and args.fast:
                rows = mod.run(FAST_DATASETS)
            elif n == "mapper":
                rows = mod.run(FAST_MAPPER_CASES if args.fast else None,
                               device=dev)
            elif n == "codesign" and args.fast:
                rows = mod.run(fast=True)
            elif n == "serve":
                rows = mod.run(smoke=args.fast, device=dev)
            elif n == "serve_chaos":
                rows = serve_gnn.run_chaos(smoke=args.fast, device=dev)
            elif n == "serve_restart":
                rows = serve_gnn.run_restart(smoke=args.fast, device=dev)
            elif n == "serve_async":
                rows = serve_gnn.run_async(smoke=args.fast, device=dev)
            elif n == "serve_giant":
                rows = serve_gnn.run_giant(smoke=args.fast, device=dev)
            elif n == "calibrate":
                rows = calibrate_model.run(fast=args.fast, device=dev)
            elif n in ("fig12", "fig13") and args.fast:
                # skip the slow scalar-loop baseline (and its speedup guard)
                rows = mod.run(with_baseline=False)
            else:
                rows = mod.run()
        except RuntimeError as e:
            # a lane's guard raises after its evidence landed: report it,
            # run the other lanes, and exit non-zero at the end
            failures.append(f"{n}: {e}")
            print(f"# {n} FAILED: {e}", file=sys.stderr)
            continue
        emit(rows)
        print(f"# {n} done in {time.time()-t0:.1f}s", file=sys.stderr)
    if failures:
        print(f"# {len(failures)} lane(s) failed: " + " | ".join(failures),
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
