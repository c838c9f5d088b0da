"""Calibrated cost model: fit error + measured re-ranking evidence.

    PYTHONPATH=src python -m repro_torch.bench.calibrate_model [--fast] [--device cpu]

Closes the predicted<->measured loop end to end and commits the evidence:

1. **Fit** — :func:`repro_torch.core.calibrate.calibrate` measures the
   kernel grid (policy x phase order x graph size) on ``--device`` (the
   CUDA device unless another is named), on the kernel tier (the
   hand-written kernels on the card), least-squares fits a
   :class:`~repro_torch.core.hw.LatencyModel` (per-family overheads,
   effective bandwidth, per-dispatch setup) and reports per-point
   relative error.  The fitted model is persisted beside a
   :class:`~repro_torch.runtime.ProgramStore` keyed by
   :func:`~repro_torch.core.calibrate.backend_fingerprint`.
2. **Serve** — an :class:`~repro_torch.runtime.InferenceEngine` on that
   store (it auto-loads the fitted model) serves a seeded request stream
   to a warm state, measures the warm wall
   (:func:`~repro_torch.kernels.common.measure_wall`, which synchronizes
   the card after each call), runs
   :meth:`~repro_torch.runtime.InferenceEngine.rerank_topk` and measures
   the warm wall again on the identical stream — with a
   ``repro_torch.trace_count()`` delta of **zero** on the post-rerank
   request path (the swap is build-cached, never on the request path).

Full runs commit ``experiments/benchmarks_torch/calibrate_model.json`` and
guard (a) fit median relative error <= ``ERROR_CEIL`` and (b) the
re-ranked warm wall never slower than the analytic-best warm wall beyond
timer noise (``NEVER_SLOWER_CEIL``); ``--fast`` shrinks the grid and the
stream and re-checks the error guard against the ceiling committed in
``experiments/benchmarks_torch/calibrate_model.json`` without rewriting
it.  Evidence is saved before any guard raises, so a regression still
leaves the JSON behind.
"""
from __future__ import annotations

import sys
import tempfile
import time

import repro_torch
from repro_torch.core.calibrate import backend_fingerprint, calibrate
from repro_torch.device import resolve_device
from repro_torch.kernels.common import measure_wall
from repro_torch.runtime import InferenceEngine, ProgramStore

from . import common
from .common import emit, kernel_launches, launches_since, save_json
from .serve_gnn import DIMS, USE_KERNELS, init_params, make_stream

#: calibrated model must land within 25% median relative error on its own
#: grid (committed in the evidence JSON; the fast lane re-checks against
#: the committed value).
ERROR_CEIL = 0.25
#: re-ranking must never make warm serving slower; 10% headroom absorbs
#: scheduler noise (rerank itself only swaps on a measured >= 3% win, so
#: the true floor is "no change or better").
NEVER_SLOWER_CEIL = 1.10
N_FULL = 1000
N_FAST = 64
SEED = 0


def _committed_error_ceil() -> float:
    """The committed evidence's error ceiling (regression guard for the
    fast lane), or the default when no evidence is committed yet."""
    import json

    path = common.OUT_DIR / "calibrate_model.json"
    try:
        return float(json.loads(path.read_text())["guards"]["error_ceil"])
    except Exception:
        return ERROR_CEIL


def run(fast: bool = False, device=None) -> list[tuple[str, float, str]]:
    dev = resolve_device(device)
    rows: list[tuple[str, float, str]] = []
    failures: list[str] = []
    backend = backend_fingerprint(dev)
    launches0 = kernel_launches()

    with tempfile.TemporaryDirectory() as tmp:
        store = ProgramStore(tmp)

        # -- part 1: calibration fit -----------------------------------------
        t0 = time.perf_counter()
        report = calibrate(fast=fast, store=store, seed=SEED,
                           use_pallas=USE_KERNELS, device=dev)
        fit_wall = time.perf_counter() - t0
        rows.append((
            "calibrate_fit",
            fit_wall * 1e6,
            f"err_med={report.error_median:.3f}"
            f"_max={report.error_max:.3f}_n={report.n_points}"
            f"_bw={report.bw_mult:g}x",
        ))
        for fam, d in sorted(report.per_family.items()):
            rows.append((
                f"calibrate_{fam}",
                0.0,
                f"overhead={d['overhead']:.2f}_err={d['error_median']:.3f}",
            ))
        err_ceil = _committed_error_ceil() if fast else ERROR_CEIL
        if report.error_median > err_ceil:
            failures.append(
                f"calibration fit error regressed: median relative error "
                f"{report.error_median:.3f} > ceiling {err_ceil:.3f} "
                f"on {backend}"
            )

        # -- part 2: measured re-ranking on a warm stream --------------------
        n = N_FAST if fast else N_FULL
        stream = make_stream(n, seed=SEED)
        # the engine auto-loads the fitted model from the store (keyed by
        # the backend fingerprint calibrate() just wrote)
        engine = InferenceEngine(DIMS, store=store, use_pallas=USE_KERNELS,
                                 device=dev)
        init_params(engine, SEED)
        if not engine.hw.latency.calibrated:
            raise RuntimeError(
                "engine did not auto-load the fitted LatencyModel from the store"
            )
        top = engine.ladder[0].name

        def warm_pass():
            res = engine.submit(stream)
            bad = [(r.rid, r.status, r.tier, r.error) for r in res
                   if not (r.ok and r.tier == top)]
            if bad:
                raise RuntimeError(f"calibrate: served below {top}: {bad[:5]}")
            return res

        warm_pass()  # cold pass: searches + builds happen here
        wall_before = measure_wall(warm_pass, warmup=1, iters=3, reduce="min")

        rerank = engine.rerank_topk(iters=3 if fast else 5)

        traces0 = repro_torch.trace_count()
        warm_pass()  # post-rerank request path must build nothing
        trace_delta = repro_torch.trace_count() - traces0
        wall_after = measure_wall(warm_pass, warmup=0, iters=3, reduce="min")

        if trace_delta != 0:
            failures.append(
                f"re-ranking leaked {trace_delta} executable builds onto the "
                f"request path (must be 0: swaps are build-cached)"
            )
        if engine.stats().n_downgrades:
            failures.append(
                f"{engine.stats().n_downgrades} micro-batches served below "
                f"the top tier"
            )
        # the wall guard needs the full stream to rise above scheduler
        # noise (the fast lane's short walls jitter more than 10%)
        slower = wall_after > wall_before * NEVER_SLOWER_CEIL
        if not fast and slower:
            failures.append(
                f"re-ranked warm wall {wall_after:.3f}s slower than "
                f"analytic-best {wall_before:.3f}s "
                f"(ceiling {NEVER_SLOWER_CEIL}x)"
            )
        gps_before = n / wall_before
        gps_after = n / wall_after
        rows.append((
            "rerank_warm_before",
            wall_before * 1e6,
            f"gps={gps_before:.0f}",
        ))
        rows.append((
            "rerank_warm_after",
            wall_after * 1e6,
            f"gps={gps_after:.0f}_swapped={rerank.n_swapped}"
            f"_traces={trace_delta}",
        ))

        if not fast:
            save_json("calibrate_model", {
                "backend": backend,
                "lane_device": str(dev),
                "use_pallas": USE_KERNELS,
                "fit": report.to_dict(),
                "fit_wall_s": fit_wall,
                "guards": {
                    "error_ceil": ERROR_CEIL,
                    "never_slower_ceil": NEVER_SLOWER_CEIL,
                },
                "met": {
                    "error_ceil": report.error_median <= ERROR_CEIL,
                    "never_slower_ceil": not slower,
                },
                "serving": {
                    "n_requests": n,
                    "warm_wall_before_s": wall_before,
                    "warm_wall_after_s": wall_after,
                    "warm_gps_before": gps_before,
                    "warm_gps_after": gps_after,
                    "request_path_traces_after_rerank": trace_delta,
                    "rerank": rerank.as_dict(),
                },
                "launches": launches_since(launches0),
            })
    if failures:
        raise RuntimeError("; ".join(failures))
    return rows


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true",
                    help="small grid and stream, no evidence JSON")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device)")
    args = ap.parse_args(argv)
    print("name,us_per_call,derived")
    emit(run(fast=args.fast, device=args.device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
