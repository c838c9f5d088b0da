"""Drive the PyTorch port on one CUDA card, end to end; exit non-zero on
any failure.

    python3 chip_smoke.py

Phases, one JSON line each (no phase's error is caught):

1. build   — compile every CUDA kernel from the sources in the checkout,
             all ``nvcc`` processes started together.
2. kernels — each kernel against its plain PyTorch version on the card at
             the main path's shapes (cora layer 0, a ragged case, bf16),
             with its time, the plain version's, one PyTorch library
             call's where one computes the same function, and the bound.
3. main    — ``repro_torch.compile`` on cora at the paper's Kipf widths
             (1433 -> 16 -> 8): the searched schedule and forced
             (sp_opt, AC), (seq, AC), (seq, CA) schedules, each on the
             kernel tier and against its eager twin on the card.
4. serving — 32 reddit-bin graphs: bucketize -> assemble -> compile per
             bucket -> bind -> batched run with mean readout.  Each batch
             is held against its eager twin, the fused kernel against its
             plain version at the batch's shapes, and every per-graph
             output against a solo run of that graph.

Launch counts are set to 0 just before phases 3 and 4 and read just after;
the ``{"kernels": [...]}`` line reports them.  The last line is
``{"ok": true, "device": {...}}``; it is printed only when every phase
passed.  Weights and data are random, made from fixed seeds.
"""
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

TOL_F32 = {"spmm": dict(rtol=1e-4, atol=1e-5),
           "fused_agg_cmb": dict(rtol=2e-4, atol=2e-4)}
TOL_BF16 = dict(rtol=2e-2, atol=2e-2)
TOL_PATH = dict(rtol=2e-4, atol=2e-4)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
PEAK_OPS = {torch.float32: 67e12, torch.bfloat16: 989e12}  # dense, per s


def check(ok: bool, what: str) -> None:
    """Fail the run (a plain check, kept under ``python -O``)."""
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def emit(record: dict) -> None:
    print(json.dumps(record), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, flush, iters=20, warmup=3) -> float:
    """Median CUDA-event time of one call, L2 flushed before each."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(n_bytes: float, n_ops: float, dtype) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ell_of(g, dev, block_rows=1):
    idx, wts, _ = g.to_ell(block_rows)
    return torch.as_tensor(idx, device=dev), torch.as_tensor(wts, device=dev)


def randn(shape, seed, dev, scale=1.0):
    a = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return torch.as_tensor(a * np.float32(scale), device=dev)


def phase_build(libs) -> None:
    from repro_torch.kernels.common import build_libraries

    seconds = build_libraries(libs)
    ptxas = []
    for lib in libs:
        log = lib.log_path()
        text = log.read_text() if log.exists() else ""
        ptxas += [f"{lib.name}: {ln.strip()}" for ln in text.splitlines()
                  if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": round(seconds, 3),
          "card": card_line(), "ptxas": ptxas})


def phase_kernels(dev, flush) -> dict:
    """Each kernel against its plain version; returns the per-kernel
    numbers at cora layer 0 for the final ``kernels`` line."""
    from repro_torch.graphs import from_edges, load_dataset
    from repro_torch.kernels.fused_agg_cmb import fused_agg_cmb, fused_ref
    from repro_torch.kernels.spmm import spmm, spmm_ref, spmm_streamed

    cora, _ = load_dataset("cora")
    idx, wts = ell_of(cora, dev, block_rows=128)  # the searched schedule's
    v, f, g = cora.n_nodes, 1433, 16
    check(tuple(idx.shape) == (2816, 72), f"cora ELL is {tuple(idx.shape)}")
    x = randn((v, f), 1, dev)
    w = randn((f, g), 2, dev, scale=1.0 / np.sqrt(f))
    nnz = int(torch.count_nonzero(wts))
    csr = torch.sparse_csr_tensor(
        torch.as_tensor(cora.row_ptr.astype(np.int64), device=dev),
        torch.as_tensor(cora.col_idx.astype(np.int64), device=dev),
        torch.as_tensor(cora.values, device=dev), size=(v, v),
    )

    # a ragged case: V_pad not a multiple of any CTA's row count
    rng = np.random.default_rng(5)
    r_idx, r_wts = ell_of(
        from_edges(1001, rng.integers(0, 1001, 4000),
                   rng.integers(0, 1001, 4000)), dev)
    r_x = randn((1001, 333), 6, dev)
    r_w = randn((333, 24), 7, dev, scale=0.05)

    cases = {
        "spmm": [
            ("cora_l0_f32", lambda: spmm(idx, wts, x),
             lambda: spmm_ref(idx, wts, x), TOL_F32["spmm"]),
            ("cora_l0_ca_f32", lambda: spmm(idx, wts, x @ w),
             lambda: spmm_ref(idx, wts, x @ w), TOL_F32["spmm"]),
            ("ragged_1001x333_f32", lambda: spmm(r_idx, r_wts, r_x),
             lambda: spmm_ref(r_idx, r_wts, r_x), TOL_F32["spmm"]),
            ("cora_l0_bf16", lambda: spmm(idx, wts, x.bfloat16()),
             lambda: spmm_ref(idx, wts, x.bfloat16()), TOL_BF16),
        ],
        "fused_agg_cmb": [
            ("cora_l0_f32_block_f512",
             lambda: fused_agg_cmb(idx, wts, x, w, band_size=128, block_f=512),
             lambda: fused_ref(idx, wts, x, w), TOL_F32["fused_agg_cmb"]),
            ("cora_l0_f32_block_fNone",
             lambda: fused_agg_cmb(idx, wts, x, w, band_size=128),
             lambda: fused_ref(idx, wts, x, w), TOL_F32["fused_agg_cmb"]),
            ("ragged_1001x333x24_f32",
             lambda: fused_agg_cmb(r_idx, r_wts, r_x, r_w, band_size=8),
             lambda: fused_ref(r_idx, r_wts, r_x, r_w), TOL_F32["fused_agg_cmb"]),
            ("cora_l0_bf16",
             lambda: fused_agg_cmb(idx, wts, x.bfloat16(), w.bfloat16()),
             lambda: fused_ref(idx, wts, x.bfloat16(), w.bfloat16()), TOL_BF16),
        ],
    }
    errs = {}
    for name, runs in cases.items():
        for case, kern, plain, tol in runs:
            out, ref = kern(), plain()
            torch.cuda.synchronize()
            check(out.shape == ref.shape and out.dtype == ref.dtype, case)
            check(bool(torch.isfinite(out).all()), f"{case}: non-finite output")
            err = float((out.float() - ref.float()).abs().max())
            torch.testing.assert_close(out, ref, **tol)
            emit({"phase": "kernels", "kernel": name, "case": case,
                  "shape": list(out.shape), "dtype": str(out.dtype),
                  "max_abs_err": err, "tol": tol, "ok": True})
            errs.setdefault(name, err)  # the first case is cora layer 0

    streamed = spmm_streamed(idx, wts, x, block_rows=1024)
    check(torch.equal(streamed, spmm(idx, wts, x)), "spmm_streamed differs")
    emit({"phase": "kernels", "kernel": "spmm", "case":
          "spmm_streamed(block_rows=1024) == spmm, cora layer 0",
          "bit_identical": True, "ok": True})

    es = x.element_size()
    sp_bytes = nnz * 8 + v * f * es + idx.shape[0] * f * es
    sp_bound, sp_by = bound_ms(sp_bytes, 2 * nnz * f, x.dtype)
    fu_bytes = nnz * 8 + v * f * es + f * g * es + idx.shape[0] * g * es
    fu_bound, fu_by = bound_ms(fu_bytes, 2 * nnz * f + 2 * v * f * g, x.dtype)
    numbers = {
        "spmm": {
            "ms": time_ms(lambda: spmm(idx, wts, x), flush),
            "plain_ms": time_ms(lambda: spmm_ref(idx, wts, x), flush, iters=5),
            "library_ms": time_ms(lambda: torch.sparse.mm(csr, x), flush),
            "bound_ms": sp_bound, "bound_by": sp_by, "bytes": sp_bytes,
        },
        "fused_agg_cmb": {
            "ms": time_ms(lambda: fused_agg_cmb(idx, wts, x, w, band_size=128,
                                                block_f=512), flush),
            "plain_ms": time_ms(lambda: fused_ref(idx, wts, x, w), flush,
                                iters=5),
            "library_ms": None,  # no single PyTorch call computes (A @ X) @ W
            "bound_ms": fu_bound, "bound_by": fu_by, "bytes": fu_bytes,
        },
    }
    for name, nums in numbers.items():
        nums["max_abs_err"] = errs[name]
        emit({"phase": "kernels", "kernel": name, "case": "cora_l0_timing",
              "nnz": nnz, "v_pad": idx.shape[0], "d": idx.shape[1],
              **nums})
    return numbers


def tiers(prog) -> list:
    from repro_torch.core.registry import lookup_kernel

    out = []
    for s in prog.specs:
        impl = lookup_kernel(s.policy, s.order, s.use_pallas)
        kernel = impl is not lookup_kernel(s.policy, s.order, False)
        out.append({"spec": [s.policy, s.order, s.band_size, s.block_f],
                    "runs": impl.__name__,
                    "tier": "cuda kernel" if kernel else "eager"})
    return out


def reset_counts(counters) -> None:
    for c in counters.values():
        c.launches = 0


def phase_main(dev, counters) -> dict:
    import repro_torch
    from repro_torch.core.schedule import ModelSchedule
    from repro_torch.gnn import GNNConfig
    from repro_torch.graphs import load_dataset

    cora, _ = load_dataset("cora")
    cfg = GNNConfig("gcn", f_in=1433, hidden=16, n_classes=8, use_pallas=True)
    x = randn((cora.n_nodes, cfg.f_in), 10, dev)
    params = None
    launches = {k: 0 for k in counters}
    runs = [("searched", None, "fused_agg_cmb")] + [
        (f"forced {p}/{o}", ModelSchedule.from_policies(p, o, cfg.dims),
         "fused_agg_cmb" if p == "sp_opt" else "spmm")
        for p, o in (("sp_opt", "AC"), ("seq", "AC"), ("seq", "CA"))
    ]
    for label, schedule, expect in runs:
        prog = repro_torch.compile(cfg, graph=cora, schedule=schedule,
                                   device=dev)
        if params is None:
            params = prog.init(torch.Generator().manual_seed(0))
        reset_counts(counters)
        t0 = time.perf_counter()
        out = prog.run(params, x)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        counts = {k: c.launches for k, c in counters.items()}
        check(counts[expect] > 0, f"{label}: {expect} never launched")
        for k in launches:
            launches[k] += counts[k]
        eager = prog.degraded(use_pallas=False).run(params, x)
        check(out.shape == (cora.n_nodes, 8) and bool(torch.isfinite(out).all()),
              f"{label}: bad output")
        torch.testing.assert_close(out, eager, **TOL_PATH)
        emit({"phase": "main", "run": label, "layers": tiers(prog),
              "launches": counts, "first_run_wall_ms": wall_ms,
              "max_abs_err_vs_eager": float((out - eager).abs().max()),
              "ok": True})
    return launches


def phase_serving(dev, counters) -> dict:
    import repro_torch
    from repro_torch.gnn import GNNConfig
    from repro_torch.graphs import TABLE4, BucketPolicy, assemble, bucketize
    from repro_torch.graphs.datasets import make_graph
    from repro_torch.kernels.fused_agg_cmb import fused_agg_cmb, fused_ref

    table = TABLE4["reddit-bin"]
    f_in = table.n_features
    rng = np.random.default_rng(0)
    graphs = [make_graph(table, rng) for _ in range(32)]
    feats = [np.random.default_rng(1000 + i).normal(
        size=(g.n_nodes, f_in)).astype(np.float32)
        for i, g in enumerate(graphs)]
    cfg = GNNConfig("gcn", f_in=f_in, hidden=16, n_classes=8,
                    use_pallas=True)
    policy = BucketPolicy()
    params = None
    served, buckets, outputs, batches = 0, [], {}, []
    reset_counts(counters)
    t0 = time.perf_counter()
    for key, ids in bucketize(graphs, policy).items():
        for s in range(0, len(ids), policy.max_graphs):
            chunk = ids[s:s + policy.max_graphs]
            batch = assemble([graphs[i] for i in chunk], policy)
            prog = repro_torch.compile(cfg, graph=batch.graph, device=dev)
            if params is None:
                params = prog.init(torch.Generator().manual_seed(1))
            bound = prog.bind(batch.graph, pad_degree=batch.d_bucket)
            xb = torch.as_tensor(
                batch.batch_features([feats[i] for i in chunk]), device=dev)
            seg = torch.as_tensor(batch.segment_ids, device=dev)
            out = bound.run(params, xb, segment_ids=seg,
                            num_segments=batch.slots, readout="mean")
            for i, row in zip(chunk, out[: batch.n_graphs]):
                outputs[i] = (row, bound)
            served += batch.n_graphs
            batches.append((key, bound, xb, seg, batch.slots, out))
            buckets.append({"bucket": list(key), "graphs": batch.n_graphs,
                            "slots": batch.slots, "layers": tiers(prog)})
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = {k: c.launches for k, c in counters.items()}
    check(launches["fused_agg_cmb"] > 0 or launches["spmm"] > 0,
          f"serving launched no kernel: {launches}")

    # each batched forward against its eager twin on the same batch, and
    # the fused kernel against its plain version at the batch's shapes
    # (the plain version in row chunks: its (rows, D, F) gather of a whole
    # batch would not fit in device memory)
    worst_eager, worst_plain = 0.0, 0.0
    for key, bound, xb, seg, slots, out in batches:
        eager = bound.degraded(use_pallas=False).run(
            params, xb, segment_ids=seg, num_segments=slots, readout="mean")
        torch.testing.assert_close(out, eager, **TOL_PATH)
        worst_eager = max(worst_eager, float((out - eager).abs().max()))
        spec, adj, w = bound.specs[0], bound.adj, params[0]["w"]
        if (spec.policy, spec.order, spec.use_pallas) != ("sp_opt", "AC", True):
            continue  # layer 0 of this batch runs no fused kernel
        kern = fused_agg_cmb(adj.indices, adj.weights, xb, w,
                             band_size=spec.band_size, block_f=spec.block_f)
        rows = 512
        plain = torch.cat([
            fused_ref(adj.indices[r:r + rows], adj.weights[r:r + rows], xb, w)
            for r in range(0, adj.v_pad, rows)])
        torch.testing.assert_close(kern, plain, **TOL_F32["fused_agg_cmb"])
        err = float((kern - plain).abs().max())
        worst_plain = max(worst_plain, err)
        emit({"phase": "serving", "kernel": "fused_agg_cmb",
              "case": f"bucket {list(key)} layer 0",
              "shape": [*adj.indices.shape, xb.shape[1], w.shape[1]],
              "band_size": spec.band_size, "block_f": spec.block_f,
              "max_abs_err": err, "tol": TOL_F32["fused_agg_cmb"], "ok": True})

    worst = 0.0
    for i, (row, bound) in outputs.items():
        solo = bound.bind(graphs[i]).run(params, feats[i]).mean(dim=0)
        check(row.shape == (8,) and bool(torch.isfinite(row).all()),
              f"graph {i}: bad output")
        torch.testing.assert_close(row, solo, **TOL_PATH)
        worst = max(worst, float((row - solo).abs().max()))
    check(served == len(graphs), f"served {served} of {len(graphs)}")
    emit({"phase": "serving", "dataset": "reddit-bin", "f_in": f_in,
          "n_buckets": len(buckets), "graphs_served": served,
          "wall_s": wall_s, "launches": launches, "buckets": buckets,
          "max_abs_err_vs_solo": worst,
          "max_abs_err_vs_eager": worst_eager,
          "max_abs_err_fused_vs_plain": worst_plain, "ok": True})
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke: no checkout of the port at {src}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    import repro_torch  # noqa: F401
    from repro_torch.kernels.fused_agg_cmb import ops as fused_ops
    from repro_torch.kernels.spmm import ops as spmm_ops

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    phase_build([spmm_ops.LIBRARY, fused_ops.LIBRARY])

    counters = {"spmm": spmm_ops.spmm, "fused_agg_cmb": fused_ops.fused_agg_cmb}
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)
    numbers = phase_kernels(dev, flush)
    launches = phase_main(dev, counters)
    for k, n in phase_serving(dev, counters).items():
        launches[k] += n
    for k, n in launches.items():
        check(n > 0, f"{k} was never launched on the main path")

    meta = {
        "spmm": ("cuda", "src/repro_torch/kernels/spmm/spmm.cu",
                 "src/repro/kernels/spmm/kernel.py:39"),
        "fused_agg_cmb": ("cuda",
                          "src/repro_torch/kernels/fused_agg_cmb/fused_agg_cmb.cu",
                          "src/repro/kernels/fused_agg_cmb/kernel.py:46"),
    }
    kernels = []
    for name, (route, source, replaces) in meta.items():
        nums = numbers[name]
        kernels.append({
            "name": name, "route": route, "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": nums["max_abs_err"], "ms": nums["ms"],
            "plain_ms": nums["plain_ms"], "bound_ms": nums["bound_ms"],
            "bound_by": nums["bound_by"], "library_ms": nums["library_ms"],
            "ok": True,
        })
    emit({"kernels": kernels})
    print(card_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
