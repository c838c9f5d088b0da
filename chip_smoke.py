"""Drive the PyTorch port on one CUDA card, end to end; exit non-zero on
any failure.

    python3 chip_smoke.py

Phases, one JSON line each (no phase's error is caught):

1. build      — compile every CUDA kernel from the sources in the checkout,
                all ``nvcc`` processes started together; per kernel
                instantiation, ptxas's register and spill lines and the
                count of HGMMA (wgmma) and UTMALDG (TMA load) instructions
                in its SASS (a tensor-core instantiation without both
                fails the run).
2. kernels    — each kernel against its plain PyTorch version on the card
                at the main paths' shapes, with its time, the plain
                version's, one PyTorch library call's where one computes
                the same function, and the bound: the GNN kernels at cora
                layer 0, at cora re-padded to D = 512 (the time ratio:
                only real slots are work), and at the layer-0 shapes of the
                serving phase's reddit-bin (512, 256) bucket (beside
                ``torch.sparse.mm``; the fused kernel also beside the
                two-call pair ``torch.sparse.mm(csr, x) @ w``,
                ``library_pair_ms``); flash attention at the reference's test shapes,
                smollm-135m prefill (f32, bf16), a ragged S and D = 128;
                ``gemm`` under each dataflow at the reference's test shapes,
                cora's layer-0 combination, smollm's ``w_gate``, a bf16
                shape TMA refuses and one past a resident slab.  A kernel
                and its library call are timed in alternation, L2 flushed
                before each: as direct calls (``ms``, ``library_ms``) and
                as CUDA-graph replays (``graph_ms``, ``library_graph_ms``).
3. main       — ``repro_torch.compile`` on cora at the paper's Kipf widths
                (1433 -> 16 -> 8): the searched schedule and forced
                (sp_opt, AC), (seq, AC), (seq, CA) schedules, each on the
                kernel tier and against its eager twin on the card.
4. serving    — 32 reddit-bin graphs: bucketize -> assemble -> compile per
                bucket -> bind -> batched run with mean readout.  Each batch
                is held against its eager twin, the fused kernel against its
                plain version at the batch's shapes, and every per-graph
                output against a solo run of that graph.
5. gemm       — the dataflow GEMM's own entry point, the public op
                ``gemm``, called once per dataflow on cora's layer-0
                combination (no model path of the reference calls it).
6. lm_serve   — ``repro_torch.launch.serve.generate`` on smollm-135m at full
                width (batch 4, 1024-token prompts, 32 greedy tokens), with
                the prefill logits held against the plain-version twin in
                f32 and in bf16, then a depth-2 forward of the other dense
                archs at full width against their twins.

Launch counts are set to 0 just before phases 3-6 and read just after;
the ``{"kernels": [...]}`` line reports them.  The last line is
``{"ok": true, "device": {...}}``; it is printed only when every phase
passed.  Weights and data are random, made from fixed seeds.
"""
import json
import re
import shutil
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
TOL_FLASH = dict(rtol=2e-4, atol=2e-5)  # tests/test_kernels.py's f32 tolerance
TOL_GEMM = dict(rtol=1e-4, atol=1e-4)
# f32 prefill logits, kernel route against the plain versions: 30 layers of
# f32 online softmax summed in another order (64-key blocks, not 512)
TOL_LM_F32 = dict(rtol=1e-3, atol=1e-3)
# bf16 prefill logits against the plain twin, as a relative L2 error: the
# two attention outputs differ by at most about one bf16 rounding (2^-8) in
# some elements, and that difference is carried through 30 bf16 layers
LM_BF16_REL_L2 = 3e-2
# bf16 flash on the tensor cores against the f32 plain version on the same
# bf16 inputs, as the largest relative L2 error of one output row: the
# output's bf16 rounding and P's give ~2e-3-6e-3; a key block dropped or
# counted twice moves a late row by far more.  Held beside TOL_BF16.
FLASH_ROW_REL_L2 = 1e-2
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
    return time_pair(fn, None, flush, iters, warmup)[0]


def graphed(fn):
    """``fn`` captured into a CUDA graph after eager warm-up calls; returns
    its replay.  A replay times the device work of the call without the
    host's Python and launch cost."""
    fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return graph.replay


def time_pair(kernel, library, flush, iters=20, warmup=3) -> tuple[float, float | None]:
    """Median CUDA-event times of a kernel and of its library call (None:
    there is none), timed in alternation in one loop, L2 flushed before
    each call, so both see the same card state."""
    fns = [kernel] + ([library] if library is not None else [])
    for fn in fns:
        for _ in range(warmup):
            fn()
    times = [[] for _ in fns]
    for _ in range(iters):
        for fn, ts in zip(fns, times):
            flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            ts.append(start.elapsed_time(end))
    meds = [statistics.median(ts) for ts in times]
    return meds[0], (meds[1] if library is not None else None)


def timed(kernel, library, plain, flush) -> dict:
    """The kernel's and its library call's times, the two in alternation:
    as direct calls (``ms``, ``library_ms``: events around the call, the
    wrapper's host cost included, as every PR has timed them) and as
    CUDA-graph replays (``graph_ms``, ``library_graph_ms``: device work
    only); the replays' ratio ``kernel_over_library``; and the plain
    version's time."""
    ms, lib_ms = time_pair(kernel, library, flush)
    g_ms, g_lib = time_pair(graphed(kernel),
                            graphed(library) if library is not None else None, flush)
    return {"ms": ms, "library_ms": lib_ms, "graph_ms": g_ms, "library_graph_ms": g_lib,
            "kernel_over_library": g_ms / g_lib if g_lib else None,
            "plain_ms": time_ms(plain, flush, iters=5) if plain is not None else None}


def bound_ms(n_bytes: float, n_ops: float, dtype) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ell_of(g, dev, block_rows=1):
    idx, wts, _ = g.to_ell(block_rows)
    return torch.as_tensor(idx, device=dev), torch.as_tensor(wts, device=dev)


def serving_graphs():
    """The serving phase's 32 reddit-bin graphs (seed 0)."""
    from repro_torch.graphs import TABLE4, sample_graphs

    return sample_graphs(TABLE4["reddit-bin"], 32, seed=0)


def randn(shape, seed, dev, scale=1.0):
    a = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return torch.as_tensor(a * np.float32(scale), device=dev)


def _cuda_tool(name: str) -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which(name)
    if found:
        return found
    path = Path(CUDA_HOME or "/usr/local/cuda", "bin", name)
    check(path.exists(), f"{name} not found")
    return str(path)


def _demangle(names: list[str]) -> list[str]:
    tool = shutil.which("c++filt")
    if not tool or not names:
        return names
    out = subprocess.run([tool], input="\n".join(names), capture_output=True,
                         text=True, timeout=60).stdout.splitlines()
    return out if len(out) == len(names) else names


def ptxas_report(log: str) -> dict:
    """ptxas's register, spill and shared-memory lines per kernel entry."""
    entries, current = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            current = m.group(1)
            entries[current] = []
        elif current and re.search(r"registers|spill|smem", line):
            entries[current].append(re.sub(r"^ptxas info\s*:\s*", "", line.strip()))
    return dict(zip(_demangle(list(entries)), entries.values()))


def sass_counts(so: Path) -> dict:
    """HGMMA (wgmma) and UTMALDG (TMA load) instructions per kernel in the
    library's SASS."""
    sass = subprocess.run([_cuda_tool("cuobjdump"), "-sass", str(so)],
                          capture_output=True, text=True, timeout=300, check=True).stdout
    counts, current = {}, None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            current = m.group(1)
            counts[current] = {"HGMMA": 0, "UTMALDG": 0}
        elif current:
            for op in ("HGMMA", "UTMALDG"):
                counts[current][op] += len(re.findall(rf"\b{op}\b", line))
    return dict(zip(_demangle(list(counts)), counts.values()))


#: the tensor-core kernels, by the name their instantiations carry
TENSOR_CORE_KERNELS = {"gemm_dataflow": "tc_kernel", "flash_attention": "flash_tc_kernel"}


def phase_build(libs) -> None:
    from repro_torch.kernels.common import build_libraries

    seconds = build_libraries(libs)
    report = {}
    for lib in libs:
        log = lib.log_path()
        sass = sass_counts(lib.so_path())
        report[lib.name] = {
            "ptxas": ptxas_report(log.read_text() if log.exists() else ""),
            "sass": {fn: c for fn, c in sass.items() if c["HGMMA"] or c["UTMALDG"]},
            "HGMMA": sum(c["HGMMA"] for c in sass.values()),
            "UTMALDG": sum(c["UTMALDG"] for c in sass.values()),
        }
        tc = TENSOR_CORE_KERNELS.get(lib.name)
        if tc:
            inst = {fn: c for fn, c in sass.items() if tc + "<" in fn or tc + "I" in fn}
            check(bool(inst), f"{lib.name}: no {tc} instantiation in the SASS")
            for fn, c in inst.items():
                check(c["HGMMA"] > 0 and c["UTMALDG"] > 0,
                      f"{lib.name}: {fn} has {c} in its SASS")
    emit({"phase": "build", "seconds": round(seconds, 3), "card": card_line(),
          "libraries": report})


def phase_kernels(dev, flush) -> dict:
    """Each kernel against its plain version; returns the per-kernel
    numbers at cora layer 0 for the final ``kernels`` line."""
    from repro_torch.graphs import from_edges, load_dataset, to_torch_csr
    from repro_torch.kernels.fused_agg_cmb import fused_agg_cmb, fused_ref
    from repro_torch.kernels.spmm import spmm, spmm_ref, spmm_streamed

    cora, _ = load_dataset("cora")
    idx, wts = ell_of(cora, dev, block_rows=128)  # the searched schedule's
    v, f, g = cora.n_nodes, 1433, 16
    check(tuple(idx.shape) == (2816, 72), f"cora ELL is {tuple(idx.shape)}")
    x = randn((v, f), 1, dev)
    w = randn((f, g), 2, dev, scale=1.0 / np.sqrt(f))
    nnz = int(torch.count_nonzero(wts))
    csr = to_torch_csr(cora, dev)

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

    numbers = gnn_timings(idx, wts, x, w, csr, flush)
    for name, nums in numbers.items():
        nums["max_abs_err"] = errs[name]
        emit({"phase": "kernels", "kernel": name, "case": "cora_l0_timing",
              "nnz": nnz, "v_pad": idx.shape[0], "d": idx.shape[1],
              **nums})

    # padding invariance: cora's graph re-padded to D = 512; only the real
    # slots are work, so the time should not follow D
    idx512, wts512 = (torch.as_tensor(a, device=dev)
                      for a in cora.to_ell(128, pad_to=512)[:2])
    torch.testing.assert_close(spmm(idx512, wts512, x), spmm(idx, wts, x),
                               **TOL_F32["spmm"])
    torch.testing.assert_close(fused_agg_cmb(idx512, wts512, x, w),
                               fused_agg_cmb(idx, wts, x, w), **TOL_F32["fused_agg_cmb"])
    wide = gnn_timings(idx512, wts512, x, w, csr, flush, plain=False)
    emit({"phase": "kernels", "case": "padding_invariance cora_l0 D 512 against D 72",
          **{name: {"graph_ms_d72": numbers[name]["graph_ms"],
                    "graph_ms_d512": wide[name]["graph_ms"],
                    "ms_d72": numbers[name]["ms"], "ms_d512": wide[name]["ms"],
                    "ratio": wide[name]["graph_ms"] / numbers[name]["graph_ms"]}
             for name in numbers}, "ok": True})
    serving = phase_serving_shape(dev, flush)
    keys = ("ms", "graph_ms", "library_ms", "library_graph_ms", "library_pair_ms",
            "library_pair_graph_ms", "bound_ms", "bound_by", "over_bound", "x_rows_read",
            "w_l2_bytes", "x_bytes")
    for name, nums in numbers.items():
        nums["cases"] = {
            "reddit-bin (512, 256) layer 0, f32": {
                k: serving[name][k] for k in keys if k in serving[name]},
            "cora layer 0 re-padded to D 512, f32": {
                k: wide[name][k] for k in keys if k in wide[name]},
        }
    return numbers


def phase_serving_shape(dev, flush) -> dict:
    """Both GNN kernels at the layer-0 shapes of the serving phase's first
    batch of the reddit-bin (512, 256) bucket, built by the same
    ``micro_batches`` as that phase (``bucket_ell``); each held against its plain version in
    512-row chunks (the plain version's (rows, D, F) gather of the whole
    batch would not fit in device memory, so it is not timed)."""
    from repro_torch.graphs import TABLE4, bucket_ell, to_torch_csr
    from repro_torch.kernels.fused_agg_cmb import fused_agg_cmb, fused_ref
    from repro_torch.kernels.spmm import spmm, spmm_ref

    batch, idx, wts = bucket_ell(serving_graphs(), (512, 256))
    graph, f = batch.graph, TABLE4["reddit-bin"].n_features
    idx, wts = torch.as_tensor(idx, device=dev), torch.as_tensor(wts, device=dev)
    g = 16
    x = randn((graph.n_nodes, f), 30, dev)
    w = randn((f, g), 31, dev, scale=1.0 / np.sqrt(f))
    rows, errs = 512, {}
    for name, kern, plain, tol in (
            ("spmm", lambda: spmm(idx, wts, x),
             lambda r: spmm_ref(idx[r:r + rows], wts[r:r + rows], x), TOL_F32["spmm"]),
            ("fused_agg_cmb", lambda: fused_agg_cmb(idx, wts, x, w),
             lambda r: fused_ref(idx[r:r + rows], wts[r:r + rows], x, w),
             TOL_F32["fused_agg_cmb"])):
        out = kern()
        ref = torch.cat([plain(r) for r in range(0, idx.shape[0], rows)])
        torch.cuda.synchronize()
        check(bool(torch.isfinite(out).all()), f"{name} reddit-bin: non-finite output")
        torch.testing.assert_close(out, ref, **tol)
        errs[name] = float((out - ref).abs().max())
        del ref
    nums = gnn_timings(idx, wts, x, w, to_torch_csr(graph, dev), flush, plain=False)
    for name, rec in nums.items():
        emit({"phase": "kernels", "kernel": name,
              "case": "reddit-bin bucket [512, 256] layer 0",
              "shape": [*idx.shape, f, g], "nnz": int(torch.count_nonzero(wts)),
              "max_abs_err": errs[name], "tol": TOL_F32[name],
              "plain_ms_note": "not timed: the plain version runs in 512-row chunks",
              **rec, "ok": True})
    return nums


def gnn_timings(idx, wts, x, w, csr, flush, plain=True) -> dict:
    """Both GNN kernels' times and bounds on one ELL: ``spmm`` beside
    ``torch.sparse.mm`` on the same graph's CSR; the fused kernel beside no
    one-call library (none computes (A @ X) @ W) and beside the two-call
    pair ``torch.sparse.mm(csr, x) @ w`` (``library_pair_ms``: the unfused
    library route, not a one-call yardstick).  ``plain=False`` leaves the
    plain versions untimed (``plain_ms`` None).

    The bounds count the work this ELL needs: its non-zero (src, weight)
    pairs, the x rows they reference (a serving batch's pad rows hold only
    a weight-0 self-loop, so their x rows are never read), out, w, and the
    combination of the rows that have a non-zero weight.  The fused
    record also gives the w bytes the kernel reads from L2 (every row block
    with a real slot reads all of w) beside x's."""
    from repro_torch.kernels.fused_agg_cmb import fused_agg_cmb, fused_ref
    from repro_torch.kernels.fused_agg_cmb.ops import plan as fused_plan
    from repro_torch.kernels.spmm import spmm, spmm_ref

    real = wts != 0
    nnz = int(real.sum())
    x_rows = int(torch.unique(idx[real]).numel())
    live = real.any(dim=1)
    v_pad, f, g = idx.shape[0], x.shape[1], w.shape[1]
    es = x.element_size()
    x_bytes = x_rows * f * es
    sp_bytes = nnz * 8 + x_bytes + v_pad * f * es
    sp_bound, sp_by = bound_ms(sp_bytes, 2 * nnz * f, x.dtype)
    fu_bytes = nnz * 8 + x_bytes + f * g * es + v_pad * g * es
    fu_bound, fu_by = bound_ms(fu_bytes, 2 * nnz * f + 2 * int(live.sum()) * f * g, x.dtype)
    fp = fused_plan(idx, x, w)
    blocks = int(torch.unique(live.nonzero()[:, 0] // fp["rows"]).numel())
    sp = timed(lambda: spmm(idx, wts, x), lambda: torch.sparse.mm(csr, x),
               (lambda: spmm_ref(idx, wts, x)) if plain else None, flush)
    fu = timed(lambda: fused_agg_cmb(idx, wts, x, w, band_size=128, block_f=512),
               None, (lambda: fused_ref(idx, wts, x, w)) if plain else None, flush)
    pair = time_pair(graphed(lambda: torch.sparse.mm(csr, x) @ w), None, flush)[0]
    pair_ms = time_ms(lambda: torch.sparse.mm(csr, x) @ w, flush)
    return {
        "spmm": {**sp, "bound_ms": sp_bound, "bound_by": sp_by, "bytes": sp_bytes,
                 "x_rows_read": x_rows, "over_bound": sp["graph_ms"] / sp_bound},
        "fused_agg_cmb": {**fu, "bound_ms": fu_bound, "bound_by": fu_by,
                          "bytes": fu_bytes, "x_rows_read": x_rows,
                          "over_bound": fu["graph_ms"] / fu_bound,
                          "plan": fp, "w_l2_bytes": blocks * f * g * es,
                          "x_bytes": x_bytes,
                          "library_pair_ms": pair_ms, "library_pair_graph_ms": pair,
                          "library_pair": "torch.sparse.mm(csr, x) @ w, two calls"},
    }


def flash_bound(b, hq, hkv, sq, sk, d, dtype, causal) -> tuple[float, str]:
    """Bytes: q, k, v read once, out written once.  Operations: 2 D for
    q.k and 2 D for p.v per (query, key) pair the mask lets through."""
    pairs = sum(min(i + 1, sk) for i in range(sq)) if causal else sq * sk
    es = torch.tensor([], dtype=dtype).element_size()
    n_bytes = (2 * b * hq * sq * d + 2 * b * hkv * sk * d) * es
    return bound_ms(n_bytes, 4 * d * b * hq * pairs, dtype)


def gemm_bound(v, f, g, dtype) -> tuple[float, str]:
    es = torch.tensor([], dtype=dtype).element_size()
    return bound_ms((v * f + f * g + v * g) * es, 2 * v * f * g, dtype)


def phase_lm_kernels(dev, flush) -> dict:
    """Flash attention and the dataflow GEMM against their plain versions;
    returns their numbers for the final ``kernels`` line."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref, route
    from repro_torch.kernels.gemm_dataflow import DATAFLOWS, gemm, gemm_ref, plan

    def qkv(b, hq, hkv, sq, sk, d, seed, dtype=torch.float32):
        return (randn((b, hq, sq, d), seed, dev).to(dtype),
                randn((b, hkv, sk, d), seed + 1, dev).to(dtype),
                randn((b, hkv, sk, d), seed + 2, dev).to(dtype))

    flash_cases = [(f"test_kernels_{b}x{hq}x{hkv}x{sq}x{sk}x{d}_causal{int(c)}",
                    (b, hq, hkv, sq, sk, d), torch.float32, c, TOL_FLASH)
                   for b, hq, hkv, sq, sk, d in [(2, 4, 2, 96, 96, 32),
                                                 (1, 8, 1, 64, 128, 16),
                                                 (2, 2, 2, 33, 33, 64)]
                   for c in (False, True)]
    smollm = (4, 9, 3, 1024, 1024, 64)
    flash_cases += [
        ("smollm_prefill_f32", smollm, torch.float32, True, TOL_FLASH),
        ("smollm_prefill_bf16", smollm, torch.bfloat16, True, TOL_BF16),
        ("ragged_s1000_f32", (4, 9, 3, 1000, 1000, 64), torch.float32, True, TOL_FLASH),
        ("olmo_head_d128_f32", (1, 16, 16, 512, 512, 128), torch.float32, True, TOL_FLASH),
        ("granite_head_d128_bf16", (1, 32, 8, 512, 512, 128), torch.bfloat16, True,
         TOL_BF16),
    ]
    flash_err = None
    for i, (case, shape, dtype, causal, tol) in enumerate(flash_cases):
        q, k, v = qkv(*shape, 100 + 3 * i, dtype)
        out = flash_attention(q, k, v, causal=causal)
        ref = flash_attention_ref(q, k, v, causal)
        torch.cuda.synchronize()
        check(out.shape == ref.shape and out.dtype == ref.dtype, case)
        check(bool(torch.isfinite(out).all()), f"{case}: non-finite output")
        err = float((out.float() - ref.float()).abs().max())
        torch.testing.assert_close(out, ref, **tol)
        rec = {"phase": "kernels", "kernel": "flash_attention", "case": case,
               "shape": list(shape), "dtype": str(dtype), "causal": causal,
               "route": route(dtype, [(t.shape, t.stride()) for t in (q, k, v, out)],
                              [t.data_ptr() for t in (q, k, v, out)]),
               "max_abs_err": err, "tol": tol}
        if dtype == torch.bfloat16:
            ref32 = flash_attention_ref(q.float(), k.float(), v.float(), causal)
            row = float(((out.float() - ref32).norm(dim=-1) / ref32.norm(dim=-1)).max())
            check(row <= FLASH_ROW_REL_L2,
                  f"{case}: row relative L2 {row} > {FLASH_ROW_REL_L2} against f32")
            rec.update(row_rel_l2_vs_f32=row, row_rel_l2_limit=FLASH_ROW_REL_L2)
        emit({**rec, "ok": True})
        if case == "smollm_prefill_bf16":
            flash_err = err

    q, k, v = qkv(*smollm, 7, torch.bfloat16)
    fb, fby = flash_bound(*smollm, torch.bfloat16, True)
    flash = {
        **timed(lambda: flash_attention(q, k, v, causal=True),
                lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                       enable_gqa=True),
                lambda: flash_attention_ref(q, k, v, True, 512), flush),
        "bound_ms": fb, "bound_by": fby, "max_abs_err": flash_err,
        "case": "smollm_prefill_bf16 (B 4, Hq 9, Hkv 3, S 1024, D 64, causal)",
    }
    emit({"phase": "kernels", "kernel": "flash_attention", "case": "timing", **flash})

    gemm_shapes = [(f"test_kernels_{v}x{f}x{g}_blk32", (v, f, g), torch.float32, 32,
                    TOL_GEMM)
                   for v, f, g in [(128, 128, 128), (96, 80, 72), (33, 17, 5),
                                   (256, 64, 512)]]
    gemm_shapes += [("cora_l0_f32", (2708, 1433, 16), torch.float32, 128, TOL_GEMM),
                    ("smollm_w_gate_bf16", (4096, 576, 1536), torch.bfloat16, 128,
                     TOL_BF16),
                    # rows of 150 bf16 (300 bytes): TMA refuses w, CUDA cores
                    ("ragged_no_tma_bf16", (300, 200, 150), torch.bfloat16, 128, TOL_BF16),
                    # F past one resident slab: slab partials in the workspace
                    ("two_slabs_bf16", (1000, 1216, 264), torch.bfloat16, 128, TOL_BF16)]
    numbers = {}
    for i, (case, (v, f, g), dtype, blk, tol) in enumerate(gemm_shapes):
        x = randn((v, f), 200 + i, dev).to(dtype)
        w = randn((f, g), 300 + i, dev, scale=1.0 / np.sqrt(f)).to(dtype)
        ref = gemm_ref(x, w)
        for df in DATAFLOWS:
            out = gemm(x, w, dataflow=df, block_v=blk, block_g=blk, block_f=blk)
            torch.cuda.synchronize()
            check(out.shape == ref.shape and out.dtype == ref.dtype, f"{case} {df}")
            check(bool(torch.isfinite(out).all()), f"{case} {df}: non-finite output")
            err = float((out.float() - ref.float()).abs().max())
            torch.testing.assert_close(out, ref, **tol)
            check(torch.equal(out, gemm(x, w, dataflow=df, block_v=blk, block_g=blk,
                                        block_f=blk)), f"{case} {df}: not deterministic")
            pl = plan(v, f, g, dtype, df, x_ptr=x.data_ptr(), w_ptr=w.data_ptr())
            rec = {"phase": "kernels", "kernel": "gemm_dataflow", "case": case,
                   "dataflow": df, "shape": [v, f, g], "dtype": str(dtype),
                   "route": pl.route, "grid": list(pl.grid), "nslab": pl.nslab,
                   "max_abs_err": err, "tol": tol, "deterministic": True, "ok": True}
            if case in ("cora_l0_f32", "smollm_w_gate_bf16"):
                b_ms, b_by = gemm_bound(v, f, g, dtype)
                rec.update(**timed(lambda: gemm(x, w, dataflow=df),
                                   lambda: torch.matmul(x, w), lambda: gemm_ref(x, w),
                                   flush),
                           bound_ms=b_ms, bound_by=b_by)
                numbers[(case, df)] = rec
            emit(rec)
    keys = ("ms", "plain_ms", "library_ms", "graph_ms", "library_graph_ms",
            "kernel_over_library", "bound_ms", "bound_by", "max_abs_err", "route")
    gemm_nums = {k: numbers[("cora_l0_f32", "output_stationary")][k] for k in keys}
    gemm_nums["case"] = "cora_l0_f32 (2708 x 1433 @ 1433 x 16), output_stationary"
    # every timed case, smollm's w_gate in bf16 beside cora's layer 0 in f32
    gemm_nums["cases"] = {f"{case} {df}": {k: rec[k] for k in keys}
                          for (case, df), rec in numbers.items()}
    return {"flash_attention": flash, "gemm_dataflow": gemm_nums}


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
    from repro_torch.graphs import TABLE4, BucketPolicy, micro_batches
    from repro_torch.kernels.fused_agg_cmb import fused_agg_cmb, fused_ref

    f_in = TABLE4["reddit-bin"].n_features
    graphs = serving_graphs()
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
    for key, chunk, batch in micro_batches(graphs, policy):
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


def phase_gemm(dev, counters) -> dict:
    """The dataflow GEMM's entry point as a user calls it: ``gemm`` on
    cora's layer-0 combination, once per dataflow."""
    from repro_torch.kernels.gemm_dataflow import DATAFLOWS, gemm, gemm_ref

    x = randn((2708, 1433), 20, dev)
    w = randn((1433, 16), 21, dev, scale=1.0 / np.sqrt(1433))
    reset_counts(counters)
    outs = {df: gemm(x, w, dataflow=df) for df in DATAFLOWS}
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in counters.items()}
    check(launches["gemm_dataflow"] == len(DATAFLOWS),
          f"gemm launched {launches['gemm_dataflow']} times")
    ref = gemm_ref(x, w)
    errs = {}
    for df, out in outs.items():
        torch.testing.assert_close(out, ref, **TOL_GEMM)
        errs[df] = float((out - ref).abs().max())
    emit({"phase": "gemm", "shape": [2708, 1433, 16], "launches": launches,
          "max_abs_err": errs, "ok": True})
    return launches


def phase_lm_serve(dev, counters, batch=4, prompt_len=1024, new_tokens=32) -> dict:
    """smollm-135m served at full width through ``generate``."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.common import measure_wall
    from repro_torch.launch.serve import generate
    from repro_torch.models import forward, init_params, make_inputs

    cfg = get_config("smollm-135m")
    params = init_params(cfg, torch.Generator().manual_seed(0), dev)
    prompts = make_inputs(cfg, batch, prompt_len, seed=0, device=dev)
    reset_counts(counters)
    timings = {}
    toks, lat = generate(cfg, params, prompts, new_tokens, timings=timings)
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in counters.items()}
    check(launches["flash_attention"] == cfg.n_layers,
          f"flash_attention launched {launches['flash_attention']} times in one "
          f"forward of {cfg.n_layers} layers")
    check(toks.shape == (batch, new_tokens) and toks.dtype == torch.int32,
          f"generate returned {tuple(toks.shape)} {toks.dtype}")
    check(bool(((toks >= 0) & (toks < cfg.vocab)).all()), "token ids out of range")

    # the plain-version twin of the same run (no kernel launch)
    twin, _ = generate(cfg, params, prompts, new_tokens, use_kernels=False)
    agree = float((toks == twin).float().mean())
    logits, _ = forward(cfg, params, prompts)
    plain, _ = forward(cfg, params, prompts, use_kernels=False)
    # the prefill forward warmed up (generate's first call pays one-time
    # costs): host clock around each call, synchronised, median of 3
    prefill_ms = {route: 1e3 * measure_wall(
        lambda: forward(cfg, params, prompts, use_kernels=kern), warmup=1, iters=3)
        for route, kern in (("kernels", True), ("plain", False))}
    check(bool(torch.isfinite(logits).all()), "bf16 logits not finite")
    diff = (logits.float() - plain.float())
    rel_l2 = float(diff.norm() / plain.float().norm())
    max_bf16 = float(diff.abs().max())
    check(rel_l2 <= LM_BF16_REL_L2, f"bf16 logits rel L2 {rel_l2} > {LM_BF16_REL_L2}")
    del logits, plain, diff

    cfg32 = cfg.with_(dtype="float32")
    params32 = init_params(cfg32, torch.Generator().manual_seed(0), dev)
    before = counters["flash_attention"].launches
    l32, _ = forward(cfg32, params32, prompts)
    torch.cuda.synchronize()
    check(counters["flash_attention"].launches - before == cfg.n_layers,
          "f32 forward did not launch flash_attention once per layer")
    p32, _ = forward(cfg32, params32, prompts, use_kernels=False)
    check(bool(torch.isfinite(l32).all()), "f32 logits not finite")
    err32 = float((l32 - p32).abs().max())
    torch.testing.assert_close(l32, p32, **TOL_LM_F32)
    del l32, p32, params32
    emit({"phase": "lm_serve", "arch": cfg.name, "batch": batch,
          "prompt_len": prompt_len, "new_tokens": new_tokens,
          "prefill_s": timings["prefill_s"], "replay_s": timings["replay_s"],
          "prefill_forward_ms_median": prefill_ms,
          "decode_s": timings["decode_s"],
          "decode_step_ms_median": statistics.median(lat) * 1e3,
          "launches": launches,
          "bf16_logits_rel_l2_vs_plain": rel_l2,
          "bf16_logits_max_abs_err_vs_plain": max_bf16,
          "bf16_greedy_tokens_agree": agree,
          "f32_logits_max_abs_err_vs_plain": err32, "tol_f32": TOL_LM_F32,
          "ok": True})

    # the other dense archs, full width, depth cut to 2, against their twins
    for arch in ("tinyllama-1.1b", "olmo-1b", "granite-8b", "llava-next-34b",
                 "musicgen-large"):
        acfg = get_config(arch).with_(n_layers=2, dtype="float32")
        gen = torch.Generator(device=dev).manual_seed(1)
        ap = init_params(acfg, gen, dev)
        inputs = make_inputs(acfg, 1, 256, seed=1, device=dev)
        before = counters["flash_attention"].launches
        out, _ = forward(acfg, ap, inputs)
        torch.cuda.synchronize()
        check(counters["flash_attention"].launches - before == acfg.n_layers,
              f"{arch}: flash_attention not launched once per layer")
        twin_out, _ = forward(acfg, ap, inputs, use_kernels=False)
        check(bool(torch.isfinite(out).all()), f"{arch}: logits not finite")
        torch.testing.assert_close(out, twin_out, **TOL_LM_F32)
        emit({"phase": "lm_serve", "arch": arch, "depth": acfg.n_layers,
              "head_dim": acfg.head_dim, "heads": [acfg.n_heads, acfg.n_kv_heads],
              "max_abs_err_vs_plain": float((out - twin_out).abs().max()),
              "ok": True})
        del ap, out, twin_out
        torch.cuda.empty_cache()
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
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.fused_agg_cmb import ops as fused_ops
    from repro_torch.kernels.gemm_dataflow import ops as gemm_ops
    from repro_torch.kernels.spmm import ops as spmm_ops

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    phase_build([spmm_ops.LIBRARY, fused_ops.LIBRARY, flash_ops.LIBRARY,
                 gemm_ops.LIBRARY])

    counters = {"spmm": spmm_ops.spmm, "fused_agg_cmb": fused_ops.fused_agg_cmb,
                "flash_attention": flash_ops.flash_attention,
                "gemm_dataflow": gemm_ops.gemm}
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)
    numbers = phase_kernels(dev, flush)
    numbers.update(phase_lm_kernels(dev, flush))
    launches = phase_main(dev, counters)
    for phase in (phase_serving, phase_gemm, phase_lm_serve):
        for k, n in phase(dev, counters).items():
            launches[k] += n
    for k, n in launches.items():
        check(n > 0, f"{k} was never launched on the main path")

    meta = {
        "spmm": ("cuda", "src/repro_torch/kernels/spmm/spmm.cu",
                 "src/repro/kernels/spmm/kernel.py:39"),
        "fused_agg_cmb": ("cuda",
                          "src/repro_torch/kernels/fused_agg_cmb/fused_agg_cmb.cu",
                          "src/repro/kernels/fused_agg_cmb/kernel.py:46"),
        "flash_attention": ("cuda",
                            "src/repro_torch/kernels/flash_attention/flash_attention.cu",
                            "src/repro/kernels/flash_attention/kernel.py:65"),
        "gemm_dataflow": ("cuda",
                          "src/repro_torch/kernels/gemm_dataflow/gemm_dataflow.cu",
                          "src/repro/kernels/gemm_dataflow/kernel.py:50"),
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
            "case": nums.get("case", "cora_l0_f32"),
            **{k: nums[k] for k in ("graph_ms", "library_graph_ms",
                                    "kernel_over_library", "cases") if k in nums},
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
