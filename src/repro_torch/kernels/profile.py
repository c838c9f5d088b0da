"""Per-kernel readings on one CUDA card for every kernel of the port --
``spmm``, ``fused_agg_cmb``, ``flash_attention`` and ``gemm_dataflow`` --
beside their library calls; not a part of any model path.

    PYTHONPATH=src python -m repro_torch.kernels.profile [--only gnn|lm] [--out FILE]
        [--gnn-from CHECKOUT]

For ``spmm`` and ``fused_agg_cmb`` at cora's layer 0 (f32) and at the
layer-0 shapes of the reddit-bin (512, 256) serving bucket (f32), flash
attention at smollm-135m prefill (bf16) and ``gemm`` at smollm's ``w_gate``
(bf16) and cora's layer-0 combination (f32), each dataflow:

- the kernel's device time from ``torch.profiler`` (CUPTI kernel records,
  mean of ``--iters`` calls, L2 flushed before each), and the library
  call's (``torch.sparse.mm``; for the fused kernel the two-call pair
  ``torch.sparse.mm(csr, x) @ w``; SDPA; ``torch.matmul``) taken the same way;
- achieved rates: the least bytes the function moves, and its operations,
  over that time, each as a share of the card's rate;
- resources: ptxas's registers and spills per instantiation, the CTA's
  threads and shared memory, the CTAs an SM holds by each limit, the grid
  and its waves (the GNN kernels report their launch through ``plan``);
- ablations: copies of the kernel source with one stage taken out, built
  and timed the same way (their outputs are wrong by design; only their
  time is read).  The gap to the full kernel is what that stage costs on
  the critical path;
- the host cost of one ``cuTensorMapEncodeTiled`` call at the shapes the
  wrappers encode (a small timer built beside the ablations).
- for the GNN kernels at the reddit-bin shape, two input-side readings:
  every row cut to its first 16 slots (no hub rows), and the longest row
  alone; and the fused kernel built with at most 8 rows a CTA (``rows_8``:
  four times the w re-reads) and with F in one slice (``slices_1``: no
  cluster, one SM per row block);
- ``--gnn-from CHECKOUT``: the GNN kernels also built from another
  checkout's ``spmm.cu`` and ``fused_agg_cmb.cu`` (the parent commit's, for
  a before/after reading in one process), timed on the same inputs; besides
  the two shapes above also at cora's unpadded ELL (V_pad 2708, where the
  fused kernel takes 16 rows a CTA) at layer 0 (F 1433, G 16) and layer 1
  (F 16, G 8).  And whole kernel-tier forwards of GCN 1433 -> 16 -> 8 on
  cora (``repro_torch.compile`` under seq/AC, seq/CA and sp_opt/AC, the
  median of 30 warm ``run`` calls, CUDA events and host wall) of that
  checkout's package and this one's, each in a process of its own, in the
  order other, this, this, other;
- with the GNN kernels, the dense products that keep a row's result
  independent of the call's row count, at cora's and the reddit-bin
  (512, 256) x 64 batch's layer-0 combination: ``row_matmul`` (the eager
  tier's), the same over 64-, 512- and 2,048-row tiles, one batched call
  over the zero-padded tiles (a variable batch count, and a fixed 32), and
  the ``gemm`` kernel (the kernel tier's), beside one ``torch.matmul``;
  each with its direct-call time (CUDA events, host cost included) and
  whether its rows came out bit-identical at other row counts and offsets.

One JSON line per reading; ``--out`` also writes them all to a file.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import torch

from .common import BUILD_DIR, CudaLibrary, build_libraries, cdiv

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
PEAK_OPS = {torch.float32: 67e12, torch.bfloat16: 989e12}  # dense, per s
#: H100 per-SM limits: registers, shared memory (bytes), threads, CTAs
SM_REGS, SM_SMEM, SM_THREADS, SM_CTAS = 65536, 233472, 2048, 32
KERNELS = Path(__file__).resolve().parent
PROFILE_DIR = BUILD_DIR.parent / "profile"

# (file, variant) -> [(text in the source, replacement)]; each text must
# occur exactly once
ABLATIONS = {
    ("flash_attention", "no_softmax"): [(
        "  auto softmax = [&](int code) {\n    hopper::fence_operands(sc);\n",
        "  auto softmax = [&](int code) {\n    hopper::fence_operands(sc);\n"
        "    if (code >= 0) {  // ablation: P = S, no mask, max, exp or sum\n"
        "      alpha[0] = alpha[1] = 1.f;\n"
        "#pragma unroll\n"
        "      for (int kk = 0; kk < 4; ++kk)\n"
        "#pragma unroll\n"
        "        for (int r = 0; r < 4; ++r)\n"
        "          pa[kk][r] = hopper::pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);\n"
        "      return;\n"
        "    }\n")],
    ("flash_attention", "no_pv"): [(
        "        if constexpr (DP == 64) {\n"
        "          hopper::wgmma_rs_n64<1>(o, pa[kk], dv, 1);\n"
        "        } else if constexpr (DP == 128) {\n"
        "          hopper::wgmma_rs_n128<1>(o, pa[kk], dv, 1);\n"
        "        } else {  // columns 0-127, then 128-255 (panels 2 and 3)\n"
        "#pragma unroll\n"
        "          for (int half = 0; half < 2; ++half)\n"
        "            hopper::wgmma_rs_n128<1>(\n"
        "                *reinterpret_cast<float(*)[64]>(o + 64 * half), pa[kk],\n"
        "                hopper::desc_b128(v_addr + 2 * half * kKVPanel + kk * 2048, kKVPanel, 1024),\n"
        "                1);\n"
        "        }\n",
        "        (void)dv;  // ablation: no P V product\n")],
    ("gemm_dataflow", "tc_no_mma"): [(
        "  const uint32_t a0 = hopper::smem_u32(a) + wg * 64 * 128, b0 = hopper::smem_u32(b);\n",
        "  if (wg >= 0) return;  // ablation: the ring is filled and drained, no wgmma\n"
        "  const uint32_t a0 = hopper::smem_u32(a) + wg * 64 * 128, b0 = hopper::smem_u32(b);\n")],
    ("gemm_dataflow", "cc_no_fill"): [(
        "  for (int e = threadIdx.x; e < rows * kCcCols; e += kCcThreads) {\n",
        "  for (int e = threadIdx.x; e < 0 * rows * kCcCols; e += kCcThreads) {  // ablation\n")],
    ("gemm_dataflow", "cc_no_product"): [(
        "      cc_partial<T, false, true>(p, nullptr, wsm, rg * kCcRows, c0, k0, rows, acc);\n",
        "      if (rows < 0)  // ablation: the slab is filled, no product\n"
        "        cc_partial<T, false, true>(p, nullptr, wsm, rg * kCcRows, c0, k0, rows, acc);\n")],
    ("gemm_dataflow", "cc_no_x_fill"): [(
        "    for (int c = threadIdx.x; c < cols; c += kCcThreads)\n",
        "    for (int c = threadIdx.x; c < 0 * cols; c += kCcThreads)  // ablation\n")],
    ("gemm_dataflow", "cc_x_fill_only"): [(
        "      cc_partial<T, true, false>(p, xs, nullptr, r0, cb * kCcCols, k0, rows, acc);\n",
        "      if (rows < 0)  // ablation: the x slab is filled, no product\n"
        "        cc_partial<T, true, false>(p, xs, nullptr, r0, cb * kCcCols, k0, rows, acc);\n")],
}
# the GNN kernels: the slot lists staged and nothing gathered; the
# gathers without the combination
ABLATIONS[("spmm", "stage_only")] = [(
    "  for (int cv = lane; cv < ncol; cv += NC * lanes) {\n",
    "  for (int cv = lane; cv < 0 * ncol; cv += NC * lanes) {  // ablation: no gathers\n")]
ABLATIONS[("fused_agg_cmb", "stage_only")] = [(
    "    if (f0 + lane * VEC < f) {\n",
    "    if (f0 + lane * VEC < 0 * f) {  // ablation: no gathers\n")]
ABLATIONS[("fused_agg_cmb", "gathers_only")] = [(
    "    const int nc = min(fc, f - f0);\n",
    "    const int nc = 0 * min(fc, f - f0);  // ablation: no combination\n")]
# not ablations: the fused kernel with at most 8 rows a CTA (four times the
# w re-reads), and with F in one slice (no cluster); outputs right
ABLATIONS[("fused_agg_cmb", "rows_8")] = [(
    "constexpr int kMaxRows = 32;", "constexpr int kMaxRows = 8;")]
ABLATIONS[("fused_agg_cmb", "slices_1")] = [(
    "constexpr int kMaxSlices = 4;", "constexpr int kMaxSlices = 1;")]
ABLATIONS[("flash_attention", "feed_only")] = ABLATIONS[("flash_attention", "no_softmax")] + \
    ABLATIONS[("flash_attention", "no_pv")] + [(
        "    const uint32_t k_addr = hopper::smem_u32(ks + st * NP * kKVPanel);\n",
        "    if (st >= 0) return;  // ablation: no q k^T product\n"
        "    const uint32_t k_addr = hopper::smem_u32(ks + st * NP * kKVPanel);\n")]

TENSOR_MAP_TIMER = r"""
#include <chrono>

#include "HOPPER"

extern "C" {

// Microseconds per cuTensorMapEncodeTiled call, the mean of `reps`: out[0]
// for gemm's rank-2 maps (x (4096, 576) of smollm's w_gate), out[1] for
// flash's rank-4 maps (q (4, 9, 1024, 64) of smollm prefill, contiguous).
// Returns 0, or 1000 + the error of the rank-2 map, 2000 + the rank-4's.
int tensor_map_us(double* out, const void* x, const void* q, int reps) {
  CUtensorMap m;
  const uint64_t d2[2] = {576, 4096}, s2[1] = {576 * 2};
  const uint32_t b2[2] = {64, 128};
  const uint64_t d4[4] = {64, 1024, 9, 4}, s4[3] = {64 * 2, 1024 * 64 * 2, 9 * 1024 * 64 * 2};
  const uint32_t b4[4] = {64, 64, 1, 1};
  cudaError_t err = hopper::make_map_bf16(&m, x, 2, d2, s2, b2);
  if (err != cudaSuccess) return 1000 + (int)err;
  err = hopper::make_map_bf16(&m, q, 4, d4, s4, b4);
  if (err != cudaSuccess) return 2000 + (int)err;
  auto t0 = std::chrono::steady_clock::now();
  for (int i = 0; i < reps; ++i) hopper::make_map_bf16(&m, x, 2, d2, s2, b2);
  auto t1 = std::chrono::steady_clock::now();
  for (int i = 0; i < reps; ++i) hopper::make_map_bf16(&m, q, 4, d4, s4, b4);
  auto t2 = std::chrono::steady_clock::now();
  out[0] = std::chrono::duration<double, std::micro>(t1 - t0).count() / reps;
  out[1] = std::chrono::duration<double, std::micro>(t2 - t1).count() / reps;
  return 0;
}

const char* tensor_map_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}
"""


def emit(record: dict, sink: list) -> None:
    sink.append(record)
    print(json.dumps(record), flush=True)


def variant_library(lib: CudaLibrary, name: str, patches) -> CudaLibrary:
    """A copy of ``lib``'s source with ``patches`` applied, as a library of
    its own under the build directory."""
    text = re.sub(r'#include "\.\./([^"]+)"', lambda m: f'#include "{KERNELS / m.group(1)}"',
                  lib.source.read_text())
    for old, new in patches:
        if text.count(old) != 1:
            raise RuntimeError(f"ablation {name}: patch site not found once: {old!r}")
        text = text.replace(old, new)
    path = PROFILE_DIR / name / lib.source.name
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(text)
    return CudaLibrary(path, lib.functions)


def ptxas_registers(libs) -> dict:
    """Registers and spill-store bytes per kernel entry (demangled where
    ``c++filt`` is present), from ptxas's ``-v`` lines."""
    entries, current = {}, None
    for lib in libs:
        for line in lib.log_path().read_text().splitlines():
            m = re.search(r"Compiling entry function '([^']+)'", line)
            if m:
                current = m.group(1)
                entries[current] = {}
            elif current:
                r = re.search(r"Used (\d+) registers", line)
                if r:
                    entries[current]["registers"] = int(r.group(1))
                s = re.search(r"(\d+) bytes spill stores", line)
                if s:
                    entries[current]["spill_store_bytes"] = int(s.group(1))
    names = list(entries)
    tool = shutil.which("c++filt")
    if tool and names:
        out = subprocess.run([tool], input="\n".join(names), capture_output=True,
                             text=True, timeout=60).stdout.splitlines()
        if len(out) == len(names):
            names = out
    return dict(zip(names, entries.values()))


def resident_ctas(registers: int, threads: int, smem: int) -> dict:
    """CTAs one SM holds by each limit (registers allocated per warp in
    units of 256; 1 KB of shared memory reserved per CTA)."""
    warps = -(-threads // 32)
    regs_per_cta = warps * (-(-registers * 32 // 256) * 256)
    by = {"registers": SM_REGS // regs_per_cta, "shared_memory": SM_SMEM // (smem + 1024),
          "threads": SM_THREADS // threads, "ctas": SM_CTAS}
    return {"ctas_per_sm": min(by.values()), "limited_by": min(by, key=by.get),
            "ctas_per_sm_by_limit": by}


def device_ms(fn, flush, iters: int) -> tuple[float, list[str]]:
    """Mean device time of the kernels ``fn`` launches per call (the
    flush's fill kernel left out), from the profiler's CUDA records."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    total, names = 0.0, []
    for e in prof.key_averages():
        if "fill" in e.key.lower() or "memset" in e.key.lower():
            continue  # the L2 flush
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us > 0:
            total += us
            names.append(e.key[:120])
    return total / iters / 1e3, names


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--only", choices=("gnn", "lm"), default=None,
                    help="the GNN kernels or the LM kernels alone")
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--gnn-from", type=Path, default=None, metavar="CHECKOUT",
                    help="also time the GNN kernels built from this checkout's sources")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile: needs a CUDA device")
    import torch.nn.functional as F

    from .flash_attention import flash_attention
    from .flash_attention import ops as fops
    from .fused_agg_cmb import ops as agg_ops
    from .gemm_dataflow import DATAFLOWS, gemm, plan
    from .gemm_dataflow import ops as gops
    from .spmm import ops as sp_ops

    records: list = []
    libs = {"flash_attention": fops.LIBRARY, "gemm_dataflow": gops.LIBRARY,
            "spmm": sp_ops.LIBRARY, "fused_agg_cmb": agg_ops.LIBRARY}
    wanted = {"gnn": ("spmm", "fused_agg_cmb"), "lm": ("flash_attention", "gemm_dataflow"),
              None: tuple(libs)}[args.only]
    variants = {key: variant_library(libs[key[0]], key[1], patches)
                for key, patches in ABLATIONS.items() if key[0] in wanted}
    before = {}
    if args.gnn_from and "spmm" in wanted:
        src = args.gnn_from / "src" / "repro_torch" / "kernels"
        before = {name: CudaLibrary(src / name / f"{name}.cu", {fn: libs[name].functions[fn]})
                  for name, fn in (("spmm", "spmm_ell_launch"),
                                   ("fused_agg_cmb", "fused_agg_cmb_launch"))}
    timer_cu = PROFILE_DIR / "tensor_map" / "tensor_map.cu"
    timer_cu.parent.mkdir(parents=True, exist_ok=True)
    timer_cu.write_text(TENSOR_MAP_TIMER.replace("HOPPER", str(KERNELS / "hopper.cuh")))
    timer = CudaLibrary(timer_cu, {"tensor_map_us": [ctypes.POINTER(ctypes.c_double),
                                                     ctypes.c_void_p, ctypes.c_void_p,
                                                     ctypes.c_int]})
    seconds = build_libraries([*(libs[k] for k in wanted), timer, *variants.values(),
                               *before.values()])
    regs = ptxas_registers([libs[k] for k in wanted])
    emit({"reading": "build", "seconds": seconds, "ptxas": regs,
          "device": torch.cuda.get_device_name(0)}, records)

    dev = torch.device("cuda", 0)
    out = (ctypes.c_double * 2)()
    x_map = torch.empty((4096, 576), dtype=torch.bfloat16, device=dev)
    q_map = torch.empty((4, 9, 1024, 64), dtype=torch.bfloat16, device=dev)
    code = timer.load().tensor_map_us(out, x_map.data_ptr(), q_map.data_ptr(), 20000)
    emit({"reading": "tensor_map_encode_us", "code": code, "rank2_gemm": out[0],
          "rank4_flash": out[1],
          "per_launch_us": {"gemm": 2 * out[0], "flash_attention": 3 * out[1]}}, records)

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)

    def randn(shape, seed, dtype, scale=1.0):
        a = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
        return torch.as_tensor(a * np.float32(scale), device=dev).to(dtype)

    def reading(case, fn, library, lib_obj, ablations, n_bytes, n_ops, dtype, launch):
        ms, names = device_ms(fn, flush, args.iters)
        lib_ms, lib_names = device_ms(library, flush, args.iters)
        abl = {}
        saved = lib_obj._lib
        try:
            for name in ablations:
                lib_obj._lib = variants[(lib_obj.name, name)].load()
                abl[name] = device_ms(fn, flush, args.iters)[0]
        finally:
            lib_obj._lib = saved
        kernel = next((r for n, r in regs.items() if launch["entry"] in n), {})
        occ = resident_ctas(kernel.get("registers", 255), launch["threads"], launch["smem"])
        emit({"reading": "kernel", "case": case, "device_ms": ms, "kernels": names,
              "library_ms": lib_ms, "library_kernels": lib_names,
              "kernel_over_library": ms / lib_ms if lib_ms else None,
              "achieved_GBps": n_bytes / ms / 1e6,
              "bytes_share_of_hbm": n_bytes / ms / 1e-3 / HBM_BYTES_PER_S,
              "achieved_TFLOPs": n_ops / ms / 1e9,
              "ops_share_of_peak": n_ops / ms / 1e-3 / PEAK_OPS[dtype],
              "entry": launch["entry"], "ptxas": kernel, "threads": launch["threads"],
              "smem_bytes": launch["smem"], "ctas": launch["ctas"], **occ,
              "waves": launch["ctas"] / (occ["ctas_per_sm"] * sms),
              "ablation_ms": abl,
              **{k: v for k, v in launch.items() if k not in ("entry", "threads", "smem",
                                                              "ctas")}}, records)

    if "spmm" in wanted:
        gnn_readings(reading, dev, sp_ops, agg_ops, flush, args.iters, records, before)
        product_readings(dev, gemm, records)
        if args.gnn_from:
            here = Path(__file__).resolve().parents[3]
            for label, tree in (("other", args.gnn_from), ("this", here), ("this", here),
                                ("other", args.gnn_from)):
                emit({"reading": "forward", "tree": label, "checkout": str(tree),
                      **forward_times(tree)}, records)
    if "flash_attention" not in wanted:
        return finish(args, records)

    # flash attention, smollm-135m prefill
    b, hq, hkv, s, d = 4, 9, 3, 1024, 64
    q = randn((b, hq, s, d), 7, torch.bfloat16)
    k = randn((b, hkv, s, d), 8, torch.bfloat16)
    v = randn((b, hkv, s, d), 9, torch.bfloat16)
    pairs = s * (s + 1) // 2
    reading("flash smollm_prefill_bf16",
            lambda: flash_attention(q, k, v, causal=True),
            lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True),
            fops.LIBRARY, ("no_softmax", "no_pv", "feed_only"),
            (2 * b * hq * s * d + 2 * b * hkv * s * d) * 2, 4 * d * b * hq * pairs,
            torch.bfloat16,
            # as flash_attention.cu sizes the launch: 64-row q tiles, one
            # consumer warpgroup and a producer warp, 3-stage K/V ring
            {"entry": "flash_tc_kernel<64>", "threads": 160,
             "smem": 1024 + 8192 + 2 * 3 * 8192 + 256, "ctas": b * hq * (s // 64)})

    # gemm: smollm's w_gate (bf16, tensor cores) and cora layer 0 (f32)
    for case, (vv, f, g), dtype in (("w_gate_bf16", (4096, 576, 1536), torch.bfloat16),
                                    ("cora_l0_f32", (2708, 1433, 16), torch.float32)):
        x = randn((vv, f), 1, dtype)
        w = randn((f, g), 2, dtype, 1.0 / np.sqrt(f))
        es = x.element_size()
        for df in DATAFLOWS:
            p = plan(vv, f, g, dtype, df, sms=sms, x_ptr=x.data_ptr(), w_ptr=w.data_ptr())
            if p.route == "tensor_cores":
                # as gemm_dataflow.cu sizes it: 2 consumer warpgroups and a
                # producer warp; 4 ring stages and 9 resident 16 KB tiles
                launch = {"entry": f"tc_kernel<{DATAFLOWS.index(df)}>", "threads": 288,
                          "smem": 1024 + 13 * 16384 + 256}
                ablations = ("tc_no_mma",)
            else:
                entry = ("cc_input_kernel<float>" if df == "input_stationary" else
                         f"cc_w_resident_kernel<float, {str(df == 'output_stationary').lower()}>")
                rows = p.tile_v if df == "input_stationary" else p.tile_g
                launch = {"entry": entry, "threads": 128, "smem": p.slab * rows * 4}
                ablations = (("cc_no_x_fill", "cc_x_fill_only") if df == "input_stationary"
                             else ("cc_no_fill", "cc_no_product"))
            launch["ctas"] = p.grid[0] * p.grid[1]
            reading(f"gemm {case} {df}", lambda df=df: gemm(x, w, dataflow=df),
                    lambda: torch.matmul(x, w), gops.LIBRARY, ablations,
                    (vv * f + f * g + vv * g) * es, 2 * vv * f * g, dtype, launch)

    return finish(args, records)


def finish(args, records) -> int:
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("\n".join(json.dumps(r) for r in records) + "\n")
    return 0


def gnn_readings(reading, dev, sp_ops, agg_ops, flush, iters, records, before) -> None:
    """``spmm`` and ``fused_agg_cmb`` at cora's layer 0 and at chip_smoke.py's
    serving shape (the first batch of the reddit-bin (512, 256) bucket of
    its 32 graphs, seed 0), G = 16, float32.  The least bytes count the x
    rows that non-zero weights reference (a pad row's weight-0 self-loop
    reads none).  ``before``: libraries built from another checkout, timed
    in place of this one's on the same inputs."""
    from ..graphs import TABLE4, bucket_ell, load_dataset, sample_graphs, to_torch_csr

    cora, _ = load_dataset("cora")
    batch, r_idx, r_wts = bucket_ell(sample_graphs(TABLE4["reddit-bin"], 32, seed=0),
                                     (512, 256))
    # (name, graph, ELL, F, G, full readings or only before/after)
    cases = [("cora_l0_f32", cora, *cora.to_ell(128)[:2], 1433, 16, True),
             ("reddit_bin_512x256_l0_f32", batch.graph, r_idx, r_wts,
              TABLE4["reddit-bin"].n_features, 16, True)]
    if before:
        cases += [("cora_vpad2708_l0_f32", cora, *cora.to_ell(1)[:2], 1433, 16, False),
                  ("cora_vpad2708_l1_f32", cora, *cora.to_ell(1)[:2], 16, 8, False)]
    for name, graph, idx, wts, f, g, full in cases:
        idx, wts = torch.as_tensor(idx, device=dev), torch.as_tensor(wts, device=dev)
        rng = np.random.default_rng(1)
        x = torch.as_tensor(rng.normal(size=(graph.n_nodes, f)).astype(np.float32), device=dev)
        w = torch.as_tensor((rng.normal(size=(f, g)) / np.sqrt(f)).astype(np.float32),
                            device=dev)
        a = to_torch_csr(graph, dev)
        real = wts != 0
        live = real.any(dim=1)
        nnz, v_pad = int(real.sum()), idx.shape[0]
        x_bytes = int(torch.unique(idx[real]).numel()) * f * 4
        inputs = {}
        if name.startswith("reddit"):
            # input-side readings: every row cut to its first 16 slots (no
            # hub rows), and the longest row alone (every other row's
            # weights 0: the other CTAs only trim and write zeros)
            cut = wts.clone()
            cut[:, 16:] = 0
            top = int(real.sum(1).argmax())
            alone = torch.zeros_like(wts)
            alone[top] = wts[top]
            inputs.update(rows_cut_to_16_slots=cut, longest_row_alone=alone)
        for label, wv in inputs.items():
            emit({"reading": "input", "case": name, "input": label,
                  "longest_row": int((wv != 0).sum(1).max()),
                  "spmm_device_ms": device_ms(lambda: sp_ops.spmm(idx, wv, x), flush, iters)[0],
                  "fused_agg_cmb_device_ms": device_ms(
                      lambda: agg_ops.fused_agg_cmb(idx, wv, x, w), flush, iters)[0]}, records)
        if before:
            times = {}
            for label, libs in (("before", before), ("after", None)):
                for ops, fn in ((sp_ops, lambda: sp_ops.spmm(idx, wts, x)),
                                (agg_ops, lambda: agg_ops.fused_agg_cmb(idx, wts, x, w))):
                    saved = ops.LIBRARY._lib
                    try:
                        if libs:
                            ops.LIBRARY._lib = libs[ops.LIBRARY.name].load()
                        times[f"{ops.LIBRARY.name}_{label}_device_ms"] = device_ms(
                            fn, flush, iters)[0]
                    finally:
                        ops.LIBRARY._lib = saved
            emit({"reading": "before_after", "case": name, "v_pad": v_pad, "f": f, "g": g,
                  "fused_rows_per_cta": agg_ops.plan(idx, x, w)["rows"], **times}, records)
        if not full:
            continue
        sp = sp_ops.plan(idx, x)
        reading(f"spmm {name}", lambda: sp_ops.spmm(idx, wts, x),
                lambda: torch.sparse.mm(a, x), sp_ops.LIBRARY, ("stage_only",),
                nnz * 8 + x_bytes + v_pad * f * 4, 2 * nnz * f, torch.float32,
                {"entry": f"spmm_ell_kernel<float, {sp['vec']}, {sp['nc']}>",
                 "threads": sp["threads"], "smem": sp["smem"], "ctas": sp["grid"],
                 "plan": sp})
        fu = agg_ops.plan(idx, x, w)
        blocks = int(torch.unique(live.nonzero()[:, 0] // fu["rows"]).numel())
        reading(f"fused_agg_cmb {name}", lambda: agg_ops.fused_agg_cmb(idx, wts, x, w),
                lambda: torch.sparse.mm(a, x) @ w, agg_ops.LIBRARY,
                ("stage_only", "gathers_only", "rows_8", "slices_1"),
                nnz * 8 + x_bytes + f * g * 4 + v_pad * g * 4,
                2 * nnz * f + 2 * int(live.sum()) * f * g, torch.float32,
                {"entry": f"fused_agg_cmb_kernel<float, {fu['vec']}, {fu['nc']}>",
                 "threads": fu["threads"], "smem": fu["smem"],
                 "ctas": fu["grid_x"] * fu["grid_y"] * fu["slices"], "plan": fu,
                 # every row block with a real slot reads all of w from L2
                 "w_l2_bytes": blocks * f * g * 4, "x_bytes": x_bytes})


FORWARD_TIMER = r"""
import json, time, torch
import repro_torch
from repro_torch.core.schedule import ModelSchedule
from repro_torch.gnn import GNNConfig
from repro_torch.graphs import load_dataset

dev = torch.device("cuda")
cora, _ = load_dataset("cora")
cfg = GNNConfig("gcn", f_in=1433, hidden=16, n_classes=8, use_pallas=True)
x = torch.randn((cora.n_nodes, 1433), generator=torch.Generator().manual_seed(10)).to(dev)
rec, params = {}, None
for p, o in (("seq", "AC"), ("seq", "CA"), ("sp_opt", "AC")):
    prog = repro_torch.compile(cfg, graph=cora, device=dev,
                               schedule=ModelSchedule.from_policies(p, o, cfg.dims))
    params = params or prog.init(torch.Generator().manual_seed(0))
    for _ in range(3):
        prog.run(params, x)
    torch.cuda.synchronize()
    walls, evs = [], []
    for _ in range(30):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        prog.run(params, x)
        b.record()
        b.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        evs.append(a.elapsed_time(b))
    rec[f"{p}/{o}"] = {"events_ms": sorted(evs)[15], "wall_ms": sorted(walls)[15]}
print(json.dumps(rec))
"""


def forward_times(tree: Path) -> dict:
    """Kernel-tier forwards at cora of the package in checkout ``tree``,
    timed in a process of its own (``FORWARD_TIMER``)."""
    import os
    import sys

    env = {**os.environ, "PYTHONPATH": str(Path(tree).resolve() / "src")}
    out = subprocess.run([sys.executable, "-c", FORWARD_TIMER], env=env, cwd=tree,
                         capture_output=True, text=True, timeout=600, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def product_readings(dev, gemm, records, iters: int = 30) -> None:
    """Dense products that keep each row's result independent of the
    call's row count, timed and checked for that (see the module note)."""
    from .common import ROW_TILE, row_matmul

    def tiled(x, w, tile):
        n, f = x.shape
        xp = torch.zeros((cdiv(n, tile) * tile, f), device=dev)
        xp[:n] = x
        return torch.cat([xp[s:s + tile] @ w for s in range(0, xp.shape[0], tile)])[:n]

    def batched(x, w, chunk=None):
        n, f = x.shape
        t = cdiv(n, ROW_TILE)
        chunk = chunk or t
        xp = torch.zeros((cdiv(t, chunk) * chunk * ROW_TILE, f), device=dev)
        xp[:n] = x
        return torch.cat([
            torch.bmm(xp[s:s + chunk * ROW_TILE].view(chunk, ROW_TILE, f),
                      w.expand(chunk, f, w.shape[1])).reshape(-1, w.shape[1])
            for s in range(0, xp.shape[0], chunk * ROW_TILE)])[:n]

    products = {
        f"row_matmul (tile {ROW_TILE})": row_matmul,
        **{f"tile {t}": (lambda x, w, t=t: tiled(x, w, t)) for t in (64, 512, 2048)},
        "bmm over the tiles": batched,
        "bmm, 32 tiles a call": lambda x, w: batched(x, w, 32),
        "gemm kernel": gemm,
        "torch.matmul": torch.matmul,
    }

    def event_ms(fn):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        ts = []
        for _ in range(iters):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            ts.append(a.elapsed_time(b))
        return float(np.median(ts))

    for case, (v, f, g) in {"cora_l0": (2708, 1433, 16),
                            "reddit_bin_512x256_x64_l0": (32768, 3782, 16)}.items():
        gen = torch.Generator().manual_seed(3)
        x = torch.randn((v, f), generator=gen).to(dev)
        w = (torch.randn((f, g), generator=gen) / f ** 0.5).to(dev)
        for name, fn in products.items():
            full = fn(x, w)
            stable = all(torch.equal(fn(x[s:s + n], w), full[s:s + n])
                         for n in (1, 100, 300, 1024) for s in (0, 5))
            emit({"reading": "dense_product", "case": case, "shape": [v, f, g],
                  "product": name, "direct_ms": event_ms(lambda: fn(x, w)),
                  "rows_bit_stable": stable,
                  "max_abs_vs_matmul": float((full - x @ w).abs().max())}, records)


if __name__ == "__main__":
    raise SystemExit(main())
