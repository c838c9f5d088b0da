"""Drive the PyTorch port on one CUDA card, end to end; exit non-zero on
any failure.

    python3 chip_smoke.py
    python3 chip_smoke.py --only train         # phase 8 alone, in a fresh process
    python3 chip_smoke.py --only lm_families   # phase 11 alone, in a fresh process
    python3 chip_smoke.py --only sharded       # phase 12 alone (on 4 cards: also one process a card)
    python3 chip_smoke.py --only dryrun        # phase 13 alone
    python3 chip_smoke.py --only lanes         # phase 14 alone (the GNN kernels built first)
    python3 chip_smoke.py --only captured      # phase 15 alone (every kernel built first)
    python3 chip_smoke.py --only pp            # phase 7 alone (the GNN kernels built first)

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
                smollm-135m prefill (f32, bf16), a ragged S, D = 128, and
                recurrentgemma's local blocks (D 256, MQA 10 / 1, S 4096,
                window 2048, bf16, beside SDPA under the same boolean mask);
                ``gemm`` under each dataflow at the reference's test shapes,
                cora's layer-0 combination, smollm's ``w_gate``, a bf16
                shape TMA refuses and one past a resident slab.  A kernel
                and its library call are timed in alternation, L2 flushed
                before each: as direct calls (``ms``, ``library_ms``) and
                as CUDA-graph replays (``graph_ms``, ``library_graph_ms``).
3. main       — ``repro_torch.compile`` on cora at the paper's Kipf widths
                (1433 -> 16 -> 8): the searched schedule and forced
                (sp_opt, AC), (seq, AC), (seq, CA) schedules, each on the
                kernel tier (seq: ``spmm``, its products on ``gemm``) and
                against its eager twin on the card.
4. serving    — 32 reddit-bin graphs: bucketize -> assemble -> compile per
                bucket -> bind -> batched run with mean readout.  Each batch
                is held against its eager twin, the fused kernel against its
                plain version at the batch's shapes, and every per-graph
                output against a solo run of that graph.
5. engine     — the ported serving runtime (``repro_torch.runtime``), driven
                as a user drives it, at full width: (a) ``InferenceEngine``
                (GCN 3782 -> 16 -> 8, the kernel tier, mean readout) serves
                64 reddit-bin requests, each output held against a solo
                kernel-tier run and the eager tier, then the same stream
                again (no new build, bit-identical); (b) a second engine
                under seeded faults and one ``kill_pallas`` window: every
                fault a typed non-ok status, every ok output bit-identical
                to (a)'s, every degraded one within 2e-4; (c) cora at 1433
                -> 16 -> 8 made oversized (``max_nodes=1024``) and served
                by ``row_stream`` partitions, bit-identical to the
                monolithic kernel-tier forward under sp_opt/AC and under
                seq/CA; (d) ``calibrate()`` on the card, the fitted model
                resolved by an engine on its store, a measured
                ``rerank_topk``, then no build on the request path.
                Healthy parts assert no downgrade, every result ``ok`` from
                the top tier, and a kernel launch count that moved.  A
                revived engine on a store is the restart lane's drill
                (phase 14).
6. async      — the async front-end (``AsyncEngine`` on ``[cuda:0]``,
                same model and weights as ``engine``): the 64 requests as a
                blast, bit-identical to the sync engine, twice (no build
                the second time), then under one ``torch.profiler`` window
                (device busy share, kernel time by name, host-to-device
                copy time beside kernels), a revived front-end
                on the engine's store (``precompile()``, then no mapper
                search, no build), admission (a malformed request rejected
                at once; ``max_queue_graphs`` shedding with
                ``retry_after_s``), and cora made oversized through
                ``serve_partitioned``, bit-identical to (c).  Per batch,
                the flusher's staging seconds beside the worker's forward
                seconds.  The paced stream is the async lane's (phase 14).
7. pp         — the paper's Parallel Pipeline on two CUDA streams of one
                card (``mesh=[cuda:0, cuda:0]``) at cora layer 0 and the
                engine's (512, 256) batch's layer 0 (256 bands): eager tier
                bit-identical to the one-device fallback, kernel tier
                (``spmm`` + ``gemm``) within 2e-4; the three times, and
                whether the two streams' kernels overlap in the trace.
                Then ``Program.run`` under a ``pp`` schedule on that mesh,
                cora GCN 1433 -> 16 -> 8 and the batch at the engine's
                dims, on both tiers, one CUDA graph per key (both streams
                inside it): replays ``torch.equal`` to the uncaptured
                forward, the eager tier to the fallback, the kernel tier
                within 2e-4, ``spmm`` and ``gemm`` once a band a replay;
                replay and uncaptured ms.
8. train      — training on the card, which reaches no kernel (the
                reference's training reaches no ``pallas_call``), each step
                a captured CUDA graph where the reference jits it: cora GCN
                1433 -> 16 -> 8 through ``Program.train_step`` (searched
                schedule, 2 epochs x 20 steps, lr 0.05: one capture, the
                second epoch builds nothing, the first 3 steps
                ``torch.equal`` to the uncaptured step, the loss falls,
                step 1 within 2e-4 of the CPU's, the kernel tier's step
                refused with no launch); ``repro_torch.launch.train.main``
                at smollm-135m's published widths (batch 8, seq 512),
                captured: 30 steps with a checkpoint every 10, and the same
                run restarted from its step-20 checkpoint, ``torch.equal``
                to it; one step run twice, each from its own copy of one
                state, bit-identical; 3 captured steps ``torch.equal`` to
                the uncaptured step (params, moments, step counter).  For
                cora and smollm, captured and uncaptured: warm step ms
                (CUDA events), kernels a step and device busy share (one
                profiled step), peak memory allocated, and the graphs'
                pool reserved; the process's threads, allocator and
                garbage-collector state at the phase's start.
                recurrentgemma-2b (3 layers) and xlstm-1.3b (8 layers) at
                published widths, batch 2 x 128: 3 captured steps
                ``torch.equal`` to uncaptured, warm step ms of each.
                granite-moe-1b-a400m at its published widths and depth
                (batch 2, seq 512), captured: 3 steps ``torch.equal`` to
                uncaptured, warm step ms of each, live peak and graph pool,
                and step 8 run from the step-7 state saved and restored by
                the ``Checkpointer`` and from a second copy, each
                ``torch.equal`` to the straight one; cora
                GCN under a ``pp`` schedule trained through the two-stream
                Parallel Pipeline (``mesh=[cuda:0, cuda:0]``, and two cards
                where there are two): the loss equal to ``mesh=None``'s,
                the parameters within 2e-4, a repeated step bit-identical;
                the two-stream step captured, its 3 steps ``torch.equal``
                to the uncaptured step, warm ms of both.
9. gemm       — the dataflow GEMM's own entry point, the public op
                ``gemm``, called once per dataflow on cora's layer-0
                combination (on the model path it is the kernel tier's
                dense product: seq's combination, SAGE / GIN self terms).
10. lm_serve  — ``repro_torch.launch.serve.generate`` on smollm-135m at full
                width (batch 4, 1024-token prompts, 32 greedy tokens), with
                the prefill logits held against the plain-version twin in
                f32 and in bf16, then a depth-2 forward of the other dense
                archs at full width against their twins.
11. lm_families — granite-moe-1b-a400m, recurrentgemma-2b and
                xlstm-1.3b at full published width in bf16 through
                ``generate`` (batch 2, 128-token prompts, 8 greedy
                tokens): flash launches a forward equal to the config's
                attention layers (24, 8, 0), prefill logits against the
                plain route and 8 decode steps against the prefill (relative
                L2), prefill / replay / decode walls against their bounds,
                peak memory; recurrentgemma also at 1 x 4096 tokens, where
                its 2048 window masks.  granite-moe decodes captured: every
                position's logits ``torch.equal`` to ``decode_step`` run
                uncaptured, the greedy tokens equal, both walls; its
                grouped expert product against the per-expert loop (bf16
                relative L2 ``MOE_BF16_REL_L2``, f32 ``TOL_MOE_F32``), and
                ``moe_ragged`` under ``set_sync_debug_mode("error")``.
12. sharded   — the LM on a ``(data, model)`` device mesh (DTensor, one
                process a card): granite-moe-1b-a400m at full width, bf16,
                on a (1, 1) NCCL mesh in this process — the sharded prefill
                (``moe_ep``, flash through ``local_map``, 24 launches),
                each layer's flash output held on its local q, k, v against
                the plain version, the logits against the plain route (held
                in f32, and in bf16 on the kernel route's expert choices;
                read in bf16 with each route's own choices, beside the
                count of choices that changed), an 8-token
                sharded prefill against the unsharded one, its decode
                through one captured graph over the DTensor cache
                ``torch.equal`` to uncaptured (logits and cache); the
                sharded AdamW step at batch 2 x 512 captured: 3 steps
                ``torch.equal`` to ``TrainStep.eager`` leaf by leaf, an
                eager step under ``set_sync_debug_mode("error")``, a
                checkpoint round trip and the resumed captured step
                ``torch.equal`` to the straight one; DTensor's host cost as
                smollm-135m's step on the (1, 1) mesh, captured and eager,
                against the same step unsharded.  With two or more cards,
                one process a card (4 cards: meshes (1, 4) and (2, 2)): EP
                over the cards against the (1, 1) logits, each rank's flash
                on its own heads held as above, f32 data parallelism
                against one card's whole batch, each rank's captured step
                ``torch.equal`` to its eager twin, a resumed step
                ``torch.equal``, a checkpoint written on every card
                restored on half of them and on one, per-rank step walls
                and a profiled step's NCCL time.  On one card that part
                prints that it did not run.
13. dryrun    — the multi-pod dry-run (``launch/dryrun.py``), its traces on
                the CPU in two subprocesses started with the run (a fake
                process group cannot share this process with NCCL): (a)
                smollm-135m decode_32k on 16 x 16 and 2 x 16 x 16 and
                granite-moe-1b-a400m train_4k on 16 x 16, their three
                roofline terms on the H100's spec constants and the trace
                seconds; (b) granite-moe at the sharded phase's shape
                (published widths, bf16, 2 x 512) traced on a fake (1, 1)
                mesh and run on a (1, 1) NCCL mesh on this card, train step
                (uncaptured) and kernel-route prefill: argument bytes and local FLOPs
                (``FlopCounterMode`` on a warm step; flash through its
                registered formula) held equal, flash launched once an
                attention layer; the predicted peak against
                ``max_memory_allocated`` and the roofline bound against the
                warm wall read, not held.
14. lanes     — run after ``pp``: the port's benchmark lanes and examples
                (``repro_torch.bench``, ``repro_torch.examples``) as a user
                runs them: the plain serve lane at full size (1000
                requests, GCN 32 -> 16 -> 8, engine against naive per-graph
                compile + run), chaos, restart, async (two workers on two
                streams of this card) and giant at their smoke sizes, then
                quickstart, gnn_parallel_pipeline and serve_async.  Each
                lane holds its own correctness guards (engine vs naive
                1e-5, bit-identity across chaos, restart, async and giant,
                typed statuses, no build warm, no downgrade, no ``nvcc`` on
                revival) and, in the serve and giant lanes, the kernel tier
                against the eager tier on the same weights at 2e-4 (the
                whole 1000-request stream; every giant graph); the async
                lane also reports its blast against a sync engine warmed
                by traffic alone (bitwise agreement counted, held at
                2e-4); graphs/s, p50 / p99 and each speed ratio are
                printed beside the lane's floor (read here, enforced by the
                lane's CLI); spmm, fused_agg_cmb and gemm_dataflow must
                each launch.
15. captured  — run after ``engine``: ``Program.run`` and the LM's
                ``decode_step`` as CUDA graphs (the port's ``jax.jit``;
                ``repro_torch.capture``).  (a) cora GCN 1433 -> 16 -> 8
                under seq/AC, sp_opt/AC and seq/CA on both tiers: two runs
                (the first captures) against the uncaptured forward of the
                same executable called directly, ``torch.equal`` on the
                kernel tier (the eager tier is read: cuBLAS may choose
                otherwise under capture; held at 2e-4), one capture, a
                replay's launches equal to what its capture recorded, and
                the replay's host wall beside the direct call's; (b) the
                serving phase's reddit-bin batches under mean, max and sum
                readouts, each replay ``torch.equal`` to its uncaptured
                run, and a second batch of one bucket (its graphs in
                reverse order, other features) through the same graph:
                no capture, equal to its own uncaptured run, the first
                batch's output untouched; (c) cora oversized through
                ``serve_partitioned`` (each ``row_stream`` partition a
                captured executable), bit-identical to the monolith's
                uncaptured forward; (d) a reddit-bin engine served once,
                revived on its store and precompiled (the captures; memory
                reserved before and after), then the 64 requests with no
                capture on the request path; (e) smollm-135m at full width
                (4 x 1024, bf16): the prompt replayed through the captured
                step and eagerly, the caches compared (bitwise count, held
                at 2e-2), 32 greedy tokens from each and from
                ``generate``, identical; the replay walls side by side.
                A capture that fails fails the run: nothing falls back.

Launch counts are set to 0 just before phases 3-15 (each part of the engine,
captured and async phases that serves the main path) and read just after; a
replay of a captured graph counts the launches its capture recorded;
the ``{"kernels": [...]}`` line reports them.  The last line is
``{"ok": true, "device": {...}}``; it is printed only when every phase
passed.  Weights and data are random, made from fixed seeds.
"""
import atexit
import contextlib
import gc
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import threading
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
# a float32 decode step against the float32 prefill at the same position,
# as a relative L2 error: two sum orders of the same f32 function (flash
# and the cache's plain attention, the doubling and the stepwise RG-LRU
# scan, the chunkwise and the recurrent mLSTM); a state not carried between
# steps moves the logits by order 1.  xlstm-1.3b at random init amplifies
# a rounding through its 48 exponentially gated blocks, more with each
# position: the reference's own decode and forward differ by up to 1.2e-4
# at d_model 512 x 16 layers in f32 on a CPU, and the port's by up to
# 4.8e-3 at full width on the card (first reading), so its limit is 1e-2.
# In bf16 the MoE's top-8 routing can flip between the two paths and the
# xLSTM's logits move by ~45% under one-ulp noise on its embeddings (the
# reference's, on a CPU), so bf16 decode is read, not held.
DECODE_F32_REL_L2 = {"xlstm-1.3b": 1e-2}
# f32 gradients on a (2, 2) mesh (data and tensor parallel) against the whole
# batch on one card, as the largest relative L2 error of one leaf, with every
# token sent to every expert: the same f32 function summed in another order
# (per-shard partial sums, all-reduces; the CPU's reduced run reads 7.6e-7).
# With the published top-8 a near-tie routed one way on one side and the
# other way on the other moves an expert's gradient by a token's share
# (1.2e-3 per leaf on H100s at full width), so top-8 is read, not held.
DP_GRAD_REL_L2 = 1e-4
# granite-moe's sharded prefill (moe_ep, flash through local_map) against
# the same mesh's plain route, and on (1, N) cards against (1, 1), in
# float32, as a relative L2 error: two sum orders of one f32 function.  In
# bf16 the two sides' roundings (flash against the plain softmax; the
# row-parallel partial sums all-reduced over the cards) flip some of the
# 1,024 tokens' top-8 expert choices in 24 layers, and a flip under the
# capacity limit moves the tokens queued behind it: 0.0300 on one H100
# (2,824 of 196,608 choices changed, from layer 0 on), with the unsharded
# routes at 0.0283 at the same shape.  So in bf16 the held checks are each
# layer's flash call on its own local q, k, v (``held_flash_islands``),
# where no routing sits between the two sides, and the logits against the
# plain route rerun on the kernel route's expert choices, at
# ``LM_BF16_REL_L2`` (0.0104 on one H100); the free-routing logits are read.
SHARDED_F32_REL_L2 = 1e-3
DECODE_F32_REL_L2_DEFAULT = 1e-3
# granite-moe's grouped expert product (three grouped GEMMs over the
# expert-sorted rows, the ends read on the device) against the per-expert
# loop it replaced, on the same rows and weights: bf16 as a relative L2
# error (the two may accumulate a row's products in another order, each
# rounded to bf16 once), float32 at the reference's MoE tolerance
# (tests/test_models.py)
MOE_BF16_REL_L2 = 2e-2
TOL_MOE_F32 = dict(rtol=1e-4, atol=1e-5)
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
            inst = {fn: c for fn, c in sass.items() if tc in fn}  # flash's pingpong too
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


def flash_bound(b, hq, hkv, sq, sk, d, dtype, causal, window=0) -> tuple[float, str]:
    """Bytes: q, k, v read once, out written once.  Operations: 2 D for
    q.k and 2 D for p.v per (query, key) pair the mask lets through
    (query i sees keys max(0, i - window + 1) .. i under a window)."""
    span = lambda i: min(i + 1, sk, window) if window > 0 else min(i + 1, sk)  # noqa: E731
    pairs = sum(span(i) for i in range(sq)) if causal else sq * sk
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

    from repro_torch.kernels.flash_attention import (
        attend,
        attend_chunked,
        flash_attention,
        flash_attention_ref,
        route,
    )
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

    # recurrentgemma-2b's local blocks: D 256, MQA 10 / 1, window 2048, at a
    # length where the window masks (the model route, positions 0..S-1)
    b, s_len, hq, hkv, d, win = 1, 4096, 10, 1, 256, 2048
    q = randn((b, s_len, hq, d), 40, dev).to(torch.bfloat16)
    k = randn((b, s_len, hkv, d), 41, dev).to(torch.bfloat16)
    v = randn((b, s_len, hkv, d), 42, dev).to(torch.bfloat16)
    pos = torch.arange(s_len, dtype=torch.int32, device=dev)
    out = attend(q, k, v, pos, pos, win)
    ref = attend_chunked(q, k, v, pos, pos, win)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(out).all()), "d256: non-finite output")
    torch.testing.assert_close(out, ref, **TOL_BF16)
    ref32 = attend_chunked(q.float(), k.float(), v.float(), pos, pos, win)
    row = float(((out.float() - ref32).norm(dim=-1) / ref32.norm(dim=-1)).max())
    check(row <= FLASH_ROW_REL_L2, f"d256: row relative L2 {row} > {FLASH_ROW_REL_L2}")
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    i, j = pos.long()[:, None], pos.long()[None, :]
    mask = (j <= i) & (j > i - win)  # SDPA's boolean mask: True = attend
    fb, fby = flash_bound(b, hq, hkv, s_len, s_len, d, torch.bfloat16, True, win)
    d256 = {
        **timed(lambda: attend(q, k, v, pos, pos, win),
                lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                       enable_gqa=True),
                lambda: attend_chunked(q, k, v, pos, pos, win), flush),
        "bound_ms": fb, "bound_by": fby,
        "max_abs_err": float((out.float() - ref.float()).abs().max()),
        "row_rel_l2_vs_f32": row,
        "route": route(torch.bfloat16, [(t.shape, t.stride()) for t in (qt, kt, vt, qt)],
                       [t.data_ptr() for t in (q, k, v, q)]),
    }
    check(d256["route"] == "tensor_cores", f"d256 took the {d256['route']} route")
    emit({"phase": "kernels", "kernel": "flash_attention",
          "case": "recurrentgemma_local_d256_bf16 (B 1, Hq 10, Hkv 1, S 4096, D 256, "
                  "window 2048)", "tol": TOL_BF16, "row_rel_l2_limit": FLASH_ROW_REL_L2,
          **d256, "ok": True})
    flash["cases"] = {"smollm_prefill_bf16": {k: flash[k] for k in flash if k != "case"},
                      "recurrentgemma_local_d256_bf16": d256}
    del q, k, v, out, ref, ref32, mask

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
    runs = [("searched", None, ("fused_agg_cmb",))] + [
        (f"forced {p}/{o}", ModelSchedule.from_policies(p, o, cfg.dims),
         ("fused_agg_cmb",) if p == "sp_opt" else ("spmm", "gemm_dataflow"))
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
        for k in expect:
            check(counts[k] > 0, f"{label}: {k} never launched")
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


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def reddit_requests(n, f_in, seed):
    """``n`` seeded reddit-bin graphs with seeded features, as requests."""
    from repro_torch.graphs import TABLE4, sample_graphs
    from repro_torch.runtime import Request

    return [Request(graph=g, x=np.random.default_rng(seed * 1000 + i).normal(
        size=(g.n_nodes, f_in)).astype(np.float32), rid=i)
        for i, g in enumerate(sample_graphs(TABLE4["reddit-bin"], n, seed=seed))]


def same_outputs(got, want, what, exact=True) -> float:
    worst = 0.0
    for a, b in zip(got, want):
        check(a.rid == b.rid, f"{what}: rid {a.rid} against {b.rid}")
        if exact:
            check(np.array_equal(a.output, b.output), f"{what}: rid {a.rid} differs")
        else:
            np.testing.assert_allclose(a.output, b.output, **TOL_PATH)
        worst = max(worst, float(np.abs(a.output - b.output).max()))
    return worst


def phase_engine(dev, counters, n_requests=64) -> tuple[dict, dict]:
    """The ported serving runtime, as a user drives it: (a) serve, (b)
    chaos, (c) giant, (d) calibrate (see the module docstring).  Returns
    the launches of (a) and (c), and what the ``async`` phase holds its
    results against (the store is left for it)."""
    import dataclasses

    import repro_torch
    from repro_torch.bench.serve_gnn import check_top_tier
    from repro_torch.core.calibrate import backend_fingerprint, calibrate
    from repro_torch.core.hw import DEFAULT_ACCEL
    from repro_torch.core.schedule import ModelSchedule
    from repro_torch.gnn import GNNConfig
    from repro_torch.graphs import TABLE4, BucketPolicy, load_dataset
    from repro_torch.graphs.partition import plan_partition
    from repro_torch.kernels.fused_agg_cmb.ops import plan as fused_plan
    from repro_torch.runtime import (FaultInjector, FaultRule, InferenceEngine,
                                     ProgramStore, Request, RetryPolicy, kill_pallas)

    t_phase = time.perf_counter()
    launches = {k: 0 for k in counters}

    def count(fn):
        reset_counts(counters)
        out = fn()
        sync(dev)
        for k, c in counters.items():
            launches[k] += c.launches
        return out, {k: c.launches for k, c in counters.items()}

    store_dir = Path(__file__).resolve().parent / "build" / "engine_store"
    shutil.rmtree(store_dir, ignore_errors=True)
    f_in = TABLE4["reddit-bin"].n_features
    dims = [(f_in, 16), (16, 8)]
    reqs = reddit_requests(n_requests, f_in, seed=2)

    def engine(params=None, **kw):
        return InferenceEngine(dims, params, use_pallas=kw.pop("use_pallas", True),
                               readout="mean", device=dev, **kw)

    # (a) serve, then the same stream again
    eng = engine(store=ProgramStore(store_dir / "serve"))
    params = eng.init(torch.Generator().manual_seed(3))
    reserved0 = torch.cuda.memory_reserved(dev)
    tc_cold = repro_torch.trace_count()
    t0 = time.perf_counter()
    first, counts = count(lambda: eng.submit(reqs))
    cold_s = time.perf_counter() - t0
    captures = repro_torch.trace_count() - tc_cold
    reserved1 = torch.cuda.memory_reserved(dev)
    check(counts["fused_agg_cmb"] > 0 or counts["spmm"] > 0,
          f"engine serve launched no kernel: {counts}")
    check_top_tier(first, eng, "engine serve")
    cold = eng.stats()
    solo = engine(params, policy=BucketPolicy(max_graphs=1))
    solo_res = solo.submit(reqs)
    check_top_tier(solo_res, solo, "engine solo")
    err_solo = same_outputs(first, solo_res, "serve vs solo", exact=False)
    eager = engine(params, use_pallas=False)
    eager_res = eager.submit(reqs)
    err_eager = same_outputs(first, eager_res, "serve vs eager", exact=False)
    t0 = time.perf_counter()
    eager.submit(reqs)
    eager_warm_s = time.perf_counter() - t0
    tc0 = repro_torch.trace_count()
    t0 = time.perf_counter()
    again, again_counts = count(lambda: eng.submit(reqs))
    warm_s = time.perf_counter() - t0
    check(repro_torch.trace_count() == tc0, "the warm stream built executables")
    check(again_counts["fused_agg_cmb"] + again_counts["spmm"] > 0,
          f"the warm stream's replays counted no launch: {again_counts}")
    check_top_tier(again, eng, "engine serve again")
    same_outputs(again, first, "serve again")
    warm = eng.stats()
    walls = eng.monitor.times
    emit({"phase": "engine", "part": "serve", "dataset": "reddit-bin", "dims": dims,
          "requests": n_requests, "buckets": cold.n_buckets,
          "batches_per_pass": cold.n_batches, "cold_wall_s": cold_s,
          "warm_wall_s": warm_s, "warm_graphs_per_s": n_requests / warm_s,
          "cold_p50_ms": cold.p50_ms, "cold_p99_ms": cold.p99_ms,
          "p50_ms_both_passes": warm.p50_ms, "p99_ms_both_passes": warm.p99_ms,
          "warm_batch_walls_ms": [w * 1e3 for w in walls[len(walls) // 2:]],
          "cold_batch_walls_ms": [w * 1e3 for w in walls[: len(walls) // 2]],
          "mapper_s": cold.search_s, "mapper_searches": cold.n_searches,
          "build_s": cold.trace_s, "captures_first_pass": captures,
          "memory_reserved_bytes_cold_pass": [reserved0, reserved1],
          "launches_first_pass": counts, "launches_second_pass": again_counts,
          "new_builds_second_pass": 0, "second_pass_bit_identical": True,
          "max_abs_err_vs_solo": err_solo, "max_abs_err_vs_eager": err_eager,
          "eager_tier_warm_wall_s": eager_warm_s, "tol": TOL_PATH, "ok": True})

    # (b) chaos: seeded faults and a kernel-backend outage
    # a seeded background mix, plus one sticky kernel fault (its batch
    # fails on every tier, then runs solo: rid 5 fails alone), one transient
    # NaN (served one tier down) and one latency spike
    inj = FaultInjector(seed=5, p_exception=0.1, p_nan=0.05, p_latency=0.05,
                        latency_s=0.02, rules=[
                            FaultRule(kind="exception", rid=5),
                            FaultRule(kind="nan", rid=9, max_fires=1),
                            FaultRule(kind="latency", batch_index=0, max_fires=1)])
    chaos = engine(params, fault_injector=inj, retry=RetryPolicy(max_retries=0))
    half = n_requests // 2
    res_b = chaos.submit(reqs[:half])
    with kill_pallas():
        res_b += chaos.submit(reqs[half:])
    by_status = {}
    for r, ref in zip(res_b, first):
        by_status[r.status] = by_status.get(r.status, 0) + 1
        if r.status == "ok":
            check(r.tier == "pallas+searched" and np.array_equal(r.output, ref.output),
                  f"chaos: ok rid {r.rid} differs from the healthy run")
        elif r.status == "degraded":
            check(r.tier != "pallas+searched", f"chaos: rid {r.rid} degraded on the top tier")
            np.testing.assert_allclose(r.output, ref.output, **TOL_PATH)
        else:
            check(r.status == "failed" and r.error_type in (
                "kernel_fault", "numerical_fault"), f"chaos: rid {r.rid}: {r.status} "
                  f"{r.error_type}")
    st = chaos.stats()
    faults = inj.counts()
    check(faults.get("exception", 0) > 0 and faults.get("nan", 0) > 0,
          f"chaos: the injector fired {faults}")
    check(res_b[5].status == "failed" and res_b[5].error_type == "kernel_fault",
          f"chaos: the poisoned rid 5 ended {res_b[5].status}")
    check(st.n_degraded + st.n_failed > 0 and st.n_downgrades > 0,
          f"chaos: no fault landed as a non-ok status ({st.as_dict()})")
    emit({"phase": "engine", "part": "chaos", "injected": faults,
          "statuses": by_status, "errors": st.errors, "downgrades": st.n_downgrades,
          "retries": st.n_retries, "solo_retries": st.n_solo_retries,
          "stragglers": st.n_stragglers, "ok_bit_identical_to_serve": True, "ok": True})

    # (c) giant: cora partitioned into row_stream closures
    cora, _ = load_dataset("cora")
    gdims = [(1433, 16), (16, 8)]
    hw = dataclasses.replace(DEFAULT_ACCEL, gb_capacity_bytes=None)
    gpol = BucketPolicy(max_nodes=1024)
    x = np.random.default_rng(44).normal(size=(cora.n_nodes, 1433)).astype(np.float32)
    gplan = plan_partition(cora, gdims, hw, objective="edp", allow_monolithic=False,
                           max_block_rows=gpol.max_nodes)
    giant_out = None
    giant_rec = {"phase": "engine", "part": "giant", "graph": "cora", "dims": gdims,
                 "plan": gplan.kind, "block_rows": gplan.block_rows,
                 "candidates": [c.as_dict() for c in gplan.candidates]}
    gparams = None
    for policy, order, kernels in (("sp_opt", "AC", ("fused_agg_cmb",)),
                                   ("seq", "CA", ("spmm", "gemm_dataflow"))):
        sched = ModelSchedule.from_policies(policy, order, gdims)
        giant = InferenceEngine(gdims, gparams, use_pallas=True, readout=None,
                                schedule=sched, hw=hw, objective="edp", policy=gpol,
                                partition_oversized=True, device=dev)
        if gparams is None:
            gparams = giant.init(torch.Generator().manual_seed(4))
        (res,), counts = count(lambda: giant.submit([Request(graph=cora, x=x)]))
        check(res.status == "ok" and res.tier == "pallas+searched" and
              res.plan == "row_stream" and res.n_partitions > 1,
              f"giant {policy}/{order}: {res.status} {res.tier} {res.plan} {res.error}")
        check(giant.stats().n_downgrades == 0, "giant: downgraded")
        mono = repro_torch.compile(
            GNNConfig("gcn", 1433, 16, 8, use_pallas=True), graph=cora,
            schedule=sched, device=dev).run(gparams, x).cpu().numpy()
        same = bool(np.array_equal(res.output, mono))
        giant_rec[f"{policy}/{order}"] = {
            "n_partitions": res.n_partitions, "partition_wall_s": res.partition_wall_s,
            "bit_identical_to_monolithic": same,
            "max_abs_diff": float(np.abs(res.output - mono).max()), "launches": counts}
        np.testing.assert_allclose(res.output, mono, **TOL_PATH)
        for k in kernels:
            check(counts[k] > 0, f"giant {policy}/{order}: {k} never launched {counts}")
        check(same, f"giant {policy}/{order}: the partitioned output is not "
                    "bit-identical to the monolithic kernel-tier forward")
        if giant_out is None:
            giant_out = res.output
    w0 = torch.empty((1433, 16), device=dev)
    x0 = torch.empty((1, 1433), device=dev)
    giant_rec["fused_rows_per_cta_l0"] = {
        f"v_pad {v}": fused_plan(torch.empty((v, 72), dtype=torch.int32, device=dev), x0,
                                 w0)["rows"] for v in (2708, 4096)}
    emit({**giant_rec, "ok": True})

    # (d) calibrate on the card; an engine on the store resolves the model
    cal_store = ProgramStore(store_dir / "cal")
    fit = calibrate(store=cal_store, fast=True, use_pallas=True, device=dev,
                    warmup=1, iters=6)
    fp = backend_fingerprint(dev)
    check(fit.model.backend == fp and cal_store.load_latency_model(fp) == fit.model,
          f"calibrate stored {fit.model.backend!r}, not under {fp!r}")
    ce = engine(params, store=ProgramStore(store_dir / "cal"))
    check(ce.hw.latency == fit.model, "the engine did not resolve the fitted model")
    few = reqs[:16]
    ce.submit(few)
    ce.submit(few)
    rr = ce.rerank_topk(top_k=2, max_shapes=2, warmup=1, iters=3)
    tc0 = repro_torch.trace_count()
    res_e = ce.submit(few)
    check(repro_torch.trace_count() == tc0, "rerank left builds on the request path")
    check_top_tier(res_e, ce, "engine after rerank")
    emit({"phase": "engine", "part": "calibrate", "backend": fp,
          "points": fit.n_points, "fit_error_median": fit.error_median,
          "fit_error_max": fit.error_max, "bw_mult": fit.bw_mult,
          "residuals": list(fit.errors), "per_family": fit.per_family,
          "model": dataclasses.asdict(fit.model), "rerank": rr.as_dict(),
          "request_path_builds_after_rerank": 0, "ok": True})
    print(f"engine phase wall {time.perf_counter() - t_phase:.3f} s", flush=True)
    held = {"store_dir": store_dir, "dims": dims, "params": params, "requests": reqs,
            "sync": first, "sync_warm_graphs_per_s": n_requests / warm_s,
            "giant": (cora, x, gdims, gparams, hw, gpol, giant_out)}
    return launches, held


def only_executable(prog):
    """The one executable of a Program's cache (a fresh Program, one shape
    key)."""
    (exe,) = prog._exec_cache.values()
    return exe


def compared(got, want) -> dict:
    """Bitwise agreement and the largest difference of two tensors (or
    lists of tensors)."""
    pairs = list(zip(got, want)) if isinstance(got, (list, tuple)) else [(got, want)]
    equal = sum(int((a == b).sum()) for a, b in pairs)
    total = sum(a.numel() for a, _ in pairs)
    worst = max(float((a.float() - b.float()).abs().max()) if a.numel() else 0.0
                for a, b in pairs)
    return {"bit_identical": equal == total, "elements_equal": equal, "elements": total,
            "max_abs_diff": worst}


def host_ms(fn, n=5) -> float:
    """Median host wall of ``fn()`` in ms, each call ended by a
    synchronise (one warm-up call first)."""
    fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(walls)


def phase_captured(dev, counters, n_requests=64) -> dict:
    """``Program.run`` and the LM's ``decode_step`` as CUDA graphs (see the
    module docstring).  Returns the launches of the captured runs."""
    import dataclasses

    import repro_torch
    from repro_torch.api import CapturedForward
    from repro_torch.core.hw import DEFAULT_ACCEL
    from repro_torch.core.schedule import ModelSchedule
    from repro_torch.gnn import GNNConfig
    from repro_torch.graphs import TABLE4, BucketPolicy, assemble, load_dataset, micro_batches
    from repro_torch.runtime import InferenceEngine, ProgramStore, Request

    t_phase = time.perf_counter()
    launches = {k: 0 for k in counters}

    def counted(fn):
        reset_counts(counters)
        out = fn()
        sync(dev)
        counts = {k: c.launches for k, c in counters.items()}
        for k in launches:
            launches[k] += counts[k]
        return out, counts

    # (a) cora, GCN 1433 -> 16 -> 8: each forced dataflow on both tiers;
    # the replays against the uncaptured forward called directly
    cora, _ = load_dataset("cora")
    x = randn((cora.n_nodes, 1433), 20, dev)
    params = None
    for policy, order in (("seq", "AC"), ("sp_opt", "AC"), ("seq", "CA")):
        for use_pallas in (True, False):
            cfg = GNNConfig("gcn", f_in=1433, hidden=16, n_classes=8, use_pallas=use_pallas)
            prog = repro_torch.compile(cfg, graph=cora, device=dev,
                                       schedule=ModelSchedule.from_policies(policy, order,
                                                                            cfg.dims))
            if params is None:
                params = prog.init(torch.Generator().manual_seed(5))
            tc0 = repro_torch.trace_count()
            first, first_counts = counted(lambda: prog.run(params, x))
            again, replay_counts = counted(lambda: prog.run(params, x))
            check(repro_torch.trace_count() == tc0 + 1, f"cora {policy}/{order}: "
                  f"{repro_torch.trace_count() - tc0} captures, not 1")
            exe = only_executable(prog)
            check(isinstance(exe, CapturedForward) and exe.graph is not None,
                  f"cora {policy}/{order}: the executable is not a CUDA graph")
            direct = exe.eager(params, prog.adj.indices, prog.adj.weights, x, None)
            sync(dev)
            tally = exe.graph.launches
            check(replay_counts == {k: tally.get(counters[k].__name__, 0) for k in counters},
                  f"cora {policy}/{order}: a replay counted {replay_counts}, its capture "
                  f"recorded {tally}")
            held = compared([first, again], [direct, direct])
            if use_pallas:
                check(sum(tally.values()) > 0, f"cora {policy}/{order}: no kernel captured")
                check(held["bit_identical"], f"cora {policy}/{order}: a replay differs from "
                      f"the uncaptured kernel-tier forward ({held})")
            else:
                torch.testing.assert_close(first, direct, **TOL_PATH)
            emit({"phase": "captured", "part": "cora", "dataflow": f"{policy}/{order}",
                  "tier": "kernels" if use_pallas else "eager", "layers": tiers(prog),
                  "replay_vs_direct": held, "launches_first_run": first_counts,
                  "launches_a_replay": replay_counts, "captured_launches": tally,
                  "replay_ms": host_ms(lambda: prog.run(params, x)),
                  "direct_ms": host_ms(lambda: exe.eager(params, prog.adj.indices,
                                                        prog.adj.weights, x, None)),
                  "ok": True})

    # (b) the serving phase's reddit-bin batches through each readout, and
    # two batches of one shape through one graph
    f_in = TABLE4["reddit-bin"].n_features
    graphs = serving_graphs()
    feats = [np.random.default_rng(3000 + i).normal(size=(g.n_nodes, f_in)).astype(np.float32)
             for i, g in enumerate(graphs)]
    cfg = GNNConfig("gcn", f_in=f_in, hidden=16, n_classes=8, use_pallas=True)
    policy = BucketPolicy()
    rparams, pair = None, None
    worst = {}
    n_batches = 0
    for key, chunk, batch in micro_batches(graphs, policy):
        prog = repro_torch.compile(cfg, graph=batch.graph, device=dev)
        if rparams is None:
            rparams = prog.init(torch.Generator().manual_seed(6))
        prog = prog.bind(batch.graph, pad_degree=batch.d_bucket)
        xb = torch.as_tensor(batch.batch_features([feats[i] for i in chunk]), device=dev)
        seg = torch.as_tensor(batch.segment_ids, device=dev)
        n_batches += 1
        for readout in ("mean", "max", "sum"):
            known = set(prog._exec_cache)
            kw = dict(segment_ids=seg, num_segments=batch.slots, readout=readout)
            out, _ = counted(lambda: prog.run(rparams, xb, **kw))
            (new_key,) = set(prog._exec_cache) - known
            exe = prog._exec_cache[new_key]
            direct = exe.eager(rparams, prog.adj.indices, prog.adj.weights, xb, seg)
            held = compared(out, direct)
            check(held["bit_identical"], f"reddit-bin {list(key)} {readout}: the replay "
                  f"differs from the uncaptured forward ({held})")
            worst[readout] = max(worst.get(readout, 0.0), held["max_abs_diff"])
            if readout == "mean" and len(chunk) > 1 and pair is None:
                pair = (key, chunk, prog, exe, out)
    check(pair is not None, "reddit-bin: no bucket holds two graphs")
    key, chunk, prog_a, exe, out_a = pair
    kept = out_a.clone()
    batch_b = assemble([graphs[i] for i in reversed(chunk)], policy)
    prog_b = prog_a.bind(batch_b.graph, pad_degree=batch_b.d_bucket)
    xb = torch.as_tensor(batch_b.batch_features(
        [np.random.default_rng(4000 + i).normal(size=(graphs[i].n_nodes, f_in))
         .astype(np.float32) for i in reversed(chunk)]), device=dev)
    seg_b = torch.as_tensor(batch_b.segment_ids, device=dev)
    tc0 = repro_torch.trace_count()
    out_b, _ = counted(lambda: prog_b.run(rparams, xb, segment_ids=seg_b,
                                          num_segments=batch_b.slots, readout="mean"))
    check(repro_torch.trace_count() == tc0, "a second batch of one shape was captured anew")
    check(torch.equal(out_b, exe.eager(rparams, prog_b.adj.indices, prog_b.adj.weights, xb,
                                       seg_b)), "the second batch differs from its own "
          "uncaptured run")
    check(torch.equal(out_a, kept), "the first batch's output changed under the next replay")
    emit({"phase": "captured", "part": "reddit-bin batches", "batches": n_batches,
          "readouts": list(worst),
          "batches_bit_identical_to_uncaptured": True,
          "two_batches_one_graph": {"bucket": list(key), "graphs": len(chunk),
                                    "new_captures": 0, "each_equals_its_uncaptured_run": True,
                                    "first_output_survives_the_next_replay": True},
          "ok": True})

    # (c) one graph through serve_partitioned (row_stream closures, each a
    # captured executable) against the monolith's uncaptured forward
    gdims = [(1433, 16), (16, 8)]
    hw = dataclasses.replace(DEFAULT_ACCEL, gb_capacity_bytes=None)
    sched = ModelSchedule.from_policies("sp_opt", "AC", gdims)
    giant = InferenceEngine(gdims, None, use_pallas=True, readout=None, schedule=sched, hw=hw,
                            objective="edp", policy=BucketPolicy(max_nodes=1024),
                            partition_oversized=True, device=dev)
    gparams = giant.init(torch.Generator().manual_seed(4))
    xg = np.random.default_rng(44).normal(size=(cora.n_nodes, 1433)).astype(np.float32)
    res, counts = counted(lambda: giant.serve_partitioned(Request(graph=cora, x=xg)))
    check(res.status == "ok" and res.plan == "row_stream" and res.n_partitions > 1
          and res.tier == "pallas+searched", f"captured giant: {res.status} {res.plan} "
          f"{res.error}")
    mono = repro_torch.compile(GNNConfig("gcn", 1433, 16, 8, use_pallas=True), graph=cora,
                               schedule=sched, device=dev)
    mono.run(gparams, xg)
    exe = only_executable(mono)
    direct = exe.eager(gparams, mono.adj.indices, mono.adj.weights,
                       torch.as_tensor(xg, device=dev), None).cpu().numpy()
    same = bool(np.array_equal(res.output, direct))
    check(same, "serve_partitioned's captured partitions differ from the monolith's "
                f"uncaptured forward by {float(np.abs(res.output - direct).max())}")
    emit({"phase": "captured", "part": "serve_partitioned", "graph": "cora",
          "n_partitions": res.n_partitions, "launches": counts,
          "bit_identical_to_uncaptured_monolith": True, "ok": True})

    # (d) a warm engine: served once, revived on its store, precompiled
    # (the captures), then the stream again with no capture
    store_dir = Path(__file__).resolve().parent / "build" / "captured_store"
    shutil.rmtree(store_dir, ignore_errors=True)
    dims = [(f_in, 16), (16, 8)]
    reqs = reddit_requests(n_requests, f_in, seed=2)
    eng = InferenceEngine(dims, None, use_pallas=True, readout="mean", device=dev,
                          store=ProgramStore(store_dir))
    eparams = eng.init(torch.Generator().manual_seed(3))
    first = eng.submit(reqs)
    del eng
    gc.collect()
    sync(dev)
    torch.cuda.empty_cache()  # the first engine's graphs released
    rev = InferenceEngine(dims, eparams, use_pallas=True, readout="mean", device=dev,
                          store=ProgramStore(store_dir))
    reserved0, allocated0 = torch.cuda.memory_reserved(dev), torch.cuda.memory_allocated(dev)
    tc0 = repro_torch.trace_count()
    rep = rev.precompile()
    sync(dev)
    reserved1, allocated1 = torch.cuda.memory_reserved(dev), torch.cuda.memory_allocated(dev)
    captures = repro_torch.trace_count() - tc0
    check(rep.n_searches == 0 and captures > 0, f"revived precompile: {rep.as_dict()}")
    tc0 = repro_torch.trace_count()
    t0 = time.perf_counter()
    warm, counts = counted(lambda: rev.submit(reqs))
    warm_s = time.perf_counter() - t0
    check(repro_torch.trace_count() == tc0, "the warm engine captured on the request path")
    check(counts["fused_agg_cmb"] + counts["spmm"] > 0, f"warm engine launched {counts}")
    check(all(r.status == "ok" for r in warm), "warm engine: a request was not ok")
    n_same = sum(bool(np.array_equal(a.output, b.output)) for a, b in zip(warm, first))
    worst_engine = max(float(np.abs(a.output - b.output).max()) for a, b in zip(warm, first))
    check(worst_engine <= TOL_PATH["atol"], f"warm engine vs its first pass {worst_engine}")
    emit({"phase": "captured", "part": "warm engine", "requests": n_requests,
          "precompile": rep.as_dict(), "captures": captures,
          "memory_reserved_bytes": [reserved0, reserved1],
          "graphs_reserved_bytes": reserved1 - reserved0,
          "graphs_allocated_bytes": allocated1 - allocated0,
          "request_path_captures": 0, "warm_wall_s": warm_s,
          "warm_graphs_per_s": n_requests / warm_s, "launches": counts,
          "bit_identical_to_first_pass": n_same, "max_abs_diff_vs_first_pass": worst_engine,
          "ok": True})
    shutil.rmtree(store_dir, ignore_errors=True)
    del rev, giant, mono, exe
    gc.collect()
    torch.cuda.empty_cache()
    print(f"captured phase GNN part wall {time.perf_counter() - t_phase:.3f} s", flush=True)
    phase_captured_lm(dev)
    print(f"captured phase wall {time.perf_counter() - t_phase:.3f} s", flush=True)
    return launches


def phase_captured_lm(dev, batch=4, prompt_len=1024, new_tokens=32) -> None:
    """smollm-135m at full width: the prompt replayed through the captured
    ``decode_step`` (``models.transformer.decoder``, as ``prefill`` and
    ``generate`` replay it) against the same replay run eagerly, then
    greedy tokens from each cache and from ``generate``."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import generate
    from repro_torch.models import decode_step, forward, init_cache, init_params, make_inputs
    from repro_torch.models.transformer import captures_decode, decoder
    from repro_torch.tree import leaves

    cfg = get_config("smollm-135m")
    check(captures_decode(cfg, dev), "smollm-135m does not decode captured")
    params = init_params(cfg, torch.Generator().manual_seed(0), dev)
    prompts = make_inputs(cfg, batch, prompt_len, seed=0, device=dev)
    logits, _ = forward(cfg, params, prompts)
    first_tok = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
    del logits
    length = prompt_len + new_tokens

    captured = init_cache(cfg, batch, length, dev)
    sync(dev)
    t0 = time.perf_counter()
    step = decoder(cfg, params, captured, prompts[:, :1])
    sync(dev)
    capture_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for t in range(prompt_len):
        step(prompts[:, t:t + 1], t)
    sync(dev)
    replay_s = time.perf_counter() - t0

    eager = init_cache(cfg, batch, length, dev)
    t0 = time.perf_counter()
    for t in range(prompt_len):
        decode_step(cfg, params, eager, prompts[:, t:t + 1], t)
    sync(dev)
    eager_replay_s = time.perf_counter() - t0
    cache_cmp = compared(leaves(captured), leaves(eager))
    for a, b in zip(leaves(captured), leaves(eager)):
        torch.testing.assert_close(a, b, **TOL_BF16)

    def greedy(run):
        tok, toks, walls = first_tok, [], []
        for i in range(new_tokens):
            t0 = time.perf_counter()
            logits = run(tok, prompt_len + i)
            tok = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
            toks.append(tok)
            sync(dev)
            walls.append((time.perf_counter() - t0) * 1e3)
        return torch.cat(toks, dim=1), walls

    toks_c, ms_c = greedy(step)
    toks_e, ms_e = greedy(lambda tok, i: decode_step(cfg, params, eager, tok, i)[0])
    timings = {}
    toks_g, _ = generate(cfg, params, prompts, new_tokens, timings=timings)
    check(torch.equal(toks_c, toks_e), "captured and eager greedy tokens differ")
    check(torch.equal(toks_g, toks_e), "generate's greedy tokens differ from the eager decode")
    emit({"phase": "captured", "part": "lm replay", "arch": cfg.name, "batch": batch,
          "prompt_len": prompt_len, "new_tokens": new_tokens, "capture_s": capture_s,
          "replay_s": replay_s, "eager_replay_s": eager_replay_s,
          "replay_speedup": eager_replay_s / replay_s, "cache_vs_eager": cache_cmp,
          "tol": TOL_BF16, "decode_step_ms_median": statistics.median(ms_c),
          "eager_decode_step_ms_median": statistics.median(ms_e),
          "greedy_tokens_identical": True, "generate_tokens_identical": True,
          "generate_timings": timings, "ok": True})
    del captured, eager, step, params
    gc.collect()
    torch.cuda.empty_cache()


PROFILED_WINDOWS = [0]  # torch.profiler windows opened in this process


def device_trace(fn, name) -> tuple[object, list]:
    """Run ``fn`` under ``torch.profiler`` (CPU and CUDA activities) and
    return its result and the device events of the trace: kernels,
    copies and fills, each ``(category, name, stream, start_us, end_us)``."""
    from torch.profiler import ProfilerActivity, profile

    PROFILED_WINDOWS[0] += 1
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    path = Path(__file__).resolve().parent / "build" / "traces" / f"{name}.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    events = []
    for e in json.loads(path.read_text()).get("traceEvents", []):
        if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
            start = float(e["ts"])
            events.append((e["cat"], e.get("name", ""), e.get("args", {}).get("stream"),
                           start, start + float(e.get("dur", 0.0))))
    path.unlink()
    return out, events


def busy_us(intervals) -> float:
    """Length of the union of ``(start, end)`` intervals."""
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def overlap_us(a, b) -> float:
    """Time in which some interval of ``a`` and some of ``b`` both run."""
    return busy_us(a) + busy_us(b) - busy_us(list(a) + list(b))


def trace_summary(events, wall_s) -> dict:
    """Device busy share of a traced window (the union of kernels, copies
    and fills over the window's host wall), kernel time by name, and how
    much of the host-to-device copy time ran beside a kernel."""
    kernels = [(a, b) for cat, _, _, a, b in events if cat == "kernel"]
    h2d = [(a, b) for cat, n, _, a, b in events
           if cat == "gpu_memcpy" and "HtoD" in n]
    by_name: dict = {}
    for cat, n, _, a, b in events:
        if cat == "kernel":
            by_name[n] = by_name.get(n, 0.0) + (b - a) / 1e3
    top = dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:12])
    busy = busy_us([(a, b) for *_, a, b in events])
    return {"device_events": len(events),
            "device_busy_share": busy / (wall_s * 1e6) if events else None,
            "device_busy_ms": busy / 1e3, "window_wall_ms": wall_s * 1e3,
            "kernel_busy_ms": busy_us(kernels) / 1e3,
            "h2d_copy_ms": busy_us(h2d) / 1e3,
            "h2d_beside_kernels_ms": overlap_us(h2d, kernels) / 1e3,
            "kernel_ms_by_name_top": top}


def phase_async(dev, counters, held) -> dict:
    """The async front-end (``repro_torch.runtime.AsyncEngine``) serving the
    engine phase's stream at full width on ``[cuda:0]``: (1) a blast,
    bit-identical to the sync engine; (2) the same blast again, no build,
    and once more under one profiler window; (3) a revived front-end on the
    engine phase's store: ``precompile()``, then no mapper search and no
    build; (4) admission: a malformed request rejected at once, a capped
    queue shedding with ``retry_after_s``; (5) cora made oversized through
    ``serve_partitioned``, bit-identical to the engine phase's giant.  The
    paced stream (p50 / p99 against the window) is the async lane's
    (``lanes``).  Returns the launches of (1)-(3) and (5)."""
    import repro_torch
    from repro_torch.core.schedule import ModelSchedule
    from repro_torch.runtime import AsyncEngine, ProgramStore, Request

    t_phase = time.perf_counter()
    launches = {k: 0 for k in counters}
    dims, params, reqs, sync = held["dims"], held["params"], held["requests"], held["sync"]
    store_dir = held["store_dir"] / "serve"

    def front(**kw):
        return AsyncEngine(dims, params, devices=[dev], use_pallas=True, readout="mean",
                           **kw).start()

    def blast(eng, what, trace=None):
        reset_counts(counters)
        tc0 = repro_torch.trace_count()
        clock = []  # start, all admitted, all resolved (the profiler's
        # start-up is outside the window)

        def submit():
            clock.append(time.perf_counter())
            futs = [eng.submit_async(r) for r in reqs]
            clock.append(time.perf_counter())
            out = [f.result() for f in futs]
            clock.append(time.perf_counter())
            return out

        if trace:
            res, events = device_trace(submit, trace)
        else:
            res, events = submit(), None
        admit, wall = clock[1] - clock[0], clock[2] - clock[0]
        check(admit < window_s, f"{what}: admitting the blast took {admit} s, "
              f"past the {window_s} s window (the windows would split)")
        counts = {k: c.launches for k, c in counters.items()}
        for k in launches:
            launches[k] += counts[k]
        check(counts["fused_agg_cmb"] > 0, f"{what}: fused_agg_cmb never launched {counts}")
        for r in res:
            check(r.status == "ok" and r.tier == "pallas+searched",
                  f"{what}: rid {r.rid} is {r.status} on {r.tier} ({r.error})")
        same_outputs(res, sync, what)
        return admit, wall, counts, repro_torch.trace_count() - tc0, events

    # (1) and (2): the blast, twice, on the engine phase's store (its
    # schedules: no mapper search).  The window outlasts the blast's
    # admission, so each bucket's window holds all its requests, as the
    # sync engine's batches do, and the second blast repeats the first's
    # shapes (no build)
    window_s = 0.25
    eng = front(store=ProgramStore(store_dir), window_ms=window_s * 1e3)
    _, cold_wall, counts, _, _ = blast(eng, "async blast")
    walls0, stage0 = len(eng.workers[0].engine._batch_walls), len(eng._stage_walls)
    st0 = eng.stats()
    admit_s, warm_wall, _, builds, _ = blast(eng, "async blast again")
    check(builds == 0, f"the warm async blast built {builds} executables")
    forward_s = eng.workers[0].engine._batch_walls[walls0:]
    stage_s = eng._stage_walls[stage0:]
    st = eng.stats()
    # a third blast under the profiler (its host cost slows the host side)
    _, traced_wall, _, _, events = blast(eng, "async blast traced", trace="async_blast")
    trace = {**trace_summary(events, traced_wall), "traced_wall_s": traced_wall}
    after = eng.stats()
    check(after.n_degraded == 0 and after.per_device[eng.labels[0]]["n_downgrades"] == 0,
          f"async: downgraded {after.as_dict()}")
    eng.close()
    blast_rec = {"phase": "async", "part": "blast", "requests": len(reqs),
                 "window_ms": window_s * 1e3, "admit_s": admit_s,
                 "workers": eng.labels, "cold_wall_s": cold_wall, "warm_wall_s": warm_wall,
                 "warm_graphs_per_s": len(reqs) / warm_wall,
                 "sync_warm_graphs_per_s": held["sync_warm_graphs_per_s"],
                 "flushes_full": st.n_flushes_full - st0.n_flushes_full,
                 "flushes_deadline": st.n_flushes_deadline - st0.n_flushes_deadline,
                 "stage_s_per_batch": stage_s, "forward_s_per_batch": forward_s,
                 "launches_first_blast": counts, "new_builds_second_blast": 0,
                 "bit_identical_to_sync": True, "trace": trace, "ok": True}
    emit(blast_rec)

    # (3) restart: a fresh front-end on the same store
    revived = front(store=ProgramStore(store_dir), window_ms=window_s * 1e3)
    rep = revived.precompile()
    check(rep.n_searches == 0 and rep.n_shapes > 0, f"async precompile: {rep.as_dict()}")
    _, _, _, builds, _ = blast(revived, "async restart")
    st = revived.stats()
    check(builds == 0, f"the revived front-end built {builds} on the request path")
    check(st.per_device[revived.labels[0]]["n_searches"] == 0,
          "the revived front-end ran the mapper")
    revived.close()
    emit({"phase": "async", "part": "restart", "precompile": rep.as_dict(),
          "request_path_builds": 0, "mapper_searches": 0, "bit_identical_to_sync": True,
          "ok": True})

    # (4) admission before queueing, and a capped queue
    with front(store=ProgramStore(store_dir), window_ms=200.0,
               max_queue_graphs=8) as capped:
        bad = Request(graph=reqs[0].graph, x=np.zeros((3, dims[0][0]), np.float32), rid=999)
        f_bad = capped.submit_async(bad)
        check(f_bad.done() and f_bad.result().status == "rejected"
              and f_bad.result().error_type == "invalid_request",
              "a malformed request was not rejected at once")
        res = capped.submit(reqs)
    shed = [r for r in res if r.status == "rejected"]
    check(len(shed) == len(reqs) - 8 and all(
        r.error_type == "engine_overloaded" and r.retry_after_s and r.retry_after_s > 0
        for r in shed), f"the capped queue shed {len(shed)}")
    check(all(r.status == "ok" for r in res[:8]), "the capped queue's admitted requests")
    same_outputs(res[:8], sync[:8], "async capped")
    emit({"phase": "async", "part": "admission", "malformed": "rejected at once",
          "max_queue_graphs": 8, "shed": len(shed),
          "retry_after_s": [shed[0].retry_after_s, shed[-1].retry_after_s], "ok": True})

    # (5) cora made oversized, through serve_partitioned on the worker
    cora, x, gdims, gparams, hw, gpol, giant_out = held["giant"]
    reset_counts(counters)
    with AsyncEngine(gdims, gparams, devices=[dev], use_pallas=True, readout=None,
                     schedule=ModelSchedule.from_policies("sp_opt", "AC", gdims), hw=hw,
                     objective="edp", policy=gpol, partition_oversized=True) as giant:
        (res,) = giant.submit([Request(graph=cora, x=x)])
    counts = {k: c.launches for k, c in counters.items()}
    for k in launches:
        launches[k] += counts[k]
    check(res.status == "ok" and res.plan == "row_stream" and res.n_partitions > 1
          and res.tier == "pallas+searched", f"async giant: {res.status} {res.plan} {res.error}")
    check(np.array_equal(res.output, giant_out),
          "async giant: not bit-identical to the engine phase's giant")
    check(counts["fused_agg_cmb"] > 0, f"async giant launched {counts}")
    emit({"phase": "async", "part": "giant", "plan": res.plan,
          "n_partitions": res.n_partitions, "partition_wall_s": res.partition_wall_s,
          "launches": counts, "bit_identical_to_engine_giant": True, "ok": True})
    print(f"async phase wall {time.perf_counter() - t_phase:.3f} s", flush=True)
    return launches


def event_ms(fn, iters) -> float:
    """Median CUDA-event time of one ``fn()`` (host cost included), after
    one warm-up call."""
    fn()
    ts = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        ts.append(start.elapsed_time(end))
    return statistics.median(ts)


def phase_pp(dev, counters, held) -> dict:
    """The paper's Parallel Pipeline on two CUDA streams of one card
    (``mesh=[cuda:0, cuda:0]``): producer aggregation bands handed to the
    consumer's combination through events.  At cora layer 0 and at the
    engine's (512, 256) batch's layer 0: the eager tier bit-identical to
    the one-device fallback, the kernel tier (``spmm`` + ``gemm``) within
    2e-4 of it; times of the three; whether the two streams' kernels ran
    at once in the profiler's timeline."""
    from repro_torch.gnn import EllAdjacency, multiphase_matmul
    from repro_torch.graphs import BucketPolicy, assemble, bucketize, load_dataset

    t_phase = time.perf_counter()
    launches = {k: 0 for k in counters}
    cora, _ = load_dataset("cora")
    reqs = held["requests"]
    routed = bucketize([r.graph for r in reqs], BucketPolicy())
    big = [reqs[i] for i in routed[(512, 256)]]
    batch = assemble([r.graph for r in big], BucketPolicy())
    f_big = held["dims"][0][0]
    shapes = [
        ("cora layer 0", EllAdjacency.from_csr(cora, device=dev),
         randn((cora.n_nodes, 1433), 50, dev), randn((1433, 16), 51, dev, 1 / np.sqrt(1433)),
         128, 5),
        ("reddit-bin (512, 256) x 64 layer 0",
         EllAdjacency.from_csr(batch.graph, pad_to=batch.d_bucket, device=dev),
         torch.as_tensor(batch.batch_features([r.x for r in big]), device=dev),
         randn((f_big, 16), 52, dev, 1 / np.sqrt(f_big)), 128, 2),
    ]
    mesh = [dev, dev]
    for label, adj, x, w, band, iters in shapes:
        def fallback():
            return multiphase_matmul(adj, x, w, policy="pp", band_size=band)

        def eager():
            return multiphase_matmul(adj, x, w, policy="pp", band_size=band, mesh=mesh)

        def kernels():
            return multiphase_matmul(adj, x, w, policy="pp", band_size=band, mesh=mesh,
                                     use_pallas=True)

        want = fallback()
        reset_counts(counters)
        got_k, events = device_trace(kernels, "pp")
        counts = {k: c.launches for k, c in counters.items()}
        for k in launches:
            launches[k] += counts[k]
        n_bands = -(-adj.v_pad // band)
        check(counts["spmm"] == n_bands and counts["gemm_dataflow"] == n_bands,
              f"pp {label}: launches {counts} for {n_bands} bands")
        got_e = eager()
        torch.cuda.synchronize()
        check(bool(torch.equal(got_e, want)), f"pp {label}: the two-stream eager tier "
              "is not bit-identical to the one-device fallback")
        check(bool(torch.isfinite(got_k).all()), f"pp {label}: non-finite kernel tier")
        torch.testing.assert_close(got_k, want, **TOL_PATH)
        by_stream: dict = {}
        for cat, _, stream, a, b in events:
            if cat == "kernel":
                by_stream.setdefault(stream, []).append((a, b))
        streams = sorted(by_stream, key=lambda s: -len(by_stream[s]))[:2]
        both = (overlap_us(by_stream[streams[0]], by_stream[streams[1]])
                if len(streams) == 2 else None)
        kernel_us = busy_us([iv for ivs in by_stream.values() for iv in ivs])
        times = {"fallback_ms": event_ms(fallback, iters),
                 "two_stream_eager_ms": event_ms(eager, iters),
                 "two_stream_kernels_ms": event_ms(kernels, iters)}
        emit({"phase": "pp", "case": label, "v_pad": adj.v_pad, "d": adj.indices.shape[1],
              "f": x.shape[1], "g": w.shape[1], "band": band, "bands": n_bands,
              "mesh": [str(d) for d in mesh], **times, "launches": counts,
              "eager_bit_identical_to_fallback": True,
              "kernels_max_abs_err_vs_fallback": float((got_k - want).abs().max()),
              "tol": TOL_PATH, "kernel_streams": len(by_stream),
              "kernel_busy_ms": kernel_us / 1e3,
              "kernel_ms_per_stream": [busy_us(by_stream[st]) / 1e3 for st in streams],
              "producer_consumer_kernels_overlap_ms":
                  None if both is None else both / 1e3,
              "ok": True})
        del want, got_k, got_e
    torch.cuda.empty_cache()
    big_case = (batch.graph, batch.d_bucket, shapes[1][2])
    for k, n in pp_programs(dev, counters, cora, big_case, held["dims"]).items():
        launches[k] += n
    print(f"pp phase wall {time.perf_counter() - t_phase:.3f} s", flush=True)
    return launches


def pp_programs(dev, counters, cora, big_case, dims) -> dict:
    """``Program.run`` under a ``pp`` schedule (128-row bands) on two
    streams of one card, ``mesh=[cuda:0, cuda:0]``, captured as one CUDA
    graph per shape key, on both tiers: cora GCN 1433 -> 16 -> 8 and the
    engine's reddit-bin (512, 256) x 64 batch at the engine's ``dims``
    (``big_case``: its graph, ELL width and features).  Each: one capture
    for the key (two runs); both replays ``torch.equal`` to the uncaptured twin
    (``exe.eager``) on the same inputs; the eager tier ``torch.equal`` to
    ``mesh=None``'s fallback, the kernel tier within ``TOL_PATH`` of it;
    ``spmm`` and ``gemm`` launched once a band of each layer a replay; the
    replay's ms beside the uncaptured forward's.  Returns the kernels'
    launches in the two captured runs."""
    import repro_torch
    from repro_torch.api import CapturedForward
    from repro_torch.core.schedule import ModelSchedule
    from repro_torch.gnn import GNNConfig

    launches = {k: 0 for k in counters}
    cases = [("cora gcn", cora, None, randn((cora.n_nodes, 1433), 53, dev),
              [(1433, 16), (16, 8)], 10),
             ("reddit-bin (512, 256) x 64", *big_case, dims, 2)]
    mesh = [dev, dev]
    for label, graph, pad, x, dims_, iters in cases:
        for use_pallas in (False, True):
            cfg = GNNConfig(f_in=dims_[0][0], hidden=dims_[0][1], n_classes=dims_[-1][1],
                            use_pallas=use_pallas)
            sched = ModelSchedule.from_policies("pp", "AC", cfg.dims, band_size=128)
            prog = repro_torch.compile(cfg, graph=graph, schedule=sched, device=dev)
            if pad is not None:  # the batch's ELL width, as the engine pads it
                prog = prog.bind(graph, pad_degree=pad)
            params = prog.init(torch.Generator().manual_seed(4))
            tc0 = repro_torch.trace_count()
            reset_counts(counters)
            out = prog.run(params, x, mesh=mesh)
            again = prog.run(params, x, mesh=mesh)
            sync(dev)
            counts = {k: c.launches for k, c in counters.items()}
            for k in launches:
                launches[k] += counts[k]
            captures = repro_torch.trace_count() - tc0
            (exe,) = prog._exec_cache.values()
            check(isinstance(exe, CapturedForward) and exe.graph is not None,
                  f"pp program {label}: mesh={mesh} not captured")
            direct = exe.eager(params, prog.adj.indices, prog.adj.weights, x, None)
            fallback = prog.run(params, x)
            sync(dev)
            tier = "kernels" if use_pallas else "eager"
            replay_equal = bool(torch.equal(out, direct) and torch.equal(again, direct))
            check(captures == 1, f"pp program {label} {tier}: {captures} captures, not 1")
            check(replay_equal, f"pp program {label} {tier}: a replay differs from the "
                  "uncaptured forward")
            n_bands = 2 * -(-prog.adj.v_pad // 128)
            per_replay = exe.graph.launches
            if use_pallas:
                check(per_replay.get("spmm") == n_bands and per_replay.get("gemm") == n_bands,
                      f"pp program {label}: a replay launches {per_replay}, not {n_bands} "
                      "spmm and gemm")
                torch.testing.assert_close(out, fallback, **TOL_PATH)
            else:
                check(not per_replay, f"pp program {label} eager: launched {per_replay}")
                check(bool(torch.equal(out, fallback)), f"pp program {label}: the two-stream "
                      "eager tier is not bit-identical to the one-device fallback")
            emit({"phase": "pp", "case": f"Program.run {label}", "tier": tier,
                  "dims": cfg.dims, "v_pad": prog.adj.v_pad, "band": 128,
                  "mesh": [str(d) for d in mesh], "captures": captures,
                  "launches_per_replay": per_replay, "bands_per_replay": n_bands,
                  "launches_two_runs": counts, "replays_equal_uncaptured": replay_equal,
                  "max_abs_vs_fallback": float((out - fallback).abs().max()),
                  "replay_ms": event_ms(lambda: prog.run(params, x, mesh=mesh), iters),
                  "uncaptured_ms": event_ms(lambda: exe.eager(
                      params, prog.adj.indices, prog.adj.weights, x, None), iters),
                  "fallback_replay_ms": event_ms(lambda: prog.run(params, x), iters),
                  "card": card_line(), "ok": True})
            del prog, exe, out, again, direct, fallback
    torch.cuda.empty_cache()
    return launches


def lane_record(name: str, rows, payload: dict, guards: list, wall_s: float) -> dict:
    """One serving lane's line: its rows, each speed guard's value beside
    its limit (read, not held: the lane's CLI enforces them), and the
    kernels it launched."""
    for g in guards:
        limit = g.get("floor", g.get("ceiling"))
        kind = "floor" if "floor" in g else "ceiling"
        print(f"lanes {name}: {g['key']} {g['value']:.4g} against the {kind} "
              f"{limit:g}: {'met' if g['met'] else 'MISSED'}", flush=True)
    return {"phase": "lanes", "lane": name, "wall_s": wall_s,
            "rows": [list(r) for r in rows],
            "guards": [{k: v for k, v in g.items() if k != "message"} for g in guards],
            "launches": payload.get("launches"), "ok": True}


def phase_lanes(dev, counters) -> dict:
    """The benchmark lanes and examples of the port (``repro_torch.bench``,
    ``repro_torch.examples``) on the card: the plain serve lane at full
    size (1000 requests, engine and naive), chaos, restart, async (two
    workers on two streams of this card) and giant at their smoke sizes,
    then quickstart, gnn_parallel_pipeline and serve_async.  Each lane
    raises on its correctness guards (engine vs naive 1e-5, bit-identity
    across chaos, restart, async and giant, typed statuses, no build warm,
    no downgrade, no ``nvcc`` on revival); the serve and giant lanes also
    hold the kernel tier against the eager tier (plain PyTorch, the same
    weights) at ``TOL_PATH``: the serve lane's whole stream, every giant
    graph.  The naive loops run the same kernels as the engines, so these
    two holds are what compares a kernel with its plain version at the
    lanes' shapes.  Speed ratios are printed beside their floors.  Returns
    the phase's launches; spmm, fused_agg_cmb and gemm_dataflow must each
    have launched."""
    import io

    from repro_torch.bench import serve_gnn
    from repro_torch.examples import gnn_parallel_pipeline, quickstart, serve_async

    check(serve_gnn.CLOSE_TOL == TOL_PATH,
          f"lanes: the lanes hold at {serve_gnn.CLOSE_TOL}, not at {TOL_PATH}")
    import repro_torch

    t_phase = time.perf_counter()
    reset_counts(counters)
    tc0 = repro_torch.trace_count()
    lanes = [("serve", lambda: serve_gnn.measure(smoke=False, device=dev)),
             ("serve_chaos", lambda: serve_gnn.measure_chaos(smoke=True, device=dev)),
             ("serve_restart", lambda: serve_gnn.measure_restart(smoke=True, device=dev)),
             ("serve_async", lambda: serve_gnn.measure_async(smoke=True, device=dev)),
             ("serve_giant", lambda: serve_gnn.measure_giant(smoke=True, device=dev))]
    for name, fn in lanes:
        t0 = time.perf_counter()
        rows, payload, guards = fn()
        rec = lane_record(name, rows, payload, guards, time.perf_counter() - t0)
        if name in ("serve", "serve_giant"):
            hold = payload["eager_hold"]
            n_held = hold.get("n_requests", hold.get("n_graphs"))
            stream = payload["stream"]
            want = len(stream["sizes"]) if name == "serve_giant" else stream["n_requests"]
            check(n_held == want, f"lanes {name}: the eager tier held {n_held} of {want}")
            rec["kernel_vs_eager"] = hold
            print(f"lanes {name}: kernel tier vs eager tier max |d| "
                  f"{hold['max_abs_diff']:.3e} over {n_held} outputs "
                  f"(rtol {TOL_PATH['rtol']:g}, atol {TOL_PATH['atol']:g})", flush=True)
        if name == "serve_async":
            rec["traffic_warmed_sync"] = tw = payload["traffic_warmed_sync"]
            print(f"lanes serve_async: {payload['n_bit_identical']} bit-identical to "
                  f"the precompiled sync engine; {tw['n_bit_identical']} to the "
                  f"traffic-warmed one, max |d| {tw['max_abs_diff']:.3e}", flush=True)
        if name == "serve":
            eng = payload["engine"]
            rec.update({k: eng[k] for k in ("graphs_per_sec", "p50_ms", "p99_ms",
                                            "warm_graphs_per_sec", "n_downgrades")})
            rec["naive_graphs_per_sec"] = payload["naive"]["graphs_per_sec"]
            rec["parity_max_abs_diff"] = payload["parity_max_abs_diff"]
            print(f"lanes serve: {eng['graphs_per_sec']:.1f} graphs/s cold pass, "
                  f"{eng['warm_graphs_per_sec']:.1f} warm, p50 {eng['p50_ms']:.3f} ms, "
                  f"p99 {eng['p99_ms']:.3f} ms; naive "
                  f"{payload['naive']['graphs_per_sec']:.1f} graphs/s", flush=True)
        emit(rec)
    for mod in (quickstart, gnn_parallel_pipeline, serve_async):
        name = mod.__name__.rsplit(".", 1)[1]
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            code = mod.main(["--device", str(dev)])
        check(code == 0, f"lanes: example {name} returned {code}")
        emit({"phase": "lanes", "example": name, "wall_s": time.perf_counter() - t0,
              "tail": out.getvalue().strip().splitlines()[-3:], "ok": True})
    sync(dev)
    launches = {k: c.launches for k, c in counters.items()}
    for k in ("spmm", "fused_agg_cmb", "gemm_dataflow"):
        check(launches[k] > 0, f"lanes: {k} never launched ({launches})")
    wall = time.perf_counter() - t_phase
    emit({"phase": "lanes", "launches": launches, "wall_s": wall,
          "captures": repro_torch.trace_count() - tc0, "ok": True})
    print(f"lanes phase wall {wall:.3f} s", flush=True)
    return launches


def traced_step(fn, name) -> tuple[object, dict]:
    """One warm call of ``fn`` under the profiler: its result and
    :func:`trace_summary` over the call's host wall (the profiler's host
    cost included), with the count of kernels the call ran."""
    wall = []

    def timed():
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall.append(time.perf_counter() - t0)
        return out

    out, events = device_trace(timed, name)
    return out, {**trace_summary(events, wall[0]),
                 "kernels": sum(1 for e in events if e[0] == "kernel")}


def thread_cpu_s() -> dict:
    """``(name, CPU seconds)`` (user + system) of each thread of this
    process, by native thread id, from ``/proc/self/task``."""
    tick = os.sysconf("SC_CLK_TCK")
    out = {}
    for task in Path("/proc/self/task").iterdir():
        try:
            stat = (task / "stat").read_text()
        except OSError:  # the thread has ended
            continue
        name, rest = stat.split("(", 1)[1].rsplit(")", 1)
        fields = rest.split()
        out[int(task.name)] = (name, (int(fields[11]) + int(fields[12])) / tick)
    return out


def launch_us(dev, n=2000) -> float:
    """Host microseconds a small eager CUDA op takes to launch: ``n``
    in-place adds on one element, back to back, then one sync."""
    t = torch.zeros(1, device=dev)
    t.add_(1)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(n):
        t.add_(1)
    torch.cuda.synchronize(dev)
    return (time.perf_counter() - t0) / n * 1e6


def run_context(dev) -> dict:
    """What the process holds besides the phase about to run: its threads,
    torch's intra-op threads, the objects the garbage collector tracks, the
    caching allocator's state, and the profiler windows opened so far; and
    how fast its host launches an op (:func:`launch_us`)."""
    stats = torch.cuda.memory_stats()
    rss = re.search(r"VmRSS:\s+(\d+) kB", Path("/proc/self/status").read_text())
    return {
        "launch_us": launch_us(dev),
        "rss_gib": int(rss.group(1)) / 2**20,
        "os_thread_names": sorted(n for n, _ in thread_cpu_s().values()),
        "python_threads": sorted(t.name for t in threading.enumerate()),
        "os_threads": len(os.listdir("/proc/self/task")),
        "torch_threads": torch.get_num_threads(),
        "gc_tracked_objects": len(gc.get_objects()),
        "cuda_allocated_gib": stats.get("allocated_bytes.all.current", 0) / 2**30,
        "cuda_reserved_gib": stats.get("reserved_bytes.all.current", 0) / 2**30,
        "cuda_segments": stats.get("segment.all.current", 0),
        "cuda_alloc_retries": stats.get("num_alloc_retries", 0),
        "profiler_windows_before": PROFILED_WINDOWS[0],
    }


def timed_steps(step, n) -> dict:
    """``step(0) .. step(n - 1)``, each timed by CUDA events (host cost
    included), with the CPU seconds of the calling thread and of every
    other thread of the process, and the time the garbage collector ran."""
    me = threading.get_native_id()
    gc_s, gc_t0 = [], []

    def on_gc(phase, _info):
        if phase == "start":
            gc_t0.append(time.perf_counter())
        elif gc_t0:
            gc_s.append(time.perf_counter() - gc_t0.pop())

    gc.callbacks.append(on_gc)
    cpu0 = thread_cpu_s()
    times = []
    try:
        for s in range(n):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            step(s)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
    finally:
        gc.callbacks.remove(on_gc)
    cpu1 = thread_cpu_s()
    others = {}
    for t, (name, c) in cpu1.items():
        if t != me:
            others[name] = others.get(name, 0.0) + c - cpu0.get(t, (name, 0.0))[1]
    return {
        "step_ms": times, "step_ms_median": statistics.median(times[1:]),
        "cpu_s_caller": cpu1[me][1] - cpu0[me][1],
        "cpu_s_other_threads": sum(others.values()),
        "cpu_s_by_other_thread": {n: c for n, c in sorted(others.items()) if c > 0},
        "gc_collections": len(gc_s), "gc_ms": sum(gc_s) * 1e3,
    }


def graph_pool_bytes(graphs) -> int:
    """Bytes the caching allocator holds in the private pools of
    ``graphs`` (:class:`repro_torch.capture.CapturedGraph` objects): what
    their captures reserve beyond the tensors the caller holds."""
    pools = {tuple(g.graph.pool()) for g in graphs}
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", ())) in pools)


def step_profile(step, n, name) -> dict:
    """``step(0) .. step(n - 1)`` timed (:func:`timed_steps`), the peak
    memory allocated over them, then ``step(n)`` under the profiler: its
    device busy share and the kernels it ran."""
    torch.cuda.reset_peak_memory_stats()
    timed = timed_steps(step, n)
    peak = torch.cuda.max_memory_allocated() / 2**30
    _, trace = traced_step(lambda: step(n), name)
    return {**timed, "peak_allocated_gib": peak, "kernels_per_step": trace["kernels"],
            "device_busy_share": trace["device_busy_share"], "trace": trace}


def leaves_differing(a, b) -> list:
    from repro_torch.tree import leaf_paths, leaves

    return ["/".join(map(str, path))
            for (path, x), y in zip(leaf_paths(a), leaves(b)) if not torch.equal(x, y)]


def phase_train(dev, counters) -> dict:
    """Training on the card, as a user drives it, each step a captured CUDA
    graph; no kernel launches (the reference's training reaches no
    ``pallas_call``, and no hand-written kernel has a backward).

    GNN: ``compile`` on cora (GCN 1433 -> 16 -> 8, the searched schedule,
    the eager tier), then ``Program.train_step`` for 2 epochs x 20 steps at
    lr 0.05 (``examples/train_gnn_dataflow.py``'s defaults): one capture,
    the second epoch builds nothing, the first 3 steps equal the
    uncaptured step's, the loss falls, step 1 is within 2e-4 of the same
    step on the CPU, and the kernel tier's ``train_step`` raises with the
    launch counts unmoved.  LM: ``repro_torch.launch.train.main`` at
    smollm-135m's published widths (batch 8, seq 512): 30 steps with a
    checkpoint every 10; a copy of its checkpoints without step 30,
    restarted with the same flags, resumes at 20 and must end
    ``torch.equal`` to the straight run, parameters and optimizer state;
    the same step run twice from two copies of one state must be
    bit-identical too, and 3 captured steps equal the uncaptured step's.
    For both models, captured and uncaptured: warm step times by CUDA
    events (host cost included) with the CPU time of the process's other
    threads, one profiled step's kernels and busy share, peak memory and
    the graphs' pool; the LM's tokens/s and its bound (6 N tokens over the
    bf16 dense peak).  Then recurrentgemma-2b and xlstm-1.3b at cut depth
    (:func:`train_families`), granite-moe (:func:`moe_train`) and the
    two-stream PP (:func:`pp_train`)."""
    import contextlib
    import io

    import repro_torch
    from repro_torch.api import CapturedForward
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import get_config
    from repro_torch.data import LMDataPipeline
    from repro_torch.gnn import GNNConfig, make_node_classification_task
    from repro_torch.graphs import load_dataset
    from repro_torch.launch import train
    from repro_torch.models import count_params, init_params
    from repro_torch.models.transformer import captures_train
    from repro_torch.tree import tree_map

    t_phase = time.perf_counter()
    context = run_context(dev)
    launches = {k: 0 for k in counters}

    # -- GNN: Program.train_step on cora ------------------------------------
    cora, spec = load_dataset("cora")
    cfg = GNNConfig("gcn", f_in=spec.n_features, hidden=16, n_classes=8)
    prog = repro_torch.compile(cfg, graph=cora, objective="cycles", device=dev)
    x, labels, mask = make_node_classification_task(cora, spec.n_features, 8, device=dev)
    params = prog.init(torch.Generator().manual_seed(0))
    first = [{k: v.clone() for k, v in layer.items()} for layer in params]
    reset_counts(counters)
    losses, builds, step_ms, kept = [], [], [], []
    for epoch in range(2):
        before = repro_torch.trace_count()
        for _ in range(20):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            loss, params = prog.train_step(params, x, labels, mask, lr=0.05)
            end.record()
            end.synchronize()
            step_ms.append(start.elapsed_time(end))
            losses.append(float(loss))
            if len(kept) < 3:
                kept.append((loss, params))
        builds.append(repro_torch.trace_count() - before)
    counts = {k: c.launches for k, c in counters.items()}
    check(builds == [1, 0], f"GNN train: builds per epoch {builds}, not [1, 0]")
    check(losses[-1] < losses[0], f"GNN train: loss {losses[0]} -> {losses[-1]}")
    check(all(n == 0 for n in counts.values()), f"GNN train launched kernels: {counts}")
    (exe,) = [e for k, e in prog._exec_cache.items() if k[0] == "train"]
    check(isinstance(exe, CapturedForward) and exe.graph is not None,
          "GNN train: the step was not captured")
    adj = prog.adj
    p, differ = first, []
    for i, (loss, new) in enumerate(kept):
        want_loss, p = exe.eager(p, adj.indices, adj.weights, x, labels, mask)
        if not torch.equal(loss, want_loss):
            differ.append(f"step {i + 1} loss")
        differ += [f"step {i + 1} {j}/{k}" for j, (a, b) in enumerate(zip(new, p))
                   for k in a if not torch.equal(a[k], b[k])]
    check(not differ, f"GNN train: captured steps differ from the uncaptured step: {differ[:4]}")
    cpu = prog.bind(cora, device="cpu")
    first_cpu = [{k: v.cpu() for k, v in layer.items()} for layer in first]
    loss_c, new_c = cpu.train_step(first_cpu, x.cpu(), labels.cpu(), mask.cpu(), lr=0.05)
    step1 = kept[0]
    err = abs(float(step1[0]) - float(loss_c))
    for a, b in zip(step1[1], new_c):
        for k in a:
            torch.testing.assert_close(a[k].cpu(), b[k], **TOL_PATH)
            err = max(err, float((a[k].cpu() - b[k]).abs().max()))
    check(err <= 2e-4, f"GNN train: step 1 differs from the CPU's by {err}")
    kernel_tier = prog.degraded(use_pallas=True)
    reset_counts(counters)
    try:
        kernel_tier.train_step(params, x, labels, mask)
        refused = False
    except ValueError:
        refused = True
    check(refused, "GNN train: the kernel tier's train_step did not raise")
    check(all(c.launches == 0 for c in counters.values()),
          "GNN train: the refused kernel-tier step launched a kernel")
    gstate = {"captured": params, "uncaptured": params}

    def gnn_captured(_):
        loss, gstate["captured"] = prog.train_step(gstate["captured"], x, labels, mask, lr=0.05)
        return loss

    def gnn_uncaptured(_):
        loss, gstate["uncaptured"] = exe.eager(gstate["uncaptured"], adj.indices,
                                               adj.weights, x, labels, mask)
        return loss

    gnn_steps = {"captured": step_profile(gnn_captured, 10, "train_gnn"),
                 "uncaptured": step_profile(gnn_uncaptured, 10, "train_gnn_eager")}
    emit({"phase": "train", "model": "gcn cora", "dims": cfg.dims, "layers": tiers(prog),
          "steps": len(losses), "lr": 0.05, "builds_per_epoch": builds,
          "loss_first": losses[0], "loss_last": losses[-1],
          "step_ms_first": step_ms[0], "step_ms_median_warm": statistics.median(step_ms[1:]),
          "captured_equals_uncaptured_3_steps": not differ,
          "step1_max_abs_err_vs_cpu": err, "kernel_tier_refused": True,
          "graph_pool_bytes": graph_pool_bytes([exe.graph]),
          "memory_reserved_bytes": torch.cuda.memory_reserved(dev),
          **gnn_steps, "launches": counts, "card": card_line(), "ok": True})
    del gstate, kept, exe

    # -- LM: launch.train.main at smollm-135m's published widths ------------
    arch, batch, seq = "smollm-135m", 8, 512
    lm = get_config(arch)
    check(captures_train(lm, dev), f"{arch} train: not captured by the rule")
    root = Path(__file__).resolve().parent / "build" / "train_ckpt"
    shutil.rmtree(root, ignore_errors=True)
    flags = ["--arch", arch, "--batch", str(batch), "--seq", str(seq),
             "--checkpoint-every", "10", "--steps", "30"]
    finals = {}

    def run(label, ckdir):
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            code = train.main(flags + ["--checkpoint-dir", str(ckdir)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check(code == 0, f"LM train {label}: main returned {code}")
        line = [ln for ln in out.getvalue().splitlines() if ln.startswith("FINAL")]
        check(len(line) == 1, f"LM train {label}: no FINAL line")
        print(f"train {label}: {line[0]} ({wall:.3f} s)", flush=True)
        vals = dict(kv.split("=") for kv in line[0].split()[1:])
        finals[label] = {k: float(v) for k, v in vals.items()} | {"wall_s": wall}

    torch.cuda.reset_peak_memory_stats()
    reset_counts(counters)
    run("straight 30", root / "straight")
    # a run preempted after its step-20 checkpoint, restarted as it was
    shutil.copytree(root / "straight", root / "resumed")
    shutil.rmtree(root / "resumed" / "step_30")
    run("resume 20 to 30", root / "resumed")
    counts = {k: c.launches for k, c in counters.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    check(all(n == 0 for n in counts.values()), f"LM train launched kernels: {counts}")
    check(finals["resume 20 to 30"]["steps"] == 10, "LM train: the resume did not start at 20")
    check(finals["straight 30"]["loss"] < finals["straight 30"]["first"],
          "LM train: the loss did not fall")
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_params(lm, gen, dev)
    init_opt, step_fn = train.build_trainer(lm, lr=3e-4, total_steps=30)
    like = {"params": params, "opt": init_opt(params), "data": {"seed": 0, "step": 0}}
    got = {k: Checkpointer(root / k).restore(like, step=30) for k in ("resumed", "straight")}
    differ = leaves_differing(got["resumed"], got["straight"])
    shutil.rmtree(root, ignore_errors=True)
    del got, like
    torch.cuda.empty_cache()
    # the same step twice, each from its own copy of one state (the
    # captured step owns the state it is given), each result copied out
    data = LMDataPipeline(lm, batch, seq, seed=0, device=dev)
    opt = init_opt(params)
    twice = [tree_map(torch.clone, step_fn(*tree_map(torch.clone, (params, opt)), None,
                                           data.peek(0))) for _ in range(2)]
    repeat_differ = leaves_differing(twice[0], twice[1])
    del twice
    # 3 captured steps against 3 uncaptured, from the same state
    owned, fresh, lm_differ = tree_map(torch.clone, (params, opt)), (params, opt), []
    for s in range(3):
        loss_c, pc, oc, _ = step_fn(*owned, None, data.peek(s))
        loss_e, pe, oe, _ = step_fn.eager(*fresh, None, data.peek(s))
        owned, fresh = (pc, oc), (pe, oe)
        if not torch.equal(loss_c, loss_e):
            lm_differ.append(f"step {s + 1} loss")
    lm_differ += leaves_differing(owned, fresh)
    check(len(step_fn.graphs) == 1, f"LM train: {len(step_fn.graphs)} graphs, not 1")
    state = {"captured": owned, "uncaptured": fresh}

    def lm_captured(s):
        loss, *st, _ = step_fn(*state["captured"], None, data.peek(3 + s))
        state["captured"] = tuple(st)
        return loss

    def lm_uncaptured(s):
        loss, *st, _ = step_fn.eager(*state["uncaptured"], None, data.peek(3 + s))
        state["uncaptured"] = tuple(st)
        return loss

    launch_before = launch_us(dev)
    lm_steps = {"captured": step_profile(lm_captured, 6, "train_lm"),
                "uncaptured": step_profile(lm_uncaptured, 6, "train_lm_eager")}
    check(bool(torch.isfinite(lm_captured(20))), "LM train: non-finite loss")
    ms = lm_steps["captured"]["step_ms_median"]
    n = count_params(params)
    bound = 6 * n * batch * seq / PEAK_OPS[torch.bfloat16] * 1e3
    for v in lm_steps.values():
        v["tokens_per_s"] = batch * seq / v["step_ms_median"] * 1e3
    emit({"phase": "train", "model": arch, "depth": lm.n_layers, "d_model": lm.d_model,
          "vocab": lm.vocab, "dtype": lm.dtype, "params": n, "batch": batch, "seq": seq,
          "runs": finals, "resumed_equals_straight": not differ,
          "leaves_differing": differ[:8], "n_leaves_differing": len(differ),
          "repeat_step_bit_identical": not repeat_differ,
          "repeat_leaves_differing": repeat_differ[:8],
          "captured_equals_uncaptured_3_steps": not lm_differ,
          "captured_leaves_differing": lm_differ[:8], "context": context,
          "launch_us_before_steps": launch_before,
          "step_ms_median": ms, "tokens_per_s": batch * seq / ms * 1e3,
          "bound_ms_6NT_bf16": bound, "bound_share": bound / ms,
          "peak_memory_gib_main_runs": peak_gb,
          "graph_pool_bytes": graph_pool_bytes(step_fn.graphs.values()),
          "memory_reserved_bytes": torch.cuda.memory_reserved(dev),
          **lm_steps, "launches": counts, "card": card_line(),
          "ok": not (differ or repeat_differ or lm_differ)})
    check(not differ, f"LM train: resumed and straight runs differ in {len(differ)} "
          f"leaves, first {differ[:4]}")
    check(not repeat_differ, f"LM train: the repeated step differs in {repeat_differ[:4]}")
    check(not lm_differ, f"LM train: captured steps differ from uncaptured: {lm_differ[:4]}")
    del params, opt, data, state, owned, fresh, step_fn, pc, oc, pe, oe, loss_c, loss_e
    torch.cuda.empty_cache()
    train_families(dev, counters)
    moe_train(dev, counters)
    pp_train(dev, cora, spec, x, labels, mask)
    for k in launches:
        launches[k] += counts[k]
    print(f"train phase wall {time.perf_counter() - t_phase:.3f} s", flush=True)
    return launches


def train_families(dev, counters, batch=2, seq=128) -> None:
    """recurrentgemma-2b (one (rglru, rglru, local) period) and xlstm-1.3b
    (8 blocks: 7 mLSTM, 1 sLSTM) at their published widths, cut in depth,
    AdamW at ``batch`` x ``seq``: 3 uncaptured steps, then 3 captured ones
    (the RG-LRU doubling scan, the xLSTM time loops and their backward
    inside the graph) from the same state, ``torch.equal`` in every loss
    and leaf; then 4 warm steps of each, timed.  One state lives on the
    card at a time (recurrentgemma's 256k-token embedding makes it 15 GB
    with its moments): the start and the uncaptured result wait on the
    host."""
    from repro_torch.configs import get_config
    from repro_torch.data import LMDataPipeline
    from repro_torch.launch import train
    from repro_torch.models import count_params, init_params
    from repro_torch.models.transformer import captures_train
    from repro_torch.tree import leaf_paths, leaves, tree_map

    for arch, layers in (("recurrentgemma-2b", 3), ("xlstm-1.3b", 8)):
        cfg = get_config(arch).with_(n_layers=layers)
        check(captures_train(cfg, dev), f"{arch} train: not captured by the rule")
        reset_counts(counters)
        torch.cuda.reset_peak_memory_stats()
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
        n = count_params(params)
        init_opt, step_fn = train.build_trainer(cfg, lr=3e-4, total_steps=10)
        data = LMDataPipeline(cfg, batch, seq, seed=0, device=dev)
        box = {"state": (params, init_opt(params))}
        del params
        start = tree_map(lambda t: t.cpu(), box["state"])
        runs = {}
        for kind, fn in (("uncaptured", step_fn.eager), ("captured", step_fn)):
            if kind == "captured":
                box["state"] = tree_map(lambda t: t.to(dev), start)
                del start

            def one(s, fn=fn):
                loss, *st, _ = fn(*box["state"], None, data.peek(s))
                box["state"] = tuple(st)
                return loss

            losses, first_ms = [], []
            for s in range(3):
                t0 = time.perf_counter()
                losses.append(one(s))
                torch.cuda.synchronize()
                first_ms.append((time.perf_counter() - t0) * 1e3)
            if kind == "uncaptured":
                after3 = tree_map(lambda t: t.cpu(), box["state"])
                differ = []
            else:
                differ = ["/".join(map(str, path)) for (path, a), b in
                          zip(leaf_paths(box["state"]), leaves(after3))
                          if not torch.equal(a, b.to(dev))]
                del after3
            runs[kind] = {"losses": torch.stack(losses).cpu(), "first_steps_ms": first_ms,
                          **timed_steps(lambda s: one(3 + s), 4)}
            box["state"] = None
            torch.cuda.empty_cache()
        if not torch.equal(runs["captured"]["losses"], runs["uncaptured"]["losses"]):
            differ.append("losses")
        counts = {k: c.launches for k, c in counters.items()}
        for r in runs.values():
            r["losses"] = r["losses"].tolist()
        emit({"phase": "train", "model": arch, "depth": layers, "d_model": cfg.d_model,
              "dtype": cfg.dtype, "params": n, "batch": batch, "seq": seq,
              "graphs": len(step_fn.graphs), "captured_equals_uncaptured_3_steps": not differ,
              "leaves_differing": differ[:8], "n_leaves_differing": len(differ),
              "step_ms_median": {k: v["step_ms_median"] for k, v in runs.items()},
              **runs, "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
              "launches": counts, "card": card_line(), "ok": not differ})
        check(not differ, f"{arch} train: captured steps differ from uncaptured: {differ[:4]}")
        check(len(step_fn.graphs) == 1, f"{arch} train: {len(step_fn.graphs)} graphs, not 1")
        check(all(v == 0 for v in counts.values()), f"{arch} train launched kernels: {counts}")
        del step_fn, box
        torch.cuda.empty_cache()


def pp_train(dev, cora, spec, x, labels, mask) -> None:
    """cora GCN (1433 -> 16 -> 8) under a ``pp`` schedule trained through
    the two-stream Parallel Pipeline: ``mesh=[cuda:0, cuda:0]`` (and
    ``[cuda:0, cuda:1]`` with two cards) against ``mesh=None``, three SGD
    steps each: the same loss, the parameters within 2e-4 (the CPU test's
    checks), and the first step run again bit-identical.  On one card the
    two-stream step is a CUDA graph (each band's backward on its forward's
    stream, inside it): its three steps ``torch.equal`` to the uncaptured
    step (``exe.eager``) from the same parameters, and its warm step ms
    beside the uncaptured step's; two cards stay uncaptured."""
    import repro_torch
    from repro_torch.api import CapturedForward
    from repro_torch.core.cost_model import GNNLayerWorkload
    from repro_torch.core.schedule import ModelSchedule
    from repro_torch.gnn import GNNConfig

    cfg = GNNConfig("gcn", f_in=spec.n_features, hidden=16, n_classes=8)
    wls = [GNNLayerWorkload(cora.nnz, fi, fo) for fi, fo in cfg.dims]
    sched = ModelSchedule.from_policies("pp", "AC", cfg.dims)
    prog = repro_torch.compile(wls, graph=cora, schedule=sched, device=dev)
    params = prog.init(torch.Generator().manual_seed(0))
    meshes = {"none": None, "two_streams": [dev, dev]}
    if torch.cuda.device_count() >= 2:
        meshes["two_cards"] = [torch.device("cuda", 0), torch.device("cuda", 1)]
    runs, walls = {}, {}
    for name, mesh in meshes.items():
        p, steps, ms = params, [], []
        for _ in range(3):  # the first builds the executable
            t0 = time.perf_counter()
            loss, p = prog.train_step(p, x, labels, mask, lr=0.05, mesh=mesh)
            sync(dev)
            ms.append((time.perf_counter() - t0) * 1e3)
            steps.append((loss, p))
        runs[name], walls[name] = steps, ms
    record = {"phase": "train", "model": "gcn cora pp", "dims": cfg.dims,
              "layers": tiers(prog), "meshes": sorted(meshes),
              "step_ms": walls, "losses": {k: [float(s[0]) for s in v] for k, v in runs.items()}}
    for name in meshes:
        if name == "none":
            continue
        again = prog.train_step(params, x, labels, mask, lr=0.05, mesh=meshes[name])
        worst = 0.0
        for (l_p, p_p), (l_n, p_n) in zip(runs[name], runs["none"]):
            check(torch.equal(l_p, l_n), f"PP train {name}: loss {float(l_p)} != "
                  f"mesh=None's {float(l_n)}")
            for a, b in zip(p_p, p_n):
                for k in a:
                    torch.testing.assert_close(a[k], b[k], **TOL_PATH)
                    worst = max(worst, float((a[k] - b[k]).abs().max()))
        repeat = torch.equal(again[0], runs[name][0][0]) and all(
            torch.equal(a[k], b[k]) for a, b in zip(again[1], runs[name][0][1]) for k in a)
        record[f"{name}_max_abs_vs_none"] = worst
        record[f"{name}_repeat_bit_identical"] = repeat
        check(repeat, f"PP train {name}: the repeated step is not bit-identical")
    # the two-stream step's graph against its uncaptured twin
    (exe,) = [e for k, e in prog._exec_cache.items()
              if k[0] == "train" and k[3] == tuple(meshes["two_streams"])]
    check(isinstance(exe, CapturedForward) and exe.graph is not None,
          "PP train two_streams: the step is not captured")
    q, differ = params, []
    for s, (loss, p) in enumerate(runs["two_streams"]):
        want_loss, q = exe.eager(q, prog.adj.indices, prog.adj.weights, x, labels, mask)
        if not (torch.equal(loss, want_loss)
                and all(torch.equal(a[k], b[k]) for a, b in zip(p, q) for k in a)):
            differ.append(s)
    two = meshes["two_streams"]
    record["two_streams_captured"] = True
    record["two_streams_captured_equals_uncaptured_3_steps"] = not differ
    record["two_streams_warm_step_ms"] = {
        "captured": event_ms(lambda: prog.train_step(params, x, labels, mask, lr=0.05,
                                                     mesh=two), 10),
        "uncaptured": event_ms(lambda: exe.eager(params, prog.adj.indices, prog.adj.weights,
                                                 x, labels, mask), 10),
        "mesh_none_captured": event_ms(lambda: prog.train_step(params, x, labels, mask,
                                                               lr=0.05), 10)}
    check(not differ, f"PP train two_streams: captured steps {differ} differ from uncaptured")
    emit(record | {"card": card_line(), "ok": True})


def moe_train(dev, counters, batch=2, seq=512) -> None:
    """granite-moe-1b-a400m at its published widths and depth (bf16, 24
    layers, 32 experts top 8) trained through ``launch.train``'s step, a
    CUDA graph (``lm_loss`` with the router's aux loss, the grouped expert
    products and their backward inside it), at ``batch`` x ``seq``: 3
    uncaptured steps (``TrainStep.eager``), then 3 captured ones from the
    same start, ``torch.equal`` in every loss and in every leaf of params,
    m, v and the step counter; then 4 warm steps of each, timed, with the
    peak allocated over them and the graph's pool.  The captured state
    after step 7 is saved by the ``Checkpointer`` and step 8 run straight;
    then the state restored from the checkpoint, and after it a second
    copy of the saved state, are each written into the graph's buffers and
    step 8 run again: both ``torch.equal`` to the straight step.  One state
    lives on the card at a time: the start, the uncaptured result, the
    saved state and the straight result wait on the host."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import get_config
    from repro_torch.data import LMDataPipeline
    from repro_torch.launch import train
    from repro_torch.models import count_params, init_params
    from repro_torch.models.transformer import captures_train
    from repro_torch.tree import leaf_paths, leaves, tree_map

    def differing(on_card, on_host) -> list:  # leaf by leaf: no second state on the card
        return ["/".join(map(str, path)) for (path, a), b in
                zip(leaf_paths(on_card), leaves(on_host)) if not torch.equal(a, b.to(dev))]

    def to_host(t):
        return t.to("cpu", copy=True)

    arch = "granite-moe-1b-a400m"
    cfg = get_config(arch)
    check(captures_train(cfg, dev), f"{arch} train: not captured by the rule")
    root = Path(__file__).resolve().parent / "build" / "train_moe_ckpt"
    shutil.rmtree(root, ignore_errors=True)
    reset_counts(counters)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    n = count_params(params)
    init_opt, step_fn = train.build_trainer(cfg, lr=3e-4, total_steps=10)
    data = LMDataPipeline(cfg, batch, seq, seed=0, device=dev)
    box = {"state": (params, init_opt(params))}
    del params
    start = tree_map(to_host, box["state"])
    runs = {}
    for kind, fn in (("uncaptured", step_fn.eager), ("captured", step_fn)):
        if kind == "captured":
            box["state"] = tree_map(lambda t: t.to(dev), start)
            del start
        torch.cuda.reset_peak_memory_stats()

        def one(s, fn=fn):
            loss, *st, _ = fn(*box["state"], None, data.peek(s))
            box["state"] = tuple(st)
            return loss

        losses, first_ms = [], []
        for s in range(3):
            t0 = time.perf_counter()
            losses.append(one(s))
            torch.cuda.synchronize()
            first_ms.append((time.perf_counter() - t0) * 1e3)
        first_peak = torch.cuda.max_memory_allocated() / 2**30
        if kind == "uncaptured":
            after3 = tree_map(to_host, box["state"])
            differ = []
        else:
            differ = differing(box["state"], after3)
            del after3
        torch.cuda.reset_peak_memory_stats()
        runs[kind] = {"losses": torch.stack(losses).cpu(), "first_steps_ms": first_ms,
                      "peak_allocated_gib_first_3": first_peak,
                      **timed_steps(lambda s: one(3 + s), 4),
                      "peak_allocated_gib_warm": torch.cuda.max_memory_allocated() / 2**30}
        if kind == "uncaptured":
            box["state"] = None
            torch.cuda.empty_cache()
    if not torch.equal(runs["captured"]["losses"], runs["uncaptured"]["losses"]):
        differ.append("losses")
    for r in runs.values():
        r["losses"] = r["losses"].tolist()
        check(all(math.isfinite(v) for v in r["losses"]), f"{arch} train: non-finite loss")
    pool = graph_pool_bytes(step_fn.graphs.values())
    live = torch.cuda.memory_allocated(dev) / 2**30

    # resume: the state after step 7 saved, step 8 straight, then from the
    # restored state and from a second copy, each written into the buffers
    state = box.pop("state")
    ck = Checkpointer(root)
    t0 = time.perf_counter()
    ck.save(7, {"params": state[0], "opt": state[1]})
    save_s = time.perf_counter() - t0
    saved = tree_map(to_host, state)
    loss, *_ = step_fn(*state, None, data.peek(7))
    straight = tree_map(to_host, (loss, *state))

    def step8_from(host_state) -> list:
        for buf, t in zip(leaves(state), leaves(host_state)):
            buf.copy_(t)
        loss, *_ = step_fn(*state, None, data.peek(7))
        return differing((loss, *state), straight)

    t0 = time.perf_counter()
    restored = ck.restore({"params": saved[0], "opt": saved[1]}, step=7)
    restore_s = time.perf_counter() - t0
    shutil.rmtree(root, ignore_errors=True)
    resume_differ = step8_from((restored["params"], restored["opt"]))
    del restored
    repeat_differ = step8_from(saved)
    del saved, straight
    counts = {k: c.launches for k, c in counters.items()}
    ms = {k: v["step_ms_median"] for k, v in runs.items()}
    emit({"phase": "train", "model": arch, "depth": cfg.n_layers, "d_model": cfg.d_model,
          "experts": [cfg.moe.n_experts, cfg.moe.top_k], "dtype": cfg.dtype, "params": n,
          "captured": True, "graphs": len(step_fn.graphs), "batch": batch, "seq": seq,
          "captured_equals_uncaptured_3_steps": not differ, "leaves_differing": differ[:8],
          "n_leaves_differing": len(differ), "step_ms_median": ms,
          "tokens_per_s": {k: batch * seq / v * 1e3 for k, v in ms.items()},
          "bound_ms_6NT_bf16": 6 * cfg.active_param_count() * batch * seq
          / PEAK_OPS[torch.bfloat16] * 1e3,
          **runs, "graph_pool_bytes": pool, "live_allocated_gib_after_steps": live,
          "checkpoint_save_s": save_s, "checkpoint_restore_s": restore_s,
          "resumed_step_equals_straight": not resume_differ,
          "resume_leaves_differing": resume_differ[:8],
          "repeat_step_bit_identical": not repeat_differ,
          "repeat_leaves_differing": repeat_differ[:8],
          "launches": counts, "card": card_line(),
          "ok": not (differ or resume_differ or repeat_differ)})
    check(all(v == 0 for v in counts.values()), f"{arch} train launched kernels: {counts}")
    check(len(step_fn.graphs) == 1, f"{arch} train: {len(step_fn.graphs)} graphs, not 1")
    check(not differ, f"{arch} train: captured steps differ from uncaptured: {differ[:4]}")
    check(not resume_differ, f"{arch} train: the resumed step differs in "
          f"{len(resume_differ)} leaves, first {resume_differ[:4]}")
    check(not repeat_differ, f"{arch} train: the repeated step differs in {repeat_differ[:4]}")
    del state, step_fn, box
    gc.collect()
    torch.cuda.empty_cache()


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
    from repro_torch.models.transformer import captures_decode

    cfg = get_config("smollm-135m")
    check(captures_decode(cfg, dev), "smollm-135m does not decode captured")
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
          "decode_captured": True, "launches": launches,
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


#: the block kinds whose prefill runs flash attention (one launch a layer)
ATTENTION_KINDS = ("attn", "local", "moe")


def rel_l2(a, b) -> float:
    """||a - b|| / ||b|| in float32."""
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm())


def decode_vs_prefill(cfg, params, prompts, logits, n) -> list:
    """Relative L2 of each of the first ``n`` decode steps' logits against
    the prefill ``forward``'s at the same position."""
    from repro_torch.models import decode_step, init_cache

    cache = init_cache(cfg, prompts.shape[0], n, prompts.device)
    errs = []
    for i in range(n):
        step_logits, cache = decode_step(cfg, params, cache, prompts[:, i:i + 1], i)
        errs.append(rel_l2(step_logits[:, 0], logits[:, i]))
    return errs


def moe_grouped_checks(dev, tokens=1024, seed=0) -> dict:
    """granite-moe-1b-a400m's grouped expert product
    (``moe._grouped_product``) at its widths (d 1024, ff 512, 32 experts,
    top 8) on the ``tokens`` x 8 expert-sorted rows of a 2 x 512 batch,
    four experts left empty, against the per-expert loop it replaced
    (``moe._grouped_product_plain``): the output and the gradients of the
    rows and the three weights, bf16 by relative L2 at
    ``MOE_BF16_REL_L2``, float32 at ``TOL_MOE_F32``; each route's forward
    time.  Then ``moe_ragged``'s forward and backward under
    ``torch.cuda.set_sync_debug_mode("error")``: held in bf16 (no host
    read, what lets a CUDA graph hold the MoE), recorded in float32 (its
    route reads the ends on the host: ``captures_decode``'s dtype rule)."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe

    cfg = get_config("granite-moe-1b-a400m")
    e, d, ff = cfg.moe.n_experts, cfg.d_model, cfg.d_ff
    gen = torch.Generator(device=dev).manual_seed(seed)
    ids = torch.randint(0, e - 4, (tokens * cfg.moe.top_k,), generator=gen, device=dev)
    ids = ids + 1 + (ids >= 4).long() * 2  # experts 0, 5, 6 and 31 get no row
    ends = torch.cumsum(torch.bincount(ids, minlength=e), 0).to(torch.int32)
    rows = ids.numel()
    out = {"rows": rows, "experts": e, "empty_experts": [0, 5, 6, 31]}
    for dtype in (torch.bfloat16, torch.float32):
        xs = torch.randn((rows, d), generator=gen, device=dev).to(dtype)
        ws = [(torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)
              for shape, scale in (((e, d, ff), d ** -0.5), ((e, d, ff), d ** -0.5),
                                   ((e, ff, d), ff ** -0.5))]
        gy = torch.randn((rows, d), generator=gen, device=dev).to(dtype)
        got = {}
        for route, fn in (("grouped", moe._grouped_product),
                          ("plain", moe._grouped_product_plain)):
            args = [t.clone().requires_grad_() for t in [xs, *ws]]
            y = fn(cfg, args[0], ends, *args[1:])
            y.backward(gy)
            got[route] = [y.detach()] + [a.grad for a in args]
            with torch.no_grad():
                got[route + "_ms"] = event_ms(lambda: fn(cfg, xs, ends, *ws), 10)
        names = ["out", "d_rows", "d_gate", "d_up", "d_down"]
        rec = {"rel_l2": {n: rel_l2(a, b) for n, a, b in zip(names, got["grouped"], got["plain"])},
               "max_abs": {n: float((a.float() - b.float()).abs().max())
                           for n, a, b in zip(names, got["grouped"], got["plain"])},
               "empty_expert_grads_zero": all(
                   bool((g[out["empty_experts"]] == 0).all()) for g in got["grouped"][2:]),
               "grouped_forward_ms": got["grouped_ms"], "plain_forward_ms": got["plain_ms"]}
        if dtype == torch.bfloat16:
            ok = max(rec["rel_l2"].values()) <= MOE_BF16_REL_L2
        else:
            ok = all(torch.allclose(a, b, **TOL_MOE_F32)
                     for a, b in zip(got["grouped"], got["plain"]))
        rec["ok"] = ok and rec["empty_expert_grads_zero"]
        out[str(dtype).removeprefix("torch.")] = rec
        check(rec["ok"], f"grouped expert product vs the per-expert loop ({dtype}): {rec}")
        del xs, ws, gy, got

    for dtype in ("bfloat16", "float32"):
        c = cfg.with_(dtype=dtype)
        p = {k: v.requires_grad_() for k, v in moe.init_moe(c, gen, dev).items()}
        x = (torch.randn((2, tokens // 2, d), generator=gen, device=dev) * 0.5).to(
            p["experts_gate"].dtype).requires_grad_()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            y, aux = moe.moe_ragged(c, p, x)
            (y.float().square().mean() + aux).backward()
            synced = None
        except RuntimeError as err:
            synced = str(err)[:200]
        finally:
            torch.cuda.set_sync_debug_mode(0)
        out[f"sync_free_{dtype}"] = synced is None
        if synced:
            out[f"sync_{dtype}"] = synced
        del p, x
    check(out["sync_free_bfloat16"],
          f"moe_ragged synchronised in bf16 under sync debug: {out.get('sync_bfloat16')}")
    return out


def decode_twins(cfg, params, prompts, new_tokens, generated) -> dict:
    """The prompt replayed and ``new_tokens`` greedy tokens decoded twice,
    each on a fresh cache: through the captured ``decode_step``
    (``models.transformer.decoder``, as ``generate`` runs it) and through
    ``decode_step`` uncaptured.  Held: every position's logits
    ``torch.equal`` between the two, and the greedy tokens equal to each
    other and to ``generate``'s (``generated``).  Read: each run's first
    call (the capture's warm-up and capture), prompt replay and decode
    step walls."""
    from repro_torch.models import decode_step, forward, init_cache
    from repro_torch.models.transformer import decoder

    dev = prompts.device
    b, s = prompts.shape[:2]
    logits, _ = forward(cfg, params, prompts)
    first = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
    del logits
    runs = {}
    for kind in ("captured", "uncaptured"):
        cache = init_cache(cfg, b, s + new_tokens, dev)
        if kind == "captured":
            step = decoder(cfg, params, cache, prompts[:, :1])
        else:
            def step(tok, i, cache=cache):
                return decode_step(cfg, params, cache, tok, i)[0]
        sync(dev)
        t0 = time.perf_counter()
        out = [step(prompts[:, :1], 0)]
        sync(dev)
        first_ms = (time.perf_counter() - t0) * 1e3
        for i in range(1, s):
            out.append(step(prompts[:, i:i + 1], i))
        sync(dev)
        replay_s = time.perf_counter() - t0
        tok, toks, ms = first, [], []
        for i in range(new_tokens):
            t0 = time.perf_counter()
            out.append(step(tok, s + i))
            tok = torch.argmax(out[-1][:, -1], dim=-1)[:, None].to(torch.int32)
            toks.append(tok)
            sync(dev)
            ms.append((time.perf_counter() - t0) * 1e3)
        runs[kind] = {"logits": out, "tokens": torch.cat(toks, dim=1), "first_call_ms": first_ms,
                      "replay_s": replay_s, "decode_step_ms_median": statistics.median(ms)}
        del step, cache
    c, u = runs["captured"], runs["uncaptured"]
    differ = [i for i, (x, y) in enumerate(zip(c["logits"], u["logits"])) if not torch.equal(x, y)]
    rec = {"positions": len(c["logits"]), "logits_positions_differing": differ[:8],
           "logits_equal": not differ,
           "tokens_equal": torch.equal(c["tokens"], u["tokens"]),
           "generate_tokens_equal": torch.equal(generated, u["tokens"]),
           **{f"{k}_{kind}": runs[kind][k] for kind in runs
              for k in ("first_call_ms", "replay_s", "decode_step_ms_median")}}
    check(not differ, f"{cfg.name}: captured decode logits differ from uncaptured at "
          f"positions {differ[:8]}")
    check(rec["tokens_equal"] and rec["generate_tokens_equal"],
          f"{cfg.name}: greedy tokens differ between captured, uncaptured and generate")
    return rec


def phase_lm_families(dev, counters, batch=2, prompt_len=128, new_tokens=8) -> dict:
    """The MoE, RG-LRU/local-attention and xLSTM families at full published
    width in bf16 (granite-moe-1b-a400m, recurrentgemma-2b, xlstm-1.3b),
    served through ``generate``: batch 2, 128-token prompts, 8 greedy
    tokens.  Per arch: flash launches in the one prefill ``forward`` equal
    to its attention layers (from the config's layer kinds); tokens in
    range; the prefill logits of the kernel route against the plain route
    by relative L2 (``LM_BF16_REL_L2``); the first 8 decode steps against
    the prefill, in bf16 (a reading) and in float32 on the same weights
    (``DECODE_F32_REL_L2``); the prefill, replay and decode walls, the
    prefill ``forward`` against its analytic bound (``cell_flops`` over the
    bf16 dense peak) and a decode step against parameter bytes over the
    memory rate; peak memory.  recurrentgemma also runs one ``forward`` at
    batch 1 x 4096 tokens, where its 2048 window masks, kernel route
    against plain.  granite-moe's decode is captured by the rule and held
    bitwise against the uncaptured one (:func:`decode_twins`), and its
    grouped expert product checked (:func:`moe_grouped_checks`)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import ShapeSuite
    from repro_torch.kernels.common import measure_wall
    from repro_torch.launch.analytic import cell_flops
    from repro_torch.launch.serve import generate
    from repro_torch.models import count_params, forward, init_params, make_inputs
    from repro_torch.models.transformer import captures_decode
    from repro_torch.tree import tree_map

    t_phase = time.perf_counter()
    launches = {k: 0 for k in counters}
    for arch in ("granite-moe-1b-a400m", "recurrentgemma-2b", "xlstm-1.3b"):
        t_arch = time.perf_counter()
        cfg = get_config(arch)
        n_attn = sum(kind in ATTENTION_KINDS for kind in cfg.layer_kinds)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
        n_params = count_params(params)
        prompts = make_inputs(cfg, batch, prompt_len, seed=0, device=dev)
        reset_counts(counters)
        timings = {}
        toks, lat = generate(cfg, params, prompts, new_tokens, timings=timings)
        torch.cuda.synchronize()
        counts = {k: c.launches for k, c in counters.items()}
        for k in launches:
            launches[k] += counts[k]
        moe_rec = {}
        if "moe" in cfg.layer_kinds:
            check(captures_decode(cfg, dev), f"{arch}: decode_step not captured by the rule")
            moe_rec = {"decode_twins": decode_twins(cfg, params, prompts, new_tokens, toks),
                   "grouped_product": moe_grouped_checks(dev)}
        check(counts["flash_attention"] == n_attn,
              f"{arch}: flash_attention launched {counts['flash_attention']} times in "
              f"one forward of {n_attn} attention layers")
        check(toks.shape == (batch, new_tokens) and toks.dtype == torch.int32,
              f"{arch}: generate returned {tuple(toks.shape)} {toks.dtype}")
        check(bool(((toks >= 0) & (toks < cfg.vocab)).all()), f"{arch}: tokens out of range")

        logits, aux = forward(cfg, params, prompts)
        plain, _ = forward(cfg, params, prompts, use_kernels=False)
        finite = bool(torch.isfinite(logits).all()) and bool(torch.isfinite(aux))
        prefill_err = rel_l2(logits, plain)
        del plain
        # decode against the prefill: in float32 on the same weights, where
        # a routing flip between the two paths (a top-8 of 32 gates within a
        # bf16 rounding) is rare; the bf16 readings are kept beside it
        decode_err = {"bf16": decode_vs_prefill(cfg, params, prompts, logits, new_tokens)}
        del logits
        cfg32 = cfg.with_(dtype="float32")
        params32 = tree_map(lambda t: t.float(), params)
        logits32, _ = forward(cfg32, params32, prompts)
        decode_err["f32"] = decode_vs_prefill(cfg32, params32, prompts, logits32,
                                              new_tokens)
        del logits32, params32
        decode_limit = DECODE_F32_REL_L2.get(arch, DECODE_F32_REL_L2_DEFAULT)
        prefill_ms = {route: 1e3 * measure_wall(
            lambda: forward(cfg, params, prompts, use_kernels=kern), warmup=1, iters=3)
            for route, kern in (("kernels", True), ("plain", False))}
        flops = cell_flops(cfg, ShapeSuite("lm_families", prompt_len, batch, "prefill"))
        bound_ms = flops / PEAK_OPS[torch.bfloat16] * 1e3
        decode_bound_ms = n_params * 2 / HBM_BYTES_PER_S * 1e3
        decode_ms = statistics.median(lat) * 1e3
        rec = {"phase": "lm_families", "arch": arch, "family": cfg.family,
               "depth": cfg.n_layers, "d_model": cfg.d_model, "head_dim": cfg.head_dim,
               "heads": [cfg.n_heads, cfg.n_kv_heads], "vocab": cfg.vocab,
               "dtype": cfg.dtype, "params": n_params, "attention_layers": n_attn,
               "batch": batch, "prompt_len": prompt_len, "new_tokens": new_tokens,
               "prefill_s": timings["prefill_s"], "replay_s": timings["replay_s"],
               "decode_s": timings["decode_s"], "decode_step_ms_median": decode_ms,
               "prefill_forward_ms_median": prefill_ms,
               "prefill_flops": flops, "prefill_bound_ms": bound_ms,
               "prefill_over_bound": prefill_ms["kernels"] / bound_ms,
               "decode_bound_ms_param_bytes": decode_bound_ms,
               "decode_over_bound": decode_ms / decode_bound_ms,
               "launches": counts, "aux_loss": float(aux),
               "decode_captured": captures_decode(cfg, dev),
               "prefill_logits_rel_l2_vs_plain": prefill_err,
               "decode_vs_prefill_rel_l2": decode_err, "rel_l2_limit": LM_BF16_REL_L2,
               "f32_decode_rel_l2_limit": decode_limit, **moe_rec}
        if arch == "recurrentgemma-2b":
            long_in = make_inputs(cfg, 1, 4096, seed=1, device=dev)
            before = counters["flash_attention"].launches
            out, _ = forward(cfg, params, long_in)
            torch.cuda.synchronize()
            long_launches = counters["flash_attention"].launches - before
            twin, _ = forward(cfg, params, long_in, use_kernels=False)
            finite = finite and bool(torch.isfinite(out).all())
            rec["window_forward"] = {"batch": 1, "seq": 4096, "window": cfg.window,
                                     "flash_launches": long_launches,
                                     "logits_rel_l2_vs_plain": rel_l2(out, twin)}
            del out, twin, long_in
        rec["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
        rec["arch_wall_s"] = time.perf_counter() - t_arch
        window = rec.get("window_forward", {"flash_launches": n_attn,
                                            "logits_rel_l2_vs_plain": 0.0})
        window_ok = (window["flash_launches"] == n_attn
                     and window["logits_rel_l2_vs_plain"] <= LM_BF16_REL_L2)
        ok = (finite and prefill_err <= LM_BF16_REL_L2
              and max(decode_err["f32"]) <= decode_limit and window_ok)
        emit({**rec, "card": card_line(), "ok": ok})
        check(finite, f"{arch}: logits or aux loss not finite")
        check(prefill_err <= LM_BF16_REL_L2,
              f"{arch}: prefill logits rel L2 {prefill_err} > {LM_BF16_REL_L2}")
        check(max(decode_err["f32"]) <= decode_limit,
              f"{arch}: f32 decode vs prefill rel L2 {max(decode_err['f32'])} > "
              f"{decode_limit}")
        check(window_ok, f"{arch}: the 4096-token forward: {window}")
        del params, prompts, aux
    torch.cuda.empty_cache()
    print(f"lm_families phase wall {time.perf_counter() - t_phase:.3f} s", flush=True)
    return launches


SHARDED_ARCH = "granite-moe-1b-a400m"


def local_equal(a, b) -> bool:
    """``torch.equal`` of two DTensors' (or tensors') own shards."""
    if hasattr(a, "to_local"):
        a, b = a.to_local(), b.to_local()
    return torch.equal(a, b)


def step_timer(step_fn):
    """``step_fn`` wrapped to record, per call, its CUDA-event ms (host cost
    included) and its calling thread's CPU seconds."""
    log = []

    def run(*args):
        me = threading.get_native_id()
        cpu0 = thread_cpu_s()[me][1]
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = step_fn(*args)
        end.record()
        end.synchronize()
        log.append({"ms": start.elapsed_time(end), "cpu_s": thread_cpu_s()[me][1] - cpu0})
        check(bool(torch.isfinite(out[0])), "sharded step: non-finite loss")
        return out

    return run, log


@contextlib.contextmanager
def held_flash_islands(log: list):
    """Inside, every flash call of the model's attention (``attention.attend``
    on each rank's own q, k, v, inside the ``local_map`` island) launches
    the kernel as usual and is then held against its plain version on the
    same local inputs: ``TOL_BF16`` (``TOL_FLASH`` in f32), and in bf16
    each output row's relative L2 error against the f32 plain version
    (``FLASH_ROW_REL_L2``).  No MoE sits between the two, so no routing
    choice can move either side.  One record a call goes to ``log``."""
    import repro_torch.models.attention as attention_mod
    from repro_torch.kernels.flash_attention import attend_chunked, route

    real = attention_mod.attend

    def held(q, k, v, q_pos, k_pos, window=0, chunk=512):
        out = real(q, k, v, q_pos, k_pos, window, chunk)
        ref = attend_chunked(q, k, v, q_pos, k_pos, window, chunk)
        views = [t.transpose(1, 2) for t in (q, k, v, out)]
        bf16 = q.dtype == torch.bfloat16
        rec = {"q": list(q.shape), "kv": list(k.shape), "dtype": str(q.dtype),
               "route": route(q.dtype, [(t.shape, t.stride()) for t in views],
                              [t.data_ptr() for t in views]),
               "max_abs_err": float((out.float() - ref.float()).abs().max()),
               "close": bool(torch.allclose(out.float(), ref.float(),
                                            **(TOL_BF16 if bf16 else TOL_FLASH)))}
        if bf16:
            ref32 = attend_chunked(q.float(), k.float(), v.float(), q_pos, k_pos, window, chunk)
            rec["row_rel_l2_vs_f32"] = float(
                ((out.float() - ref32).norm(dim=-1) / ref32.norm(dim=-1)).max())
        log.append(rec)
        return out

    attention_mod.attend = held
    try:
        yield log
    finally:
        attention_mod.attend = real


def islands_summary(log: list) -> dict:
    rows = [r["row_rel_l2_vs_f32"] for r in log if "row_rel_l2_vs_f32" in r]
    return {"calls": len(log),
            "local_shapes": sorted({f"q{r['q']} kv{r['kv']} {r['dtype']}" for r in log}),
            "routes": sorted({r["route"] for r in log}),
            "max_abs_err": max(r["max_abs_err"] for r in log),
            "row_rel_l2_max": max(rows) if rows else None,
            "all_close": all(r["close"] for r in log)}


def check_islands(summary: dict, layers: int, where: str) -> None:
    """Each attention layer's flash call held (``held_flash_islands``); in
    bf16 on the tensor cores, within ``FLASH_ROW_REL_L2``."""
    check(summary["calls"] == layers,
          f"{where}: {summary['calls']} flash calls held, not {layers}")
    check(summary["all_close"], f"{where}: a layer's flash output is not within "
          f"tolerance of its plain version: {summary}")
    if summary["row_rel_l2_max"] is not None:
        check(summary["routes"] == ["tensor_cores"],
              f"{where}: bf16 flash did not take the tensor cores: {summary['routes']}")
        check(summary["row_rel_l2_max"] <= FLASH_ROW_REL_L2,
              f"{where}: flash row relative L2 {summary['row_rel_l2_max']} > "
              f"{FLASH_ROW_REL_L2}")


@contextlib.contextmanager
def moe_routes(log: list, replay: list | None = None):
    """Inside, each MoE layer's top-k expert choices (``moe._route``, as
    ``moe_ep`` calls it) are appended to ``log``.  With ``replay`` (the
    ``log`` of an earlier run) each layer takes that run's choices in place
    of its own top-k; its gates, and so the weights of the choices, stay
    its own."""
    import repro_torch.models.moe as moe_mod

    real = moe_mod._route

    def routed(cfg, p, x2d):
        probs, ids, aux = real(cfg, p, x2d)
        if replay is not None:
            ids = replay[len(log)]
            gates = torch.softmax(x2d.float() @ p["router"].float(), dim=-1)
            probs = gates.gather(-1, ids)
            probs = probs / torch.clamp_min(probs.sum(-1, keepdim=True), 1e-9)
        log.append(ids)
        return probs, ids, aux

    moe_mod._route = routed
    try:
        yield log
    finally:
        moe_mod._route = real


def route_flips(a: list, b: list) -> dict:
    """How many top-k expert choices two runs' routers made differently,
    layer by layer (a choice of one run the other's token did not make)."""
    changed, tokens = [], []
    for x, y in zip(a, b):
        found = (x[:, :, None] == y[:, None, :]).any(-1).sum(-1)
        changed.append(int((x.shape[1] - found).sum()))
        tokens.append(int((found < x.shape[1]).sum()))
    first = next((i for i, n in enumerate(changed) if n), None)
    return {"layers": len(a), "tokens_a_layer": int(a[0].shape[0]), "top_k": int(a[0].shape[1]),
            "choices_changed_by_layer": changed, "tokens_changed_by_layer": tokens,
            "choices_changed": sum(changed), "first_layer_changed": first}


def dtensor_host_cost(dev, mesh, rules, steps=5, batch=8, seq=512) -> dict:
    """DTensor's cost on one algorithm: smollm-135m (dense, so the sharded
    and the unsharded step run the same products) trained ``steps`` steps
    unsharded (captured), on the (1, 1) mesh captured, and on the mesh
    uncaptured (``TrainStep.eager``), at the ``train`` phase's batch, each
    from the same weights.  The differences of the medians of the warm
    steps (the first left out), in CUDA-event ms and in the calling
    thread's CPU seconds; whether the mesh's captured losses equal its
    uncaptured ones."""
    from repro_torch.configs import get_config
    from repro_torch.data import LMDataPipeline
    from repro_torch.launch import train
    from repro_torch.models import init_params, param_shardings
    from repro_torch.models.sharding import distribute

    cfg = get_config("smollm-135m")
    data = LMDataPipeline(cfg, batch, seq, seed=0, device=dev)
    logs, losses = {}, {}
    for name in ("unsharded", "sharded", "sharded_eager"):
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
        m, r = (None, None) if name == "unsharded" else (mesh, rules)
        if m is not None:
            params = distribute(params, param_shardings(params, m, r))
        init_opt, step_fn = train.build_trainer(cfg, m, r, lr=3e-4, total_steps=steps)
        run, logs[name] = step_timer(step_fn.eager if name == "sharded_eager" else step_fn)
        opt, losses[name] = init_opt(params), []
        for i in range(steps):
            loss, params, opt, _ = run(params, opt, None, data.peek(i))
            losses[name].append(loss)
        if name != "sharded_eager":
            check(len(step_fn.graphs) == 1, f"smollm-135m {name} step: not one graph")
        del params, opt, step_fn
        gc.collect()
        torch.cuda.empty_cache()
    med = {name: {key: statistics.median(s[key] for s in log[1:]) for key in ("ms", "cpu_s")}
           for name, log in logs.items()}
    same = all(torch.equal(a, b) for a, b in zip(losses["sharded"], losses["sharded_eager"]))
    check(same, "smollm-135m on the (1, 1) mesh: captured losses differ from uncaptured")
    return {"model": "smollm-135m", "batch": batch, "seq": seq, "steps": logs,
            "median_warm": med,
            "sharded_captured_losses_equal_eager": same,
            "dtensor_host_ms_per_step": med["sharded"]["ms"] - med["unsharded"]["ms"],
            "dtensor_host_cpu_s_per_step": med["sharded"]["cpu_s"] - med["unsharded"]["cpu_s"],
            "dtensor_eager_ms_per_step":
                med["sharded_eager"]["ms"] - med["unsharded"]["ms"],
            "dtensor_eager_cpu_s_per_step":
                med["sharded_eager"]["cpu_s"] - med["unsharded"]["cpu_s"]}


def phase_sharded(dev, counters, batch=2, seq=512) -> dict:
    """The LM on a ``(data, model)`` device mesh (``models/sharding.py``,
    ``launch/mesh.py``): on this card a (1, 1) NCCL mesh in this process,
    granite-moe-1b-a400m at its published widths in bf16, DTensor
    parameters placed by ``param_shardings``.  The sharded prefill
    ``forward`` (``moe_ep``; flash attention through ``local_map`` on each
    shard's heads), one flash launch an attention layer, each launch held
    on its local q, k, v against the plain version
    (:func:`held_flash_islands`); the logits against the same mesh's plain
    route, held in f32, and in bf16 with the plain route rerun on the
    kernel route's expert choices; read in bf16 with each route's own
    choices, beside the count of choices that changed; an 8-token sharded
    ``prefill`` (its decode replay through one captured graph over the
    DTensor cache) against the unsharded one, and its decode captured
    against uncaptured (:func:`sharded_decode`); the sharded AdamW step,
    captured, against ``TrainStep.eager``, an eager step under
    ``set_sync_debug_mode("error")`` and a checkpoint-resumed captured step
    (:func:`sharded_train`); DTensor's host cost on smollm-135m, captured
    and eager (:func:`dtensor_host_cost`).  Then, with two or more cards,
    one process a card (:func:`sharded_multi_card`); on one card that part
    says it did not run."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.data import LMDataPipeline
    from repro_torch.launch.mesh import init_process_group, make_mesh_for
    from repro_torch.models import (
        count_params,
        forward,
        init_params,
        param_shardings,
        prefill,
        production_rules,
        use_sharding,
    )
    from repro_torch.models.sharding import distribute
    from repro_torch.tree import leaves, tree_map

    t_phase = time.perf_counter()
    cfg = get_config(SHARDED_ARCH)
    root = Path(__file__).resolve().parent / "build" / "sharded"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    init_process_group("cuda")
    mesh, rules = make_mesh_for(1, 1), production_rules()
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    n = count_params(params)
    data = LMDataPipeline(cfg, batch, seq, seed=0, device=dev)
    tokens = data.peek(0)["inputs"]

    with torch.no_grad():
        short_ref, cache_ref = prefill(cfg, params, tokens[:, :8])
        # the unsharded routes at this shape, read beside the sharded ones
        unsharded_vs_plain = rel_l2(forward(cfg, params, tokens)[0],
                                    forward(cfg, params, tokens, use_kernels=False)[0])
    cache_ref = [t.clone() for t in leaves(cache_ref)]

    sp = distribute(params, param_shardings(params, mesh, rules))
    del params
    torch.cuda.empty_cache()
    placements = sorted({str(t.placements) for t in leaves(sp)})
    reset_counts(counters)
    islands, islands32, kernel_routes, plain_routes = [], [], [], []
    with torch.no_grad(), use_sharding(mesh, rules):
        # the flash kernel's build and first launch, each layer's call held
        with held_flash_islands(islands), moe_routes(kernel_routes):
            forward(cfg, sp, tokens)
        reset_counts(counters)
        sync(dev)
        t0 = time.perf_counter()
        logits, _ = forward(cfg, sp, tokens)
        sync(dev)
        prefill_ms = (time.perf_counter() - t0) * 1e3
        flash = counters["flash_attention"].launches
        counts = {k: c.launches for k, c in counters.items()}
        with moe_routes(plain_routes):
            plain_logits, _ = forward(cfg, sp, tokens, use_kernels=False)
        logits = logits.full_tensor()
        vs_plain = rel_l2(logits, plain_logits.full_tensor())
        del plain_logits
        flips = route_flips(kernel_routes, plain_routes)
        with moe_routes([], replay=kernel_routes):
            same_routes = forward(cfg, sp, tokens, use_kernels=False)[0].full_tensor()
        vs_plain_same_routes = rel_l2(logits, same_routes)
        del same_routes, kernel_routes, plain_routes
        t0 = time.perf_counter()
        short, cache = prefill(cfg, sp, tokens[:, :8])
        sync(dev)
        short_prefill_s = time.perf_counter() - t0
        short_vs = rel_l2(short.full_tensor(), short_ref)
        cache_vs = max(rel_l2(a.full_tensor(), b) for a, b in zip(leaves(cache), cache_ref))
        del short, cache, short_ref, cache_ref
        decode8 = sharded_decode(dev, cfg, sp, tokens[:, :8])
        # the same comparison in float32, where the two routes' rounding
        # cannot flip an expert choice: the held check of flash on the mesh
        cfg32 = cfg.with_(dtype="float32")
        sp32 = tree_map(lambda t: t.float(), sp)
        with held_flash_islands(islands32):
            logits32 = forward(cfg32, sp32, tokens)[0].full_tensor()
        f32_vs_plain = rel_l2(logits32,
                              forward(cfg32, sp32, tokens, use_kernels=False)[0].full_tensor())
        del sp32
    torch.save(logits32.cpu(), root / "logits_1x1_f32.pt")
    del logits32
    torch.save(logits.cpu(), root / "logits_1x1.pt")
    del logits

    trained = sharded_train(dev, cfg, mesh, rules, sp, data, root)
    del sp
    gc.collect()
    torch.cuda.empty_cache()
    dtensor = dtensor_host_cost(dev, mesh, rules)
    islands, islands32 = islands_summary(islands), islands_summary(islands32)
    emit({"phase": "sharded", "model": SHARDED_ARCH, "mesh": {"data": 1, "model": 1},
          "backend": dist.get_backend(), "depth": cfg.n_layers, "depth_cut": False,
          "d_model": cfg.d_model, "dtype": cfg.dtype, "params": n, "batch": batch, "seq": seq,
          "param_placements": placements,
          "prefill_ms": prefill_ms, "flash_launches": flash,
          "flash_islands_bf16": islands, "flash_islands_f32": islands32,
          "prefill_vs_plain_rel_l2": vs_plain,
          "prefill_vs_plain_same_routes_rel_l2": vs_plain_same_routes,
          "route_flips_vs_plain": flips,
          "unsharded_prefill_vs_plain_rel_l2": unsharded_vs_plain,
          "prefill_f32_vs_plain_rel_l2": f32_vs_plain,
          "prefill8_vs_unsharded_rel_l2": short_vs, "cache8_vs_unsharded_rel_l2": cache_vs,
          "prefill8_s": short_prefill_s, "decode8": decode8,
          "train": trained, "dtensor_cost": dtensor,
          "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
          "phase_s": time.perf_counter() - t_phase, "card": card_line()})
    check(flash == cfg.n_layers, f"sharded prefill launched flash {flash} times, "
          f"not once per attention layer ({cfg.n_layers})")
    check_islands(islands, cfg.n_layers, "sharded bf16 prefill")
    check(vs_plain_same_routes <= LM_BF16_REL_L2,
          f"sharded bf16 prefill vs the plain route on the same expert choices: "
          f"{vs_plain_same_routes} > {LM_BF16_REL_L2}")
    check_islands(islands32, cfg.n_layers, "sharded f32 prefill")
    check(f32_vs_plain <= SHARDED_F32_REL_L2,
          f"sharded f32 prefill vs plain route: {f32_vs_plain}")
    check(cache_vs <= LM_BF16_REL_L2, f"sharded 8-token prefill's cache vs unsharded: {cache_vs}")
    if torch.cuda.device_count() >= 2:
        sharded_multi_card(root)
        restore_on_one_card(root / "ckpt_multi", mesh)
    else:
        emit({"phase": "sharded_multi_card", "ran": False,
              "reason": f"{torch.cuda.device_count()} CUDA device: the multi-card checks "
                        "(EP over cards, data parallelism, elastic restore) need two or "
                        "more; not run, not passed"})
        restore_on_one_card(root / "ckpt", mesh)
    shutil.rmtree(root, ignore_errors=True)
    dist.destroy_process_group()
    return counts


def on_host(tree):
    """Each tensor of ``tree`` (a DTensor's own shard) copied to the host."""
    from repro_torch.capture import local
    from repro_torch.tree import tree_map

    return tree_map(lambda t: local(t).to("cpu", copy=True), tree)


def shards_differing(on_card, host) -> list:
    """The paths of the leaves of ``on_card`` whose shards differ from
    ``host``'s (:func:`on_host`), leaf by leaf: no second state on the card."""
    from repro_torch.capture import local
    from repro_torch.tree import leaf_paths, leaves

    return ["/".join(map(str, path)) for (path, a), b in zip(leaf_paths(on_card), leaves(host))
            if not torch.equal(local(a), b.to(local(a).device))]


def sharded_decode(dev, cfg, sp, prompt) -> dict:
    """The prompt through ``decode_step`` on the mesh (inside
    ``use_sharding``) over the heads-placed DTensor cache of
    ``init_cache``: captured (one graph, ``transformer.decoder``, the
    position a 0-d device tensor) and uncaptured, each on a cache of its
    own.  Every position's logits and every cache leaf ``torch.equal``;
    both walls (the captured one includes its warm-up and capture)."""
    from repro_torch.capture import local
    from repro_torch.models import decode_step, init_cache
    from repro_torch.models.transformer import captures_decode, decoder
    from repro_torch.tree import leaves

    b, n = prompt.shape
    caches, logits, walls = {}, {}, {}
    for kind in ("captured", "uncaptured"):
        cache = init_cache(cfg, b, n, dev)
        sync(dev)
        t0 = time.perf_counter()
        if kind == "captured":
            check(captures_decode(cfg, dev, cache), "sharded decode: not captured by the rule")
            step = decoder(cfg, sp, cache, prompt[:, :1])
        else:
            def step(tok, i, cache=cache):
                return decode_step(cfg, sp, cache, tok, i)[0]
        logits[kind] = [local(step(prompt[:, i:i + 1], i)).clone() for i in range(n)]
        sync(dev)
        walls[kind] = time.perf_counter() - t0
        caches[kind] = cache
    same_logits = all(torch.equal(a, b) for a, b in zip(logits["captured"],
                                                        logits["uncaptured"]))
    same_cache = all(torch.equal(local(a), local(b)) for a, b in
                     zip(leaves(caches["captured"]), leaves(caches["uncaptured"])))
    check(same_logits and same_cache, f"sharded decode: captured differs from uncaptured "
          f"(logits equal {same_logits}, cache equal {same_cache})")
    return {"positions": n, "batch": b, "captured_equals_uncaptured": True,
            "cache_placements": str(leaves(caches["captured"])[0].placements),
            "captured_s": walls["captured"], "uncaptured_s": walls["uncaptured"]}


def sharded_train(dev, cfg, mesh, rules, sp, data, root) -> dict:
    """``launch.train``'s AdamW step on the (1, 1) NCCL mesh (bf16
    parameters, f32 moments, batch 2 x 512), a CUDA graph by the rule:
    3 uncaptured steps (``TrainStep.eager``) from ``sp`` and a fresh
    state, one more under ``set_sync_debug_mode("error")`` (forward and
    backward read nothing on the host), then 3 captured steps from the same
    start, each leaf's shard and every loss ``torch.equal``; the state
    after step 3 saved by the ``Checkpointer``, step 4 run straight, then
    from the restored state (its placements kept), ``torch.equal``.  One
    state lives on the card at a time."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.launch import train
    from repro_torch.models.transformer import captures_train
    from repro_torch.capture import local
    from repro_torch.tree import leaves

    init_opt, step_fn = train.build_trainer(cfg, mesh, rules, lr=3e-4, total_steps=10)
    check(captures_train(cfg, dev, mesh), "sharded train: not captured by the rule")
    box = {"state": (sp, init_opt(sp))}
    start = on_host(box["state"])
    losses, logs = {}, {}
    for kind in ("uncaptured", "captured"):
        run, logs[kind] = step_timer(step_fn.eager if kind == "uncaptured" else step_fn)
        losses[kind] = []
        for s in range(3):
            loss, *st, _ = run(*box["state"], None, data.peek(s))
            box["state"] = tuple(st)
            losses[kind].append(loss)
        if kind == "uncaptured":
            batch = data.peek(3)  # the batch's copy from the host is outside the step
            sync(dev)
            torch.cuda.set_sync_debug_mode("error")
            try:  # raises where a forward or backward op synchronises
                step_fn.eager(*box["state"], None, batch)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            del batch
            after3 = on_host(box["state"])
            for buf, h in zip(leaves(box["state"]), leaves(start)):  # the start again
                local(buf).copy_(h)
            del start
    differ = shards_differing(box["state"], after3)
    del after3
    if not torch.equal(torch.stack(losses["captured"]), torch.stack(losses["uncaptured"])):
        differ.append("losses")
    state = box.pop("state")
    ck = Checkpointer(root / "ckpt")
    t0 = time.perf_counter()
    ck.save(3, {"params": state[0], "opt": state[1]})
    save_s = time.perf_counter() - t0
    loss, *_ = step_fn(*state, None, data.peek(3))
    straight = on_host((loss, *state))
    t0 = time.perf_counter()
    restored = ck.restore({"params": state[0], "opt": state[1]}, step=3)
    restore_s = time.perf_counter() - t0
    same_placements = all(a.placements == b.placements for a, b in
                          zip(leaves(restored["params"]), leaves(state[0])))
    loss, *_ = step_fn(restored["params"], restored["opt"], None, data.peek(3))
    del restored
    resume_differ = shards_differing((loss, *state), straight)
    del straight, state
    out = {"steps": 3, "graphs": len(step_fn.graphs),
           "losses": {k: [float(v) for v in ls] for k, ls in losses.items()},
           "step_ms": {k: [r["ms"] for r in log] for k, log in logs.items()},
           "step_cpu_s": {k: [r["cpu_s"] for r in log] for k, log in logs.items()},
           "warm_step_ms_median": {k: statistics.median(r["ms"] for r in log[1:])
                                   for k, log in logs.items()},
           "eager_step_under_sync_debug_error": "passed",
           "captured_equals_uncaptured_3_steps": not differ, "leaves_differing": differ[:8],
           "checkpoint_save_s": save_s, "checkpoint_restore_s": restore_s,
           "restored_on_the_same_placements": same_placements,
           "resumed_step_equals_straight": not resume_differ,
           "resume_leaves_differing": resume_differ[:8],
           "graph_pool_bytes": graph_pool_bytes(step_fn.graphs.values())}
    check(len(step_fn.graphs) == 1, f"sharded train: {len(step_fn.graphs)} graphs, not 1")
    check(not differ, f"sharded train: captured steps differ from uncaptured in {differ[:4]}")
    check(same_placements, "restored parameters lost their placements")
    check(not resume_differ, f"sharded resumed step differs in {len(resume_differ)} leaves: "
          f"{resume_differ[:4]}")
    return out


def restore_on_one_card(ckdir, mesh) -> None:
    """The step-1 parameters restored onto the (1, 1) mesh of this card,
    ``torch.equal`` to the files (read onto the CPU)."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import get_config
    from repro_torch.models import init_params, param_shardings, production_rules
    from repro_torch.tree import leaves

    cfg = get_config(SHARDED_ARCH)
    like = init_params(cfg, torch.Generator(device="cuda").manual_seed(1), "cuda")
    ck = Checkpointer(ckdir)
    got = ck.restore({"params": like}, shardings={
        "params": param_shardings(like, mesh, production_rules())})
    del like
    want = ck.restore({"params": on_host_like(cfg)})
    same = all(torch.equal(a.full_tensor().cpu(), b)
               for a, b in zip(leaves(got["params"]), leaves(want["params"])))
    emit({"phase": "sharded_restore", "ranks": 1, "exact": same})
    check(same, "the checkpoint restored on one card differs from its files")


def on_host_like(cfg):
    """A tree of the parameters' structure whose leaves are numbers: the
    ``Checkpointer`` then reads each leaf onto the host as it is stored."""
    from repro_torch.models import init_params
    from repro_torch.tree import tree_map

    return tree_map(lambda _: 0, init_params(cfg, torch.Generator(), "meta"))


def sharded_rank(world: int, root: str) -> dict:
    """One rank of the multi-card run (NCCL, this process's card):
    (a) the sharded prefill on a (1, world) mesh — experts, heads, d_ff over
    the cards; the vocab of 49,155 replicated — against the (1, 1) logits
    the parent saved, each flash launch held on this rank's own heads
    (:func:`held_flash_islands`); (b) data parallelism on (world / 2, 2) in f32 (the
    MoE with room for every token and no aux loss, so the whole batch's
    loss is the same function) against this card's unsharded loss and
    gradients on the whole batch (rank 0); (c) on (world / 2, 2), bf16: two
    steps uncaptured, then two captured from the same start, ``torch.equal``
    shard by shard, the step-1 state saved by every rank (rank 0 writes),
    the resumed step ``torch.equal`` to the straight one; per-rank step
    walls and one profiled step's NCCL kernel time."""
    from dataclasses import replace

    import torch.distributed as dist

    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import get_config
    from repro_torch.data import LMDataPipeline
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.models import (
        forward,
        init_params,
        lm_loss,
        param_shardings,
        production_rules,
        use_sharding,
    )
    from repro_torch.models.sharding import distribute, shard
    from repro_torch.tree import leaf_paths, leaves, tree_map

    rank = dist.get_rank()
    dev = torch.device("cuda", torch.cuda.current_device())
    cfg, rules = get_config(SHARDED_ARCH), production_rules()
    data = LMDataPipeline(cfg, 2, 512, seed=0, device=dev)
    out = {"rank": rank, "device": str(dev)}

    # (a) expert parallelism over the cards, in bf16 (read) and f32 (held)
    mesh = make_mesh_for(world, world)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    sp = distribute(params, param_shardings(params, mesh, rules))
    del params
    out["placements_1xN"] = {"/".join(map(str, k)): str(v.placements)
                             for k, v in leaf_paths(sp)
                             if k[-1] in ("embed", "experts_gate", "wq", "wo", "router")}
    for tag, c in (("", cfg), ("_f32", cfg.with_(dtype="float32"))):
        held = []
        with torch.no_grad(), use_sharding(mesh, rules), held_flash_islands(held):
            p = sp if c is cfg else tree_map(lambda t: t.float(), sp)
            logits = forward(c, p, data.peek(0)["inputs"])[0].full_tensor()
            del p
        out[f"flash_islands{tag or '_bf16'}"] = islands_summary(held)
        if rank == 0:
            ref = torch.load(Path(root) / f"logits_1x1{tag}.pt").to(dev)
            out[f"ep_vs_1x1_rel_l2{tag}"] = rel_l2(logits, ref)
            del ref
        del logits
    del sp
    torch.cuda.empty_cache()

    # (b) data parallelism against the whole batch on one card, f32, with
    # room for every token and no aux loss (the whole batch's loss is then
    # the same function): held with every token sent to every expert (no
    # routing choice to flip), read with the published top-8
    mesh2 = make_mesh_for(world, 2)
    batch = data.peek(0)
    names = ["/".join(map(str, k)) for k, _ in leaf_paths(init_params(
        cfg, torch.Generator(), "meta"))]
    for tag, k in (("", cfg.moe.n_experts), ("_top8", cfg.moe.top_k)):
        moe = replace(cfg.moe, top_k=k, capacity_factor=cfg.moe.n_experts / k,
                      router_aux_weight=0.0)
        cfg32 = cfg.with_(dtype="float32", moe=moe)
        p32 = init_params(cfg32, torch.Generator(device=dev).manual_seed(0), dev)
        with use_sharding(mesh2, rules):
            sp = tree_map(lambda t: t.requires_grad_(),
                          distribute(p32, param_shardings(p32, mesh2, rules)))
            sb = {key: shard(v, "batch", None) for key, v in batch.items()}
            loss = lm_loss(cfg32, sp, sb).full_tensor()
            grads = [g.redistribute(w.device_mesh, w.placements).full_tensor()
                     for g, w in zip(torch.autograd.grad(loss, leaves(sp)), leaves(sp))]
        del sp
        if rank == 0:
            p = tree_map(lambda t: t.requires_grad_(), p32)
            ref = lm_loss(cfg32, p, batch)
            errs = sorted(((rel_l2(g, r), n) for g, r, n in
                           zip(grads, torch.autograd.grad(ref, leaves(p)), names)), reverse=True)
            out[f"dp_loss{tag}"] = [float(loss.detach()), float(ref.detach())]
            out[f"dp_grad_rel_l2_max{tag}"] = errs[0][0]
            out[f"dp_grad_rel_l2_worst{tag}"] = errs[:4]
            del p, ref
        del p32, grads
        torch.cuda.empty_cache()

    # (c) two bf16 steps on (world / 2, 2): uncaptured, then captured from
    # the same start (the captured state is the graph's, donated), a
    # checkpoint, the resumed step
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    sp = distribute(params, param_shardings(params, mesh2, rules))
    del params
    init_opt, step_fn = train.build_trainer(cfg, mesh2, rules, lr=3e-4, total_steps=2)
    start = (sp, init_opt(sp))
    del sp
    loss, p, o, _ = step_fn.eager(*start, None, data.peek(0))
    loss, p, o, _ = step_fn.eager(p, o, None, data.peek(1))
    eager2 = on_host((loss, p, o))
    del p, o
    run, log = step_timer(step_fn)
    _, p1, o1, _ = run(*start, None, data.peek(0))
    del start
    ck = Checkpointer(Path(root) / "ckpt_multi")
    ck.save(1, {"params": p1, "opt": o1})
    loss, p2, o2, _ = run(p1, o1, None, data.peek(1))
    out["captured_leaves_differing"] = shards_differing((loss, p2, o2), eager2)[:8]
    out["graphs"] = len(step_fn.graphs)
    straight = on_host((p2, o2))
    state = ck.restore({"params": p2, "opt": o2}, step=1)
    _, p3, o3, _ = run(state["params"], state["opt"], None, data.peek(1))
    out["resume_equal"] = not shards_differing((p3, o3), straight)
    del eager2, straight
    wall = []

    def profiled():
        t0 = time.perf_counter()
        run(state["params"], state["opt"], None, data.peek(1))
        wall.append(time.perf_counter() - t0)

    _, events = device_trace(profiled, f"sharded_step_rank{rank}")
    kernels = [(a, b) for cat, _, _, a, b in events if cat == "kernel"]
    nccl = [(a, b) for cat, name, _, a, b in events if cat == "kernel" and "nccl" in name.lower()]
    out.update({"steps": log,
                "profiled_step": {**trace_summary(events, wall[0]),
                                  "nccl_ms": busy_us(nccl) / 1e3,
                                  "nccl_share_of_step": busy_us(nccl) / (wall[0] * 1e6),
                                  "nccl_share_of_kernel_time":
                                      busy_us(nccl) / max(busy_us(kernels), 1e-9)},
                "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30})
    return out


def elastic_rank(root: str) -> dict:
    """One rank of a smaller group: the parameters the larger group saved,
    restored onto a (1, world) mesh of this group, ``torch.equal`` to the
    files."""
    import torch.distributed as dist

    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.models import init_params, param_shardings, production_rules
    from repro_torch.tree import leaves

    world = dist.get_world_size()
    dev = torch.device("cuda", torch.cuda.current_device())
    cfg = get_config(SHARDED_ARCH)
    mesh = make_mesh_for(world, world)
    like = init_params(cfg, torch.Generator(device=dev).manual_seed(1), dev)
    ck = Checkpointer(Path(root) / "ckpt_multi")
    got = ck.restore({"params": like}, shardings={
        "params": param_shardings(like, mesh, production_rules())})
    del like
    full = [t.full_tensor().cpu() for t in leaves(got["params"])]
    if dist.get_rank() != 0:
        return {}
    want = ck.restore({"params": on_host_like(cfg)})
    return {"exact": all(torch.equal(a, b) for a, b in zip(full, leaves(want["params"]))),
            "placements": sorted({str(t.placements) for t in leaves(got["params"])})}


def sharded_multi_card(root: Path) -> None:
    """One process a card (``repro_torch.launch.mesh.spawn``: NCCL, a
    ``file://`` store in a temporary directory, a join timeout): expert
    parallelism, data parallelism, a bitwise resume and a checkpoint
    written on every card, then restored on half the cards and (by the
    caller) on one."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import spawn

    world = 4 if torch.cuda.device_count() >= 4 else 2
    t0 = time.perf_counter()
    ranks = spawn(sharded_rank, world, world, str(root), device_type="cuda",
                  join_timeout_s=600, pg_timeout_s=300)
    wall_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    half = spawn(elastic_rank, world // 2, str(root), device_type="cuda",
                 join_timeout_s=300, pg_timeout_s=300)[0]
    r0 = ranks[0]
    record = {"phase": "sharded_multi_card", "ran": True, "world": world,
              "meshes": {"ep": [1, world], "dp": [world // 2, 2]},
              "ep_vs_1x1_rel_l2": r0["ep_vs_1x1_rel_l2"],
              "ep_vs_1x1_rel_l2_f32": r0["ep_vs_1x1_rel_l2_f32"],
              "placements_1xN": r0["placements_1xN"],
              "flash_islands_bf16_by_rank": [r["flash_islands_bf16"] for r in ranks],
              "flash_islands_f32_by_rank": [r["flash_islands_f32"] for r in ranks],
              "dp_loss_sharded_vs_whole": r0["dp_loss"],
              "dp_grad_rel_l2_max": r0["dp_grad_rel_l2_max"],
              "dp_grad_rel_l2_worst": r0["dp_grad_rel_l2_worst"],
              "dp_loss_sharded_vs_whole_top8": r0["dp_loss_top8"],
              "dp_grad_rel_l2_max_top8": r0["dp_grad_rel_l2_max_top8"],
              "dp_grad_rel_l2_worst_top8": r0["dp_grad_rel_l2_worst_top8"],
              "resume_equal_by_rank": [r["resume_equal"] for r in ranks],
              "captured_equals_eager_by_rank": [not r["captured_leaves_differing"]
                                                for r in ranks],
              "graphs_by_rank": [r["graphs"] for r in ranks],
              "step_ms_by_rank": [[s["ms"] for s in r["steps"]] for r in ranks],
              "step_cpu_s_by_rank": [[s["cpu_s"] for s in r["steps"]] for r in ranks],
              "profiled_step_by_rank": [r["profiled_step"] for r in ranks],
              "peak_memory_gib_by_rank": [r["peak_memory_gib"] for r in ranks],
              "restored_on": world // 2, "restore_exact": half["exact"],
              "restore_placements": half["placements"],
              "wall_s": wall_s, "restore_wall_s": time.perf_counter() - t0,
              "card": card_line()}
    emit(record)
    layers = get_config(SHARDED_ARCH).n_layers
    for r in ranks:
        check_islands(r["flash_islands_bf16"], layers, f"rank {r['rank']} bf16 (1, {world})")
        check_islands(r["flash_islands_f32"], layers, f"rank {r['rank']} f32 (1, {world})")
    check(r0["ep_vs_1x1_rel_l2_f32"] <= SHARDED_F32_REL_L2,
          f"EP on (1, {world}) vs (1, 1) in f32: {r0['ep_vs_1x1_rel_l2_f32']}")
    check(abs(r0["dp_loss"][0] - r0["dp_loss"][1]) <= 1e-4 * abs(r0["dp_loss"][1]),
          f"data-parallel loss vs the whole batch: {r0['dp_loss']}")
    check(r0["dp_grad_rel_l2_max"] <= DP_GRAD_REL_L2,
          f"data-parallel gradients vs the whole batch: {r0['dp_grad_rel_l2_max']}")
    check(all(r["resume_equal"] for r in ranks), "multi-card resumed step differs")
    for r in ranks:
        check(r["graphs"] == 1 and not r["captured_leaves_differing"],
              f"rank {r['rank']}: {r['graphs']} graphs; captured steps differ from "
              f"uncaptured in {r['captured_leaves_differing'][:4]}")
    check(half["exact"], f"checkpoint from {world} ranks restored on {world // 2} differs")


# ---------------------------------------------------------------------------
# The multi-pod dry-run (fake process groups, in subprocesses)
# ---------------------------------------------------------------------------

#: (a) the production cells: smollm-135m decode_32k on 16 x 16 and 2 x 16 x
#: 16, granite-moe-1b-a400m train_4k on 16 x 16 (a fake group of 256 or 512
#: ranks is the subprocess's default group)
DRYRUN_PRODUCTION = """
import json, time
import torch.distributed as dist
from repro_torch.launch.dryrun import run_cell
for arch, shape, mp in (("smollm-135m", "decode_32k", False),
                        ("granite-moe-1b-a400m", "train_4k", False),
                        ("smollm-135m", "decode_32k", True)):
    if mp and dist.is_initialized():
        dist.destroy_process_group()  # one fake group at a time
    t0 = time.perf_counter()
    r = run_cell(arch, shape, mp, save=False)
    r["wall_s"] = time.perf_counter() - t0
    print(json.dumps(r), flush=True)
"""

#: (b) granite-moe-1b-a400m at the sharded phase's shape on fake meshes of
#: the sizes the card run uses, (1, 1), or (1, 4) and (2, 2): the trainer's
#: step (train 2 x 512) and, on (1, 1), the kernel-route prefill; (c) on
#: (1, 1) and (1, 4) the decode step at the last slot of a 516-slot cache
#: placed by ``cache_shardings``
DRYRUN_HELD = """
import json, time
from repro_torch.configs import ShapeSuite, get_config
from repro_torch.launch import train
from repro_torch.launch.dryrun import cell_result, placed_batch, record, step_stats
from repro_torch.launch.hlo import analyze
from repro_torch.launch.mesh import make_fake_mesh
from repro_torch.launch.specs import abstract_params
from repro_torch.models import forward, param_shardings, production_rules, use_sharding
from repro_torch.models.sharding import distribute
cfg, meshes, (batch, seq), decode_len = get_config(%r), %r, %r, %r
shapes = {"train": ShapeSuite("sharded_train", seq, batch, "train"),
          "prefill": ShapeSuite("sharded_prefill", seq, batch, "prefill")}
decode = ShapeSuite("sharded_decode", decode_len, batch, "decode")
for shape in meshes:
    mesh, rules = make_fake_mesh(shape), production_rules()
    with use_sharding(mesh, rules):
        pa = abstract_params(cfg)
        params = distribute(pa, param_shardings(pa, mesh, rules))
        init_opt, step = train.build_trainer(cfg, mesh, rules, lr=3e-4, total_steps=10)
        opt = init_opt(params)
        data = {k: placed_batch(cfg, s) for k, s in shapes.items()}
    fns = {"train": (lambda p, o, b: step(p, o, None, b), (params, opt, data["train"]))}
    if shape == (1, 1):
        fns["prefill"] = (lambda p, b: forward(cfg, p, b["inputs"])[0],
                          (params, data["prefill"]))
    for kind, (fn, args) in fns.items():
        t0 = time.perf_counter()
        with use_sharding(mesh, rules):
            stats = analyze(record(fn, args))
        r = cell_result(cfg, shapes[kind], mesh, stats, time.perf_counter() - t0)
        print(json.dumps(r), flush=True)
    if shape[0] == 1:  # (c): the decode step on the cache cache_shardings places
        t0 = time.perf_counter()
        with use_sharding(mesh, rules):
            stats, _ = step_stats(cfg, decode, mesh, rules)
        print(json.dumps(cell_result(cfg, decode, mesh, stats, time.perf_counter() - t0)),
              flush=True)
"""

#: (d) xlstm-1.3b's prefill at 2 x 512 on a fake (1, 1) mesh, its time loops
#: (the mLSTM's chunks, the sLSTM's positions) scaled, then unrolled
DRYRUN_LOOPS = """
import json, time
from repro_torch.configs import ShapeSuite, get_config
from repro_torch.launch.dryrun import cell_result, step_stats
from repro_torch.launch.mesh import make_fake_mesh
from repro_torch.models import production_rules, use_sharding
cfg, (batch, seq) = get_config(%r), %r
shape = ShapeSuite("loops_prefill", seq, batch, "prefill")
mesh, rules = make_fake_mesh((1, 1)), production_rules()
for unrolled in (False, True):
    t0 = time.perf_counter()
    with use_sharding(mesh, rules):
        stats, _ = step_stats(cfg, shape, mesh, rules, unrolled=unrolled)
    r = cell_result(cfg, shape, mesh, stats, time.perf_counter() - t0)
    r["unrolled"] = unrolled
    print(json.dumps(r), flush=True)
"""


def start_dryrun() -> dict:
    """Both dry-run scripts in subprocesses of their own, started together:
    a fake default group cannot share this process with NCCL.  They trace
    on the CPU while the card runs the other phases."""
    src = Path(__file__).resolve().parent / "src"
    env = dict(os.environ, PYTHONPATH=str(src))
    decode_len = DECODE_PROMPT + DECODE_STEPS
    scripts = {"production": DRYRUN_PRODUCTION,
               "held": DRYRUN_HELD % (SHARDED_ARCH, [(1, 1)], (2, 512), decode_len),
               "loops": DRYRUN_LOOPS % (LOOPS_ARCH, (2, LOOPS_PROMPT))}
    if torch.cuda.device_count() >= 4:  # the meshes of the four-card run
        scripts["held4"] = DRYRUN_HELD % (SHARDED_ARCH, [(1, 4), (2, 2)], (2, 512),
                                          decode_len)
    procs = {name: subprocess.Popen([sys.executable, "-c", script], cwd=src.parent, env=env,
                                    stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for name, script in scripts.items()}
    # a phase that fails before they are read leaves none running
    atexit.register(lambda: [p.kill() for p in procs.values() if p.poll() is None])
    return procs


def dryrun_results(proc, what, timeout_s=900) -> list:
    """The JSON lines a dry-run subprocess printed; fails the run when it
    failed."""
    try:
        out, err = proc.communicate(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
    if proc.returncode != 0:
        print(err[-6000:], file=sys.stderr, flush=True)
    check(proc.returncode == 0, f"dryrun {what}: the trace failed (exit {proc.returncode})")
    return [json.loads(line) for line in out.splitlines() if line.startswith("{")]


def dryrun_rank(model_parallel: int) -> dict:
    """One rank of the four-card step (NCCL, this process's card): the
    trainer's granite-moe step at 2 x 512 on a (4 / model_parallel,
    model_parallel) mesh, once warm, then under ``CommDebugMode``: the
    collectives it issued on this rank and its argument bytes."""
    import torch.distributed as dist
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.configs import get_config
    from repro_torch.data import LMDataPipeline
    from repro_torch.launch import train
    from repro_torch.launch.dryrun import local_bytes
    from repro_torch.launch.hlo import comm_counts
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.models import init_params, param_shardings, production_rules
    from repro_torch.models import shard, use_sharding
    from repro_torch.models.sharding import distribute

    dev = torch.device("cuda", torch.cuda.current_device())
    cfg = get_config(SHARDED_ARCH)
    mesh, rules = make_mesh_for(dist.get_world_size(), model_parallel), production_rules()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    sp = distribute(params, param_shardings(params, mesh, rules))
    del params
    init_opt, step = train.build_trainer(cfg, mesh, rules, lr=3e-4, total_steps=10)
    opt = init_opt(sp)
    batch = LMDataPipeline(cfg, 2, 512, seed=0, device=dev).peek(0)
    with use_sharding(mesh, rules):
        placed = {k: shard(v, "batch", None) for k, v in batch.items()}
    step.eager(sp, opt, None, batch)  # uncaptured: CommDebugMode sees its ops
    torch.cuda.synchronize()
    with CommDebugMode() as comm:
        step.eager(sp, opt, None, batch)
    torch.cuda.synchronize()
    return {"rank": dist.get_rank(), "comm": comm_counts(comm),
            "argument_bytes": local_bytes((sp, opt, placed))}


#: (c) the decode on the cache ``cache_shardings`` places: a prompt
#: prefilled unsharded, then the steps decoded against the placed cache
DECODE_PROMPT, DECODE_STEPS = 512, 4
#: (d) the time-loop scaling held against a real prefill: xlstm-1.3b at 2 x
#: this many positions
LOOPS_ARCH, LOOPS_PROMPT = "xlstm-1.3b", 512


def prefilled_cache(cfg, params, tokens, length: int):
    """The decode cache after the prompt ``tokens`` (B, P), from one
    ``forward``: each attention layer's keys and values at positions 0..P-1
    (after rope, as ``decode_attention`` writes them) copied into slots
    0..P-1 of a ``length``-slot cache (no mesh: granite-moe's 8 KV heads
    need no alignment on the meshes here).  The same cache as replaying
    the prompt through ``decode_step``, up to the two paths' sum orders, at
    one forward's cost (the replay is P host-bound steps)."""
    from repro_torch.models import attention as attention_mod
    from repro_torch.models import forward, init_cache

    check(set(cfg.layer_kinds) <= {"attn", "moe"}, "prefilled_cache: full attention only")
    project, kv = attention_mod._project_qkv, []

    def keep(*args, **kwargs):
        q, k, v = project(*args, **kwargs)
        kv.append((k, v))
        return q, k, v

    attention_mod._project_qkv = keep
    try:
        with torch.no_grad():
            forward(cfg, params, tokens)
    finally:
        attention_mod._project_qkv = project
    cache = init_cache(cfg, tokens.shape[0], length, tokens.device, place=False)
    pat, p = cfg.block_pattern, tokens.shape[1]
    for layer, (k, v) in enumerate(kv):  # layer i * len(pat) + pos is scanned[pos][i]
        state = cache["scanned"][layer % len(pat)]
        state.k[layer // len(pat), :, :p] = k
        state.v[layer // len(pat), :, :p] = v
    return cache


def decode_on_mesh(model_parallel: int) -> dict:
    """(c) on this process's card and group: granite-moe-1b-a400m at
    published width, batch 2, a ``DECODE_PROMPT``-token prompt prefilled
    unsharded (bf16, :func:`prefilled_cache`), then ``DECODE_STEPS`` decode
    steps against the cache
    placed by ``cache_shardings`` on a (world / model_parallel,
    model_parallel) mesh (the KV sequence over the model axis), in float32
    and in bf16, each against the same steps decoded unsharded.  Returns
    the logits' errors, this rank's cache bytes beside ``cache_shardings``'
    local shard, the last step's ``CommDebugMode`` counts and the warm
    steps' times; and the same steps on the cache as the serving path
    places it (``place_cache``: KV heads over the model axis), their
    times and f32 logits' error."""
    import torch.distributed as dist
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import local_bytes
    from repro_torch.launch.hlo import comm_counts
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.launch.specs import cache_shardings, local_bytes_of
    from repro_torch.models import decode_step, init_params, param_shardings
    from repro_torch.models import production_rules, use_sharding
    from repro_torch.models.layers import torch_dtype
    from repro_torch.models.sharding import distribute
    from repro_torch.models.transformer import place_cache
    from repro_torch.tree import tree_map

    dev = torch.device("cuda", torch.cuda.current_device())
    cfg = get_config(SHARDED_ARCH)
    mesh, rules = make_mesh_for(dist.get_world_size(), model_parallel), production_rules()
    b, n = 2, DECODE_PROMPT + DECODE_STEPS
    g = torch.Generator(device=dev).manual_seed(0)
    params = init_params(cfg, g, dev)
    tokens = torch.randint(0, cfg.vocab, (b, n), generator=g, device=dev)
    t0 = time.perf_counter()
    cache = prefilled_cache(cfg, params, tokens[:, :DECODE_PROMPT], n)
    sync(dev)
    out = {"rank": dist.get_rank(), "prefill_s": time.perf_counter() - t0}
    for dtype in ("float32", "bfloat16"):
        c = cfg.with_(dtype=dtype)

        def cast(t, dt=torch_dtype(c)):
            return t.to(dt)

        p, base = tree_map(cast, params), tree_map(cast, cache)

        def unsharded(routes, replay=None):
            steps, want_cache = [], tree_map(torch.clone, base)
            with torch.no_grad(), moe_routes(routes, replay):
                for i in range(DECODE_PROMPT, n):
                    steps.append(decode_step(c, p, want_cache, tokens[:, i:i + 1], i)[0])
            return steps

        free_routes, sharded_routes = [], []
        want = unsharded(free_routes)
        placement = cache_shardings(c, base, mesh, rules)
        got, times = [], []
        with torch.no_grad(), use_sharding(mesh, rules), moe_routes(sharded_routes):
            sp = distribute(p, param_shardings(p, mesh, rules))
            sc = distribute(tree_map(torch.clone, base), placement)
            for i in range(DECODE_PROMPT, n):
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                if i == n - 1:
                    with CommDebugMode() as comm:
                        logits, sc = decode_step(c, sp, sc, tokens[:, i:i + 1], i)
                else:
                    logits, sc = decode_step(c, sp, sc, tokens[:, i:i + 1], i)
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end))
                got.append(logits.full_tensor())
            # the serving path's placement of the same cache, the same steps
            hc, head, head_times = place_cache(c, tree_map(torch.clone, base)), [], []
            for i in range(DECODE_PROMPT, n):
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                logits, hc = decode_step(c, sp, hc, tokens[:, i:i + 1], i)
                end.record()
                end.synchronize()
                head_times.append(start.elapsed_time(end))
                head.append(logits.full_tensor())
        # the unsharded decode again on the sharded run's expert choices:
        # where bf16 roundings flip a top-8 choice, the two sides route a
        # token apart, which says nothing of the cache's placement
        same = unsharded([], sharded_routes)
        out[dtype] = {"max_abs": max(float((a.float() - w.float()).abs().max())
                                     for a, w in zip(got, want)),
                      "rel_l2": max(rel_l2(a, w) for a, w in zip(got, want)),
                      "rel_l2_same_routes": max(rel_l2(a, w) for a, w in zip(got, same)),
                      "route_flips": route_flips(sharded_routes, free_routes)["choices_changed"],
                      "step_ms": times,
                      # the steps after the first, before the one counted
                      "warm_step_ms": statistics.median(times[1:-1]),
                      "head_placed": {"step_ms": head_times,
                                      "warm_step_ms": statistics.median(head_times[1:]),
                                      "max_abs": max(float((a.float() - w.float()).abs().max())
                                                     for a, w in zip(head, want))},
                      "cache_bytes": [local_bytes(sc), local_bytes_of(base, placement)],
                      "comm": comm_counts(comm)}
        del p, base, sp, sc, hc, got, head, want, same
        torch.cuda.empty_cache()
    return out


#: (e) the RG-LRU gate products' placement: recurrentgemma-2b at published
#: width, its depth cut to one (rglru, rglru, local) superblock, the
#: trainer's step at this batch and length on (1, 4) (batch 4: at batch 2
#: the unpinned products' backward fails on a mesh, as
#: ``tests/test_torch_rglru_mesh.py`` pins)
GATES_ARCH, GATES_LAYERS, GATES_SHAPE, GATES_STEPS = "recurrentgemma-2b", 3, (4, 512), 5


def gates_unpinned(p: dict, u: torch.Tensor):
    """``rglru._gates`` with its products left where DTensor's matmul
    rule puts them (the port's version before the products were reduced
    onto u's channel placement)."""
    import torch.nn.functional as F

    from repro_torch.models import rglru

    uf = u.float()
    r_t = torch.sigmoid(uf @ p["w_a"].float() + p["b_a"].float())
    i_t = torch.sigmoid(uf @ p["w_x"].float() + p["b_x"].float())
    a_t = torch.exp(-rglru._C * r_t * F.softplus(-p["lam"].float()))
    return a_t, torch.sqrt(torch.clamp_min(1.0 - a_t**2, 1e-12)) * (i_t * uf)


def gates_rank() -> dict:
    """(e) on this process's card of a (1, 4) mesh: the trainer's step of
    ``GATES_ARCH`` (``GATES_LAYERS`` layers, bf16) at ``GATES_SHAPE``,
    with ``rglru._gates`` as shipped and as :func:`gates_unpinned`, in the
    order shipped, unpinned, unpinned, shipped; each run one warm step,
    then ``GATES_STEPS`` timed by CUDA events, and its collectives under
    ``CommDebugMode`` on one more, by the op DTensor called (on NCCL a
    redistribution may call ``_dtensor.shard_dim_alltoall``, which DTensor
    replaces by an all-gather and a chunk on a CPU group)."""
    import torch.distributed as dist
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.configs import get_config
    from repro_torch.data import LMDataPipeline
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.models import init_params, param_shardings, production_rules, rglru
    from repro_torch.models.sharding import distribute

    dev = torch.device("cuda", torch.cuda.current_device())
    cfg = get_config(GATES_ARCH).with_(n_layers=GATES_LAYERS)
    mesh, rules = make_mesh_for(dist.get_world_size(), 4), production_rules()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    batch = LMDataPipeline(cfg, *GATES_SHAPE, seed=0, device=dev).peek(0)
    shipped, out = rglru._gates, {"shipped": [], "unpinned": [], "comm": {}}
    for name in ("shipped", "unpinned", "unpinned", "shipped"):
        rglru._gates = shipped if name == "shipped" else gates_unpinned
        try:
            sp = distribute(params, param_shardings(params, mesh, rules))
            init_opt, step = train.build_trainer(cfg, mesh, rules, lr=3e-4, total_steps=10)
            opt = init_opt(sp)
            step = step.eager  # uncaptured: the gates' DTensor cost, seen by CommDebugMode
            step(sp, opt, None, batch)
            times = []
            for _ in range(GATES_STEPS):
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                step(sp, opt, None, batch)
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end))
            with CommDebugMode() as comm:
                step(sp, opt, None, batch)
            torch.cuda.synchronize()
        finally:
            rglru._gates = shipped
        out[name].append(statistics.median(times))
        out["comm"][name] = {str(op): n for op, n in comm.get_comm_counts().items()}
        del sp, opt
        torch.cuda.empty_cache()
    return out


def check_decode(r: dict, traced: dict, where: str) -> None:
    """(c)'s limits: f32 logits within 1e-4 of the unsharded decode (on
    the cache as ``cache_shardings`` places it and as the serving path
    does), bf16
    within ``LM_BF16_REL_L2`` of it on the same expert choices (the bf16
    logits with each side's own choices are read: on four cards the
    routers' flips moved them 0.0305); the cache bytes those of
    ``cache_shardings``' shard and of the trace; the collective counts the
    trace's."""
    f32, bf16 = r["float32"], r["bfloat16"]
    check(f32["max_abs"] <= 1e-4,
          f"dryrun decode {where}: f32 logits {f32['max_abs']} from the unsharded decode")
    check(f32["head_placed"]["max_abs"] <= 1e-4,
          f"dryrun decode {where}: f32 logits on the head-placed cache "
          f"{f32['head_placed']['max_abs']} from the unsharded decode")
    check(bf16["rel_l2_same_routes"] <= LM_BF16_REL_L2,
          f"dryrun decode {where}: bf16 logits rel L2 {bf16['rel_l2_same_routes']} on "
          "the same expert choices")
    for dtype in ("float32", "bfloat16"):
        have, want = r[dtype]["cache_bytes"]
        check(have == want, f"dryrun decode {where} {dtype}: the rank holds {have} cache "
                            f"bytes, cache_shardings' shard is {want}")
    check(r["bfloat16"]["cache_bytes"][0] == traced["memory"]["alias_bytes"],
          f"dryrun decode {where}: cache bytes {r['bfloat16']['cache_bytes'][0]} != the "
          f"trace's {traced['memory']['alias_bytes']}")
    for dtype in ("float32", "bfloat16"):
        check(r[dtype]["comm"] == traced["collectives"]["count_by_op"],
              f"dryrun decode {where} {dtype}: CommDebugMode {r[dtype]['comm']} != the "
              f"trace's {traced['collectives']['count_by_op']}")


def loops_on_card(dev, mesh, rules) -> dict:
    """(d): xlstm-1.3b's prefill at published width (bf16, 2 x
    ``LOOPS_PROMPT``) on this card's (1, 1) mesh, warm, then under
    ``FlopCounterMode``: its FLOPs and argument bytes, for the trace whose
    time loops were recorded a few steps and scaled."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import local_bytes
    from repro_torch.models import forward, init_params, param_shardings, shard, use_sharding
    from repro_torch.models.sharding import distribute

    cfg = get_config(LOOPS_ARCH)
    g = torch.Generator(device=dev).manual_seed(0)
    params = init_params(cfg, g, dev)
    inputs = torch.randint(0, cfg.vocab, (2, LOOPS_PROMPT), generator=g, device=dev,
                           dtype=torch.int32)  # as launch.specs.batch_specs
    with torch.no_grad(), use_sharding(mesh, rules):
        sp = distribute(params, param_shardings(params, mesh, rules))
        del params
        placed = shard(inputs, "batch", None)
        forward(cfg, sp, placed)  # warm
        sync(dev)
        t0 = time.perf_counter()
        with FlopCounterMode(display=False) as fc:
            logits = forward(cfg, sp, placed)[0]
        sync(dev)
        counted_s = time.perf_counter() - t0
        ok = bool(torch.isfinite(logits.full_tensor()).all())
    out = {"flops": fc.get_total_flops(), "argument_bytes": local_bytes((sp, placed)),
           "flops_by_op": {str(k): v for k, v in fc.get_flop_counts()["Global"].items()},
           "counted_forward_s": counted_s, "finite": ok}
    del sp
    torch.cuda.empty_cache()
    return out


def saved_tensor_bytes(step, arguments) -> dict:
    """One call of ``step`` with autograd's saved tensors counted: the bytes
    of every storage a backward node keeps (``saved_tensors_hooks``), apart
    from those of ``arguments`` (parameters the products save); what the
    allocator holds above the call's start when the forward has saved its
    last tensor and after the call (its outputs, kept), and its peaks
    (``memory_stats``; ``allocated`` and ``requested`` above the start)."""
    own = {t.to_local().untyped_storage().data_ptr() if hasattr(t, "to_local")
           else t.untyped_storage().data_ptr() for t in arguments}
    saved, at_save = {}, [0]

    def pack(t):
        loc = t.to_local() if hasattr(t, "to_local") else t
        st = loc.untyped_storage()
        if st.data_ptr() not in own:
            saved[st.data_ptr()] = st.nbytes()
        at_save[0] = torch.cuda.memory_allocated()
        return t

    sync(torch.device("cuda", torch.cuda.current_device()))
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = step()
    sync(torch.device("cuda", torch.cuda.current_device()))
    stats, after = torch.cuda.memory_stats(), torch.cuda.memory_allocated()
    del out
    return {"saved_bytes": sum(saved.values()), "saved_storages": len(saved),
            "base_allocated": base, "forward_end_allocated": at_save[0] - base,
            "outputs_allocated": after - base,
            **{k: stats[k] - (base if "allocated" in k or "requested" in k else 0)
               for k in ("allocated_bytes.all.peak", "requested_bytes.all.peak",
                         "active_bytes.all.peak", "reserved_bytes.all.peak")}}


def dryrun_four_cards(procs) -> dict:
    """The trainer's step on four cards, (1, 4) and (2, 2), one process a
    card: rank 0's ``CommDebugMode`` count and argument bytes against the
    trace on a fake group of four (``start_dryrun``'s ``held4``)."""
    from repro_torch.launch.mesh import spawn

    traced = {(r["kind"], tuple(r["mesh_shape"].values())): r
              for r in dryrun_results(procs["held4"], "four-card traces")}
    out = {}
    for shape in ((1, 4), (2, 2)):
        t0 = time.perf_counter()
        r0 = spawn(dryrun_rank, 4, shape[1], device_type="cuda", join_timeout_s=600,
                   pg_timeout_s=300)[0]
        t = traced["train", shape]
        out["x".join(map(str, shape))] = {
            "count_by_op": [t["collectives"]["count_by_op"], r0["comm"]],
            "argument_bytes": [t["memory"]["argument_bytes"], r0["argument_bytes"]],
            "link_bytes_by_op": t["collectives"]["link_bytes_by_op"],
            "trace_s": t["lower_s"], "wall_s": time.perf_counter() - t0}
    for name, c in out.items():
        check(c["count_by_op"][0] == c["count_by_op"][1],
              f"dryrun {name}: traced collectives {c['count_by_op'][0]} != rank 0's "
              f"CommDebugMode count {c['count_by_op'][1]}")
        check(c["argument_bytes"][0] == c["argument_bytes"][1],
              f"dryrun {name}: traced argument bytes {c['argument_bytes'][0]} != rank "
              f"0's {c['argument_bytes'][1]}")
    # (c) on (1, 4): the KV sequence over four cards, each rank's check
    t0 = time.perf_counter()
    ranks = spawn(decode_on_mesh, 4, 4, device_type="cuda", join_timeout_s=900,
                  pg_timeout_s=300)
    for r in ranks:
        check_decode(r, traced["decode", (1, 4)], f"(1, 4) rank {r['rank']}")
    out["decode_1x4"] = {"ranks": ranks, "trace_s": traced["decode", (1, 4)]["lower_s"],
                         "wall_s": time.perf_counter() - t0}
    # (e) on (1, 4): the RG-LRU gate products' placement, rank 0's times
    t0 = time.perf_counter()
    gates = spawn(gates_rank, 4, device_type="cuda", join_timeout_s=600, pg_timeout_s=300)[0]
    out["gates_1x4"] = {**gates, "wall_s": time.perf_counter() - t0}
    d = [r["bfloat16"] for r in ranks]
    print(f"dryrun decode (1, 4), {SHARDED_ARCH} bf16: warm step "
          f"{[round(r['warm_step_ms'], 3) for r in d]} ms on the cache_shardings cache, "
          f"{[round(r['head_placed']['warm_step_ms'], 3) for r in d]} ms on the "
          f"head-placed cache (ranks 0-3)", flush=True)
    print(f"dryrun gates (1, 4), {GATES_ARCH} {GATES_LAYERS} layers, train "
          f"{GATES_SHAPE[0]} x {GATES_SHAPE[1]}: step ms shipped {gates['shipped']}, "
          f"unpinned {gates['unpinned']}; collectives {gates['comm']}", flush=True)
    return out


def phase_dryrun(dev, counters, procs) -> dict:
    """The port's multi-pod dry-run (``launch/dryrun.py``): its roofline
    terms on the H100's spec constants, and the trace held against the
    real step on this card.

    (a) The production cells traced in a subprocess (``start_dryrun``):
    the three terms, the dominant one and the trace seconds.  (b)
    granite-moe-1b-a400m at the sharded phase's shape (published widths,
    bf16, 2 x 512) traced on a fake (1, 1) mesh, against the same step run
    uncaptured (``TrainStep.eager``: a graph's replay dispatches no op for
    ``FlopCounterMode`` to count) on a (1, 1) NCCL mesh on this card:
    argument bytes (parameters,
    optimizer state, batch) equal exactly; local FLOPs equal
    ``FlopCounterMode`` on a warm step exactly (the prefill's flash calls
    through the kernel's registered formula, flash launched once an
    attention layer); read, not held: the predicted peak (argument +
    temporary bytes) against ``max_memory_allocated`` of a warm step, and
    the roofline bound against the warm step's wall (the step's share of
    its bound on the H100), and the step's peak split into autograd's
    saved tensors and the allocator's peaks.  (c) The decode on the cache
    ``cache_shardings`` places (the KV sequence over the model axis,
    flash-decoding), granite-moe at published width, a 512-token prompt
    prefilled unsharded, 4 steps on the (1, 1) NCCL mesh (and with four
    cards on (1, 4), one process a card): f32 logits within 1e-4 of the
    unsharded decode, bf16 within ``LM_BF16_REL_L2`` on the same expert
    choices (on their own, read), each rank's cache
    bytes ``cache_shardings``' shard and the trace's, rank 0's
    ``CommDebugMode`` counts the trace's; read: the warm step against the
    roofline bound of the traced step, and the same steps' time on the
    cache as the serving path places it (KV heads over the model axis),
    its f32 logits within 1e-4.  (d) The time loops scaled: the
    xlstm-1.3b prefill at 2 x 512 traced with each loop recorded 3 steps
    and scaled, its FLOPs equal to ``FlopCounterMode`` on the real prefill
    and to the unrolled trace, its argument bytes the real ones; read: both
    traces' seconds.  (e) With four cards, read: recurrentgemma-2b's
    train step on (1, 4) with its RG-LRU gate products reduced onto u's
    channels (as shipped) and left where DTensor puts them.  The terms are
    predictions from spec constants, not measurements."""
    import torch.distributed as dist
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import get_config
    from repro_torch.core.hw import H100_SXM
    from repro_torch.data import LMDataPipeline
    from repro_torch.launch import train
    from repro_torch.launch.dryrun import local_bytes
    from repro_torch.launch.mesh import init_process_group, make_mesh_for
    from repro_torch.models import forward, init_params, param_shardings, production_rules
    from repro_torch.models import use_sharding
    from repro_torch.models.sharding import distribute
    from repro_torch.tree import leaves

    t_phase = time.perf_counter()
    cfg, batch, seq = get_config(SHARDED_ARCH), 2, 512
    # (b) the real steps on a (1, 1) NCCL mesh, while the traces finish
    init_process_group("cuda")
    mesh, rules = make_mesh_for(1, 1), production_rules()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    sp = distribute(params, param_shardings(params, mesh, rules))
    del params
    init_opt, step = train.build_trainer(cfg, mesh, rules, lr=3e-4, total_steps=10)
    opt = init_opt(sp)
    data = LMDataPipeline(cfg, batch, seq, seed=0, device=dev)
    real = {"train": {"argument_bytes": local_bytes((sp, opt, data.peek(0)))},
            "prefill": {"argument_bytes": local_bytes((sp, data.peek(0)["inputs"]))}}

    def train_step(s):  # the uncaptured step: its ops are what the trace holds
        return step.eager(sp, opt, None, data.peek(s))[0]

    with use_sharding(mesh, rules):
        def prefill(s):
            with torch.no_grad():
                return forward(cfg, sp, data.peek(s)["inputs"])[0]

        reset_counts(counters)
        for kind, fn in (("train", train_step), ("prefill", prefill)):
            fn(0)  # warm
            sync(dev)
            with FlopCounterMode(display=False) as fc:
                fn(1)
            sync(dev)
            reset_counts(counters)
            torch.cuda.reset_peak_memory_stats()
            # the step's own peak: what it allocates on top of what this
            # process holds (its arguments among it), plus its arguments
            base = torch.cuda.memory_allocated()
            timed = timed_steps(fn, 4)
            real[kind].update(
                flops=fc.get_total_flops(), wall_ms=timed["step_ms_median"],
                flops_by_op={str(k): v for k, v in fc.get_flop_counts()["Global"].items()},
                step_ms=timed["step_ms"],
                peak_bytes=torch.cuda.max_memory_allocated() - base
                + real[kind]["argument_bytes"],
                launches={k: c.launches for k, c in counters.items()})
        # the train step's peak, split: autograd's saved tensors and the
        # allocator's peaks, beside the trace's predicted peak
        real["train"]["memory_split"] = saved_tensor_bytes(
            lambda: step.eager(sp, opt, None, data.peek(2)), leaves((sp, opt, data.peek(2))))
    counts = real["prefill"]["launches"]
    del sp, opt
    torch.cuda.empty_cache()
    # (c) the decode on the cache cache_shardings places, (1, 1) here
    decode = decode_on_mesh(1)
    # (d) the time-loop scaling against a real xlstm-1.3b prefill
    loops = loops_on_card(dev, mesh, rules)
    dist.destroy_process_group()

    four = dryrun_four_cards(procs) if "held4" in procs else {
        "ran": False, "reason": f"{torch.cuda.device_count()} CUDA device: the four-card "
                                "comparison needs four; not run, not passed"}
    cells = dryrun_results(procs["production"], "production cells")
    held = {r["kind"]: r for r in dryrun_results(procs["held"], "(1, 1) traces")}
    check(len(cells) == 3 and set(held) == {"train", "prefill", "decode"},
          f"dryrun: {len(cells)} cells and {sorted(held)} traces came back")
    scaled, unrolled = dryrun_results(procs["loops"], "time-loop traces")
    rows = []
    for r in cells:
        rf = r["roofline"]
        rows.append({"cell": f"{r['arch']} {r['shape']} {r['mesh']}", "n_chips": r["n_chips"],
                     "grad_accum": r.get("grad_accum"), "trace_s": r["lower_s"],
                     "wall_s": r["wall_s"],
                     **{k: rf[k] for k in ("compute_term_s", "memory_term_s",
                                           "collective_term_s", "dominant_term", "bound_s",
                                           "roofline_fraction")},
                     "flops_per_device": r["cost"]["flops_per_device"],
                     "collective_count_by_op": r["collectives"]["count_by_op"],
                     "link_bytes_by_op": r["collectives"]["link_bytes_by_op"],
                     "argument_bytes": r["memory"]["argument_bytes"],
                     "temp_bytes": r["memory"]["temp_bytes"]})
        print(f"dryrun {rows[-1]['cell']}: compute {rf['compute_term_s']:.6g} s, memory "
              f"{rf['memory_term_s']:.6g} s, collective {rf['collective_term_s']:.6g} s, "
              f"bound by {rf['dominant_term']}; trace {r['lower_s']} s", flush=True)
    compared = {}
    for kind in ("train", "prefill"):
        t, m = held[kind], real[kind]
        predicted_peak = t["memory"]["argument_bytes"] + t["memory"]["temp_bytes"]
        compared[kind] = {
            "argument_bytes": [t["memory"]["argument_bytes"], m["argument_bytes"]],
            "flops": [t["cost"]["flops_per_device"], m["flops"]],
            "flops_by_op": [t["cost"]["flops_by_op"], m["flops_by_op"]],
            "kernel_calls": t["kernel_calls"],
            "predicted_peak_bytes": predicted_peak, "measured_peak_bytes": m["peak_bytes"],
            "peak_predicted_over_measured": predicted_peak / m["peak_bytes"],
            "bound_s": t["roofline"]["bound_s"], "dominant_term": t["roofline"]["dominant_term"],
            "warm_wall_ms": m["wall_ms"], "step_ms": m["step_ms"],
            "bound_share_of_wall": t["roofline"]["bound_s"] * 1e3 / m["wall_ms"],
            "trace_s": t["lower_s"],
        }
    compared["train"]["memory_split"] = {
        "predicted_argument_bytes": held["train"]["memory"]["argument_bytes"],
        "predicted_temp_bytes": held["train"]["memory"]["temp_bytes"],
        **real["train"]["memory_split"]}
    td = held["decode"]
    decode_row = {"trace": {"count_by_op": td["collectives"]["count_by_op"],
                            "alias_bytes": td["memory"]["alias_bytes"],
                            "argument_bytes": td["memory"]["argument_bytes"],
                            "bound_s": td["roofline"]["bound_s"],
                            "dominant_term": td["roofline"]["dominant_term"],
                            "trace_s": td["lower_s"]},
                  **decode,
                  "bound_share_of_warm_step": td["roofline"]["bound_s"] * 1e3
                  / decode["bfloat16"]["warm_step_ms"]}
    loops_row = {"flops": [scaled["cost"]["flops_per_device"], loops["flops"],
                           unrolled["cost"]["flops_per_device"]],
                 "argument_bytes": [scaled["memory"]["argument_bytes"],
                                    loops["argument_bytes"],
                                    unrolled["memory"]["argument_bytes"]],
                 "flops_by_op": [scaled["cost"]["flops_by_op"], loops["flops_by_op"]],
                 "trace_s_scaled": scaled["lower_s"], "trace_s_unrolled": unrolled["lower_s"],
                 "counted_forward_s": loops["counted_forward_s"], "finite": loops["finite"]}
    print(f"dryrun decode (1, 1), {SHARDED_ARCH} 2 x {DECODE_PROMPT}+{DECODE_STEPS}: warm "
          f"step {decode['bfloat16']['warm_step_ms']:.3f} ms (bf16), "
          f"{100 * decode_row['bound_share_of_warm_step']:.3f}% of its "
          f"{td['roofline']['bound_s'] * 1e3:.4f} ms bound; f32 logits max abs "
          f"{decode['float32']['max_abs']:.3g}, bf16 rel L2 "
          f"{decode['bfloat16']['rel_l2_same_routes']:.3g} on the same expert choices, "
          f"{decode['bfloat16']['rel_l2']:.3g} on its own; "
          f"prefill {decode['prefill_s']:.1f} s", flush=True)
    print(f"dryrun loops, {LOOPS_ARCH} prefill 2 x {LOOPS_PROMPT}: trace "
          f"{scaled['lower_s']} s scaled, {unrolled['lower_s']} s unrolled; FLOPs "
          f"{loops_row['flops']}", flush=True)
    props = torch.cuda.get_device_properties(0)
    emit({"phase": "dryrun", "cells": rows, "held_1x1": compared, "four_cards": four,
          "decode_1x1": decode_row, "loops_1x1": loops_row,
          "chip_constants": {"name": H100_SXM.name, "peak_bf16_flops": H100_SXM.peak_bf16_flops,
                             "hbm_bandwidth": H100_SXM.hbm_bandwidth,
                             "nvlink_bandwidth": H100_SXM.nvlink_bandwidth,
                             "network_bandwidth": H100_SXM.network_bandwidth,
                             "gpus_per_node": H100_SXM.gpus_per_node,
                             "hbm_capacity": H100_SXM.hbm_capacity},
          "card_total_memory": props.total_memory, "card": card_line(),
          "prefill_launches": counts, "phase_s": time.perf_counter() - t_phase})
    for kind, c in compared.items():
        check(c["argument_bytes"][0] == c["argument_bytes"][1],
              f"dryrun {kind}: traced argument bytes {c['argument_bytes'][0]} != the real "
              f"step's {c['argument_bytes'][1]}")
        check(c["flops"][0] == c["flops"][1],
              f"dryrun {kind}: traced FLOPs {c['flops'][0]} != FlopCounterMode's "
              f"{c['flops'][1]}")
    check(compared["prefill"]["kernel_calls"] == {"repro_torch.flash_attend": cfg.n_layers},
          f"dryrun prefill trace: flash calls {compared['prefill']['kernel_calls']}")
    check(counts["flash_attention"] == 4 * cfg.n_layers,
          f"dryrun prefill: flash launched {counts['flash_attention']} times in 4 "
          f"forwards of {cfg.n_layers} attention layers")
    check_decode(decode, td, "(1, 1)")
    check(loops_row["finite"], "dryrun loops: xlstm prefill logits not finite")
    check(loops_row["flops"][0] == loops_row["flops"][1] == loops_row["flops"][2],
          f"dryrun loops: scaled trace, real step and unrolled trace FLOPs "
          f"{loops_row['flops']} differ")
    check(loops_row["argument_bytes"][0] == loops_row["argument_bytes"][1],
          f"dryrun loops: traced argument bytes {loops_row['argument_bytes']} differ")
    return counts


def main() -> int:
    only = sys.argv[1:]
    if only not in ([], ["--only", "train"], ["--only", "lm_families"], ["--only", "sharded"],
                    ["--only", "dryrun"], ["--only", "lanes"], ["--only", "captured"],
                    ["--only", "pp"]):
        print("usage: python3 chip_smoke.py "
              "[--only train|lm_families|sharded|dryrun|lanes|captured|pp]", file=sys.stderr)
        return 2
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
    counters = {"spmm": spmm_ops.spmm, "fused_agg_cmb": fused_ops.fused_agg_cmb,
                "flash_attention": flash_ops.flash_attention,
                "gemm_dataflow": gemm_ops.gemm}
    if only == ["--only", "dryrun"]:  # its traces, then the real steps
        phase_dryrun(dev, counters, start_dryrun())
        print(card_line(), flush=True)
        return 0
    if only == ["--only", "captured"]:  # every kernel built together first
        from repro_torch.kernels.common import build_libraries

        build_libraries([spmm_ops.LIBRARY, fused_ops.LIBRARY, flash_ops.LIBRARY,
                         gemm_ops.LIBRARY])
        phase_captured(dev, counters)
        print(card_line(), flush=True)
        return 0
    if only == ["--only", "pp"]:  # the GNN kernels built together first
        from repro_torch.graphs import TABLE4
        from repro_torch.kernels.common import build_libraries

        build_libraries([spmm_ops.LIBRARY, gemm_ops.LIBRARY])
        f_in = TABLE4["reddit-bin"].n_features
        phase_pp(dev, counters, {"requests": reddit_requests(64, f_in, seed=2),
                                 "dims": [(f_in, 16), (16, 8)]})
        print(card_line(), flush=True)
        return 0
    if only == ["--only", "lanes"]:  # the GNN kernels built together first
        from repro_torch.kernels.common import build_libraries

        build_libraries([spmm_ops.LIBRARY, fused_ops.LIBRARY, gemm_ops.LIBRARY])
        phase_lanes(dev, counters)
        print(card_line(), flush=True)
        return 0
    if only:  # one phase alone, in a process nothing else ran in
        {"train": phase_train, "lm_families": phase_lm_families,
         "sharded": phase_sharded}[only[1]](dev, counters)
        print(card_line(), flush=True)
        return 0
    # the dry-run's traces run on the CPU in subprocesses beside the phases
    dryrun_procs = start_dryrun()
    phase_build([spmm_ops.LIBRARY, fused_ops.LIBRARY, flash_ops.LIBRARY,
                 gemm_ops.LIBRARY])

    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)
    numbers = phase_kernels(dev, flush)
    numbers.update(phase_lm_kernels(dev, flush))
    launches = phase_main(dev, counters)
    runs = [phase_serving(dev, counters)]
    engine_launches, held = phase_engine(dev, counters)
    runs += [engine_launches, phase_captured(dev, counters), phase_async(dev, counters, held),
             phase_pp(dev, counters, held)]
    shutil.rmtree(held["store_dir"], ignore_errors=True)
    del held
    runs.append(phase_lanes(dev, counters))
    runs.append(phase_train(dev, counters))
    runs += [phase_gemm(dev, counters), phase_lm_serve(dev, counters),
             phase_lm_families(dev, counters), phase_sharded(dev, counters),
             phase_dryrun(dev, counters, dryrun_procs)]
    for run in runs:
        for k, n in run.items():
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
