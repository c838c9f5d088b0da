"""Shared benchmark plumbing: timing, CSV emission, the evidence JSONs and
the sweep loops the fig9-fig13 modules have in common (mapper-chosen
skeleton sweeps and the batched-vs-scalar hardware-axis speedup
measurement).

Evidence lands in ``experiments/benchmarks_torch/``; each JSON carries a
``device`` block naming the card and its power limit as ``nvidia-smi``
reports them (null fields where the machine has no NVIDIA card)."""
from __future__ import annotations

import functools
import json
import subprocess
import time
from pathlib import Path

import torch

from repro_torch.core import (
    GNNLayerWorkload,
    TABLE5_NAMES,
    TileStats,
    named_skeleton,
    optimize_tiles,
)
from repro_torch.graphs import TABLE4, load_dataset

G_HIDDEN = 16  # Kipf-standard GCN hidden width
OUT_DIR = (
    Path(__file__).resolve().parents[3] / "experiments" / "benchmarks_torch"
)


def workloads(datasets=None):
    for name in datasets or TABLE4:
        g, spec = load_dataset(name)
        yield name, spec, GNNLayerWorkload(g.nnz, spec.n_features, G_HIDDEN, name=name)


def timed(fn, *args, repeat: int = 1, **kw):
    t0 = time.perf_counter()
    for _ in range(repeat):
        out = fn(*args, **kw)
    dt = (time.perf_counter() - t0) / repeat
    return out, dt * 1e6  # microseconds


def emit(rows: list[tuple[str, float, str]]):
    """Print the assignment CSV: name,us_per_call,derived."""
    for name, us, derived in rows:
        print(f"{name},{us:.1f},{derived}")


@functools.lru_cache(maxsize=1)
def card_line() -> str | None:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``'s
    first line, or None where there is no ``nvidia-smi``."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else None


def device_block() -> dict:
    """The machine a lane ran on: the card's name and power limit (from
    ``nvidia-smi``), the CUDA device count and the torch version."""
    line = card_line()
    name, _, power = line.partition(", ") if line else (None, "", None)
    return {
        "platform": "gpu" if torch.cuda.is_available() else "cpu",
        "name": name,
        "power_limit": power or None,
        "nvidia_smi": line,
        "count": torch.cuda.device_count(),
        "torch": torch.__version__,
    }


def save_json(name: str, payload: dict):
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    (OUT_DIR / f"{name}.json").write_text(
        json.dumps({**payload, "device": device_block()}, indent=2)
    )


def sync(device: torch.device) -> None:
    """Wait for the device's queued work (launches are asynchronous, so a
    clock read without it times the enqueue)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def skeleton_sweep(
    wl,
    names=TABLE5_NAMES,
    objective: str = "cycles",
    pe_splits=(0.25, 0.5, 0.75),
    tile_stats: TileStats | None = None,
):
    """The fig9/10/11 inner loop: mapper-chosen tilings for each skeleton,
    one shared TileStats ladder per workload.  Yields
    ``(skeleton_name, MappingResult, us)``; infeasible skeletons are
    skipped."""
    ts = tile_stats if tile_stats is not None else TileStats(wl.nnz)
    for sk in names:
        try:
            res, us = timed(
                optimize_tiles,
                named_skeleton(sk),
                wl,
                objective=objective,
                pe_splits=pe_splits,
                tile_stats=ts,
            )
        except (RuntimeError, ValueError):
            continue
        yield sk, res, us


def speedup_entry(batch_us: float, scalar_us: float, n_points: int) -> dict:
    """Evidence-JSON fragment for a batched-vs-per-point-scalar hw sweep."""
    return {
        "batch_us": batch_us,
        "scalar_us": scalar_us,
        "hw_points": n_points,
        "speedup": scalar_us / max(batch_us, 1e-9),
    }


def check_speedup(fig: str, dataset: str, speedup: float, floor: float) -> list[str]:
    """Wall-clock guard: the batched hw axis must beat the per-point scalar
    loop by at least ``floor``x.  Returns error strings (caller raises after
    evidence is saved, so a regression still leaves the JSON behind)."""
    if speedup < floor:
        return [
            f"{fig}/{dataset}: batched hw sweep only {speedup:.1f}x faster "
            f"than the per-point scalar loop (floor {floor:.0f}x)"
        ]
    return []


def kernel_launches() -> dict:
    """Each hand-written kernel's launch count so far (the wrappers' own
    counters; a lane reports the difference over its run)."""
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.fused_agg_cmb.ops import fused_agg_cmb
    from repro_torch.kernels.gemm_dataflow.ops import gemm
    from repro_torch.kernels.spmm.ops import spmm

    return {"spmm": spmm.launches, "fused_agg_cmb": fused_agg_cmb.launches,
            "gemm_dataflow": gemm.launches,
            "flash_attention": flash_attention.launches}


def launches_since(before: dict) -> dict:
    now = kernel_launches()
    return {k: now[k] - before[k] for k in now}
