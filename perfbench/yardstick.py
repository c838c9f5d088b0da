"""The benchmark's measuring rod: the card's published peaks, the work a
kernel or a model needs counted from shapes, and the reading of a
``torch.profiler`` trace.

The peaks are NVIDIA's for the H100 SXM (dense, without sparsity): 3.35
TB/s of HBM and 67 TFLOP/s in float32 outside the tensor cores, at the
full 700 W; a run prints the card's power limit beside its numbers.  The
byte count of the fused kernel is the one ``chip_smoke.py::gnn_timings``
uses (each referenced x row once, the ELL's non-zero slots, w, out), and
the trace arithmetic is its ``device_trace`` / ``busy_us``, copied here so
that a change to the program cannot move the yardstick.
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

import numpy as np

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}

#: device event categories of a chrome trace: kernels, copies and fills
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def bound_s(n_bytes: float, n_ops: float, dtype: str = "float32") -> float:
    """The least time the card could take: bytes over the HBM rate or
    operations over the type's peak, whichever is larger."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / PEAK_FLOPS[dtype])


@dataclass(frozen=True)
class GraphStats:
    """What a kernel's bytes and operations are counted from, for one bound
    graph: the adjacency's non-zero entries (a pad row's weight-0
    self-loop reads nothing), the rows of x they reference, the rows that
    hold one, and the program's padded ELL rows."""

    nnz: int
    x_rows: int
    live_rows: int
    v_pad: int

    @classmethod
    def of(cls, row_ptr, col_idx, values, v_pad: int) -> "GraphStats":
        real = np.asarray(values) != 0
        rows = np.repeat(np.arange(len(row_ptr) - 1), np.diff(row_ptr))
        return cls(int(real.sum()), int(np.unique(np.asarray(col_idx)[real]).size),
                   int(np.unique(rows[real]).size), int(v_pad))


def fused_agg_cmb_work(spec, f: int, g: int, stats: GraphStats,
                       elem: int = 4) -> tuple[float, float] | None:
    """Bytes and operations of the ``(A @ X) @ W`` launch of a layer whose
    schedule ``spec`` runs the fused kernel (SP-Optimized, AC, kernel
    tier), else ``None``: the ``nnz`` non-zero slots (an int32 index and a
    weight each), the rows of x they reference, read once, w, and the
    ``v_pad`` x ``g`` output; the aggregation's multiply-adds over F and
    the combination of the rows that have a non-zero slot."""
    if not (spec.use_pallas and spec.policy == "sp_opt" and spec.order == "AC"):
        return None
    n_bytes = (stats.nnz * 8 + stats.x_rows * f * elem + f * g * elem
               + stats.v_pad * g * elem)
    n_ops = 2 * stats.nnz * f + 2 * stats.live_rows * f * g
    return float(n_bytes), float(n_ops)


def layer_work(work, specs, dims, stats: GraphStats) -> list[tuple[float, float]]:
    """``work``'s count for each layer of one call that launches its kernel."""
    out = [work(spec, f, g, stats) for spec, (f, g) in zip(specs, dims)]
    return [w for w in out if w is not None]


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


def gaps(intervals, window) -> list[tuple[float, float]]:
    """The stretches of ``window`` that no interval covers."""
    lo, hi = window
    out, at = [], lo
    for a, b in sorted(intervals):
        if a > at:
            out.append((at, min(a, hi)))
        at = max(at, b)
        if at >= hi:
            break
    if at < hi:
        out.append((at, hi))
    return [(a, b) for a, b in out if b > a]


class Trace:
    """A traced slice, read from a chrome trace that ``torch.profiler``
    exported: the device events (kernels, copies, fills) as ``(category,
    name, start_us, end_us)`` clipped to the benchmark's ``window`` span,
    and the benchmark's own host spans (``record_function`` names)."""

    def __init__(self, path: Path, window_name: str = "window"):
        raw = json.loads(Path(path).read_text()).get("traceEvents", [])
        spans, device = [], []
        for e in raw:
            if e.get("ph") != "X":
                continue
            start = float(e["ts"])
            end = start + float(e.get("dur", 0.0))
            cat = e.get("cat")
            if cat == "user_annotation":
                spans.append((e.get("name", ""), start, end))
            elif cat in DEVICE_CATEGORIES:
                device.append((cat, e.get("name", ""), start, end))
        windows = [(a, b) for n, a, b in spans if n == window_name]
        if len(windows) != 1:
            raise ValueError(f"trace holds {len(windows)} '{window_name}' spans, not 1")
        self.window = windows[0]
        lo, hi = self.window
        self.spans = [s for s in spans if s[0] != window_name and s[2] > lo and s[1] < hi]
        self.events = [(c, n, max(a, lo), min(b, hi)) for c, n, a, b in device
                       if b > lo and a < hi]

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    @property
    def busy_s(self) -> float:
        return busy_us([(a, b) for *_, a, b in self.events]) / 1e6

    def time_s(self, match) -> float:
        """Summed device seconds of the events whose ``(category, name)``
        ``match`` accepts."""
        return sum(b - a for c, n, a, b in self.events if match(c, n)) / 1e6

    def count(self, match) -> int:
        return sum(1 for c, n, *_ in self.events if match(c, n))

    def top_ops(self, k: int = 10) -> list:
        """The ``k`` device operations that took most time, by name."""
        by: dict[str, float] = {}
        for _, n, a, b in self.events:
            by[n] = by.get(n, 0.0) + (b - a) / 1e6
        return [[n[:200], s] for n, s in sorted(by.items(), key=lambda kv: -kv[1])[:k]]

    def idle_gaps(self, k: int = 10) -> list:
        """The ``k`` longest stretches with nothing on the card, each named
        by the host span that held its middle ("none" between spans)."""
        out = []
        for a, b in gaps([(x, y) for *_, x, y in self.events], self.window):
            mid = (a + b) / 2
            names = [n for n, s, e in self.spans if s <= mid <= e]
            out.append([names[-1] if names else "none", (b - a) / 1e6])
        return sorted(out, key=lambda r: -r[1])[:k]


# ---------------------------------------------------------------------------
# What the per-layer metrics' readers share (each gets the run's context:
# the job, the timed window and, in a traced run, the traced slice)
# ---------------------------------------------------------------------------


def idle_pct(ctx) -> float | None:
    """Share of the traced window with no kernel, copy or fill on the card."""
    tr = ctx.traced.trace if ctx.traced else None
    if tr is None or not tr.events:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)


def window_idle_pct(ctx) -> float | None:
    """Share of the timed window with no kernel, copy or fill on the card,
    for a job whose calls all do the same work: the traced slice's device
    seconds a call, times the window's calls, against the window's
    seconds.  The slice gives the work, the untraced window the pace: a
    profiler's host cost, which can starve the card in the slice, does
    not enter."""
    tr = ctx.traced.trace if ctx.traced else None
    if tr is None or not tr.events:
        return None
    busy_s = tr.busy_s / len(ctx.traced.calls) * ctx.window.calls
    return 100.0 * (1.0 - busy_s / ctx.window.seconds)


def per_call_ms(ctx, match) -> float | None:
    """Device milliseconds a traced call spends in the events ``match``
    accepts; nothing when the trace holds none."""
    tr = ctx.traced.trace if ctx.traced else None
    if tr is None or tr.count(match) == 0:
        return None
    return tr.time_s(match) * 1e3 / len(ctx.traced.calls)


def roofline_pct(ctx, kernel: str, work) -> float | None:
    """A kernel's bound time over its traced time, summed over the traced
    calls' launches, in percent.  ``work(spec, f, g, stats)`` counts one
    layer's launch (``None`` where the layer launches none).  Nothing to
    read unless the trace, the program's launch counter ``kernel`` and the
    launches the job's shapes predict agree on the count."""
    if ctx.traced is None:
        return None
    launches = ctx.job.kernel_work(work, ctx.traced.calls)
    match = lambda cat, name: cat == "kernel" and kernel in name  # noqa: E731
    n = ctx.traced.trace.count(match)
    if not launches or n != len(launches) or ctx.traced.counters.get(kernel) != n:
        return None
    bound = sum(bound_s(b, o, ctx.job.dtype_name) for b, o in launches)
    return 100.0 * bound / ctx.traced.trace.time_s(match)


def mfu_pct(ctx) -> float:
    """Model FLOPs of the timed window's calls over the window's seconds
    and the card's peak in the configuration's type, in percent."""
    flops = ctx.job.model_flops(list(range(ctx.window.calls)))
    return 100.0 * flops / ctx.window.seconds / PEAK_FLOPS[ctx.job.dtype_name]
