"""The per-layer metrics that read the port's own counters
(``repro_torch.trace.counters()``: totals since the process started).

A run's window binds, captures and assembles nothing (the zero-retrace
contract), so a set-up counter read at the end holds set-up alone.  The
work counters (``agg.slots``, ``ell.nonzero``, ``replay.*``) hold every
call of the run, set-up included.  A program that keeps no such counter
gives ``None``, and the metric is left out of the result line.
"""
from __future__ import annotations


def counters() -> dict:
    """The program's counters, or ``{}`` where the program has none."""
    try:
        from repro_torch.trace import counters as read
    except ImportError:
        return {}
    return read()


def value(name: str):
    """The counter ``name``, or ``None`` where it was never counted."""
    return counters().get(name)


def ratio(num: str, den: str, scale: float = 1.0):
    """``num`` over ``den`` times ``scale``, or ``None`` without ``den``."""
    c = counters()
    return c.get(num, 0) / c[den] * scale if c.get(den) else None


def agg_slots_per_nnz(ctx):
    """Padded-ELL slots the eager tier walked for each non-zero slot of the
    adjacencies the run's calls were given."""
    return ratio("agg.slots", "ell.nonzero")
