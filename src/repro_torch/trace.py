"""The port's counters and spans.

Counters are process-wide totals by name, always on: each is an integer
add at the boundary where the work happens, or two clock reads around a
set-up phase.  :func:`counters` returns them as they stand.

- ``agg.slots``: padded-ELL slots the eager tier walks
  (``gnn.layers.aggregate_band`` and its backward), pad slots included;
- ``ell.nonzero``: the bound adjacency's non-zero slots, once a
  ``Program.run`` or ``Program.train_step`` call, so ``agg.slots`` over
  ``ell.nonzero`` is the slots walked for each one that counts;
- ``replay.bytes_in`` and ``replay.calls``: bytes a CUDA-graph replay
  copies into its static buffers, and the replays;
- ``setup.bind_s``, ``setup.capture_s`` and ``setup.batching_s``: host
  seconds in ``Program.bind`` (the ELL build and its upload), in capturing
  graphs (warm-up and capture) and in ``bucketize`` / ``assemble``;
- ``moe.calls`` and ``moe.dispatch_bytes``: MoE layers run by the
  grouped product (``models.moe.moe_ragged``), and the bytes their expert
  sort's gather and weighted un-sort write, counted from shapes.

Kernel launches are counted on each wrapper's own ``launches`` attribute
(:func:`count_launch`).  While a thread captures a CUDA graph nothing
runs yet, so its counts, named and launches alike, go to the capture's
tally (:func:`launch_tally`), and each replay adds the tally
(:func:`add_launches`): a count is the work that ran.  A training step's
backward runs on autograd's device thread, on the capturing stream: a
count made there goes to the tally of the capture in progress too (one
capture at a time in a process).

Spans are ``torch.profiler.record_function`` ranges named
``repro_torch.<layer>.<phase>``, opened at host boundaries (``Program.run``,
``train_step`` and ``bind``, a capture's warm-up and recording, a replay's
copies and launch, batch assembly, an LM block's attention and MoE FFN)
only while a torch profiler records: they land in its trace beside the
card's kernels, on its clock.  With no
profiler on, :func:`span` is one flag check and records nothing.  A span
opened inside a function that a CUDA graph captures records nothing: the
function runs once, at capture (the LM blocks' spans in a captured step).
"""
from __future__ import annotations

import contextlib
import functools
import threading
import time

import torch
from torch.profiler import record_function

_LOCK = threading.Lock()
_COUNTS: dict[str, float] = {}
_LOCAL = threading.local()  # .tally: this thread's capture
_CAPTURE: list = [None]  # the tally of the capture in progress, if any

#: what :func:`span` returns while no profiler records
NO_SPAN = contextlib.nullcontext()


def _tally():
    """The tally a count made now belongs to: this thread's capture, or the
    capture in progress when this thread launches on its capturing stream
    (autograd's device thread running a captured backward); else None."""
    tally = getattr(_LOCAL, "tally", None)
    if tally is None and _CAPTURE[0] is not None and torch.cuda.is_available() \
            and torch.cuda.is_current_stream_capturing():
        tally = _CAPTURE[0]
    return tally


def _apply(key, n) -> None:
    """Add ``n`` to a name's counter or a wrapper's launches (under the lock)."""
    if isinstance(key, str):
        _COUNTS[key] = _COUNTS.get(key, 0) + n
    else:
        key.launches += n


def _add(key, n) -> None:
    tally = _tally()
    with _LOCK:
        if tally is None:
            _apply(key, n)
        else:
            tally[key] = tally.get(key, 0) + n


def count(name: str, n=1) -> None:
    """Add ``n`` to the counter ``name`` (to the capture's tally while the
    work is being captured, see the module docstring)."""
    _add(name, n)


def count_launch(wrapper) -> None:
    """Count one launch of ``wrapper``'s kernel on ``wrapper.launches``
    (to the capture's tally while the launch is being captured)."""
    _add(wrapper, 1)


def add_launches(tally: dict) -> None:
    """Add a capture's tally to the counts, once for each replay of its
    graph: a wrapper's launches to its ``launches``, a name's to its
    counter."""
    with _LOCK:
        for key, n in tally.items():
            _apply(key, n)


@contextlib.contextmanager
def launch_tally():
    """Within the block, this thread's counts and kernel launches go into
    the dict it yields rather than to the counts (a capture records them)."""
    tally: dict = {}
    outer = _CAPTURE[0]
    _LOCAL.tally = _CAPTURE[0] = tally
    try:
        yield tally
    finally:
        _LOCAL.tally = None
        _CAPTURE[0] = outer


def counters() -> dict:
    """A snapshot of the named counters: totals since the process started."""
    with _LOCK:
        return dict(_COUNTS)


@contextlib.contextmanager
def timed(name: str):
    """Count the block's host seconds on ``name`` (no synchronise)."""
    start = time.perf_counter()
    try:
        yield
    finally:
        count(name, time.perf_counter() - start)


def span(name: str):
    """A ``record_function(name)`` range while a torch profiler records,
    else :data:`NO_SPAN`, which records nothing; :data:`NO_SPAN` too while
    this thread's stream captures a CUDA graph, whose function runs once,
    at capture."""
    if torch.autograd._profiler_enabled() and not _capturing():
        return record_function(name)
    return NO_SPAN


def _capturing() -> bool:
    return torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()


def spanned(name: str):
    """Decorate a function so that each call runs in :func:`span` ``name``."""
    def decorate(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return decorate
