"""Resilience primitives shared by the serving and training runtimes.

The port of :mod:`repro.runtime.resilience`; statuses, error codes and tier
names are the reference's, so results and stats read the same in both
packages.

The paper's own framing is that *flexibility between execution strategies
is an asset* (Sec. 7, value of flexibility): the stack already carries
several interchangeable paths per phase — hand-written CUDA kernels with
eager registry twins, mapper-searched schedules with a safe default.  This module
turns that flexibility into explicit fault-handling machinery:

* an **error taxonomy** (:class:`ServingError` and friends) so every
  per-request failure carries a typed cause and a stable ``code`` that
  surfaces on :class:`~repro_torch.runtime.engine.Result` and in
  ``EngineStats.errors``;
* **request statuses** — ``ok`` / ``rejected`` / ``failed`` / ``degraded``
  — the engine's per-request contract (``submit()`` never raises for a
  per-request cause; it returns a non-``ok`` status instead);
* a :class:`RetryPolicy` with bounded exponential backoff — the retry core
  :class:`~repro_torch.runtime.fault_tolerance.ResilientRunner` (training)
  and :class:`~repro_torch.runtime.engine.InferenceEngine` (serving) both
  use;
* the **degradation ladder** (:class:`Tier` / :func:`default_ladder`):
  searched schedule + CUDA kernels -> searched schedule + eager ->
  default schedule, walked tier by tier when the preferred path faults;
* :func:`validate_request` — the engine-boundary validation that
  quarantines malformed graphs and poisoned features *before* they can
  join a micro-batch and take healthy neighbors down with them.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import TYPE_CHECKING, Callable

import numpy as np

from ..kernels.common import CudaKernelError

if TYPE_CHECKING:  # pragma: no cover - annotation-only import
    from .engine import Request

# ---------------------------------------------------------------------------
# Request statuses
# ---------------------------------------------------------------------------

#: served on the preferred execution tier; output is authoritative.
STATUS_OK = "ok"
#: never admitted (validation / admission control); safe to resubmit after
#: fixing the cause (or after ``retry_after_s`` for load shedding).
STATUS_REJECTED = "rejected"
#: admitted but produced no trustworthy output (kernel fault at every
#: tier, non-finite output, missed deadline).
STATUS_FAILED = "failed"
#: served correctly, but on a lower tier of the degradation ladder.
STATUS_DEGRADED = "degraded"

STATUSES = (STATUS_OK, STATUS_REJECTED, STATUS_FAILED, STATUS_DEGRADED)


# ---------------------------------------------------------------------------
# Error taxonomy
# ---------------------------------------------------------------------------


class ServingError(Exception):
    """Base of the serving error taxonomy; ``code`` is the stable
    machine-readable cause recorded on ``Result.error_type``."""

    code = "serving_error"
    #: the status a request carrying this error ends in.
    status = STATUS_FAILED


class InvalidRequest(ServingError):
    """Malformed request: broken CSR invariants, wrong feature dtype or
    shape, non-finite features.  Caught at the engine boundary."""

    code = "invalid_request"
    status = STATUS_REJECTED


class OversizedGraph(ServingError):
    """Graph exceeds the bucket policy's explicit size caps; rejected with
    a clear error instead of silently compiling a one-off giant bucket."""

    code = "oversized_graph"
    status = STATUS_REJECTED


class EngineOverloaded(ServingError):
    """Admission control shed this request; ``retry_after_s`` is the
    engine's backpressure hint."""

    code = "engine_overloaded"
    status = STATUS_REJECTED

    def __init__(self, message: str, retry_after_s: float | None = None):
        super().__init__(message)
        self.retry_after_s = retry_after_s


class KernelFault(ServingError):
    """An execution-path failure (any raise on the execution path, or an
    injected fault) that survived every retry and tier.  A hand-written
    CUDA kernel that fails to build, load or launch
    (:class:`~repro_torch.kernels.common.CudaKernelError`) is not one: it
    is a fault of the program, and the engine and the retry loops re-raise
    it instead of retrying it or serving a lower tier in its place."""

    code = "kernel_fault"


class NumericalFault(ServingError):
    """Non-finite values detected in a computed output; the result is
    marked failed instead of returned silently."""

    code = "numerical_fault"


class DeadlineExceeded(ServingError):
    """The request's deadline expired before its micro-batch assembled."""

    code = "deadline_exceeded"


def backlog_retry_after(
    queue_depth: int, batch_wall_s: float, max_graphs: int
) -> float:
    """Backpressure hint for a shed request: the wall time the current
    backlog needs to drain.  ``queue_depth`` graphs form
    ``ceil(queue_depth / max_graphs)`` micro-batches (at least one), each
    costing about the recent median ``batch_wall_s`` — so a client that
    waits this long retries into a queue that has actually moved, instead
    of re-colliding after one request's latency."""
    n_batches = max(1, -(-max(0, queue_depth) // max(1, max_graphs)))
    return float(batch_wall_s) * n_batches


def as_serving_error(exc: BaseException) -> ServingError:
    """Wrap an arbitrary execution failure into the taxonomy (already-typed
    errors pass through)."""
    if isinstance(exc, ServingError):
        return exc
    err = KernelFault(f"{type(exc).__name__}: {exc}")
    err.__cause__ = exc
    return err


# ---------------------------------------------------------------------------
# Retry policy (shared by serving and training)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class RetryPolicy:
    """Bounded retry with exponential backoff.

    ``delay(i)`` is the sleep before the ``i``-th retry (0-based):
    ``backoff_s * multiplier**i`` capped at ``max_backoff_s``.  A
    ``backoff_s`` of 0 (the default — right for deterministic CPU tests)
    never sleeps.
    """

    max_retries: int = 2
    backoff_s: float = 0.0
    multiplier: float = 2.0
    max_backoff_s: float = 1.0

    def __post_init__(self):
        if self.max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, got {self.max_retries}")

    @property
    def max_attempts(self) -> int:
        return self.max_retries + 1

    def delay(self, retry_index: int) -> float:
        if self.backoff_s <= 0:
            return 0.0
        return min(
            self.backoff_s * self.multiplier ** max(retry_index, 0),
            self.max_backoff_s,
        )

    def sleep_for(self, retry_index: int, sleep: Callable[[float], None] = time.sleep):
        d = self.delay(retry_index)
        if d > 0:
            sleep(d)


def run_with_retry(fn: Callable[[], "object"], policy: RetryPolicy,
                   sleep: Callable[[float], None] = time.sleep):
    """Call ``fn`` under ``policy``; returns ``(value, n_retries)`` or
    re-raises the last failure once retries are exhausted."""
    last: BaseException | None = None
    for attempt in range(policy.max_attempts):
        try:
            return fn(), attempt
        except CudaKernelError:
            raise  # a kernel that does not build or launch stays broken
        except Exception as e:  # noqa: BLE001 — any other fault is retryable
            last = e
            if attempt < policy.max_retries:
                policy.sleep_for(attempt, sleep=sleep)
    assert last is not None
    raise last


# ---------------------------------------------------------------------------
# Degradation ladder
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Tier:
    """One rung of the degradation ladder.

    ``use_pallas`` picks the kernel family (True: the hand-written CUDA
    kernel tier, the reference's key kept); ``searched`` picks between the
    mapper-searched schedule and the safe default
    (``ModelSchedule.from_policies("sp_opt", "AC", dims)``) that needs no
    mapper and no kernel build.
    """

    name: str
    use_pallas: bool
    searched: bool


def default_ladder(use_pallas: bool) -> tuple[Tier, ...]:
    """The engine's ladder, preferred tier first.

    With kernels enabled: searched+kernels -> searched+eager ->
    default+eager.  Without: searched+eager -> default+eager.  Every
    downgrade is recorded on the per-request
    :class:`~repro_torch.runtime.engine.Result` and counted in
    ``EngineStats``.  The tier names are the reference's
    (``"pallas+searched"``, ``"jnp+searched"``, ``"jnp+default"``):
    results and stats carry them, and here ``pallas`` names the CUDA kernel
    tier and ``jnp`` the eager PyTorch tier.
    """
    tiers = []
    if use_pallas:
        tiers.append(Tier("pallas+searched", use_pallas=True, searched=True))
    tiers.append(Tier("jnp+searched", use_pallas=False, searched=True))
    tiers.append(Tier("jnp+default", use_pallas=False, searched=False))
    return tuple(tiers)


# ---------------------------------------------------------------------------
# Engine-boundary request validation
# ---------------------------------------------------------------------------


def validate_request(req: "Request", f_in: int) -> None:
    """Reject a malformed request before it can join a micro-batch.

    Raises :class:`InvalidRequest` (message naming the request id) when the
    features are not 2-D float32 of shape ``(n_nodes, f_in)`` or carry
    non-finite values (a float64 ``x`` would otherwise silently downcast
    into the batch buffer; a NaN block would poison every neighbor's
    aggregation), or when the CSR invariants are broken: ``row_ptr``
    monotone from 0 to ``nnz``, ``col_idx`` in ``[0, n_nodes)``,
    ``values`` matching ``col_idx`` and finite.
    """
    g, x, rid = req.graph, req.x, req.rid

    def bad(msg: str) -> None:
        raise InvalidRequest(f"request {rid}: {msg}")

    if getattr(x, "ndim", None) != 2:
        bad(f"features must be a 2-D array, got ndim={getattr(x, 'ndim', None)}")
    if x.dtype != np.float32:
        bad(
            f"features must be float32, got {x.dtype} (mixed-precision "
            f"features would silently change the whole batch's numerics)"
        )
    if x.shape != (g.n_nodes, f_in):
        bad(
            f"features {x.shape} do not match (n_nodes={g.n_nodes}, "
            f"f_in={f_in})"
        )
    if not np.isfinite(x).all():
        bad("features contain non-finite values")

    rp = np.asarray(g.row_ptr)
    ci = np.asarray(g.col_idx)
    vals = np.asarray(g.values)
    if rp.ndim != 1 or rp.shape[0] != g.n_nodes + 1:
        bad(
            f"row_ptr has length {rp.shape[0] if rp.ndim == 1 else rp.shape} "
            f"for n_nodes={g.n_nodes} (want n_nodes + 1)"
        )
    if rp.shape[0] and rp[0] != 0:
        bad(f"row_ptr must start at 0, got {rp[0]}")
    if (np.diff(rp) < 0).any():
        bad("row_ptr must be monotonically non-decreasing")
    if rp.shape[0] and rp[-1] != ci.shape[0]:
        bad(
            f"row_ptr[-1]={int(rp[-1])} does not match the number of stored "
            f"edges {ci.shape[0]}"
        )
    if vals.shape[0] != ci.shape[0]:
        bad(
            f"values ({vals.shape[0]}) and col_idx ({ci.shape[0]}) lengths "
            f"disagree"
        )
    if ci.shape[0] and ((ci < 0).any() or (ci >= g.n_nodes).any()):
        bad(
            f"col indices out of range [0, {g.n_nodes}): "
            f"min={int(ci.min())}, max={int(ci.max())}"
        )
    if vals.shape[0] and not np.isfinite(vals).all():
        bad("adjacency values contain non-finite entries")
