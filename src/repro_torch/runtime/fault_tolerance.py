"""Fault-tolerant step runner: retry, restore, straggler mitigation.

The port of :mod:`repro.runtime.fault_tolerance` (framework-free).

At 1000+ node scale, node failure is routine: the runner treats every
step as retryable, restores from the last atomic checkpoint after a
failure (the deterministic data pipeline replays the exact stream), and
monitors per-step latency for stragglers.

On CPU this is exercised by fault-injection tests
(``tests/test_torch_runtime.py``): steps that raise are retried, and a
simulated preemption mid-run resumes to bit-identical parameters.
"""
from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from typing import Any, Callable

from ..kernels.common import CudaKernelError
from .resilience import RetryPolicy

log = logging.getLogger("repro_torch.runtime")


@dataclass
class StragglerMonitor:
    """Flags steps slower than ``threshold`` x the running median.

    On a real cluster the mitigation hook would trigger data re-balancing
    or hot-spare swap-in; here it records and logs (the decision logic is
    what we can test without hardware).
    """

    threshold: float = 3.0
    window: int = 50
    times: list[float] = field(default_factory=list)
    flagged: list[int] = field(default_factory=list)
    on_straggler: Callable[[int, float, float], None] | None = None

    def record(self, step: int, seconds: float) -> bool:
        self.times.append(seconds)
        hist = self.times[-self.window :]
        if len(hist) < 8:
            return False
        med = sorted(hist)[len(hist) // 2]
        if seconds > self.threshold * med:
            self.flagged.append(step)
            log.warning("straggler step %d: %.3fs vs median %.3fs", step, seconds, med)
            if self.on_straggler:
                self.on_straggler(step, seconds, med)
            return True
        return False


@dataclass
class ResilientRunner:
    """Runs a step function with retry + checkpoint/restore semantics.

    step_fn(state, batch) -> (state, metrics).  ``state`` is opaque (a
    dict of tensors, say); save_fn/restore_fn bind it to a Checkpointer.
    """

    step_fn: Callable[[Any, Any], tuple[Any, dict]]
    save_fn: Callable[[int, Any], None]
    restore_fn: Callable[[], tuple[int, Any]]  # -> (step, state)
    checkpoint_every: int = 50
    max_retries: int = 3
    backoff_s: float = 0.0
    monitor: StragglerMonitor = field(default_factory=StragglerMonitor)

    @property
    def retry_policy(self) -> RetryPolicy:
        """The shared retry/backoff core (same machinery the serving
        engine's degradation ladder uses)."""
        return RetryPolicy(max_retries=self.max_retries,
                           backoff_s=self.backoff_s)

    def run(self, state, batches, start_step: int = 0, num_steps: int = 100):
        """Iterate ``batches`` (indexable by step) for num_steps.

        ``metrics_log`` holds exactly one entry per *surviving* step: when
        a restore rolls ``step`` back, entries for the steps about to be
        replayed are truncated, so a replayed step never appears twice.
        """
        policy = self.retry_policy
        step = start_step
        metrics_log: list[dict] = []
        while step < start_step + num_steps:
            batch = batches(step)
            retries = 0
            while True:
                t0 = time.monotonic()
                try:
                    state, metrics = self.step_fn(state, batch)
                    break
                except CudaKernelError:
                    raise  # retrying or restoring cannot mend a broken kernel
                except Exception as e:  # noqa: BLE001 — any other step fault
                    retries += 1
                    log.warning("step %d failed (%s), retry %d", step, e, retries)
                    if retries > self.max_retries:
                        log.error("step %d exhausted retries; restoring", step)
                        step, state = self.restore_fn()
                        retries = 0
                        batch = batches(step)
                        # drop metrics for the steps we are about to
                        # replay, so each step is logged exactly once —
                        # and don't sleep a backoff on the restore itself
                        del metrics_log[max(step - start_step, 0):]
                        continue
                    policy.sleep_for(retries - 1)
            self.monitor.record(step, time.monotonic() - t0)
            metrics_log.append({"step": step, **metrics})
            step += 1
            if step % self.checkpoint_every == 0:
                self.save_fn(step, state)
        self.save_fn(step, state)
        return state, metrics_log
