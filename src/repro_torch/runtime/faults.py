"""Deterministic fault injection for the serving runtime.

The port of :mod:`repro.runtime.faults`.

The resilience layer is only trustworthy if it is *driven*: this module is
the chaos harness behind ``tests/test_torch_runtime.py`` and ``chip_smoke.py``'s chaos
part.  A seeded
:class:`FaultInjector` hooks the engine's execution boundaries:

* **run boundary** — before/after each micro-batch execution the engine
  consults :meth:`FaultInjector.on_run`, which can raise an injected
  :class:`~repro_torch.runtime.resilience.KernelFault`, sleep a latency
  spike (flagged by the engine's
  :class:`~repro_torch.runtime.fault_tolerance.StragglerMonitor`), or order the
  output corrupted with NaNs (caught by the engine's numerics check);
* **compile boundary** — :meth:`FaultInjector.on_compile` fires on a
  bucket's program-cache miss;
* **kernel-registry dispatch** — :func:`kill_pallas` (or any
  :func:`repro_torch.core.registry.push_kernel_hook` wrapper) replaces
  resolved kernels when an executable is built, e.g. simulating the CUDA
  kernel backend going down mid-stream so new buckets must degrade to the
  eager tier.  Programs whose executables are already built keep running
  (:class:`~repro_torch.api.Program` resolves its kernels once, at build)
  — exactly how a live serving process experiences a backend outage.

Faults are **deterministic**: targeted rules (:class:`FaultRule`) match on
request id, bucket, micro-batch index, or tier and fire a bounded number
of times; probabilistic mixes draw from a seeded generator.  Every
injection is recorded in :attr:`FaultInjector.log` so tests and the chaos
benchmark can assert exactly what the engine survived.
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Callable, Sequence

import numpy as np

from ..core.registry import pop_kernel_hook, push_kernel_hook
from .resilience import KernelFault

FAULT_KINDS = ("exception", "nan", "latency")


@dataclass
class FaultRule:
    """One targeted fault.  Unset match fields are wildcards.

    ``rid`` matches when the request is a member of the executing
    micro-batch — the way to poison *one request* so that its batch faults
    and the engine's solo-retry quarantine has to isolate it.
    ``max_fires=None`` makes the rule sticky (fires on every match,
    retries included); ``max_fires=1`` injects a transient fault that a
    single retry clears.
    """

    kind: str
    rid: int | None = None
    bucket: tuple[int, int] | None = None
    batch_index: int | None = None
    tier: str | None = None
    max_fires: int | None = None
    latency_s: float = 0.05
    fires: int = 0

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(
                f"kind must be one of {FAULT_KINDS}, got {self.kind!r}"
            )

    def matches(
        self,
        bucket: tuple[int, int],
        batch_index: int,
        rids: Sequence[int],
        tier: str | None,
    ) -> bool:
        if self.max_fires is not None and self.fires >= self.max_fires:
            return False
        if self.rid is not None and self.rid not in rids:
            return False
        if self.bucket is not None and self.bucket != bucket:
            return False
        if self.batch_index is not None and self.batch_index != batch_index:
            return False
        if self.tier is not None and tier is not None and self.tier != tier:
            return False
        return True


@dataclass(frozen=True)
class InjectionEvent:
    """One recorded injection (for assertions and the chaos report)."""

    boundary: str  # "run" | "compile" | "dispatch"
    kind: str
    bucket: tuple[int, int] | None
    batch_index: int | None
    tier: str | None


class FaultInjector:
    """Seeded fault source the engine consults at its boundaries.

    ``rules`` are targeted faults checked first (in order; the first match
    fires).  The ``p_*`` knobs add a probabilistic background mix drawn
    from ``numpy.random.default_rng(seed)`` — deterministic for a fixed
    seed and call sequence.  ``sleep`` is injectable so latency-spike
    tests need not actually wait.
    """

    def __init__(
        self,
        seed: int = 0,
        *,
        rules: Sequence[FaultRule] = (),
        p_exception: float = 0.0,
        p_nan: float = 0.0,
        p_latency: float = 0.0,
        latency_s: float = 0.05,
        nan_fraction: float = 0.25,
        sleep: Callable[[float], None] = time.sleep,
    ):
        for name, p in (("p_exception", p_exception), ("p_nan", p_nan),
                        ("p_latency", p_latency)):
            if not 0.0 <= p <= 1.0:
                raise ValueError(f"{name} must be in [0, 1], got {p}")
        if p_exception + p_nan + p_latency > 1.0:
            raise ValueError("fault probabilities must sum to <= 1")
        self.rng = np.random.default_rng(seed)
        self.rules = list(rules)
        self.p_exception = p_exception
        self.p_nan = p_nan
        self.p_latency = p_latency
        self.latency_s = latency_s
        self.nan_fraction = nan_fraction
        self.sleep = sleep
        self.log: list[InjectionEvent] = []

    # -- matching ------------------------------------------------------------
    def _targeted(self, bucket, batch_index, rids, tier) -> FaultRule | None:
        for rule in self.rules:
            if rule.matches(bucket, batch_index, rids, tier):
                rule.fires += 1
                return rule
        return None

    def _drawn(self) -> str | None:
        if self.p_exception + self.p_nan + self.p_latency <= 0.0:
            return None
        r = float(self.rng.random())
        if r < self.p_exception:
            return "exception"
        if r < self.p_exception + self.p_nan:
            return "nan"
        if r < self.p_exception + self.p_nan + self.p_latency:
            return "latency"
        return None

    # -- engine-facing hooks -------------------------------------------------
    def on_compile(self, bucket: tuple[int, int]) -> None:
        """Compile-boundary hook: a matching ``exception`` rule with
        ``batch_index=COMPILE`` (-1) fails the bucket's compilation."""
        rule = self._targeted(bucket, COMPILE, (), None)
        if rule is not None and rule.kind == "exception":
            self.log.append(
                InjectionEvent("compile", "exception", bucket, COMPILE, None)
            )
            raise KernelFault(
                f"injected compile fault for bucket {bucket}"
            )

    def on_run(
        self,
        bucket: tuple[int, int],
        batch_index: int,
        rids: Sequence[int],
        tier: str | None = None,
    ) -> str | None:
        """Run-boundary hook, called once per execution attempt.

        Raises :class:`KernelFault` for an ``exception`` fault, sleeps (and
        returns ``"latency"``) for a latency spike, or returns ``"nan"``
        when the caller must corrupt this attempt's output.  Returns
        ``None`` when no fault fires.
        """
        rule = self._targeted(bucket, batch_index, rids, tier)
        kind = rule.kind if rule is not None else self._drawn()
        if kind is None:
            return None
        self.log.append(InjectionEvent("run", kind, bucket, batch_index, tier))
        if kind == "exception":
            raise KernelFault(
                f"injected kernel fault (bucket={bucket}, "
                f"batch={batch_index}, tier={tier})"
            )
        if kind == "latency":
            self.sleep(rule.latency_s if rule is not None else self.latency_s)
            return "latency"
        return "nan"

    def corrupt_output(self, out: np.ndarray) -> np.ndarray:
        """Smear NaNs over a deterministic stride of the output buffer —
        what a misbehaving kernel's partial write looks like."""
        out = np.array(out, copy=True)
        flat = out.reshape(-1)
        stride = max(int(1 / max(self.nan_fraction, 1e-6)), 1)
        flat[::stride] = np.nan
        return out

    # -- reporting -----------------------------------------------------------
    def counts(self) -> dict[str, int]:
        """Injection totals by kind (for the chaos report)."""
        out: dict[str, int] = {}
        for ev in self.log:
            out[ev.kind] = out.get(ev.kind, 0) + 1
        return out


#: sentinel ``batch_index`` for compile-boundary rules.
COMPILE = -1


@contextmanager
def kill_pallas(message: str = "injected: pallas backend down"):
    """Registry-dispatch hook: every kernel resolved for a
    ``use_pallas=True`` (CUDA kernel tier) request raises
    :class:`KernelFault` when called.

    Executables built inside this context resolve the dead kernel, so new
    buckets fail on their kernel tier and the engine degrades them down the
    ladder; executables built *before* the kill resolved their kernels
    already and keep serving — a live backend outage, not a process
    restart.  Built on :func:`repro_torch.core.registry.push_kernel_hook`.
    """

    def hook(key, impl):
        policy, order, use_pallas = key
        if not use_pallas:
            return impl

        def dead(*args, **kwargs):
            raise KernelFault(
                f"{message} (policy={policy!r}, order={order!r})"
            )

        return dead

    push_kernel_hook(hook)
    try:
        yield
    finally:
        pop_kernel_hook(hook)
