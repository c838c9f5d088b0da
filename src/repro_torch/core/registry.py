"""Extension registries shared by the search and execution stacks.

Two registries back the :func:`repro.compile` front-end:

* **Objectives** — named scalar figures of merit over ``(cycles, energy)``.
  Every ``.objective(name)`` method (``MappingResult``, ``BatchStats``,
  ``ModelStats``, ``TransitionStats``) and every ``objective=`` search
  argument resolves names here, so an unknown objective raises *one*
  consistent :class:`ValueError` listing the valid names, and a new
  objective (say, a custom EDAP) becomes searchable everywhere with a
  single :func:`register_objective` call.

* **Kernels** — executable inter-phase paths keyed by the
  :class:`~repro.core.schedule.ExecSpec` fields ``(policy, order,
  use_pallas)``.  The implementations in :mod:`repro_torch.gnn.layers`
  register themselves at import time and ``multiphase_matmul`` becomes a
  thin dispatcher; a key with no hand-written kernel (``use_pallas`` means
  "the hand-written kernel tier" in this package) resolves to the eager
  implementation of the same ``(policy, order)`` — the reference's own
  semantics: ``sp_generic`` and ``sp_opt``/CA have no kernel.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Iterable


# ---------------------------------------------------------------------------
# Objectives
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Objective:
    """A named figure of merit computed from (cycles, energy_pj).

    ``fn`` must accept scalars *and* numpy arrays (the batch engine calls it
    on whole candidate grids).  ``additive`` marks objectives that sum
    across layers/transitions — the model-level DP requires one.
    """

    name: str
    fn: Callable[[Any, Any], Any]
    additive: bool = False
    description: str = ""

    def __call__(self, cycles, energy_pj):
        return self.fn(cycles, energy_pj)


_OBJECTIVES: dict[str, Objective] = {}


def register_objective(
    name: str,
    fn: Callable[[Any, Any], Any],
    *,
    additive: bool = False,
    description: str = "",
    replace: bool = False,
) -> Objective:
    """Register ``fn(cycles, energy_pj) -> value`` under ``name``."""
    if name in _OBJECTIVES and not replace:
        raise ValueError(
            f"objective {name!r} is already registered; pass replace=True "
            f"to overwrite"
        )
    obj = Objective(name, fn, additive=additive, description=description)
    _OBJECTIVES[name] = obj
    return obj


def unregister_objective(name: str) -> None:
    _OBJECTIVES.pop(name, None)


def objective_names(additive_only: bool = False) -> tuple[str, ...]:
    return tuple(
        sorted(
            n for n, o in _OBJECTIVES.items() if o.additive or not additive_only
        )
    )


def get_objective(name: str) -> Objective:
    """Resolve an objective name, or raise the one canonical error."""
    try:
        return _OBJECTIVES[name]
    except KeyError:
        raise ValueError(
            f"unknown objective {name!r}; valid objectives: "
            f"{', '.join(objective_names())}"
        ) from None


def objective_value(name: str, cycles, energy_pj):
    """``get_objective(name).fn(cycles, energy_pj)`` in one call."""
    return get_objective(name).fn(cycles, energy_pj)


register_objective(
    "cycles", lambda c, e: c, additive=True, description="runtime in cycles"
)
register_objective(
    "energy", lambda c, e: e, additive=True, description="energy in pJ"
)
register_objective(
    "edp",
    lambda c, e: c * e,
    additive=False,
    description="energy-delay product (cycles * pJ)",
)


# ---------------------------------------------------------------------------
# Kernels
# ---------------------------------------------------------------------------

#: (policy, order, use_pallas) -> callable(adj, x, w, spec, mesh)
_KERNELS: dict[tuple[str, str, bool], Callable] = {}

#: dispatch wrappers applied (in push order) to every kernel resolved by
#: :func:`lookup_kernel`.  A hook is ``fn(requested_key, impl) -> impl``:
#: it sees the *requested* ``(policy, order, use_pallas)`` key — even when
#: the kernel->eager fallback resolved a different entry — and may return a
#: substitute.  This is the seam the fault-injection harness
#: (:mod:`repro_torch.runtime.faults`) uses to simulate an execution
#: backend going down; hooks fire at lookup, which a Program does once per
#: executable it builds, so already-built executables are unaffected,
#: exactly like a live backend outage.
_KERNEL_HOOKS: list[Callable] = []

ORDERS = ("AC", "CA")


def push_kernel_hook(hook: Callable) -> Callable:
    """Install a dispatch wrapper (see ``_KERNEL_HOOKS``); returns it so
    callers can :func:`pop_kernel_hook` it later."""
    _KERNEL_HOOKS.append(hook)
    return hook


def pop_kernel_hook(hook: Callable) -> None:
    """Remove a previously pushed dispatch wrapper (no-op if absent)."""
    try:
        _KERNEL_HOOKS.remove(hook)
    except ValueError:
        pass


def register_kernel(
    policy: str,
    orders: Iterable[str] = ORDERS,
    pallas: Iterable[bool] = (False,),
):
    """Decorator: register an executable path for ``policy`` under each
    ``(order, use_pallas)`` combination.  Implementations take
    ``(adj, x, w, spec, mesh)`` where ``spec`` is the lowered
    :class:`~repro.core.schedule.ExecSpec`."""

    def deco(fn: Callable) -> Callable:
        for order in orders:
            if order not in ORDERS:
                raise ValueError(f"order must be one of {ORDERS}, got {order!r}")
            for p in pallas:
                key = (policy, order, bool(p))
                if key in _KERNELS:
                    raise ValueError(f"kernel already registered for {key}")
                _KERNELS[key] = fn
        return fn

    return deco


def kernel_policies() -> tuple[str, ...]:
    return tuple(sorted({k[0] for k in _KERNELS}))


def lookup_kernel(policy: str, order: str, use_pallas: bool = False) -> Callable:
    """Resolve the executable path for an ``ExecSpec``.

    A missing Pallas variant falls back to the jnp path of the same
    ``(policy, order)`` — e.g. ``sp_generic`` has no Pallas kernel, and
    ``sp_opt``'s fused kernel only covers the AC order.  Installed
    dispatch hooks (:func:`push_kernel_hook`) wrap the resolved kernel,
    keyed by the *requested* tuple.
    """
    requested = (policy, order, bool(use_pallas))
    for key in (requested, (policy, order, False)):
        impl = _KERNELS.get(key)
        if impl is not None:
            for hook in _KERNEL_HOOKS:
                impl = hook(requested, impl)
            return impl
    if policy not in kernel_policies():
        raise ValueError(
            f"policy must be one of {kernel_policies()}, got {policy!r}"
        )
    raise ValueError(
        f"order must be one of {ORDERS}, got {order!r} (policy {policy!r})"
    )
