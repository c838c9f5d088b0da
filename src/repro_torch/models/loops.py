"""Time loops that the dry-run traces a few steps of and scales.

The reference writes its loops over positions and chunks as ``lax.scan``,
whose body XLA compiles once and runs with a trip count.  The port writes
them as Python loops, which ``make_fx`` would unroll: 32,768 sLSTM steps a
layer for a ``prefill_32k`` cell.  Model code writes such a loop as

    loop = TimeLoop(n)
    for t in loop:
        x_t, *state = loop.enter(t, xs[:, t], *state)
        state = step(x_t, *state)
        state = loop.leave(t, *state)
        outs.append(state[0])
    out = loop.full(torch.stack(outs, dim=1), dim=1)

Outside :func:`scaled_loops` that is ``range(n)``, and ``enter``, ``leave``
and ``full`` return what they are given: nothing changes in a run.  Inside
it (a dry-run's ``make_fx`` trace), a loop of more than :data:`STEPS`
steps runs three of them: the first step (its incoming state needs no
gradient), one steady step and the last (its outgoing state feeds
nothing, so part of its backward never runs).  The steady step is the
marked body: the nodes recorded between its ``enter`` and ``leave`` (its
forward) and between the backward of its ``leave`` and that of its
``enter`` (its backward, which autograd records later, during
``backward()``).  The body stands for ``n - 3`` more steps
(:attr:`Mark.extra`);
:func:`repro_torch.launch.hlo.node_weights` turns the marks into a count a
node.  ``full`` pads the stacked outputs to ``n`` along the loop's dim with
the last step's (a view and a copy, no FLOP), so what follows the loop
traces at its real size.
"""
from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass, field

import torch

_STATE = threading.local()
#: steps a scaled loop runs: the first, the marked steady one, the last
STEPS = 3


@dataclass(eq=False)
class Mark:
    """One loop's marked body: its recorded nodes, forward and backward,
    and how many more times it runs than it was recorded."""

    extra: int
    nodes: set = field(default_factory=set)
    _since: set | None = None

    def open(self) -> None:
        self._since = recorded_nodes()

    def close(self) -> None:
        self.nodes |= recorded_nodes() - self._since
        self._since = None


def recorded_nodes() -> set:
    """The nodes the ``make_fx`` trace in progress has recorded so far."""
    from torch.fx.experimental.proxy_tensor import get_proxy_mode

    mode = get_proxy_mode()
    if mode is None:
        raise RuntimeError("scaled time loops run only under a make_fx trace")
    return set(mode.tracer.graph.nodes)


@contextlib.contextmanager
def scaled_loops():
    """Run every :class:`TimeLoop` of more than :data:`STEPS` steps for
    :data:`STEPS` steps and mark its steady one.  Yields the list of
    :class:`Mark` the loops append to.  Only under a ``make_fx`` trace."""
    prev = getattr(_STATE, "marks", None)
    _STATE.marks = []
    try:
        yield _STATE.marks
    finally:
        _STATE.marks = prev


class _Edge(torch.autograd.Function):
    """Identity on ``xs``; its backward opens (the body's ``leave``) or
    closes (its ``enter``) the mark over the body's backward."""

    @staticmethod
    def forward(ctx, mark, opens, *xs):
        ctx.mark, ctx.opens = mark, opens
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        if ctx.opens:
            ctx.mark.open()
        else:
            ctx.mark.close()
        return (None, None, *grads)


def _edge(mark: Mark, opens: bool, xs: tuple) -> tuple:
    if not (torch.is_grad_enabled() and any(x.requires_grad for x in xs)):
        return xs
    return _Edge.apply(mark, opens, *xs)


class TimeLoop:
    """``range(n)``, or :data:`STEPS` steps of it with the middle one
    marked under :func:`scaled_loops` (see the module docstring)."""

    def __init__(self, n: int):
        self.n = n
        marks = getattr(_STATE, "marks", None)
        self.runs, self.mark, self._marked = n, None, -1
        if marks is not None and n > STEPS:
            self.runs, self._marked = STEPS, 1
            self.mark = Mark(extra=n - STEPS)
            marks.append(self.mark)

    def __iter__(self):
        return iter(range(self.runs))

    def enter(self, t: int, *xs: torch.Tensor) -> tuple:
        """The step's inputs; the marked step's forward starts here."""
        if t != self._marked:
            return xs
        xs = _edge(self.mark, False, xs)
        self.mark.open()
        return xs

    def leave(self, t: int, *xs: torch.Tensor) -> tuple:
        """The step's outputs; the marked step's forward ends here."""
        if t != self._marked:
            return xs
        self.mark.close()
        return _edge(self.mark, True, xs)

    def full(self, out: torch.Tensor, dim: int) -> torch.Tensor:
        """``out`` (the steps run, stacked along ``dim``, a step a slice or
        an equal run of slices) at its length for all ``n`` steps."""
        if self.runs == self.n:
            return out
        per = out.shape[dim] // self.runs
        last = out.narrow(dim, out.shape[dim] - per, per)
        shape = list(last.shape)
        reps = self.n - self.runs
        tail = last.unsqueeze(dim).expand(*shape[:dim], reps, *shape[dim:])
        return torch.cat([out, tail.flatten(dim, dim + 1)], dim=dim)
