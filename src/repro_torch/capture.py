"""A fixed-shape function captured as a CUDA graph: the port's counterpart
of the reference's ``jax.jit`` executables.

:class:`CapturedGraph` runs a function over a list of input tensors three
ways on its first call: once eagerly on a side stream (which builds and
loads the kernels, and lets the allocator and cuBLAS set up outside the
capture), once under capture into a ``torch.cuda.CUDAGraph`` over static
copies of the inputs, then as a replay.  Every later call copies its
inputs into the static buffers and replays: one launch from the host for
the whole function, where the eager function dispatches every op from
Python.  The output is copied out of the graph's pool, so the caller owns
it and the next replay cannot overwrite it.

What a capture must hold to:

- *No host reads.*  A function that reads a device value on the host
  (``.item()``, ``nonzero``, a data-dependent shape) cannot be captured;
  the paths captured here have none (their CPU tests run them under
  ``FakeTensorMode``).
- *Launch counts.*  Kernel wrappers count a launch with
  :func:`~repro_torch.kernels.common.count_launch`; under capture it goes
  to the capture's tally, and every replay adds the tally, so a count is
  still the number of launches that ran.
- *Faults raise.*  A kernel that fails to launch during the capture raises
  :class:`~repro_torch.kernels.common.CudaKernelError` there, and a replay
  that fails to launch raises it too.  Nothing falls back to an
  uncaptured run.
- *Threads and streams.*  Captures run one at a time in a process, each
  in ``thread_local`` mode, so launches from another thread (another
  serving worker on the same card) neither join nor break it.  A replay
  runs on the caller's current stream; one graph is replayed by one
  thread at a time, and each replay's stream first waits for the previous
  replay's, wherever it ran, since they share the static buffers.  No
  thread may synchronise the whole device while another captures
  (CUDA refuses it), so the port's paths that may run beside a capture
  synchronise their own stream.
- *Backward.*  A training step's ``torch.autograd.grad`` runs inside the
  capture: autograd's device thread launches each backward op on the
  stream its forward op ran on, which is the capturing stream, so the
  backward joins the graph (the card's tests hold a replay equal to the
  uncaptured step, with the parameters moved).
- *Donated state.*  A replay that fails raises
  :class:`~repro_torch.kernels.common.CudaKernelError`, whose donated
  buffers may be half written; callers re-raise it and never run again
  from them (:class:`~repro_torch.runtime.fault_tolerance.ResilientRunner`
  does not retry it, and a restart resumes from the last checkpoint).
"""
from __future__ import annotations

import threading

import torch

from .kernels.common import CudaKernelError, add_launches, launch_tally

#: one capture at a time in a process (see the module docstring)
_CAPTURE_LOCK = threading.Lock()


class CapturedGraph:
    """``fn(*inputs)`` captured once; calls replay it.

    ``inputs`` are example tensors whose shapes, dtypes and device the
    graph is fixed to (each call passes tensors of the same shapes; a
    Python number fills its buffer).  ``fn`` returns a tensor or a tuple of
    tensors.  ``mutated`` lists tensors outside ``inputs`` that ``fn``
    writes in place (a decode cache): the eager warm-up's writes to them
    are undone, so only the replays change them.

    ``donated`` inputs (the first ``donated`` of them) are not copied: the
    graph takes those very tensors as its buffers, as a ``jax.jit``
    executable owns the arguments donated to it, and ``fn`` writes its new
    values into them in place (a training state).  A call that passes the
    buffers themselves copies nothing in; any other tensor is copied in.
    The caller's tensors are then the graph's: a replay overwrites them.
    ``warmup`` runs in place of ``fn`` for the eager warm-up: for a ``fn``
    that writes its donated buffers, the same computation with the writes
    left out, so the warm-up leaves them as it found them without a copy.
    """

    def __init__(self, fn, inputs, *, mutated=(), donated=0, warmup=None):
        self.device = inputs[0].device
        if self.device.type != "cuda":
            raise ValueError(f"CapturedGraph needs CUDA tensors, got {self.device}")
        self.static = list(inputs[:donated]) + [t.clone() for t in inputs[donated:]]
        self._lock = threading.Lock()
        self._done = torch.cuda.Event()
        self._replayed = False
        caller = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(caller)
        with torch.cuda.device(self.device), torch.cuda.stream(side):
            saved = [t.clone() for t in mutated]
            (warmup or fn)(*self.static)  # warm-up: kernels built and loaded, pools made
            for t, s in zip(mutated, saved):
                t.copy_(s)
            del saved
            self.graph = torch.cuda.CUDAGraph()
            with _CAPTURE_LOCK, launch_tally() as tally:
                self.graph.capture_begin(capture_error_mode="thread_local")
                try:
                    out = fn(*self.static)
                except BaseException:
                    try:  # end the broken capture; the error that broke it propagates
                        self.graph.capture_end()
                    except RuntimeError:
                        pass
                    raise
                self.graph.capture_end()
        caller.wait_stream(side)
        self.tally = dict(tally)
        self.out = out if isinstance(out, tuple) else (out,)
        self._single = not isinstance(out, tuple)

    @property
    def launches(self) -> dict:
        """Kernel launches of one replay, by wrapper name."""
        return {w.__name__: n for w, n in self.tally.items()}

    def __call__(self, *inputs):
        stream = torch.cuda.current_stream(self.device)
        with self._lock:
            if self._replayed:
                stream.wait_event(self._done)
            for buf, value in zip(self.static, inputs):
                if value is buf:
                    continue
                if isinstance(value, torch.Tensor):
                    buf.copy_(value)
                else:
                    buf.fill_(value)
            try:  # a fault from here on may leave donated buffers half written
                with torch.cuda.device(self.device):
                    self.graph.replay()
                out = tuple(t.clone() for t in self.out)
            except RuntimeError as e:
                raise CudaKernelError(f"CUDA graph replay failed: {e}") from e
            add_launches(self.tally)
            self._done.record(stream)
            self._replayed = True
        return out[0] if self._single else out
