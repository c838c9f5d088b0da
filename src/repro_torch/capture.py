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
- *Counts.*  Kernel wrappers count a launch with
  :func:`~repro_torch.trace.count_launch`, and the eager tier its work
  with :func:`~repro_torch.trace.count`; under capture both go to the
  capture's tally, and every replay adds the tally, so a count is still
  the work that ran.  A replay counts the bytes it copies into the static
  buffers (``replay.bytes_in``) and itself (``replay.calls``); a capture
  its host seconds (``setup.capture_s``).  Its phases are profiler spans
  (``repro_torch.capture.*``, ``repro_torch.replay.*``).
- *Faults raise.*  A kernel that fails to launch during the capture raises
  :class:`~repro_torch.kernels.common.CudaKernelError` there, and a replay
  that fails to launch raises it too.  Nothing falls back to an
  uncaptured run.
- *Memory and the collector.*  Before each capture the default pool's
  cached blocks go back to the card (the capture's private pool cannot
  reuse them), and Python's cyclic collector pauses until the capture
  ends: a collection inside it could free an older graph, a call CUDA
  refuses while a stream captures.  A graph keeps no reference to its
  function, so nothing waits on the collector to free one.
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
- *DTensors.*  A graph records the function of each rank's local shards
  (:class:`LocalShards`, as ``launch.dryrun.record`` records one): a
  DTensor input enters as its local tensor and is wrapped back inside
  with ``DTensor.from_local(..., run_check=False)``, which moves no data;
  a DTensor result leaves as its local tensor and the caller gets it back
  as a DTensor of the same mesh and placements.  The static buffers are
  local tensors, and a donated DTensor gives its own local tensor.  Only
  an NCCL mesh (device type ``cuda``) captures: a ``gloo`` mesh's
  tensors lie on the CPU, which raises here, and its callers keep it
  uncaptured by rule.  The eager warm-up runs every collective of the
  function once, so NCCL's communicators exist before the capture.
- *Forked streams.*  A function may fork work onto other streams (the
  Parallel Pipeline's producer and consumer, and autograd's backward on
  them), each waiting first on the capturing stream; every forked
  stream's last work must be joined back into the capturing stream before
  the function returns, or the capture ends "unjoined" and raises.
"""
from __future__ import annotations

import contextlib
import gc
import threading

import torch

from . import trace
from .kernels.common import CudaKernelError

#: one capture at a time in a process (see the module docstring)
_CAPTURE_LOCK = threading.Lock()


def _dtensor_type():
    from torch.distributed.tensor import DTensor

    return DTensor


def local(t):
    """A DTensor's own local tensor (the very tensor, not a view: a
    donated buffer is its storage); any other value as it is."""
    return t._local_tensor if isinstance(t, _dtensor_type()) else t


def placement(t):
    """``(mesh, placements, shape, stride)`` of a DTensor (its global shape
    and stride), else None: what a graph's key and its rewrapping need."""
    if isinstance(t, _dtensor_type()):
        return (t.device_mesh, tuple(t.placements), t.shape, t.stride())
    return None


def _wrap(t, spec):
    if spec is None:
        return t
    mesh, placements, shape, stride = spec
    return _dtensor_type().from_local(t, mesh, placements, run_check=False, shape=shape,
                                      stride=stride)


class LocalShards:
    """``fn`` as the function of its inputs' local tensors, the function a
    :class:`CapturedGraph` records: called with the local tensors of inputs
    placed as ``inputs`` are, it wraps each DTensor's back (no data moves),
    runs ``fn`` and returns a tuple of its results' local tensors;
    :meth:`results` wraps those back as ``fn`` returned them.  Without a
    DTensor it is ``fn`` with its results in a tuple."""

    def __init__(self, fn, inputs):
        self.fn = fn
        self.specs = [placement(t) for t in inputs]
        self.out_specs: list = []
        self.single = False

    def __call__(self, *local_inputs):
        out = self.fn(*(_wrap(t, s) for t, s in zip(local_inputs, self.specs)))
        self.single = not isinstance(out, tuple)
        outs = (out,) if self.single else out
        self.out_specs = [placement(o) for o in outs]
        return tuple(local(o) for o in outs)

    def results(self, local_outs):
        return _rewrap(local_outs, self.out_specs, self.single)


def _rewrap(local_outs, specs, single):
    outs = tuple(_wrap(t, s) for t, s in zip(local_outs, specs))
    return outs[0] if single else outs


@contextlib.contextmanager
def _collector_paused():
    """Python's cyclic collector paused until the block ends: a collection
    inside a capture could free an old graph there (a call CUDA refuses
    while a stream captures), which breaks the capture."""
    paused = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if paused:
            gc.enable()


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

    Any of ``inputs``, ``mutated`` and the results may be DTensors of an
    NCCL mesh: the graph records :class:`LocalShards` of ``fn``, its
    buffers are the local tensors, and a call returns DTensors where
    ``fn`` returned them.  ``donated`` keeps the donated inputs as given
    (DTensors over the buffers, where they were DTensors).
    """

    @trace.timed("setup.capture_s")
    def __init__(self, fn, inputs, *, mutated=(), donated=0, warmup=None):
        locals_ = [local(t) for t in inputs]
        self.device = locals_[0].device
        if self.device.type != "cuda":
            raise ValueError(f"CapturedGraph needs CUDA tensors, got {self.device}")
        shards = LocalShards(fn, inputs)
        self.donated = list(inputs[:donated])
        self.static = locals_[:donated] + [t.clone() for t in locals_[donated:]]
        self._nbytes = [t.numel() * t.element_size() for t in self.static]
        self._lock = threading.Lock()
        self._done = torch.cuda.Event()
        self._replayed = False
        caller = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(caller)
        mutated = [local(t) for t in mutated]
        with torch.cuda.device(self.device), torch.cuda.stream(side):
            with trace.span("repro_torch.capture.warmup"):
                saved = [t.clone() for t in mutated]
                # warm-up: kernels built and loaded, pools and NCCL communicators made
                LocalShards(warmup or fn, inputs)(*self.static)
                for t, s in zip(mutated, saved):
                    t.copy_(s)
                del saved
            self.graph = torch.cuda.CUDAGraph()
            with trace.span("repro_torch.capture.record"), _CAPTURE_LOCK, \
                    _collector_paused(), trace.launch_tally() as tally:
                # the capture's private pool cannot reuse the blocks the
                # default pool holds cached: hand them back to the card
                torch.cuda.empty_cache()
                self.graph.capture_begin(capture_error_mode="thread_local")
                try:
                    self.out = shards(*self.static)
                except BaseException:
                    try:  # end the broken capture; the error that broke it propagates
                        self.graph.capture_end()
                    except RuntimeError:
                        pass
                    raise
                self.graph.capture_end()
        caller.wait_stream(side)
        self.tally = dict(tally)
        # what rewraps the results, not ``fn`` itself: a graph its own
        # function refers back to would be freed only by the collector
        self._out_specs, self._single = shards.out_specs, shards.single

    @property
    def launches(self) -> dict:
        """Kernel launches of one replay, by wrapper name."""
        return {w.__name__: n for w, n in self.tally.items() if not isinstance(w, str)}

    def __call__(self, *inputs):
        stream = torch.cuda.current_stream(self.device)
        with self._lock:
            if self._replayed:
                stream.wait_event(self._done)
            copied = 0
            with trace.span("repro_torch.replay.copy_in"):
                for buf, nbytes, value in zip(self.static, self._nbytes, map(local, inputs)):
                    if value is buf:
                        continue
                    if isinstance(value, torch.Tensor):
                        buf.copy_(value)
                    else:
                        buf.fill_(value)
                    copied += nbytes
            try:  # a fault from here on may leave donated buffers half written
                with trace.span("repro_torch.replay.launch"), torch.cuda.device(self.device):
                    self.graph.replay()
                with trace.span("repro_torch.replay.copy_out"):
                    out = tuple(t.clone() for t in self.out)
            except RuntimeError as e:
                raise CudaKernelError(f"CUDA graph replay failed: {e}") from e
            trace.add_launches(self.tally)
            trace.count("replay.bytes_in", copied)
            trace.count("replay.calls")
            self._done.record(stream)
            self._replayed = True
        return _rewrap(out, self._out_specs, self._single)
