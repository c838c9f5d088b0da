"""Parallel-Pipeline (PP) inter-phase dataflow at the device level.

The port of :mod:`repro.gnn.pp`.  The paper's PP splits the PE array into
an aggregation engine and a combination engine connected by a ping-pong
buffer (HyGCN/AWB-GCN style).  The reference maps the two engines onto
two device groups of a mesh and hands bands off with ``ppermute``; here
each group is a device of the mesh with a CUDA stream of its own:

* group 0, the producer, on ``mesh[0]``, aggregates row band ``i`` into
  ping-pong slot ``i % 2`` and records an event;
* group 1, the consumer, on ``mesh[1]``, waits on that event, takes the
  band (a ``non_blocking`` peer copy that its stream waits on, when the
  two devices differ) and writes ``band_i @ w`` into its rows of the
  output;
* before the producer refills slot ``i % 2`` it waits on the consumer's
  event for band ``i - 2`` (the reference's one-deep ``carry``), so at
  most two bands are in flight.

A mesh whose two entries name the same card puts both groups on that
card, each on its own stream: the paper's own picture of one
accelerator's compute split between an aggregation and a combination
engine.  On the CPU the two groups interleave in program order.  With no
mesh, or a mesh of one device, PP is the reference's fallback,
SP-Generic on the eager tier.
"""
from __future__ import annotations

from typing import Sequence

import torch

from ..kernels.common import cdiv, row_matmul


def mesh_devices(mesh: Sequence | None = None, devices: Sequence | None = None) -> list:
    """Flatten a placement target into an ordered list of ``torch.device``.

    ``mesh`` or ``devices`` (a sequence of devices or device strings) is
    taken as it is, repeats included; passing both is an error.  With
    neither, every CUDA device, and it raises when there is none (there is
    no quiet move to the CPU: the CPU tests pass their devices).  The
    serving scheduler and the PP path share this, so "the mesh" means the
    same devices in both.
    """
    if mesh is not None and devices is not None:
        raise ValueError("pass mesh= or devices=, not both")
    chosen = mesh if mesh is not None else devices
    if chosen is not None:
        return [torch.device(d) for d in chosen]
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass the devices (for example "
            "['cpu']) to run on the CPU"
        )
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def pp_multiphase_matmul(
    adj,
    x: torch.Tensor,
    w: torch.Tensor,
    order: str = "AC",
    mesh: Sequence | None = None,
    band_size: int = 128,
    use_kernels: bool = False,
) -> torch.Tensor:
    """(A @ X) @ W (AC) or A @ (X @ W) (CA) on a two-group phase mesh.

    ``mesh`` is ``None`` or a sequence of devices (see
    :func:`mesh_devices`); its first two entries are the producer and the
    consumer group.  With fewer than 2 entries this is exactly the
    reference's fallback: SP-Generic with the default band (128) on the
    eager tier, ``band_size`` not passed on.  ``use_kernels`` (the layer
    spec's ``use_pallas``) runs the producer on the ``spmm`` kernel and the
    consumer on the ``gemm_dataflow`` kernel; otherwise the producer runs
    ``aggregate_band`` and the consumer ``row_matmul``, and since rows are
    independent and ``row_matmul`` is row-stable, the output is the
    fallback's, bit for bit.  The output is on ``x``'s device.
    """
    from .layers import multiphase_matmul

    if mesh is None or len(mesh) < 2:
        return multiphase_matmul(adj, x, w, policy="sp_generic", order=order)
    if order == "CA":
        # combination first is one dense GEMM; the reference pipelines the
        # aggregation of its output bands, which is sp_generic/CA.
        return multiphase_matmul(
            adj, x, w, policy="sp_generic", order="CA", band_size=band_size
        )
    producer, consumer = mesh_devices(mesh)[:2]
    if (producer.type == "cuda") != (consumer.type == "cuda"):
        raise ValueError(
            f"both PP groups must be CUDA devices or neither, got "
            f"{producer} and {consumer}"
        )
    if producer.type == "cuda":
        out = _pipeline_cuda(adj, x, w, producer, consumer, band_size, use_kernels)
    else:
        out = _pipeline_host(adj, x, w, producer, consumer, band_size, use_kernels)
    return out[: adj.n_nodes]


def _phases(use_kernels: bool):
    """The producer's band aggregation and the consumer's dense product."""
    if use_kernels:
        from ..kernels.spmm.ops import spmm
        from .layers import kernel_matmul

        return spmm, kernel_matmul
    from .layers import aggregate_band

    return aggregate_band, row_matmul


def _pipeline_host(adj, x, w, producer, consumer, band_size, use_kernels):
    """The two groups on the CPU: the same band hand-off in program order."""
    aggregate, combine = _phases(use_kernels)
    idx, wts, xp = (t.to(producer) for t in (adj.indices, adj.weights, x))
    wc = w.to(consumer)
    out = torch.empty((adj.v_pad, w.shape[1]), dtype=torch.promote_types(x.dtype, w.dtype),
                      device=consumer)
    for s in range(0, adj.v_pad, band_size):
        band = aggregate(idx[s:s + band_size], wts[s:s + band_size], xp)
        out[s:s + band_size] = combine(band.to(consumer), wc)
    return out.to(x.device)


def _pipeline_cuda(adj, x, w, producer, consumer, band_size, use_kernels):
    """The two groups on CUDA streams, handing bands off through events.

    Each band is a fresh tensor made on the producer's stream; slot
    ``i % 2`` is free again once the consumer's event for band ``i - 2``
    has fired, so at most two bands are in flight.  The output is
    allocated on the caller's stream, which waits on both groups' streams
    before anything reads it.

    A band's memory (with the eager tier, a view of its aggregation's whole
    pairwise tree) must not return to the allocator before the consumer has
    read it.  Without autograd the slot holds the band until the producer
    refills it, which is after its stream waited on the consumer's event
    for that band: freed then, on the producer's stream, its memory is
    reused in stream order, and at most two bands' trees are alive.  Where
    autograd keeps bands for the backward, ``record_stream`` ties each to
    the consumer's stream instead.

    Under CUDA-graph capture (``Program.run`` and ``train_step`` on
    ``mesh=[cuda:0, cuda:0]``) the caller's stream is the capturing one:
    the two streams fork from it and both join back into it here, so the
    capture ends with none left unjoined; a capture frees a
    ``record_stream`` band only when it ends, so a forward holds its bands
    in the slots.
    """
    aggregate, combine = _phases(use_kernels)
    n_bands = cdiv(adj.v_pad, band_size)
    # inputs onto each group's device, ordered on the caller's streams
    idx, wts, xp = (t.to(producer) for t in (adj.indices, adj.weights, x))
    wc = w.to(consumer)
    out = torch.empty((adj.v_pad, w.shape[1]),
                      dtype=torch.promote_types(x.dtype, w.dtype), device=consumer)
    p_stream = torch.cuda.Stream(producer)
    c_stream = torch.cuda.Stream(consumer)
    p_stream.wait_stream(torch.cuda.current_stream(producer))
    c_stream.wait_stream(torch.cuda.current_stream(consumer))
    saved = torch.is_grad_enabled() and any(
        t.requires_grad for t in (adj.weights, x, w))  # autograd keeps the bands
    consumed: list = [None, None]  # the consumer's event for each slot
    held: list = [None, None]  # each slot's band until the slot is refilled
    for i in range(n_bands):
        slot, s = i % 2, i * band_size
        with torch.cuda.stream(p_stream):
            if consumed[slot] is not None:
                p_stream.wait_event(consumed[slot])  # band i - 2 is combined
                held[slot] = None  # its memory is free again, in this stream's order
            band = aggregate(idx[s:s + band_size], wts[s:s + band_size], xp)
            produced = torch.cuda.Event()
            produced.record(p_stream)
        with torch.cuda.stream(c_stream):
            c_stream.wait_event(produced)
            if producer != consumer:
                # a peer copy: torch issues it on the source device's
                # current stream and makes c_stream wait on it
                with torch.cuda.stream(p_stream):
                    band = band.to(consumer, non_blocking=True)
            elif saved:
                band.record_stream(c_stream)
            else:
                held[slot] = band
            out[s:s + band_size] = combine(band, wc)
            consumed[slot] = torch.cuda.Event()
            consumed[slot].record(c_stream)
    torch.cuda.current_stream(consumer).wait_event(consumed[(n_bands - 1) % 2])
    # the last two bands (freed on return) go back in the producer's stream
    # order after the consumer's reads; the caller's stream joins both
    p_stream.wait_stream(c_stream)
    torch.cuda.current_stream(producer).wait_stream(p_stream)
    return out.to(x.device)
