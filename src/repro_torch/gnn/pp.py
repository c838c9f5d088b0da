"""Parallel-Pipeline (PP) inter-phase dataflow at the device level.

The port of :mod:`repro.gnn.pp`.  The paper's PP splits the PE array into
an aggregation engine and a combination engine connected by a ping-pong
buffer; the reference maps that onto two device groups of a mesh.  This
package runs the reference's one-device behaviour: with no mesh, or a
mesh of fewer than 2 devices, PP is the SP-Generic band loop.  The
two-group pipeline (two CUDA streams handing bands off through events) is
not ported yet, and a multi-device mesh raises.
"""
from __future__ import annotations


def pp_multiphase_matmul(
    adj,
    x,
    w,
    order: str = "AC",
    mesh=None,
    band_size: int = 128,
):
    """(A @ X) @ W (AC) or A @ (X @ W) (CA) under Parallel Pipeline.

    ``mesh`` is ``None`` or a sequence of devices.  With fewer than 2
    devices this is exactly the reference's fallback: SP-Generic with the
    default band (128) on the eager tier — ``band_size`` is not passed on.
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
    raise NotImplementedError(
        "the two-group Parallel Pipeline over a multi-device mesh is not "
        "ported yet; pass mesh=None (one device)"
    )
