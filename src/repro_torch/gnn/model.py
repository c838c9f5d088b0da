"""Multi-layer GNN models with per-layer multiphase dataflow schedules.

The port of :mod:`repro.gnn.model`.  The execution path runs off the
model-level schedule IR (:class:`repro_torch.core.schedule.ModelSchedule`):
``gnn_forward`` lowers each layer's LayerSchedule to its executable knobs
and dispatches :func:`repro_torch.gnn.layers.multiphase_matmul` with them.

.. deprecated::
    Configuring execution through the ``GNNConfig.policy`` / ``order`` /
    ``band_size`` string knobs is deprecated.  They remain as a thin
    compatibility shim that constructs a homogeneous default schedule
    (:meth:`ModelSchedule.from_policies`) and emits a one-time
    :class:`DeprecationWarning`; new code should compile a
    :class:`repro_torch.api.Program` with :func:`repro_torch.compile` (or
    pass an explicit ``ModelSchedule``).
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass

import numpy as np
import torch

from ..core.schedule import ModelSchedule
from ..device import resolve_device
from ..graphs.csr import CSRGraph
from .layers import LAYER_FNS, EllAdjacency, init_layer, segment_readout

#: set True after the first string-policy shim warning (reset by tests).
_POLICY_SHIM_WARNED = False


def _warn_policy_shim() -> None:
    """One-time DeprecationWarning for the string-policy execution path."""
    global _POLICY_SHIM_WARNED
    if not _POLICY_SHIM_WARNED:
        _POLICY_SHIM_WARNED = True
        warnings.warn(
            "executing from GNNConfig.policy/order/band_size string knobs is "
            "deprecated; compile a Program with repro_torch.compile(...) or "
            "pass an explicit ModelSchedule (schedule=...) instead",
            DeprecationWarning,
            stacklevel=3,
        )


@dataclass(frozen=True)
class GNNConfig:
    kind: str = "gcn"  # gcn | sage | gin
    f_in: int = 128
    hidden: int = 16  # Kipf-standard hidden width
    n_classes: int = 8
    n_layers: int = 2
    policy: str = "sp_opt"  # deprecated shim; see module docstring
    order: str = "AC"  # phase order
    band_size: int = 128
    use_pallas: bool = False  # route through the hand-written kernel tier

    @property
    def dims(self) -> list[tuple[int, int]]:
        ds = []
        f = self.f_in
        for i in range(self.n_layers):
            out = self.n_classes if i == self.n_layers - 1 else self.hidden
            ds.append((f, out))
            f = out
        return ds

    def default_schedule(self) -> ModelSchedule:
        """The homogeneous ModelSchedule the (deprecated) string knobs
        stand for; prefer :func:`repro_torch.compile` for new code."""
        return ModelSchedule.from_policies(
            self.policy, self.order, self.dims, band_size=self.band_size
        )


def init_gnn(cfg: GNNConfig, generator: torch.Generator, device=None):
    return [
        init_layer(cfg.kind, generator, fi, fo, device=device)
        for fi, fo in cfg.dims
    ]


def forward_layers(kind: str, params, adj: EllAdjacency, x: torch.Tensor,
                   specs, mesh=None, segment_ids=None, num_segments=None,
                   readout: str = "mean", kernels=None) -> torch.Tensor:
    """Run the layer stack under per-layer ExecSpecs (the single forward
    loop shared by ``gnn_forward`` and ``repro_torch.api.Program.run``).

    With ``segment_ids`` / ``num_segments`` (a block-diagonally batched
    graph, see :mod:`repro_torch.graphs.batching`), the per-node logits
    are reduced per member graph with
    :func:`repro_torch.gnn.layers.segment_readout` and the result is
    (num_segments, f_out) — per-graph outputs, not one fused logit matrix.

    ``kernels`` (one resolved registry entry per layer) skips the registry
    lookup, so an executable keeps the kernels it was built with.
    """
    fn = LAYER_FNS[kind]
    h = x
    for i, (layer, spec) in enumerate(zip(params, specs)):
        kw = {} if kernels is None else {"kernel": kernels[i]}
        h = fn(layer, adj, h, spec=spec, mesh=mesh, **kw)
    if segment_ids is not None:
        if num_segments is None:
            raise ValueError("segment_ids needs num_segments")
        h = segment_readout(h, segment_ids, num_segments, reduce=readout)
    return h


def masked_xent_loss(logits: torch.Tensor, labels, mask):
    """Masked softmax cross-entropy shared by ``gnn_loss`` and
    ``Program.loss``."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(1, labels.long()[:, None])[:, 0]
    return (nll * mask).sum() / mask.sum().clamp(min=1.0)


def gnn_forward(
    cfg: GNNConfig,
    params,
    adj: EllAdjacency,
    x: torch.Tensor,
    mesh=None,
    schedule: ModelSchedule | None = None,
):
    """Forward pass under a model-level schedule.

    ``schedule`` defaults to the homogeneous schedule constructed from the
    config's string knobs (the **deprecated** shim path — it warns once);
    pass a mapper-searched ModelSchedule, or better, compile a
    :class:`repro_torch.api.Program` with :func:`repro_torch.compile`, to
    run each layer under its own dataflow.
    """
    if schedule is None:
        _warn_policy_shim()
        schedule = cfg.default_schedule()
    if schedule.n_layers != len(params):
        raise ValueError(
            f"schedule has {schedule.n_layers} layers but params have "
            f"{len(params)}"
        )
    return forward_layers(
        cfg.kind, params, adj, x,
        schedule.lower(use_pallas=cfg.use_pallas), mesh=mesh,
    )  # logits (V, n_classes)


def gnn_loss(cfg: GNNConfig, params, adj, x, labels, mask, schedule=None):
    logits = gnn_forward(cfg, params, adj, x, schedule=schedule)
    return masked_xent_loss(logits, labels, mask)


def make_node_classification_task(
    g: CSRGraph, f_in: int, n_classes: int, seed: int = 0, device=None
):
    """Seeded synthetic node-classification task over a CSR graph:
    ``(x, labels, mask)`` drawn from numpy ``default_rng(seed)`` exactly as
    the reference draws them (so both packages train on the same bits),
    placed on ``device`` (default: the CUDA device)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(g.n_nodes, f_in)).astype(np.float32)
    labels = rng.integers(0, n_classes, size=g.n_nodes).astype(np.int32)
    mask = (rng.random(g.n_nodes) < 0.3).astype(np.float32)
    return (
        torch.as_tensor(x, device=dev),
        torch.as_tensor(labels, device=dev),
        torch.as_tensor(mask, device=dev),
    )
