"""Modality-frontend stubs for the VLM/audio backbones.

The port of :mod:`repro.models.stubs`.  ``[vlm]``/``[audio]`` entries
specify the transformer BACKBONE only; the modality frontend is a STUB
that provides precomputed frame/patch embeddings.  The numbers come from
numpy's ``default_rng(seed)``, exactly as in the reference, so tokens and
embeddings are identical to ``repro``'s for the same seed.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from .config import ArchConfig
from .layers import torch_dtype


def synthetic_embeddings(cfg: ArchConfig, batch: int, seq: int, seed: int = 0,
                         device=None):
    """Stand-in for the vision tower / EnCodec encoder output."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(batch, seq, cfg.d_model)).astype(np.float32) * 0.02
    return torch.as_tensor(x, device=resolve_device(device)).to(torch_dtype(cfg))


def synthetic_tokens(cfg: ArchConfig, batch: int, seq: int, seed: int = 0,
                     device=None):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, size=(batch, seq)).astype(np.int32)
    return torch.as_tensor(toks, device=resolve_device(device))


def make_inputs(cfg: ArchConfig, batch: int, seq: int, seed: int = 0,
                device=None):
    if cfg.embedded_inputs:
        return synthetic_embeddings(cfg, batch, seq, seed, device)
    return synthetic_tokens(cfg, batch, seq, seed, device)
