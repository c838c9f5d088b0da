"""Deterministic, checkpointable synthetic data pipelines.

The port of :mod:`repro.data.pipeline`.  Every batch is a pure function of
(seed, step), drawn from numpy exactly as the reference draws it (so both
packages see the same tokens), so the entire pipeline state is two
integers: resuming from a checkpoint replays the exact token stream, and
no host state can be lost on preemption.

The synthetic LM stream is a mixture of Zipf-distributed unigrams and
shifted-copy spans, which gives a learnable (loss-reducing) signal without
any external corpus.  Batches are tensors on the pipeline's ``device``
(default: the CUDA device).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device
from ..models.config import ArchConfig
from ..models.layers import torch_dtype


@dataclass
class LMDataPipeline:
    cfg: ArchConfig
    batch: int
    seq: int
    seed: int = 0
    step: int = 0
    device: object = None

    def state_dict(self) -> dict:
        return {"seed": self.seed, "step": self.step}

    def load_state_dict(self, state: dict) -> None:
        self.seed = int(state["seed"])
        self.step = int(state["step"])

    def peek(self, step: int | None = None) -> dict:
        """Batch for an arbitrary step (pure function — no state change)."""
        step = self.step if step is None else step
        dev = resolve_device(self.device)
        rng = np.random.default_rng((self.seed, step))
        v = self.cfg.vocab
        # Zipf-ish unigram distribution
        ranks = np.arange(1, v + 1)
        probs = 1.0 / ranks
        probs /= probs.sum()
        toks = rng.choice(v, size=(self.batch, self.seq + 1), p=probs)
        # inject copy spans: tokens repeat 8 positions later (learnable)
        span = self.seq // 4
        if span > 8:
            start = rng.integers(0, self.seq - span - 8)
            toks[:, start + 8 : start + 8 + span] = toks[:, start : start + span]
        toks = toks.astype(np.int32)
        inputs_tok = toks[:, :-1]
        labels = toks[:, 1:]
        if self.cfg.embedded_inputs:
            # stub frontend: embed with a fixed random table (seeded)
            table_rng = np.random.default_rng(self.seed + 7)
            table = table_rng.normal(size=(64, self.cfg.d_model)).astype(np.float32) * 0.05
            inputs = table[inputs_tok % 64]
            inputs = torch.as_tensor(inputs, device=dev).to(torch_dtype(self.cfg))
        else:
            inputs = torch.as_tensor(np.ascontiguousarray(inputs_tok), device=dev)
        return {"inputs": inputs,
                "labels": torch.as_tensor(np.ascontiguousarray(labels), device=dev)}

    def __next__(self) -> dict:
        b = self.peek()
        self.step += 1
        return b

    def __iter__(self):
        return self


@dataclass
class GraphStream:
    """Seeded stream of graph-classification batches (GNN training)."""

    dataset: str
    f_in: int
    n_classes: int
    seed: int = 0
    step: int = 0
    device: object = None

    def state_dict(self):
        return {"seed": self.seed, "step": self.step}

    def load_state_dict(self, state):
        self.seed = int(state["seed"])
        self.step = int(state["step"])

    def __next__(self):
        from ..graphs.datasets import load_dataset
        from ..gnn.model import make_node_classification_task

        g, spec = load_dataset(self.dataset, seed=self.seed + self.step)
        x, labels, mask = make_node_classification_task(
            g, self.f_in, self.n_classes, seed=self.seed + self.step,
            device=self.device,
        )
        self.step += 1
        return g, x, labels, mask
