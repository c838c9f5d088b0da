"""Offline scoring of a graph-classification library held on the card.

Set-up generates the configuration's graph library (a fixed set of graphs,
so every seed has the same sizes), routes it into the port's buckets and
assembles block-diagonal batches (``BucketPolicy``, ``assemble``), makes
each batch's features on the device from the seed (zero on pad rows) and
the parameters, finds each bucket shape's Program (the store, else the
mapper's search), binds one Program per batch and runs every batch once,
which captures each shape's CUDA graph.  The window calls ``Program.run``
with the mean readout over the batches back to back, pass after pass,
each pass in an order drawn from the seed, without synchronising.  The
last answer of every batch is held against the reference, graph by graph.
"""
from __future__ import annotations

import numpy as np
import torch

from graphgen import graph_library
from references import common

from . import base


class Job(base.Job):
    span = "run"

    def setup(self) -> None:
        from repro_torch.graphs import BucketPolicy, assemble, bucketize
        from repro_torch.graphs.csr import from_edges

        data, batching = self.config["dataset"], self.config["batching"]
        comp = self.config["compile"]
        self.library = graph_library(data)
        graphs = [from_edges(n, s, d) for n, s, d in self.library]
        policy = BucketPolicy(min_nodes=batching["min_nodes"],
                              min_degree=batching["min_degree"],
                              max_graphs=batching["max_graphs"])
        cfg = base.gnn_config(self.model, use_pallas=self.traffic["use_pallas"])
        self.batches, programs = [], {}
        for bucket, ids in bucketize(graphs, policy).items():
            for s in range(0, len(ids), policy.max_graphs):
                members = ids[s:s + policy.max_graphs]
                batch = assemble([graphs[i] for i in members], policy)
                shape = (bucket, batch.v_total)
                if shape not in programs:
                    programs[shape] = base.program_for(
                        self.store, cfg, batch.graph, bucket, comp["objective"], self.device)
                prog = programs[shape].bind(batch.graph, pad_degree=batch.d_bucket)
                self.batches.append({
                    "prog": prog, "members": members, "v_total": batch.v_total,
                    "segments": torch.as_tensor(batch.segment_ids, device=self.device),
                    "slots": batch.slots, "offsets": batch.offsets, "sizes": batch.sizes,
                    "stats": base.graph_stats(prog, batch.graph),
                    "flops": sum(self.ref.flops(self.model, *self.library[i])
                                 for i in members),
                })
        self.outputs: dict[int, torch.Tensor] = {}
        self.draw(self.seed)
        self.start()

    def draw(self, seed: int) -> None:
        """The seed's inputs: the parameters, each batch's features (zero
        on pad rows) and the window's order."""
        gen = base.generator(seed, self.device)
        self.params = self.ref.init_params(self.model, gen, self.device, self.dtype)
        for batch in self.batches:
            x = torch.randn((batch["v_total"], self.model["f_in"]), generator=gen,
                            device=self.device, dtype=self.dtype)
            x[int(batch["sizes"].sum()):] = 0
            batch["x"] = x
        self.order_rng = np.random.default_rng(seed)
        self.order: list[int] = []
        self.called: list[int] = []

    def start(self) -> None:
        """Every batch once, through the timed call, then wait for them."""
        for b in range(len(self.batches)):
            self._run(b)
        self.sync()

    def _run(self, b: int) -> int:
        batch = self.batches[b]
        self.outputs[b] = batch["prog"].run(
            self.params, batch["x"], segment_ids=batch["segments"],
            num_segments=batch["slots"], readout=self.traffic["readout"])
        return len(batch["members"])

    def dispatch(self, i: int) -> int:
        if not self.order:
            self.order = list(self.order_rng.permutation(len(self.batches)))
        b = int(self.order.pop())
        self.called.append(b)
        return self._run(b)

    # -- what the metrics read ------------------------------------------------
    def end_to_end(self, window) -> dict:
        return {"graphs_per_s": window.units / window.seconds}

    def model_flops(self, calls: list[int]) -> float:
        return sum(self.batches[self.called[i]]["flops"] for i in calls)

    def bound(self, call: int):
        batch = self.batches[self.called[call]]
        return batch["prog"], batch["stats"]

    # -- correctness ----------------------------------------------------------
    def release(self) -> None:
        for batch in self.batches:
            batch.pop("prog")
        self.outputs = {b: o.cpu() for b, o in self.outputs.items()}
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def answers(self) -> list[torch.Tensor]:
        """Each graph's readout, from its batch's last answer."""
        return [self.outputs[b][j] for b, batch in enumerate(self.batches)
                for j in range(len(batch["members"]))]

    def reference(self, prec: str) -> list[torch.Tensor]:
        want = []
        for batch in self.batches:
            for i, off, n in zip(batch["members"], batch["offsets"], batch["sizes"]):
                graph = self.ref.graph(*self.library[i], self.device)
                h = self.ref.forward(self.params, graph,
                                     batch["x"][int(off):int(off) + int(n)], prec)
                want.append(common.readout(h, self.traffic["readout"]))
        return want
