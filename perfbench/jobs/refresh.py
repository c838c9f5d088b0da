"""Full-graph node-classification inference as the features change, as a
periodic embedding refresh runs it.

Set-up generates the configuration's one graph, finds its Program (the
store, else the mapper's search) and binds it, makes the parameters and
``snapshots`` feature matrices on the device from the seed, and runs each
snapshot once, which captures the CUDA graph.  The window calls
``Program.run`` on one snapshot after another, without synchronising.
The last answer for every snapshot is held against the reference.
"""
from __future__ import annotations

import torch

from graphgen import single_graph

from . import base


class Job(base.Job):
    span = "run"

    def setup(self) -> None:
        from repro_torch.graphs.csr import from_edges

        comp = self.config["compile"]
        self.edges = single_graph(self.config["dataset"])
        n, src, dst = self.edges
        graph = from_edges(n, src, dst)
        cfg = base.gnn_config(self.model, use_pallas=self.traffic["use_pallas"])
        self.prog = base.program_for(self.store, cfg, graph, (n, graph.max_degree),
                                     comp["objective"], self.device).bind(graph)
        self.stats = base.graph_stats(self.prog, graph)
        self.flops = self.ref.flops(self.model, n, src, dst)
        self.outputs: dict[int, torch.Tensor] = {}
        self.draw(self.seed)
        self.start()

    def draw(self, seed: int) -> None:
        """The seed's parameters and feature snapshots."""
        gen = base.generator(seed, self.device)
        self.params = self.ref.init_params(self.model, gen, self.device, self.dtype)
        self.snapshots = torch.randn(
            (self.traffic["snapshots"], self.edges[0], self.model["f_in"]),
            generator=gen, device=self.device, dtype=self.dtype)

    def _run(self, s: int) -> int:
        self.outputs[s] = self.prog.run(self.params, self.snapshots[s])
        return 1

    def start(self) -> None:
        """Every snapshot once, through the timed call, then wait for them."""
        for s in range(len(self.snapshots)):
            self._run(s)
        self.sync()

    def dispatch(self, i: int) -> int:
        return self._run(i % len(self.snapshots))

    # -- what the metrics read ------------------------------------------------
    def end_to_end(self, window) -> dict:
        return {"forward_ms": window.seconds * 1e3 / window.units}

    def model_flops(self, calls: list[int]) -> float:
        return self.flops * len(calls)

    def bound(self, call: int):
        return self.prog, self.stats

    # -- correctness ----------------------------------------------------------
    def release(self) -> None:
        del self.prog
        self.outputs = {s: o.cpu() for s, o in self.outputs.items()}
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, prec: str) -> list[torch.Tensor]:
        graph = self.ref.graph(*self.edges, self.device)
        return [self.ref.forward(self.params, graph, x, prec) for x in self.snapshots]

    def answers(self) -> list[torch.Tensor]:
        return [self.outputs[s] for s in range(len(self.snapshots))]
