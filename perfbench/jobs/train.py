"""Full-batch node-classification training through the port's SGD step
(``Program.train_step``), on the GCN paper's full-batch setting (Kipf &
Welling, ICLR 2017) but not its recipe: no Adam, dropout or weight decay,
which the port's GNN step does not have.

Set-up generates the configuration's one graph, finds its Program (the
store, else the mapper's search) and binds it, makes the parameters, the
features, the labels and the labelled split (``labelled_per_class`` nodes
of each class) on the device from the seed, then drives the Program's
first ``checked_steps`` SGD steps through ``Program.train_step``, the
window's own call on the window's own feed (the first captures the CUDA
graph), and keeps the state after each.  The window carries on from that
state, step after step, without synchronising, and reads the loss at the
end.  The check holds those first steps against the reference's.
"""
from __future__ import annotations

import numpy as np
import torch

from graphgen import single_graph
from references import common

from . import base

#: a leaf whose reference gradient is under this share of the median
#: leaf's moves by round-off alone, and is not compared
NOUGHT_GRADIENT = 1e-3


def _norms(tree) -> list[float]:
    return [float(v.detach().double().norm()) for layer in tree for _, v in sorted(layer.items())]


def _diff(a, b) -> list[dict]:
    return [{k: la[k].detach().double().cpu() - lb[k].detach().double().cpu() for k in la}
            for la, lb in zip(a, b)]


def worst_leaf_gap(got: list[float], want: list[float], keep: list[bool]) -> float:
    """The largest gap between a leaf's norm and the reference's, over the
    reference's norm of that leaf or of the median kept leaf, whichever is
    larger."""
    kept = [w for w, k in zip(want, keep) if k]
    median = float(np.median(kept))
    return max(abs(g - w) / max(w, median) for g, w, k in zip(got, want, keep) if k)


class Job(base.Job):
    span = "train_step"
    sources = ("program", "control", "half_batch")

    def setup(self) -> None:
        from repro_torch.graphs.csr import from_edges

        comp = self.config["compile"]
        self.lr = float(self.traffic["lr"])
        self.edges = single_graph(self.config["dataset"])
        n, src, dst = self.edges
        graph = from_edges(n, src, dst)
        cfg = base.gnn_config(self.model, use_pallas=self.traffic["use_pallas"])
        self.prog = base.program_for(self.store, cfg, graph, (n, graph.max_degree),
                                     comp["objective"], self.device).bind(graph)
        self.stats = base.graph_stats(self.prog, graph)
        self.flops = 3 * self.ref.flops(self.model, n, src, dst)
        self.draw(self.seed)
        self.start()

    def draw(self, seed: int) -> None:
        """The seed's parameters, features, labels and labelled split."""
        n, classes = self.edges[0], self.model["n_classes"]
        gen = base.generator(seed, self.device)
        self.params0 = self.ref.init_params(self.model, gen, self.device, self.dtype)
        self.x = torch.randn((n, self.model["f_in"]), generator=gen, device=self.device,
                             dtype=self.dtype)
        self.labels = torch.randint(0, classes, (n,), generator=gen, device=self.device,
                                    dtype=torch.int32)
        # each class's first nodes in an order drawn from the seed
        order = torch.randperm(n, generator=gen, device=self.device).cpu().numpy()
        labels = self.labels.cpu().numpy()[order]
        mask = np.zeros(n, dtype=np.float32)
        for c in range(classes):
            mask[order[labels == c][: self.traffic["labelled_per_class"]]] = 1.0
        self.mask = torch.as_tensor(mask, device=self.device)

    def step(self, params):
        return self.prog.train_step(params, self.x, self.labels, self.mask, lr=self.lr)

    def start(self) -> None:
        """The first steps through the window's call; their losses and the
        state after each are kept for the check."""
        self.losses, self.states, p = [], [], self.params0
        for _ in range(self.traffic["checked_steps"]):
            loss, p = self.step(p)
            self.losses.append(loss)
            self.states.append(p)
        self.params = p
        self.sync()

    def dispatch(self, i: int) -> int:
        self.loss, self.params = self.step(self.params)
        return 1

    def finish(self) -> None:
        self.final_loss = float(self.loss)

    # -- what the metrics read ------------------------------------------------
    def end_to_end(self, window) -> dict:
        return {"train_step_ms": window.seconds * 1e3 / window.units}

    def model_flops(self, calls: list[int]) -> float:
        return self.flops * len(calls)

    def bound(self, call: int):
        return self.prog, self.stats

    # -- correctness ----------------------------------------------------------
    def release(self) -> None:
        del self.prog
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _run_reference(self, prec: str, mask=None):
        graph = self.ref.graph(*self.edges, self.device)
        return common.sgd(self.ref, self.params0, graph, self.x, self.labels,
                          self.mask if mask is None else mask, self.lr,
                          self.traffic["checked_steps"], prec)

    def half_mask(self) -> torch.Tensor:
        """The labelled split with every other labelled node left out."""
        idx = torch.nonzero(self.mask).flatten()
        mask = self.mask.clone()
        mask[idx[1::2]] = 0
        return mask

    def readings(self, source: str = "program") -> dict:
        """The compared numbers of ``source`` against the reference in the
        stated type: the program's first steps, or in their place the
        reference one precision below (``"control"``) or with half of the
        labelled nodes left out (``"half_batch"``).  ``loss_gap``: the worst step's loss
        gap over the reference's loss; ``grad_gap``: the first gradient,
        worked out from the state after one step; ``change_gap``: the
        parameters' change over the steps; both by the worst leaf."""
        ref_losses, ref_grad, ref_states = self._run_reference(self.dtype_name)
        if source == "program":
            losses = [float(v) for v in self.losses]
            states = self.states
        elif source == "control":
            losses, _, states = self._run_reference(common.CONTROL[self.dtype_name])
        elif source == "half_batch":
            losses, _, states = self._run_reference(self.dtype_name, self.half_mask())
        else:
            raise ValueError(f"unknown source {source!r}")
        grad = [{k: v / self.lr for k, v in layer.items()}
                for layer in _diff(self.params0, states[0])]
        want_grad = _norms(ref_grad)
        keep = [g >= NOUGHT_GRADIENT * float(np.median(want_grad)) for g in want_grad]
        return {
            "loss_gap": max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)),
            "grad_gap": worst_leaf_gap(_norms(grad), want_grad, keep),
            "change_gap": worst_leaf_gap(_norms(_diff(states[-1], self.params0)),
                                         _norms(_diff(ref_states[-1], self.params0)), keep),
            "losses": losses, "reference_losses": ref_losses,
        }

    def check(self, limits: dict) -> tuple[dict, int]:
        r = self.readings()
        numbers = {k: r[k] for k in ("loss_gap", "grad_gap", "change_gap")}
        return numbers, sum(1 for k, v in numbers.items() if not v <= limits[k])
