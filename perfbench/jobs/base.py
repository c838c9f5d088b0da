"""What every job of the benchmark shares: the configuration's plain
reference and type, its inputs made from the seed, the programs compiled
through the port's ``ProgramStore``, and the comparison of a set of answers
against the reference's."""
from __future__ import annotations

import importlib.util
from dataclasses import replace
from pathlib import Path

import numpy as np
import torch

from harness import Refused
from references import common
from yardstick import GraphStats, layer_work

BENCH = Path(__file__).resolve().parents[1]
#: the types the port's GNN programs run in (``GNNConfig`` states none:
#: its kernels and its eager tier compute in float32)
PROGRAM_DTYPES = ("float32",)


def generator(seed: int, device: torch.device) -> torch.Generator:
    """A generator on ``device`` seeded with ``seed`` (any whole number)."""
    return torch.Generator(device=device).manual_seed(seed % 2**63)


def reference(path: str):
    """The plain reference module at ``path``, as a configuration's
    ``reference`` names it (relative to ``perfbench/``, or absolute)."""
    spec = importlib.util.spec_from_file_location(
        "perfbench_reference_" + Path(path).stem.replace("-", "_"), BENCH / path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def gnn_config(model: dict, use_pallas: bool):
    """The port's ``GNNConfig`` of the configuration's model: its kind,
    widths and depth, as the configuration states them."""
    from repro_torch.gnn import GNNConfig

    return GNNConfig(kind=model["kind"], f_in=model["f_in"], hidden=model["hidden"],
                     n_classes=model["n_classes"], n_layers=model["n_layers"],
                     use_pallas=use_pallas)


def program_for(store, cfg, graph, bucket, objective: str, device):
    """The compiled Program for ``graph``'s shape: from ``store`` when a
    run before this one searched it, else searched by ``repro_torch.compile``
    on ``graph`` and put in the store.  Returns it unbound."""
    import repro_torch
    from repro_torch.core.hw import DEFAULT_ACCEL
    from repro_torch.runtime.store import store_key

    key = store_key(cfg.dims, bucket, graph.n_nodes, kind=cfg.kind, objective=objective,
                    use_pallas=cfg.use_pallas, searched=True, hw=DEFAULT_ACCEL)
    prog = store.get(key)
    if prog is None:
        prog = repro_torch.compile(cfg, graph=graph, objective=objective, device=device)
        store.put(key, prog)
    return replace(prog, device=device)


def graph_stats(prog, graph) -> GraphStats:
    """What the yardstick counts a kernel's work from, for ``prog`` bound
    to the CSR ``graph``."""
    return GraphStats.of(graph.row_ptr, graph.col_idx, graph.values,
                         prog.adj.indices.shape[0])


def relative_errors(got: list[torch.Tensor], want: list[torch.Tensor]) -> np.ndarray:
    """Each answer's largest absolute gap to the reference's, over the
    largest magnitude among all the reference's answers (one scale for the
    whole set, so that an answer near zero is not judged on its own); an
    answer that is not finite reads infinity."""
    w = torch.stack(want).cpu().double()
    g = torch.stack([t.to(want[0].device) for t in got]).cpu().double()
    scale = float(w.abs().max()) or 1.0
    gap = (g - w).abs().flatten(1).amax(dim=1) / scale
    finite = torch.isfinite(g).flatten(1).all(dim=1)
    return torch.where(finite, gap, torch.inf).numpy()


class Job:
    """One cell's work.  ``setup`` builds everything the window needs,
    ``draw``s the seed's inputs and ``start``s (warms every shape the
    window uses); ``dispatch(i)`` queues the window's call ``i`` and
    returns the units of work it completes; ``finish`` ends the window;
    ``release`` frees the program's state; ``check`` compares the timed
    path's answers with the reference's.

    The model is the configuration's: its kind and widths go to the
    program, its ``reference`` module makes the parameters (in the
    program's layout), computes the reference's answers and counts the
    model's FLOPs, and its ``dtype`` is what both compute in."""

    span = "call"
    #: what ``readings`` can put in the program's place: the program itself
    #: and the control, the reference one precision below the stated type
    sources = ("program", "control")

    def __init__(self, config: dict, traffic: dict, seed: int, device, store):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device, self.store = torch.device(device), store
        self.model = config["model"]
        self.dtype_name = self.model["dtype"]
        if self.dtype_name not in PROGRAM_DTYPES:
            raise Refused(f"the port's GNN programs run {', '.join(PROGRAM_DTYPES)}; "
                          f"the configuration states {self.dtype_name!r}")
        self.dtype = common.DTYPES[self.dtype_name]
        self.ref = reference(config["reference"])

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def reseed(self, seed: int) -> None:
        """Another seed's inputs through the same programs and graphs."""
        self.draw(seed)
        self.start()

    def finish(self) -> None:
        pass

    # -- what the metrics read ------------------------------------------------
    def bound(self, call: int):
        """The bound program that the window's call ``call`` ran, and the
        stats of its graph."""
        raise NotImplementedError

    def kernel_work(self, work, calls: list[int]) -> list[tuple[float, float]]:
        """``work``'s count (see ``yardstick.layer_work``) of every launch
        the ``calls`` made, in order."""
        out = []
        for i in calls:
            prog, stats = self.bound(i)
            out += layer_work(work, prog.specs, prog.dims, stats)
        return out

    # -- correctness of a forward job: its answers against the reference --
    def readings(self, source: str = "program") -> dict:
        """``max_rel_err`` of the program's answers (``source="control"``:
        of the reference one precision below, in their place) against the
        reference in the stated type, and each answer's error."""
        if source not in self.sources:
            raise ValueError(f"unknown source {source!r}")
        want = self.reference(self.dtype_name)
        got = (self.reference(common.CONTROL[self.dtype_name]) if source == "control"
               else self.answers())
        errs = relative_errors(got, want)
        return {"max_rel_err": float(errs.max()), "errors": errs}

    def check(self, limits: dict) -> tuple[dict, int]:
        """The numbers compared and how many answers fail their limit."""
        r = self.readings()
        return {"max_rel_err": r["max_rel_err"]}, int((r["errors"] > limits["max_rel_err"]).sum())
