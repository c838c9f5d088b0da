"""Seeded stand-ins for the paper's Table-4 datasets, frozen here.

A copy of the port's generators (``repro_torch.graphs.datasets``: the
``thread`` and ``citation`` kinds, ``make_graph``'s size draw, and the
``TABLE4`` rows of reddit-bin and cora), kept inside the benchmark so that
a change to the program cannot change what the benchmark feeds it.  They
return raw edge lists, directed both ways, without self-loops and before
any normalisation: the program builds its CSR from them and the reference
works out its own normalised adjacency from the same lists.
"""
from __future__ import annotations

import numpy as np

#: Table 4 of the paper (#graphs in one evaluated batch, avg nodes, avg
#: edges, #features, category), the rows the benchmark's configurations use.
TABLE4 = {
    "reddit-bin": {"n_graphs": 32, "avg_nodes": 429.63, "avg_edges": 497.75,
                   "n_features": 3782, "category": "HF", "kind": "thread"},
    "cora": {"n_graphs": 1, "avg_nodes": 2708, "avg_edges": 10858,
             "n_features": 1433, "category": "HF", "kind": "citation"},
}


def _thread(rng: np.random.Generator, n: int, m: int):
    """Reddit-thread style: a few huge hubs (evil rows) + shallow replies."""
    n = max(n, 10)
    hubs = max(1, n // 150)
    hub_ids = rng.choice(n, size=hubs, replace=False)
    others = np.setdiff1d(np.arange(n), hub_ids)
    parent_hub = rng.choice(hub_ids, size=len(others))
    src = [others, parent_hub]
    dst = [parent_hub, others]
    extra = max(m - len(others), 0)
    es = rng.integers(0, n, size=extra)
    ed = np.maximum(es - rng.integers(1, 5, size=extra), 0)
    src.append(es)
    dst.append(ed)
    src.append(ed)
    dst.append(es)
    return n, np.concatenate(src), np.concatenate(dst)


def _citation(rng: np.random.Generator, n: int, m: int):
    """Preferential attachment: power-law in-degree (citation hubs)."""
    deg_m = max(1, int(round(m / n / 2)))
    src_l, dst_l = [], []
    deg = np.ones(n, dtype=np.float64)
    seed = deg_m + 1
    order = rng.permutation(n)
    for i in range(seed, n):
        p = deg[order[:i]] / deg[order[:i]].sum()
        targets = rng.choice(order[:i], size=min(deg_m, i), replace=False, p=p)
        for t in targets:
            src_l.append(order[i])
            dst_l.append(t)
            deg[t] += 1
            deg[order[i]] += 1
    src = np.array(src_l)
    dst = np.array(dst_l)
    return n, np.concatenate([src, dst]), np.concatenate([dst, src])


GENERATORS = {"thread": _thread, "citation": _citation}


def graph_library(dataset: dict) -> list[tuple[int, np.ndarray, np.ndarray]]:
    """``dataset["n_graphs"]`` graphs drawn as ``make_graph`` draws them
    (node count normal around the average with a 25% spread, edges scaled
    with it), from one generator seeded with ``dataset["library_seed"]``:
    a list of ``(n_nodes, src, dst)``."""
    rng = np.random.default_rng(dataset["library_seed"])
    gen = GENERATORS[dataset["generator"]]
    avg_n, avg_e = dataset["avg_nodes"], dataset["avg_edges"]
    out = []
    for _ in range(dataset["n_graphs"]):
        n = max(3, int(round(rng.normal(avg_n, avg_n * 0.25))))
        m = max(2, int(round(avg_e * n / avg_n)))
        out.append(gen(rng, n, m))
    return out


def single_graph(dataset: dict) -> tuple[int, np.ndarray, np.ndarray]:
    """The one graph of a node-classification dataset, as ``load_dataset``
    draws it: the published node and edge counts, seeded with
    ``dataset["library_seed"]``."""
    rng = np.random.default_rng(dataset["library_seed"])
    gen = GENERATORS[dataset["generator"]]
    return gen(rng, int(dataset["avg_nodes"]), int(dataset["avg_edges"]))

