"""Synthetic stand-ins for the paper's datasets (Table 4).

The container is offline, so each dataset is generated with a seeded RNG to
match Table 4's published statistics (#graphs, avg nodes, avg edges,
#features) and — more importantly for the dataflow study — the *degree
structure* that drives the paper's observations:

  * Mutag / Proteins (LEF): small sparse molecules, near-uniform low degree
    ("no evil rows", paper Sec. 5.2.1).
  * Imdb-bin / Collab (HE): dense ego-/collaboration networks (high E/V).
  * Reddit-bin / Citeseer / Cora (HF): high-feature graphs with skewed
    (power-law-ish) degree distributions — the source of "evil rows".

Graph-classification sets are batched block-diagonally (64 graphs; 32 for
Reddit-bin) exactly as in the paper's methodology (Sec. 5.1.2).
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass

import numpy as np

from .csr import CSRGraph, block_diagonal, from_edges


@dataclass(frozen=True)
class DatasetSpec:
    name: str
    n_graphs: int  # graphs in one evaluated batch (1 = node classification)
    avg_nodes: float
    avg_edges: float
    n_features: int
    category: str  # HE / HF / LEF (paper Sec 5.1.2)
    kind: str  # "molecule" | "ego" | "collab" | "thread" | "citation"


TABLE4 = {
    "mutag": DatasetSpec("mutag", 64, 17.93, 19.79, 28, "LEF", "molecule"),
    "proteins": DatasetSpec("proteins", 64, 39.06, 72.82, 29, "LEF", "molecule"),
    "imdb-bin": DatasetSpec("imdb-bin", 64, 19.77, 96.53, 136, "HE", "ego"),
    "collab": DatasetSpec("collab", 64, 74.49, 2457.78, 492, "HE", "collab"),
    "reddit-bin": DatasetSpec("reddit-bin", 32, 429.63, 497.75, 3782, "HF", "thread"),
    "citeseer": DatasetSpec("citeseer", 1, 3327, 9464, 3703, "HF", "citation"),
    "cora": DatasetSpec("cora", 1, 2708, 10858, 1433, "HF", "citation"),
}


def _molecule(rng: np.random.Generator, n: int, m: int) -> tuple:
    """Sparse near-chain molecule: ring + random chords, degree ~2-4."""
    n = max(n, 3)
    src = np.arange(n)
    dst = (src + 1) % n
    extra = max(m - n, 0)
    es = rng.integers(0, n, size=extra)
    ed = rng.integers(0, n, size=extra)
    src = np.concatenate([src, es])
    dst = np.concatenate([dst, ed])
    return n, np.concatenate([src, dst]), np.concatenate([dst, src])


def _ego(rng: np.random.Generator, n: int, m: int) -> tuple:
    """IMDB-style ego-net: dense core (actors of one movie form cliques)."""
    n = max(n, 4)
    # partition into 1-3 cliques covering all nodes
    k = int(rng.integers(1, 4))
    cuts = np.sort(rng.choice(np.arange(1, n), size=k - 1, replace=False)) if k > 1 else np.array([], int)
    bounds = np.concatenate([[0], cuts, [n]])
    src, dst = [], []
    for a, b in zip(bounds[:-1], bounds[1:]):
        idx = np.arange(a, b)
        if len(idx) < 2:
            continue
        s, d = np.meshgrid(idx, idx)
        keep = s != d
        src.append(s[keep])
        dst.append(d[keep])
    if not src:
        return _molecule(rng, n, m)
    return n, np.concatenate(src), np.concatenate(dst)


def _collab(rng: np.random.Generator, n: int, m: int) -> tuple:
    """Collaboration net: overlapping dense groups → very high degree."""
    n = max(n, 8)
    target = m
    src, dst = [], []
    total = 0
    while total < target:
        size = int(rng.integers(max(4, n // 8), max(6, n // 2)))
        idx = rng.choice(n, size=min(size, n), replace=False)
        s, d = np.meshgrid(idx, idx)
        keep = s != d
        src.append(s[keep])
        dst.append(d[keep])
        total += keep.sum()
    return n, np.concatenate(src), np.concatenate(dst)


def _thread(rng: np.random.Generator, n: int, m: int) -> tuple:
    """Reddit-thread style: a few huge hubs (evil rows) + shallow replies."""
    n = max(n, 10)
    hubs = max(1, n // 150)
    hub_ids = rng.choice(n, size=hubs, replace=False)
    # most nodes attach to a hub; some chain replies
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


def _citation(rng: np.random.Generator, n: int, m: int) -> tuple:
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


_GENERATORS = {
    "molecule": _molecule,
    "ego": _ego,
    "collab": _collab,
    "thread": _thread,
    "citation": _citation,
}


def make_graph(spec: DatasetSpec, rng: np.random.Generator) -> CSRGraph:
    n = max(3, int(round(rng.normal(spec.avg_nodes, spec.avg_nodes * 0.25))))
    scale = n / spec.avg_nodes
    m = max(2, int(round(spec.avg_edges * scale)))
    n, src, dst = _GENERATORS[spec.kind](rng, n, m)
    return from_edges(n, src, dst)


def load_dataset(name: str, seed: int = 0) -> tuple[CSRGraph, DatasetSpec]:
    """One evaluation batch per paper Sec. 5.1.2 (block-diagonal for
    graph-classification datasets, the full graph for node classification)."""
    spec = TABLE4[name]
    # zlib.crc32 (not hash()) keeps graphs stable across processes —
    # str hashing is PYTHONHASHSEED-salted, which made the committed
    # benchmark evidence irreproducible run to run.
    rng = np.random.default_rng(seed + zlib.crc32(name.encode()) % (2**31))
    if spec.n_graphs == 1:
        n, src, dst = _GENERATORS[spec.kind](rng, int(spec.avg_nodes), int(spec.avg_edges))
        return from_edges(n, src, dst), spec
    graphs = [make_graph(spec, rng) for _ in range(spec.n_graphs)]
    return block_diagonal(graphs), spec


def all_datasets(seed: int = 0):
    for name in TABLE4:
        yield name, *load_dataset(name, seed)
