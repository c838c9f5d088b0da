"""CSR / padded-ELL graph structures.

The paper assumes CSR adjacency (Sec. 2.1, Fig. 3b).  On TPU, truly random
CSR walks do not vectorize, so the JAX execution path uses a padded
row-block layout (ELL): rows grouped into blocks, neighbor lists padded to
the block's max degree.  The padding waste *is* the paper's lockstep /
evil-row cost, so the same structure feeds both the simulator (exact nnz
array) and the JAX/Pallas kernels (padded indices + mask).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class CSRGraph:
    """Adjacency in CSR with self-loops; values are normalized (GCN Ã)."""

    row_ptr: np.ndarray  # (V+1,) int32
    col_idx: np.ndarray  # (E,) int32
    values: np.ndarray  # (E,) float32 — Ã = D^-1/2 (A+I) D^-1/2 weights
    n_nodes: int

    @property
    def n_edges(self) -> int:
        return int(len(self.col_idx))

    @property
    def nnz(self) -> np.ndarray:
        return np.diff(self.row_ptr).astype(np.int64)

    @property
    def avg_degree(self) -> float:
        return self.n_edges / max(self.n_nodes, 1)

    @property
    def max_degree(self) -> int:
        return int(self.nnz.max()) if self.n_nodes else 0

    def validate(self) -> None:
        assert self.row_ptr[0] == 0 and self.row_ptr[-1] == self.n_edges
        assert (np.diff(self.row_ptr) >= 0).all()
        assert (self.col_idx >= 0).all() and (self.col_idx < self.n_nodes).all()

    # -- conversions ---------------------------------------------------------
    def to_dense(self) -> np.ndarray:
        a = np.zeros((self.n_nodes, self.n_nodes), dtype=np.float32)
        for v in range(self.n_nodes):
            s, e = self.row_ptr[v], self.row_ptr[v + 1]
            a[v, self.col_idx[s:e]] = self.values[s:e]
        return a

    def to_ell(self, block_rows: int = 1, pad_to: int | None = None):
        """Padded neighbor lists: returns (indices, weights, mask) of shape
        (V_pad, D) where D = max degree over each `block_rows` row block,
        rounded up to the global max (single buffer).  Padded slots point at
        row 0 with weight 0, so gather+weighted-sum stays correct."""
        v = self.n_nodes
        d = pad_to or max(self.max_degree, 1)
        v_pad = -(-v // block_rows) * block_rows
        idx = np.zeros((v_pad, d), dtype=np.int32)
        wts = np.zeros((v_pad, d), dtype=np.float32)
        msk = np.zeros((v_pad, d), dtype=bool)
        for r in range(v):
            s, e = self.row_ptr[r], self.row_ptr[r + 1]
            k = min(e - s, d)
            idx[r, :k] = self.col_idx[s : s + k]
            wts[r, :k] = self.values[s : s + k]
            msk[r, :k] = True
        return idx, wts, msk


def from_edges(
    n_nodes: int,
    src: np.ndarray,
    dst: np.ndarray,
    add_self_loops: bool = True,
    normalize: bool = True,
) -> CSRGraph:
    """Build a CSR graph (GCN-normalized) from an edge list."""
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    if add_self_loops:
        loops = np.arange(n_nodes, dtype=np.int64)
        src = np.concatenate([src, loops])
        dst = np.concatenate([dst, loops])
    # dedupe
    keys = src * n_nodes + dst
    keys = np.unique(keys)
    src, dst = keys // n_nodes, keys % n_nodes

    order = np.lexsort((dst, src))
    src, dst = src[order], dst[order]
    counts = np.bincount(src, minlength=n_nodes)
    row_ptr = np.zeros(n_nodes + 1, dtype=np.int32)
    np.cumsum(counts, out=row_ptr[1:])
    if normalize:
        deg = np.maximum(counts, 1).astype(np.float32)
        dinv = 1.0 / np.sqrt(deg)
        values = dinv[src] * dinv[dst]
    else:
        values = np.ones(len(src), dtype=np.float32)
    return CSRGraph(row_ptr, dst.astype(np.int32), values.astype(np.float32), n_nodes)


def block_diagonal(graphs: list[CSRGraph]) -> CSRGraph:
    """Batch graphs into one block-diagonal CSR (paper batches 64/32 graphs)."""
    offs = 0
    ptrs = [np.zeros(1, dtype=np.int64)]
    cols, vals = [], []
    for g in graphs:
        ptrs.append(g.row_ptr[1:].astype(np.int64) + ptrs[-1][-1])
        cols.append(g.col_idx.astype(np.int64) + offs)
        vals.append(g.values)
        offs += g.n_nodes
    return CSRGraph(
        np.concatenate(ptrs).astype(np.int64),
        np.concatenate(cols).astype(np.int32),
        np.concatenate(vals).astype(np.float32),
        offs,
    )
