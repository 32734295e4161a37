"""Exact betweenness (Brandes 2001), the correctness oracle
(``repro.core.brandes.brandes_numpy``).

Host numpy, float64, one level-synchronous forward and backward pass per
source, vectorized over each level's edges.  Normalized as in the paper:
b(x) = 1/(n(n-1)) * sum_{s != t} sigma_st(x) / sigma_st.
"""
from __future__ import annotations

import numpy as np

from .graph import Graph

__all__ = ["brandes_numpy"]


def _edges_of(frontier, indptr, indices):
    """(u, v) for every edge out of the vertices in ``frontier``."""
    starts = indptr[frontier]
    degs = indptr[frontier + 1] - starts
    total = int(degs.sum())
    first = np.repeat(np.cumsum(degs) - degs, degs)
    pos = np.repeat(starts, degs) + np.arange(total) - first
    return np.repeat(frontier, degs), indices[pos]


def brandes_numpy(graph: Graph) -> np.ndarray:
    """Exact normalized betweenness (V,) on the host."""
    n = graph.n_nodes
    indptr = graph.indptr.cpu().numpy().astype(np.int64)
    indices = graph.indices[: graph.n_edges].cpu().numpy().astype(np.int64)
    bc = np.zeros(n, dtype=np.float64)
    for s in range(n):
        dist = np.full(n, -1, np.int64)
        sigma = np.zeros(n, np.float64)
        dist[s], sigma[s] = 0, 1.0
        levels = [np.array([s])]
        while True:
            u, v = _edges_of(levels[-1], indptr, indices)
            fresh = np.unique(v[dist[v] == -1])
            if fresh.size == 0:
                break
            dist[fresh] = len(levels)
            down = dist[v] == len(levels)
            np.add.at(sigma, v[down], sigma[u[down]])
            levels.append(fresh)
        delta = np.zeros(n, np.float64)
        for lvl in range(len(levels) - 1, 0, -1):
            w, u = _edges_of(levels[lvl], indptr, indices)
            up = dist[u] == lvl - 1
            w, u = w[up], u[up]
            np.add.at(delta, u, sigma[u] / sigma[w] * (1.0 + delta[w]))
        delta[s] = 0.0
        bc += delta
    return bc / (n * (n - 1))
