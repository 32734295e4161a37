"""Double-sweep diameter bounds, phase 1 of KADABRA
(``repro.core.diameter``).

BFS from K seeds gives their eccentricities and farthest vertices; BFS
from those gives realized distances.  Upper bound 2 * min(ecc) (the
graph is undirected); the vertex diameter bound is upper + 1.  Each
sweep is one batched BFS over all K chains.  Seeds are uniform vertices,
as in the JAX package.

Departure from the JAX package: 2 * ecc(seed) bounds only the diameter
of the seed's connected component, and on R-MAT a uniform seed is often
an isolated vertex (eccentricity 0, vertex diameter 1), so the
reference's bound can be none.  The port labels the components and
bounds the graph's diameter by the max over components: a component
holding a chain takes its chains' least bound, one holding none takes
its size - 1.  While some chainless component's size - 1 exceeds the
bound so far, further double sweeps start from those components'
lowest vertices, largest component first.  On a connected graph this is
the reference's bound, bit for bit.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .bfs import bfs_sssp_batched
from .graph import Graph

__all__ = ["DiameterEstimate", "connected_components", "estimate_diameter"]

# chains added per round while chainless components can exceed the bound
_EXTRA_CHAINS = 64


class DiameterEstimate(NamedTuple):
    lower: int             # best shortest-path length found
    upper: int             # valid upper bound on the diameter
    vertex_diameter: int   # upper bound on VD = upper + 1
    n_levels: int          # BFS levels the sweeps expanded


def connected_components(graph: Graph) -> torch.Tensor:
    """(V,) int64: the lowest vertex id of each vertex's component.

    Min-label propagation over the edges with pointer jumping, one host
    sync per round; labels only fall, and a round that changes nothing
    leaves every edge's two ends with one label.
    """
    label = torch.arange(graph.n_nodes, device=graph.device)
    src = graph.src[: graph.n_edges].long()
    dst = graph.dst[: graph.n_edges].long()
    while True:
        new = label.scatter_reduce(0, dst, label[src], reduce="amin")
        new = new[new]
        if torch.equal(new, label):
            return label
        label = new


def _sweep_batched(graph: Graph, seeds):
    """One batched sweep: K seeds -> (ecc (K,), farthest vertex (K,),
    levels expanded).  The farthest reached vertex breaks ties towards
    the lowest id, as ``jnp.argmax`` does."""
    res = bfs_sssp_batched(graph, seeds)
    d = torch.where(res.dist >= 0, res.dist, -1)[: graph.n_nodes]
    ids = torch.arange(graph.n_nodes, device=d.device)[:, None]
    far = torch.where(d == d.amax(dim=0, keepdim=True), ids,
                      graph.n_nodes).amin(dim=0)
    return res.levels, far.to(torch.int32), res.n_iters


def estimate_diameter(graph: Graph, gen: torch.Generator | None = None,
                      n_sweeps: int = 2, *, seeds=None) -> DiameterEstimate:
    """Double-sweep bounds with ``max(1, n_sweeps - 1)`` chains, plus a
    chain in each component that could otherwise exceed the bound (see
    the module docstring).

    The chains' seeds are uniform vertices drawn from ``gen`` unless
    ``seeds`` gives them explicitly, so that two implementations can be
    handed the same seeds.
    """
    if seeds is None:
        if gen is None:
            raise ValueError("estimate_diameter needs gen= or seeds=")
        seeds = torch.randint(0, graph.n_nodes, (max(1, n_sweeps - 1),),
                              generator=gen, device=gen.device)
    seeds = torch.as_tensor(seeds, dtype=torch.int64, device=graph.device)
    comp = connected_components(graph)
    size = torch.bincount(comp, minlength=graph.n_nodes)  # > 0 at roots
    # per component root: its chains' least bound (graph.n_nodes: none)
    comp_upper = torch.full_like(size, graph.n_nodes)
    chained = torch.zeros_like(size, dtype=torch.bool)
    lower, n_levels = 0, 0
    while True:
        ecc0, far0, n0 = _sweep_batched(graph, seeds)
        ecc1, _far1, n1 = _sweep_batched(graph, far0)
        n_levels += n0 + n1
        uppers = torch.maximum(2 * torch.minimum(ecc0, ecc1), ecc1)
        roots = comp[seeds]
        comp_upper.scatter_reduce_(0, roots, uppers.long(), reduce="amin")
        chained[roots] = True
        lower = max(lower, int(ecc1.max()))
        upper = max(int(comp_upper[chained].max()), lower)
        open_roots = torch.nonzero((size > upper + 1) & ~chained)[:, 0]
        if open_roots.numel() == 0:
            return DiameterEstimate(lower, upper, upper + 1, n_levels)
        order = torch.argsort(size[open_roots], descending=True, stable=True)
        seeds = open_roots[order[:_EXTRA_CHAINS]]
