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

:func:`estimate_diameter_sharded` runs the same chains through the
sharded BFS on a :class:`PartitionedGraph` over either shard mesh (the
components from its replicated CSR), with the same departure; it gives
the bits of :func:`estimate_diameter` on the graph the partition was
built from, on every process of a ``GroupShardMesh``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .bfs import bfs_sssp_batched, bfs_sssp_batched_sharded
from .graph import Graph

__all__ = ["DiameterEstimate", "connected_components", "estimate_diameter",
           "estimate_diameter_sharded"]

# chains added per round while chainless components can exceed the bound
_EXTRA_CHAINS = 64


class DiameterEstimate(NamedTuple):
    lower: int             # best shortest-path length found
    upper: int             # valid upper bound on the diameter
    vertex_diameter: int   # upper bound on VD = upper + 1
    n_levels: int          # BFS levels the sweeps expanded


def connected_components(graph) -> torch.Tensor:
    """(V,) int64: the lowest vertex id of each vertex's component.

    Min-label propagation over the CSR edges (a ``Graph`` or a
    ``PartitionedGraph``) with pointer jumping, one host sync per round;
    labels only fall, and a round that changes nothing leaves every
    edge's two ends with one label.
    """
    dev = graph.indptr.device
    label = torch.arange(graph.n_nodes, device=dev)
    src = torch.repeat_interleave(label, graph.degree.long())
    dst = graph.indices[: graph.n_edges].long()
    while True:
        new = label.scatter_reduce(0, dst, label[src], reduce="amin")
        new = new[new]
        if torch.equal(new, label):
            return label
        label = new


def _sweep_batched(graph: Graph, seeds):
    """One batched sweep: K seeds -> (ecc (K,), farthest vertex (K,),
    levels expanded, dist).  The farthest reached vertex breaks ties
    towards the lowest id, as ``jnp.argmax`` does."""
    res = bfs_sssp_batched(graph, seeds)
    d = torch.where(res.dist >= 0, res.dist, -1)[: graph.n_nodes]
    ids = torch.arange(graph.n_nodes, device=d.device)[:, None]
    far = torch.where(d == d.amax(dim=0, keepdim=True), ids,
                      graph.n_nodes).amin(dim=0)
    return res.levels, far.to(torch.int32), res.n_iters, res.dist


def _sweep_batched_sharded(pg, mesh, seeds):
    """A sweep on the sharded BFS: the farthest vertex is the two-level
    argmax (each shard's lowest farthest row, then the lowest global id
    among the shards holding the farthest distance: one pmax, one pmin),
    so ties break towards the lowest global id as in
    :func:`_sweep_batched`.  The dist returned is the gathered (v_pad,
    K) one."""
    res = bfs_sssp_batched_sharded(pg, seeds, mesh=mesh)
    masked = torch.where(res.dist >= 0, res.dist, -1)          # (S, R, K)
    loc_val = masked.amax(dim=1)                               # (S, K)
    rows = torch.arange(pg.shard_rows, device=mesh.device)[None, :, None]
    loc_far = torch.where(masked == loc_val[:, None, :], rows,
                          pg.shard_rows).amin(dim=1)           # (S, K)
    gid = mesh.axis_index()[:, None] * pg.shard_rows + loc_far
    far = mesh.pmin(torch.where(loc_val == mesh.pmax(loc_val), gid,
                                pg.v_pad))                     # (K,)
    return res.levels, far.to(torch.int32), res.n_iters, \
        mesh.all_gather(res.dist, what="state")


def _seeds(n_nodes: int, gen, n_sweeps: int, seeds, device):
    if seeds is None:
        if gen is None:
            raise ValueError("estimate_diameter needs gen= or seeds=")
        seeds = torch.randint(0, n_nodes, (max(1, n_sweeps - 1),),
                              generator=gen, device=gen.device)
    return torch.as_tensor(seeds, dtype=torch.int64, device=device)


def estimate_diameter(graph: Graph, gen: torch.Generator | None = None,
                      n_sweeps: int = 2, *, seeds=None) -> DiameterEstimate:
    """Double-sweep bounds with ``max(1, n_sweeps - 1)`` chains, plus a
    chain in each component that could otherwise exceed the bound (see
    the module docstring).

    The chains' seeds are uniform vertices drawn from ``gen`` unless
    ``seeds`` gives them explicitly, so that two implementations can be
    handed the same seeds.
    """
    seeds = _seeds(graph.n_nodes, gen, n_sweeps, seeds, graph.device)
    return _double_sweeps(graph, seeds,
                          lambda k: _sweep_batched(graph, k))[0]


def estimate_diameter_sharded(pg, mesh, gen: torch.Generator | None = None,
                              n_sweeps: int = 2, *, seeds=None,
                              return_dist: bool = False):
    """:func:`estimate_diameter` on a :class:`PartitionedGraph` over a
    shard mesh, every sweep through the sharded BFS; the same seed draw
    and the same bounds.

    ``return_dist=True`` also returns the first chains' second sweep's
    gathered dist, (v_pad, K) int32 with -1 on unreached and padding
    rows: the long traces the ``"auto"`` exchange budget samples its
    chunk occupancy from.
    """
    seeds = _seeds(pg.n_nodes, gen, n_sweeps, seeds, mesh.device)
    est, dist = _double_sweeps(
        pg, seeds, lambda k: _sweep_batched_sharded(pg, mesh, k))
    if return_dist:
        return est, torch.where(dist >= 0, dist, -1)
    return est


def _double_sweeps(graph, seeds, sweep):
    """The chains of :func:`estimate_diameter` with ``sweep(seeds) ->
    (ecc, far, levels expanded, dist)``; returns the estimate and the
    first round's second-sweep dist."""
    comp = connected_components(graph)
    size = torch.bincount(comp, minlength=graph.n_nodes)  # > 0 at roots
    # per component root: its chains' least bound (graph.n_nodes: none)
    comp_upper = torch.full_like(size, graph.n_nodes)
    chained = torch.zeros_like(size, dtype=torch.bool)
    lower, n_levels = 0, 0
    first_dist = None
    while True:
        ecc0, far0, n0, _ = sweep(seeds)
        ecc1, _far1, n1, dist1 = sweep(far0)
        if first_dist is None:
            first_dist = dist1
        n_levels += n0 + n1
        uppers = torch.maximum(2 * torch.minimum(ecc0, ecc1), ecc1)
        roots = comp[seeds]
        comp_upper.scatter_reduce_(0, roots, uppers.long(), reduce="amin")
        chained[roots] = True
        lower = max(lower, int(ecc1.max()))
        upper = max(int(comp_upper[chained].max()), lower)
        open_roots = torch.nonzero((size > upper + 1) & ~chained)[:, 0]
        if open_roots.numel() == 0:
            return (DiameterEstimate(lower, upper, upper + 1, n_levels),
                    first_dist)
        order = torch.argsort(size[open_roots], descending=True, stable=True)
        seeds = open_roots[order[:_EXTRA_CHAINS]]
