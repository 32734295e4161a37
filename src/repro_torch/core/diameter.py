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

:func:`estimate_diameter_weighted` (and its sharded twin) is the weighted
lane's phase 1: the same chains and seed draw, each sweep a batched
delta-stepping SSSP, giving float32 bounds on the weighted diameter
(``upper`` is the weighted stream's distance cap) and a vertex-diameter
bound from the sweeps' DAG hop depths.  The same component handling
applies: a chainless component is bounded by its size (vertices on a
path) and by size - 1 times the largest weight (distance), and chains
start in the components that could exceed either bound.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .bfs import (bfs_sssp_batched, bfs_sssp_batched_sharded,
                  delta_sssp_batched, delta_sssp_batched_sharded)
from .graph import Graph

__all__ = ["DiameterEstimate", "WeightedDiameterEstimate",
           "connected_components", "estimate_diameter",
           "estimate_diameter_sharded", "estimate_diameter_weighted",
           "estimate_diameter_weighted_sharded"]

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


# ---------------------------------------------------------------------------
# The weighted lane
# ---------------------------------------------------------------------------

class WeightedDiameterEstimate(NamedTuple):
    """Double-sweep bounds on the weighted diameter (float32 values) and
    a hop bound on the vertices of a weighted shortest path (omega's),
    from the sweeps' DAG hop depths by the unweighted bound's arithmetic:
    an estimate, as the reference's (two shortest paths end to end need
    not be shortest)."""
    lower: float           # a realized weighted distance
    upper: float           # weighted-diameter bound: the distance cap
    vertex_diameter: int   # hop bound + 1
    n_levels: int          # relaxation rounds the sweeps ran
    n_dag_rounds: int      # DAG rounds the sweeps ran


def _sweep_weighted(graph: Graph, seeds, delta):
    """One weighted sweep: K seeds -> (weighted ecc (K,) float32, DAG hop
    depth (K,), farthest vertex (K,), rounds, DAG rounds, dist).  The
    farthest reached vertex breaks ties towards the lowest id."""
    res = delta_sssp_batched(graph, seeds, delta=delta)
    d = torch.where(res.dist >= 0, res.dist, -1.0)[: graph.n_nodes]
    wecc = d.clamp(min=0.0).amax(dim=0)
    ids = torch.arange(graph.n_nodes, device=d.device)[:, None]
    far = torch.where(d == d.amax(dim=0, keepdim=True), ids,
                      graph.n_nodes).amin(dim=0)
    return (wecc, res.levels, far.to(torch.int32), res.n_iters,
            res.n_dag_rounds, res.dist)


def _sweep_weighted_sharded(pg, mesh, seeds, delta):
    """A weighted sweep on the sharded search, with the two-level argmax
    of :func:`_sweep_batched_sharded`; the dist returned is the gathered
    (v_pad, K) one."""
    res = delta_sssp_batched_sharded(pg, seeds, mesh=mesh, delta=delta)
    masked = torch.where(res.dist >= 0, res.dist, -1.0)        # (S, R, K)
    loc_val = masked.amax(dim=1)                               # (S, K)
    rows = torch.arange(pg.shard_rows, device=mesh.device)[None, :, None]
    loc_far = torch.where(masked == loc_val[:, None, :], rows,
                          pg.shard_rows).amin(dim=1)
    gid = mesh.axis_index()[:, None] * pg.shard_rows + loc_far
    far = mesh.pmin(torch.where(loc_val == mesh.pmax(loc_val), gid,
                                pg.v_pad))
    wecc = mesh.pmax(masked.clamp(min=0.0).amax(dim=1))
    return (wecc, res.levels, far.to(torch.int32), res.n_iters,
            res.n_dag_rounds, mesh.all_gather(res.dist, what="state"))


def estimate_diameter_weighted(graph: Graph,
                               gen: torch.Generator | None = None,
                               n_sweeps: int = 2, *, seeds=None,
                               delta=None) -> WeightedDiameterEstimate:
    """Weighted double-sweep bounds on a graph with weights: the chains
    and seed draw of :func:`estimate_diameter`, each sweep a batched
    delta-stepping SSSP (bucket width ``delta``, the mean weight by
    default)."""
    seeds = _seeds(graph.n_nodes, gen, n_sweeps, seeds, graph.device)
    return _weighted_double_sweeps(
        graph, seeds, lambda k: _sweep_weighted(graph, k, delta))[0]


def estimate_diameter_weighted_sharded(pg, mesh,
                                       gen: torch.Generator | None = None,
                                       n_sweeps: int = 2, *, seeds=None,
                                       delta=None, return_dist: bool = False):
    """:func:`estimate_diameter_weighted` on a weighted
    :class:`PartitionedGraph` over a shard mesh: the same seeds and
    bounds, every sweep through the sharded search.  ``return_dist=True``
    also returns the first chains' second sweep's gathered dist, (v_pad,
    K) float32 with -1 on unreached and padding rows."""
    seeds = _seeds(pg.n_nodes, gen, n_sweeps, seeds, mesh.device)
    est, dist = _weighted_double_sweeps(
        pg, seeds, lambda k: _sweep_weighted_sharded(pg, mesh, k, delta))
    if return_dist:
        return est, torch.where(dist >= 0, dist, -1.0)
    return est


def _weighted_double_sweeps(graph, seeds, sweep):
    """The chains of :func:`estimate_diameter_weighted` with ``sweep(seeds)
    -> (wecc, depth, far, rounds, DAG rounds, dist)``: per component the
    least bounds of its chains; the graph's the max over components, a
    chainless one bounded by its size; returns the estimate and the first
    round's second-sweep dist."""
    comp = connected_components(graph)
    size = torch.bincount(comp, minlength=graph.n_nodes)  # > 0 at roots
    w_max = float(graph.weight.max())
    comp_upper = torch.full(size.shape, float("inf"), dtype=torch.float32,
                            device=size.device)
    # no clamp at n: on a connected graph the bound is the reference's
    comp_vd = torch.full_like(size, torch.iinfo(torch.int64).max)
    chained = torch.zeros_like(size, dtype=torch.bool)
    lower = torch.zeros((), dtype=torch.float32, device=size.device)
    hop = 0
    n_levels = n_dag = 0
    first_dist = None
    while True:
        wecc0, h0, far0, i0, r0, _ = sweep(seeds)
        wecc1, h1, _far1, i1, r1, dist1 = sweep(far0)
        if first_dist is None:
            first_dist = dist1
        n_levels += i0 + i1
        n_dag += r0 + r1
        uppers = torch.maximum(2.0 * torch.minimum(wecc0, wecc1), wecc1)
        vds = torch.maximum(2 * torch.minimum(h0, h1), h1)
        roots = comp[seeds.long()]
        comp_upper.scatter_reduce_(0, roots, uppers.to(torch.float32),
                                   reduce="amin")
        comp_vd.scatter_reduce_(0, roots, vds.long(), reduce="amin")
        chained[roots] = True
        lower = torch.maximum(lower, wecc1.max())
        hop = max(hop, int(h1.max()))
        upper = torch.maximum(comp_upper[chained].max(), lower)
        vd = max(int(comp_vd[chained].max()), hop) + 1
        open_roots = torch.nonzero(
            ((size > vd) | ((size - 1).double() * w_max > float(upper)))
            & ~chained & (size > 0))[:, 0]
        if open_roots.numel() == 0:
            return (WeightedDiameterEstimate(float(lower), float(upper), vd,
                                             n_levels, n_dag), first_dist)
        order = torch.argsort(size[open_roots], descending=True, stable=True)
        seeds = open_roots[order[:_EXTRA_CHAINS]]
