"""Uniform shortest-path sampling (``repro.core.sampler``).

One sample: draw a uniform pair (s, t), s != t; search; draw one uniform
shortest s-t path; mark its internal vertices.  B samples share one
batched search per round.  Two streams:

* bidirectional (:func:`sample_path_batched`): a balanced bidirectional
  BFS, then a meeting-vertex draw and two backward walks;
* forward (:func:`sample_path_forward_batched`): one BFS from each s run
  to exhaustion, then one backward walk from t.  Its distance columns are
  unbiased per-source distance vectors, which closeness and harmonic
  read; the bidirectional search stops at the meeting level and has none;
* weighted (:func:`sample_path_weighted_batched`): the forward stream on
  a weighted graph, one delta-stepping SSSP from each s, then one
  backward walk from t down the shortest-path DAG, on distances: a
  predecessor u of v has ``dist[u] >= 0`` and ``dist[u] + w == dist[v]``
  (the exact float32 test the DAG count used), w read beside ``indices``
  in v's CSR row.  The pair draw comes first and reads no weight, so a
  generator draws the same pairs whatever the weights are.

On the bidirectional stream the path draw is factorized through the
search DAG:

* the meeting vertex w on the split level is drawn with probability
  proportional to sigma_s(w) * sigma_t(w) (a Gumbel-max per sample
  column of the vertex-major (V+1, B) weights);
* from w the walks go back to s and to t, drawing at a level-l vertex v
  a predecessor u (dist(u) == l-1) with probability sigma(u) / sum of
  sigma over v's predecessors.

The walks run vectorized over the 2B walkers (B towards s, B towards t),
one step per level.  A step lays the neighbour lists of the walkers'
vertices out as a zero-padded (2B, max degree) matrix, takes the prefix
sums of the weights in float64 row by row and inverts them with one
uniform per walker: an exact weighted draw for any degree, hubs included.

Randomness comes from one ``torch.Generator`` on the graph's device; the
streams do not equal ``jax.random``'s, so the two packages agree in
distribution, not draw for draw.

The ``*_sharded`` samplers run the search on a :class:`PartitionedGraph`
over a shard mesh (the sharded BFS), then gather the state once a batch
and draw and walk over the replicated CSR exactly as the replicated
samplers do: on the same generator state, and BFS state of the same
bits, the two lanes draw the same samples.  On a ``GroupShardMesh``
every process holds the gathered state and makes the same generator
calls from the same seed, so the draws and walks run replicated and
every rank takes the same samples.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .bfs import (BidirResult, bfs_sssp_batched, bfs_sssp_batched_sharded,
                  bidirectional_bfs_batched,
                  bidirectional_bfs_batched_sharded, delta_sssp_batched,
                  delta_sssp_batched_sharded)
from .graph import Graph

__all__ = ["ForwardSample", "PathSample", "sample_batch", "sample_pairs",
           "sample_path", "sample_path_batched",
           "sample_path_batched_sharded", "sample_path_forward_batched",
           "sample_path_forward_batched_sharded",
           "sample_path_weighted_batched",
           "sample_path_weighted_batched_sharded"]

_NEG_INF = -1e30


class PathSample(NamedTuple):
    """B samples of one round.  ``internal`` lists each sample's internal
    path vertices, padded with -1 (a sample's row never names a vertex
    twice: the vertices of a shortest path are distinct)."""
    internal: torch.Tensor  # (B, L) int64
    valid: torch.Tensor     # (B,) bool, False when s, t are disconnected
    length: torch.Tensor    # (B,) int32 path length, -1 if invalid
    n_levels: int           # BFS levels the round's search expanded
    # (2,) int32 exchange tally of the sharded search; None otherwise
    exchange: Optional[torch.Tensor] = None


class ForwardSample(NamedTuple):
    """B samples of one forward-stream round: a :class:`PathSample` plus
    the exhausted distance columns of the sources' searches (at the BFS
    state's row count, csc.v_pad with a CSC layout, else V+1; consumers
    cut them to V+1) and the sources themselves.  On the weighted stream
    ``dist`` is float32 (-1 unreached), ``length`` the path's hops,
    ``n_levels`` the relaxation rounds and ``n_dag_rounds`` the DAG
    rounds of the round's search."""
    internal: torch.Tensor  # (B, L) int64
    valid: torch.Tensor     # (B,) bool
    length: torch.Tensor    # (B,) int32, -1 if invalid
    dist: torch.Tensor      # (rows, B) distance from s, -1 unreached
    sources: torch.Tensor   # (B,) int32
    n_levels: int
    exchange: Optional[torch.Tensor] = None   # as PathSample.exchange
    n_dag_rounds: int = 0


def sample_pairs(gen: torch.Generator, n_nodes: int, batch: int):
    """``batch`` uniform pairs (s, t) with s != t, as (B,) int32."""
    dev = gen.device
    s = torch.randint(0, n_nodes, (batch,), generator=gen, device=dev,
                      dtype=torch.int32)
    t = torch.randint(0, n_nodes - 1, (batch,), generator=gen, device=dev,
                      dtype=torch.int32)
    return s, torch.where(t >= s, t + 1, t)


def _gumbel_argmax(gen: torch.Generator, logw):
    """One Gumbel-max draw per column of the (rows, B) log-weights."""
    u = torch.rand(logw.shape, generator=gen, device=logw.device,
                   dtype=torch.float32) * (1.0 - 1e-20) + 1e-20
    return torch.argmax(logw - torch.log(-torch.log(u)), dim=0)


def _neighbours(graph, v, walking):
    """The walkers' neighbour lists as a zero-padded (walkers, max degree)
    layout: (slot, in_list, CSR positions, neighbours, walker columns)."""
    dev = v.device
    deg = torch.where(walking, graph.degree[v].long(), 0)
    width = max(int(deg.max()), 1)
    slot = torch.arange(width, device=dev)
    in_list = slot[None, :] < deg[:, None]
    pos = torch.where(in_list, graph.indptr[v].long()[:, None]
                      + slot[None, :], 0)
    nbr = graph.indices[pos].long()
    cols = torch.arange(v.shape[0], device=dev)[:, None].expand_as(nbr)
    return slot, in_list, pos, nbr, cols


def _draw_predecessors(graph: Graph, gen, v, level, dist, sigma, walking):
    """For each walker j (a column of ``dist``/``sigma``) at vertex v[j]
    on level level[j], draw u ~ sigma[u, j] among the neighbours u of
    v[j] with dist[u, j] == level[j] - 1.  Walkers with ``walking`` False
    keep their vertex."""
    slot, in_list, _pos, nbr, cols = _neighbours(graph, v, walking)
    on_dag = in_list & (dist[nbr, cols] == (level - 1)[:, None])
    return _draw(gen, slot, nbr, on_dag, sigma[nbr, cols], v, walking)[0]


def _draw(gen, slot, nbr, on_dag, sig, v, walking):
    """One draw per walker of a slot with weight ``sig`` among its
    ``on_dag`` slots -> (the drawn neighbour, or v where the walker is
    not walking or has no such slot; whether it had one)."""
    n_walk = v.shape[0]
    dev = v.device
    w = torch.where(on_dag, sig.double(), 0.0)
    cum = torch.cumsum(w, dim=1)
    x = torch.rand(n_walk, generator=gen, device=dev,
                   dtype=torch.float64) * cum[:, -1]
    pick = torch.searchsorted(cum, x[:, None], right=True)[:, 0]
    # u * total may round up to the total: fall back to the last
    # predecessor, never to a zero-weight slot
    last = torch.where(w > 0, slot[None, :], -1).amax(dim=1)
    pick = torch.minimum(pick, last).clamp(min=0)
    u = nbr.gather(1, pick[:, None])[:, 0]
    found = walking & (last >= 0)
    return torch.where(found, u, v), found


def _walk_paths(graph: Graph, gen, start, level, dist, sigma):
    """Walk every column of ``dist``/``sigma`` from ``start`` (at
    ``level``) down to level 0; returns the (walkers, steps) vertices
    visited strictly between the start and level 0 (-1 padded)."""
    steps = int(level.max()) - 1 if level.numel() else 0
    v, lvl = start.long(), level.clone()
    visited = []
    for _ in range(max(steps, 0)):
        walking = lvl > 1
        v = _draw_predecessors(graph, gen, v, lvl, dist, sigma, walking)
        visited.append(torch.where(walking, v, -1))
        lvl = torch.where(walking, lvl - 1, lvl)
    if not visited:
        return torch.full((start.shape[0], 0), -1, dtype=torch.long,
                          device=start.device)
    return torch.stack(visited, dim=1)


def _finish_paths(graph: Graph, gen, res: BidirResult) -> PathSample:
    """Meeting-vertex draw and the two backward walks of a finished
    bidirectional search."""
    batch = res.d.shape[0]
    valid = res.d >= 0
    # weights cut to the logical V+1 rows: the draw does not depend on
    # whether the state rides at csc.v_pad rows
    v1 = graph.n_nodes + 1
    on_split = ((res.dist_s[:v1] == res.split[None, :])
                & (res.dist_t[:v1] == (res.d - res.split)[None, :]))
    logw = torch.where(
        on_split & valid[None, :],
        torch.log(torch.clamp(res.sigma_s[:v1], min=1e-30))
        + torch.log(torch.clamp(res.sigma_t[:v1], min=1e-30)),
        _NEG_INF)
    w = _gumbel_argmax(gen, logw)                                  # (B,)
    # w is internal iff it is neither s (split == 0) nor t (split == d)
    w_internal = valid & (res.split > 0) & (res.split < res.d)
    lvl_s = torch.where(valid, res.split, 0)
    lvl_t = torch.where(valid, res.d - res.split, 0)
    walks = _walk_paths(
        graph, gen, torch.cat([w, w]), torch.cat([lvl_s, lvl_t]),
        torch.cat([res.dist_s, res.dist_t], dim=1),
        torch.cat([res.sigma_s, res.sigma_t], dim=1))
    internal = torch.cat([torch.where(w_internal, w, -1)[:, None],
                          walks[:batch], walks[batch:]], dim=1)
    return PathSample(internal, valid, torch.where(valid, res.d, -1),
                      res.n_iters)


def sample_path_batched(graph: Graph, gen: torch.Generator,
                        batch: int) -> PathSample:
    """Take ``batch`` KADABRA samples with one batched bidirectional
    search."""
    s, t = sample_pairs(gen, graph.n_nodes, batch)
    res = bidirectional_bfs_batched(graph, s, t)
    return _finish_paths(graph, gen, res)


def sample_path_batched_sharded(pg, gen: torch.Generator, batch: int, *,
                                mesh) -> PathSample:
    """:func:`sample_path_batched` on a :class:`PartitionedGraph`: the
    bidirectional search sharded over ``mesh``, its state gathered once,
    then the replicated lane's draws and walks."""
    s, t = sample_pairs(gen, pg.n_nodes, batch)
    res = bidirectional_bfs_batched_sharded(pg, s, t, mesh=mesh)
    full = res._replace(**{k: mesh.all_gather(getattr(res, k), what="state")
                           for k in ("dist_s", "dist_t", "sigma_s",
                                     "sigma_t")})
    return _finish_paths(pg, gen, full)._replace(exchange=res.exchange)


def _finish_forward_paths(graph: Graph, gen, s, t, res) -> ForwardSample:
    """The backward walk from t over a finished forward search.

    With the whole (dist_s, sigma_s) at hand there is no meeting-vertex
    draw: walking back from t, drawing at each level-l vertex a
    predecessor u with probability sigma_s(u) over the sum of its
    predecessors', picks each shortest s-t path with probability
    1 / sigma_s(t), the law of the bidirectional stream.  The walk from
    t at level d marks levels d-1 .. 1: the path's internal vertices.
    """
    batch = s.shape[0]
    d = res.dist[t.long(), torch.arange(batch, device=t.device)]
    valid = d > 0                   # s == t is never drawn, so d >= 1
    internal = _walk_paths(graph, gen, t, torch.where(valid, d, 0),
                           res.dist, res.sigma)
    return ForwardSample(internal, valid, torch.where(valid, d, -1),
                         res.dist, s, res.n_iters)


def sample_path_forward_batched(graph: Graph, gen: torch.Generator,
                                batch: int) -> ForwardSample:
    """Take ``batch`` samples through the forward stream: one batched BFS
    from the sources, to exhaustion, then one backward walk per sample.
    The drawn paths follow the bidirectional stream's law; the draws
    themselves differ."""
    s, t = sample_pairs(gen, graph.n_nodes, batch)
    res = bfs_sssp_batched(graph, s)
    return _finish_forward_paths(graph, gen, s, t, res)


def sample_path_forward_batched_sharded(pg, gen: torch.Generator,
                                        batch: int, *, mesh
                                        ) -> ForwardSample:
    """:func:`sample_path_forward_batched` on a :class:`PartitionedGraph`:
    the forward search sharded over ``mesh``, its state gathered once;
    ``dist`` is the gathered (v_pad, B) one."""
    s, t = sample_pairs(gen, pg.n_nodes, batch)
    res = bfs_sssp_batched_sharded(pg, s, mesh=mesh)
    full = res._replace(dist=mesh.all_gather(res.dist, what="state"),
                        sigma=mesh.all_gather(res.sigma, what="state"))
    return _finish_forward_paths(pg, gen, s, t, full)._replace(
        exchange=res.exchange)


def _walk_weighted(graph, gen, start, tv, dist, sigma):
    """Walk every column from ``start`` (at distance ``tv``) down the
    shortest-path DAG to its source (distance 0), on distances: each step
    draws a predecessor u with probability sigma(u) over the sum of its
    predecessors' and marks it when it is not the source.  A walker stops
    at distance 0, after ``n_nodes + 1`` steps, or where no predecessor is
    found (only on a corrupt state).  Returns ((walkers, steps) visited
    internal vertices, -1 padded; (walkers,) hops)."""
    v = start.long()
    n_walk = v.shape[0]
    cols = torch.arange(n_walk, device=v.device)
    hops = torch.zeros(n_walk, dtype=torch.int32, device=v.device)
    visited = []
    while True:
        walking = (tv > 0.0) & (hops <= graph.n_nodes)
        if not bool(walking.any()):
            break
        slot, in_list, pos, nbr, wcols = _neighbours(graph, v, walking)
        dn = dist[nbr, wcols]
        on_dag = in_list & (dn >= 0.0) & (dn + graph.weight[pos]
                                           == tv[:, None])
        u, found = _draw(gen, slot, nbr, on_dag, sigma[nbr, wcols], v,
                         walking)
        du = torch.where(found, dist[u, cols], 0.0)
        visited.append(torch.where(found & (du > 0.0), u, -1))
        v = u
        tv = torch.where(walking, du, tv)
        hops = torch.where(walking, hops + 1, hops)
    if not visited:
        return torch.full((n_walk, 0), -1, dtype=torch.long,
                          device=v.device), hops
    return torch.stack(visited, dim=1), hops


def _finish_weighted_paths(graph, gen, s, t, res) -> ForwardSample:
    """The backward walk from t over a finished weighted search: the same
    telescoping law as :func:`_finish_forward_paths` (each weighted
    shortest s-t path with probability 1 / sigma(t)); ``length`` is the
    path's hops."""
    batch = s.shape[0]
    d = res.dist[t.long(), torch.arange(batch, device=t.device)]
    valid = d > 0.0
    internal, hops = _walk_weighted(graph, gen, t,
                                    torch.where(valid, d, 0.0), res.dist,
                                    res.sigma)
    return ForwardSample(internal, valid, torch.where(valid, hops, -1),
                         res.dist, s, res.n_iters,
                         n_dag_rounds=res.n_dag_rounds)


def sample_path_weighted_batched(graph: Graph, gen: torch.Generator,
                                 batch: int) -> ForwardSample:
    """Take ``batch`` samples through the weighted stream: one batched
    delta-stepping SSSP from the sources (default bucket width), then
    one backward DAG walk per sample."""
    s, t = sample_pairs(gen, graph.n_nodes, batch)
    res = delta_sssp_batched(graph, s)
    return _finish_weighted_paths(graph, gen, s, t, res)


def sample_path_weighted_batched_sharded(pg, gen: torch.Generator,
                                         batch: int, *, mesh
                                         ) -> ForwardSample:
    """:func:`sample_path_weighted_batched` on a weighted
    :class:`PartitionedGraph`: the search sharded over ``mesh``, its
    dist and sigma gathered once, then the walks over the replicated CSR
    and weights; ``dist`` is the gathered (v_pad, B) one."""
    s, t = sample_pairs(gen, pg.n_nodes, batch)
    res = delta_sssp_batched_sharded(pg, s, mesh=mesh)
    full = res._replace(dist=mesh.all_gather(res.dist, what="state"),
                        sigma=mesh.all_gather(res.sigma, what="state"))
    return _finish_weighted_paths(pg, gen, s, t, full)._replace(
        exchange=res.exchange)


def sample_path(graph: Graph, gen: torch.Generator) -> PathSample:
    """One KADABRA sample: the B=1 case of :func:`sample_path_batched`,
    with the batch row squeezed (``internal`` is (L,), -1 padded)."""
    ps = sample_path_batched(graph, gen, 1)
    return PathSample(ps.internal[0], ps.valid[0], ps.length[0],
                      ps.n_levels)


def sample_batch(graph, gen: torch.Generator, n_samples: int, *,
                 batch_size: int = 1, carry=None, return_carry: bool = False,
                 mesh=None):
    """Exactly ``n_samples`` new bidirectional samples in rounds of
    ``batch_size``, folded into path counts.

    Returns ``(counts (V+1,) float32, tau)``; with ``return_carry=True``
    also the surplus frame ``(counts, tau)`` of the last round's samples
    past ``n_samples``, which a later call folds in through ``carry``.
    The betweenness fold of the engine's :func:`draw_fold`.  With
    ``mesh`` (a ``ShardMesh`` or ``GroupShardMesh``), ``graph`` is a
    :class:`PartitionedGraph` and every round's search is sharded.
    """
    # the engine imports this module: import it at call time
    from .engine import draw_fold
    from .estimators import RunContext, get_estimator
    fold = draw_fold(graph, gen, n_samples,
                     estimators=(get_estimator("betweenness"),),
                     ctx=RunContext(graph.n_nodes, 0), batch_size=batch_size,
                     carry=None if carry is None else (carry[0][None],
                                                       carry[1]),
                     mesh=mesh)
    out = (fold.counts[0], fold.tau)
    if return_carry:
        return out, (fold.sur_counts[0], fold.sur_tau)
    return out
