"""Uniform shortest-path sampling on the bidirectional stream
(``repro.core.sampler``).

One sample: draw a uniform pair (s, t), s != t; run a balanced
bidirectional BFS; draw one uniform shortest s-t path; mark its internal
vertices.  B samples share one batched search per round.

The path draw is factorized through the search DAG:

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
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .bfs import BidirResult, bidirectional_bfs_batched
from .graph import Graph

__all__ = ["PathSample", "sample_pairs", "sample_path_batched"]

_NEG_INF = -1e30


class PathSample(NamedTuple):
    """B samples of one round.  ``internal`` lists each sample's internal
    path vertices, padded with -1 (a sample's row never names a vertex
    twice: the vertices of a shortest path are distinct)."""
    internal: torch.Tensor  # (B, L) int64
    valid: torch.Tensor     # (B,) bool, False when s, t are disconnected
    length: torch.Tensor    # (B,) int32 path length, -1 if invalid
    n_levels: int           # BFS levels the round's search expanded


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


def _draw_predecessors(graph: Graph, gen, v, level, dist, sigma, walking):
    """For each walker j (a column of ``dist``/``sigma``) at vertex v[j]
    on level level[j], draw u ~ sigma[u, j] among the neighbours u of
    v[j] with dist[u, j] == level[j] - 1.  Walkers with ``walking`` False
    keep their vertex."""
    n_walk = v.shape[0]
    dev = v.device
    deg = torch.where(walking, graph.degree[v].long(), 0)
    width = max(int(deg.max()), 1)
    slot = torch.arange(width, device=dev)
    in_list = slot[None, :] < deg[:, None]
    pos = graph.indptr[v].long()[:, None] + slot[None, :]
    nbr = graph.indices[torch.where(in_list, pos, 0)].long()
    cols = torch.arange(n_walk, device=dev)[:, None].expand_as(nbr)
    on_dag = in_list & (dist[nbr, cols] == (level - 1)[:, None])
    w = torch.where(on_dag, sigma[nbr, cols].double(), 0.0)
    cum = torch.cumsum(w, dim=1)
    x = torch.rand(n_walk, generator=gen, device=dev,
                   dtype=torch.float64) * cum[:, -1]
    pick = torch.searchsorted(cum, x[:, None], right=True)[:, 0]
    # u * total may round up to the total: fall back to the last
    # predecessor, never to a zero-weight slot
    last = torch.where(w > 0, slot[None, :], -1).amax(dim=1)
    pick = torch.minimum(pick, last).clamp(min=0)
    u = nbr.gather(1, pick[:, None])[:, 0]
    return torch.where(walking, u, v)


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
