"""Batched BFS with shortest-path counting (``repro.core.bfs``).

The state of B concurrent searches is vertex-major: ``dist`` (rows, B)
int32 and ``sigma`` (rows, B) float32, with rows = V+1 (the sink row at
``n_nodes``, dist -3) or ``csc.v_pad`` when the graph carries a CSC
layout.  One level is one masked SpMM over the edge list,

    contrib[v, b] = sum_{(u,v) in E} sigma[u, b] * [dist[u, b] == level[b]]

routed through the frontier dispatcher (a CUDA kernel on the card, the
plain version on the CPU).  Each ``lax.while_loop`` of the JAX package is
a host loop here with one device-to-host sync per level (the loop test);
the results carry ``n_iters``, the number of levels the loop expanded.

Path counts grow combinatorially, so each sample's sigma column is
rescaled by 1/max whenever its max passes 1e30; every consumer uses
ratios within a column, so the rescale is exact in distribution.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..kernels.frontier import frontier_expand
from .graph import Graph

__all__ = ["BFSResult", "BidirResult", "bfs_sssp", "bfs_sssp_batched",
           "bidirectional_bfs", "bidirectional_bfs_batched"]

_RESCALE_THRESHOLD = 1e30
_SINK_DIST = -3
_INT32_MAX = torch.iinfo(torch.int32).max


class BFSResult(NamedTuple):
    """``levels`` is the deepest settled distance per sample (the
    eccentricity when the search ran to exhaustion)."""
    dist: torch.Tensor    # (rows, B) | (rows,) int32; -1 unreached
    sigma: torch.Tensor   # (rows, B) | (rows,) float32
    levels: torch.Tensor  # (B,) | () int32
    n_iters: int          # levels expanded by the loop


class BidirResult(NamedTuple):
    """State of balanced bidirectional BFS after the frontiers met.

    ``d`` is the s-t distance (-1 when disconnected); ``split`` is the
    s-side level L such that every shortest s-t path crosses exactly one
    vertex w with dist_s(w) == L.
    """
    dist_s: torch.Tensor
    dist_t: torch.Tensor
    sigma_s: torch.Tensor
    sigma_t: torch.Tensor
    d: torch.Tensor       # (B,) | () int32
    split: torch.Tensor   # (B,) | () int32
    n_iters: int


def _state_rows(graph: Graph) -> int:
    return graph.csc.v_pad if graph.csc is not None else graph.n_nodes + 1


def _init_state(graph: Graph, sources):
    """sources (B,) -> dist/sigma (rows, B); rows >= n_nodes hold -3/0."""
    b = sources.shape[0]
    dev = graph.device
    dist = torch.full((_state_rows(graph), b), -1, dtype=torch.int32,
                      device=dev)
    dist[graph.n_nodes:] = _SINK_DIST
    cols = torch.arange(b, device=dev)
    rows = sources.long()
    dist[rows, cols] = 0
    sigma = torch.zeros(dist.shape, dtype=torch.float32, device=dev)
    sigma[rows, cols] = 1.0
    return dist, sigma


def _expand_level(graph: Graph, dist, sigma, level, active):
    """One batched relaxation; inactive columns are left untouched.
    Returns (dist, sigma, n_new (B,))."""
    # the flat route's in-edge plan, built on its first level (lazily: the
    # dispatcher asks for it only on the flat route)
    contrib = frontier_expand(graph.src, graph.dst, dist, sigma, level,
                              csc=graph.csc, plan=graph.pull_plan)
    new = (contrib > 0) & (dist == -1) & active[None, :]
    dist = torch.where(new, level[None, :] + 1, dist)
    sigma = torch.where(new, contrib, sigma)
    m = torch.where(new, sigma, 0.0).amax(dim=0, keepdim=True)
    scale = torch.where(m > _RESCALE_THRESHOLD, 1.0 / m, 1.0)
    sigma = sigma * scale
    return dist, sigma, new.sum(dim=0, dtype=torch.int32)


def _as_index(x, graph: Graph):
    return torch.as_tensor(x, dtype=torch.int32, device=graph.device)


def bfs_sssp_batched(graph: Graph, sources, *, stop_nodes=None) -> BFSResult:
    """B concurrent single-source BFS with path counting, run until every
    frontier is exhausted (or, with ``stop_nodes``, until each search's
    stop node settled; ``levels`` then under-reports the eccentricity)."""
    sources = _as_index(sources, graph).reshape(-1)
    b = sources.shape[0]
    dist, sigma = _init_state(graph, sources)
    cols = torch.arange(b, device=graph.device)
    stops = None if stop_nodes is None else _as_index(stop_nodes,
                                                      graph).long()
    level = torch.zeros(b, dtype=torch.int32, device=graph.device)
    n_new = torch.ones(b, dtype=torch.int32, device=graph.device)
    n_iters = 0
    while True:
        go = (n_new > 0) & (level < graph.n_nodes)
        if stops is not None:
            go = go & (dist[stops, cols] < 0)
        if not bool(go.any()):
            break
        dist, sigma, n_new2 = _expand_level(graph, dist, sigma, level, go)
        level = torch.where(go, level + 1, level)
        n_new = torch.where(go, n_new2, n_new)
        n_iters += 1
    settled = torch.where(dist >= 0, dist, 0).amax(dim=0)
    return BFSResult(dist, sigma, settled, n_iters)


def bfs_sssp(graph: Graph, source, *, stop_node=None) -> BFSResult:
    """Single-source BFS: the B=1 case with the batch column squeezed."""
    res = bfs_sssp_batched(
        graph, _as_index(source, graph).reshape(1),
        stop_nodes=None if stop_node is None
        else _as_index(stop_node, graph).reshape(1))
    return BFSResult(res.dist[:, 0], res.sigma[:, 0], res.levels[0],
                     res.n_iters)


def bidirectional_bfs_batched(graph: Graph, s, t, *,
                              max_levels: int | None = None) -> BidirResult:
    """B balanced bidirectional BFS sharing one edge stream per level.

    Each level every active sample expands its smaller frontier; a sample
    stops when some vertex is settled from both sides or its frontier
    died (disconnected pair).
    """
    max_levels = graph.n_nodes if max_levels is None else max_levels
    s = _as_index(s, graph).reshape(-1)
    t = _as_index(t, graph).reshape(-1)
    b = s.shape[0]
    dev = graph.device
    dist_s, sigma_s = _init_state(graph, s)
    dist_t, sigma_t = _init_state(graph, t)
    rad_s = torch.zeros(b, dtype=torch.int32, device=dev)
    rad_t = torch.zeros(b, dtype=torch.int32, device=dev)
    alive = torch.ones(b, dtype=torch.bool, device=dev)
    n_iters = 0
    while True:
        met = ((dist_s >= 0) & (dist_t >= 0)).any(dim=0)
        active = (~met) & alive & (rad_s + rad_t < max_levels)
        if not bool(active.any()):
            break
        fs = (dist_s == rad_s[None, :]).sum(dim=0)
        ft = (dist_t == rad_t[None, :]).sum(dim=0)
        pick_s = fs <= ft
        exp_dist = torch.where(pick_s[None, :], dist_s, dist_t)
        exp_sigma = torch.where(pick_s[None, :], sigma_s, sigma_t)
        exp_level = torch.where(pick_s, rad_s, rad_t)
        nd, ns, n_new = _expand_level(graph, exp_dist, exp_sigma, exp_level,
                                      active)
        upd_s = (pick_s & active)[None, :]
        upd_t = (~pick_s & active)[None, :]
        dist_s = torch.where(upd_s, nd, dist_s)
        sigma_s = torch.where(upd_s, ns, sigma_s)
        rad_s = torch.where(upd_s[0], rad_s + 1, rad_s)
        dist_t = torch.where(upd_t, nd, dist_t)
        sigma_t = torch.where(upd_t, ns, sigma_t)
        rad_t = torch.where(upd_t[0], rad_t + 1, rad_t)
        alive = torch.where(active, n_new > 0, alive)
        n_iters += 1

    both = (dist_s >= 0) & (dist_t >= 0)
    dsum = torch.where(both, dist_s + dist_t, _INT32_MAX)
    d = dsum.amin(dim=0)
    connected = d < _INT32_MAX
    d = torch.where(connected, d, -1)
    # every vertex with dist_s == split is settled on both sides
    split = torch.minimum(torch.clamp(d - rad_t, min=0), rad_s)
    split = torch.where(connected, split, 0)
    return BidirResult(dist_s, dist_t, sigma_s, sigma_t, d, split, n_iters)


def bidirectional_bfs(graph: Graph, s, t, *,
                      max_levels: int | None = None) -> BidirResult:
    """Balanced bidirectional BFS from s to t (the B=1 case)."""
    res = bidirectional_bfs_batched(
        graph, _as_index(s, graph).reshape(1), _as_index(t, graph).reshape(1),
        max_levels=max_levels)
    return BidirResult(res.dist_s[:, 0], res.dist_t[:, 0], res.sigma_s[:, 0],
                       res.sigma_t[:, 0], res.d[0], res.split[0],
                       res.n_iters)
