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
ratios within a column, so the rescale is exact in distribution.  A
reached vertex's sigma is floored at float32's smallest normal number
after the rescale, so that a count the rescale takes below float32's
range still carries reach to its successors (``_floor_reached``).

The ``*_sharded`` functions at the bottom run the same searches on a
:class:`PartitionedGraph` over a shard mesh (``core/shards.py``): the
state is the stack (shards held, shard_rows, B) of the held shards' row
slices (all of them on a ``ShardMesh``, this rank's alone on a
``GroupShardMesh``), each level exchanges the masked frontier (dense, or
bitmap-scheduled sparse) and every held shard expands its own rows
through the node-blocked kernel in wide_state mode, in one level call
(one words pass, one launch over the layout's real edge blocks).  On
integer-valued sigma they give the replicated searches' bits, whichever
protocol a level takes, on either mesh.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..kernels.frontier import frontier_expand, frontier_source_block_bitmap
from .graph import Graph
from .partition import PartitionedGraph
from .shards import SHARD_MESHES

__all__ = ["BFSResult", "BidirResult", "bfs_sssp", "bfs_sssp_batched",
           "bfs_sssp_batched_sharded", "bidirectional_bfs",
           "bidirectional_bfs_batched", "bidirectional_bfs_batched_sharded"]

_RESCALE_THRESHOLD = 1e30
_SINK_DIST = -3
_INT32_MAX = torch.iinfo(torch.int32).max
_SIGMA_FLOOR = torch.finfo(torch.float32).tiny


class BFSResult(NamedTuple):
    """``levels`` is the deepest settled distance per sample (the
    eccentricity when the search ran to exhaustion).  The sharded search
    returns dist/sigma as the (n_shards, shard_rows, B) stack and
    ``exchange``, its (2,) int32 tally [levels exchanged, of which over
    the sparse protocol], on the device; None on the replicated lanes."""
    dist: torch.Tensor    # (rows, B) | (rows,) int32; -1 unreached
    sigma: torch.Tensor   # (rows, B) | (rows,) float32
    levels: torch.Tensor  # (B,) | () int32
    n_iters: int          # levels expanded by the loop
    exchange: Optional[torch.Tensor] = None


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
    exchange: Optional[torch.Tensor] = None   # as BFSResult.exchange


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


def _floor_reached(dist, sigma):
    """Reached rows' sigma floored at float32's smallest normal number.

    The rescale can take a column's small path counts below float32's
    range; a reached vertex whose sigma became 0 would pass nothing on,
    and its successors would be reached late or never (the reference
    loses them so).  With the floor ``contrib > 0`` holds exactly where
    a frontier in-neighbour exists, and a frontier value is above +0.
    Sigma is unchanged wherever it is at least the floor; sink and
    unreached rows stay 0."""
    return torch.where(dist >= 0, sigma.clamp_min(_SIGMA_FLOOR), sigma)


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
    sigma = _floor_reached(dist, sigma * scale)
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


# ---------------------------------------------------------------------------
# The sharded lane (a PartitionedGraph over a shard mesh)
# ---------------------------------------------------------------------------
#
# State is the stack (S, R, B) of the held shards' row slices (R =
# shard_rows; S the shards held: all on a ShardMesh, 1 on a
# GroupShardMesh); every cross-shard step goes through the mesh's
# collectives.  Max, min and integer sums split exactly into a local
# reduce and a cross-shard one, the sparse exchange rebuilds the dense
# gather bit for bit, and a shard adds each destination's contributions
# in the replicated layout's order, so the lane gives the replicated
# searches' bits on integer sigma.  Every loop test and protocol pick
# reads replicated values only (the results of collectives), so every
# process of a group runs the same levels and collectives.

def _held(mesh, x):
    """(S, 1) positions of the held shards in the stack ``x`` (local),
    and (S, 1) their global shard ids."""
    local = torch.arange(x.shape[0], device=x.device)[:, None]
    return local, mesh.axis_index()[:, None]


def _init_state_sharded(pg: PartitionedGraph, mesh, sources):
    """(S, R, B) dist/sigma; rows at or past ``n_nodes`` hold -3/0, and a
    source lands only on its owner's slice."""
    b = sources.shape[0]
    rows = pg.shard_rows
    dev = mesh.device
    offset = mesh.axis_index() * rows                              # (S,)
    grow = offset[:, None] + torch.arange(rows, device=dev)[None, :]
    dist = torch.where(grow < pg.n_nodes, -1, _SINK_DIST).to(
        torch.int32)[:, :, None].expand(-1, -1, b).contiguous()
    src = sources.long()[None, :]
    loc = (src - offset[:, None]).clamp(0, rows - 1)              # (S, B)
    own = (src >= offset[:, None]) & (src < offset[:, None] + rows)
    shard = _held(mesh, dist)[0].expand_as(loc)
    cols = torch.arange(b, device=dev)[None, :].expand_as(loc)
    dist[shard, loc, cols] = torch.where(own, 0, dist[shard, loc, cols])
    sigma = torch.zeros(dist.shape, dtype=torch.float32, device=dev)
    sigma[shard, loc, cols] = own.to(torch.float32)
    return dist, sigma


def _read_rows_sharded(pg: PartitionedGraph, mesh, state, idx):
    """``state[idx[b], b]`` at global rows: the owner gives its value,
    every other shard 0, one psum."""
    rows = pg.shard_rows
    local, shard_id = _held(mesh, state)
    offset = shard_id * rows
    idx = idx.long()[None, :]
    loc = (idx - offset).clamp(0, rows - 1)                        # (S, B)
    own = (idx >= offset) & (idx < offset + rows)
    shard = local.expand_as(loc)
    cols = torch.arange(loc.shape[1], device=mesh.device)[None, :]
    vals = torch.where(own, state[shard, loc, cols.expand_as(loc)], 0)
    return mesh.psum(vals)


def _gather_frontier_sharded(pg: PartitionedGraph, mesh, dist, sigma,
                             level, active):
    """The level's exchange: ``(fvals, src_bits, took_sparse)``, with
    fvals the (v_pad, B) masked frontier ``sigma * [dist == level]`` of
    the active samples over the global rows, src_bits the (S * cps,)
    int32 chunk occupancy that scheduled it, took_sparse a 0-d int32 (1
    when the level went over the sparse protocol)."""
    s, r, b = dist.shape
    fmask = (dist == level[None, None, :]) & active[None, None, :]
    fvals_local = torch.where(fmask, sigma, 0.0)
    bits_local = frontier_source_block_bitmap(
        dist.view(s * r, b), level, pg.exchange_chunk_rows, active
    ).view(s, pg.exchange_chunks_per_shard)
    return _exchange_masked_values(pg, mesh, fvals_local, bits_local)


def _exchange_masked_values(pg: PartitionedGraph, mesh, fvals_local,
                            bits_local):
    """The wire half of the exchange: (S, R, B) masked values, zero
    outside the chunks their (S, cps) bits mark, to the (v_pad, B)
    gathered view.

    Dense: one tiled all_gather.  Sparse: each shard packs its active
    chunks, in order, into ``exchange_budget`` slots, the slots and their
    global chunk ids are gathered and scattered into a zeroed view, which
    is the dense gather bit for bit.  The break-even guard at this run's
    B can make the lane dense only; otherwise one pmax of the shards'
    occupancy decides, for every shard at once, through ``mesh.select``:
    on a ``ShardMesh`` both protocols are built and the pick stays on the
    device (no host round trip); on a ``GroupShardMesh`` the replicated
    pick is read on the host and only the chosen protocol's collectives
    run, as the reference's ``lax.cond``.
    """
    s, r, b = fvals_local.shape
    chunk = pg.exchange_chunk_rows
    cps = pg.exchange_chunks_per_shard
    budget = pg.exchange_budget
    dev = mesh.device
    src_bits = mesh.all_gather(bits_local, what="bits")
    if budget <= 0 or budget * (chunk * b + 1) >= cps * chunk * b:
        return (mesh.all_gather(fvals_local, what="dense"), src_bits,
                torch.zeros((), dtype=torch.int32, device=dev))
    n_gchunks = pg.n_shards * cps
    fits = mesh.pmax(bits_local.sum(dim=1, dtype=torch.int32),
                     what="pick") <= budget

    def sparse():
        # pack: active chunk j -> slot cumsum(bits)[j] - 1; a chunk past
        # the budget (the level does not fit) and every inactive one ->
        # the dump slot, cut off below
        pos = torch.cumsum(bits_local, dim=1) - 1
        slot = torch.where((bits_local == 1) & (pos < budget), pos, budget)
        chk_of_slot = torch.full((s, budget + 1), cps, dtype=torch.int64,
                                 device=dev)
        chk_of_slot.scatter_(1, slot.long(),
                             torch.arange(cps, device=dev).expand(s, cps))
        chk_of_slot = chk_of_slot[:, :budget]
        chunks = torch.cat([fvals_local.view(s, cps, chunk, b),
                            fvals_local.new_zeros((s, 1, chunk, b))], dim=1)
        local, shard = _held(mesh, fvals_local)
        send_vals = chunks[local, chk_of_slot]     # (S, budget, chunk, B)
        send_idx = torch.where(chk_of_slot < cps, shard * cps + chk_of_slot,
                               n_gchunks).to(torch.int32)  # sentinel: dump
        g_vals = mesh.all_gather(send_vals, what="sparse")
        g_idx = mesh.all_gather(send_idx, what="sparse").long()
        # padded slots carry zero chunks onto the sentinel row; the active
        # chunks are unique across shards
        view = fvals_local.new_zeros((n_gchunks + 1, chunk, b))
        view[g_idx] = g_vals
        return view[:n_gchunks].view(n_gchunks * chunk, b)

    gathered = mesh.select(
        fits, sparse, lambda: mesh.all_gather(fvals_local, what="dense"))
    return gathered, src_bits, fits.to(torch.int32)


def _expand_level_sharded(pg: PartitionedGraph, mesh, dist, sigma, level,
                          active):
    """One sharded level: the exchange, then every held shard's rows at
    once through the dispatcher's ``shards=`` route from the gathered values
    (the frontier is where a value is above +0: a reached frontier vertex
    has sigma > 0), then the replicated lane's update with a global
    rescale guard.  Returns (dist, sigma, n_new (B,), took_sparse)."""
    fvals, _src_bits, took = _gather_frontier_sharded(pg, mesh, dist, sigma,
                                                      level, active)
    contrib = frontier_expand(None, None, None, fvals, level,
                              shards=pg.shards)
    new = (contrib > 0) & (dist == -1) & active[None, None, :]
    dist = torch.where(new, level[None, None, :] + 1, dist)
    sigma = torch.where(new, contrib, sigma)
    m = mesh.pmax(torch.where(new, sigma, 0.0).amax(dim=1))        # (B,)
    scale = torch.where(m > _RESCALE_THRESHOLD, 1.0 / m, 1.0)
    sigma = _floor_reached(dist, sigma * scale[None, None, :])
    n_new = mesh.psum(new.sum(dim=1, dtype=torch.int32))
    return dist, sigma, n_new, took


def _check_mesh(pg: PartitionedGraph, mesh) -> None:
    if not isinstance(mesh, SHARD_MESHES):
        raise TypeError(f"mesh must be a ShardMesh or a GroupShardMesh, got "
                        f"{type(mesh)}")
    mesh.check(pg)


def bfs_sssp_batched_sharded(pg: PartitionedGraph, sources, *, mesh,
                             stop_nodes=None) -> BFSResult:
    """The sharded :func:`bfs_sssp_batched` over ``mesh`` (a
    ``ShardMesh`` or ``GroupShardMesh``): dist/sigma come back as the
    (shards held, shard_rows, B) stack (``mesh.all_gather`` gives the
    (v_pad, B) view), ``levels`` once, ``exchange`` the level tally."""
    _check_mesh(pg, mesh)
    dev = mesh.device
    sources = torch.as_tensor(sources, dtype=torch.int32,
                              device=dev).reshape(-1)
    b = sources.shape[0]
    dist, sigma = _init_state_sharded(pg, mesh, sources)
    stops = None if stop_nodes is None else torch.as_tensor(
        stop_nodes, dtype=torch.int32, device=dev).reshape(-1)
    stop_open = torch.ones(b, dtype=torch.bool, device=dev)
    if stops is not None:
        stop_open = _read_rows_sharded(pg, mesh, dist, stops) < 0
    level = torch.zeros(b, dtype=torch.int32, device=dev)
    n_new = torch.ones(b, dtype=torch.int32, device=dev)
    xch = torch.zeros(2, dtype=torch.int32, device=dev)
    n_iters = 0
    while True:
        go = (n_new > 0) & (level < pg.n_nodes) & stop_open
        if not bool(go.any()):
            break
        dist, sigma, n_new2, took = _expand_level_sharded(pg, mesh, dist,
                                                          sigma, level, go)
        xch[0] += 1
        xch[1] += took
        level = torch.where(go, level + 1, level)
        n_new = torch.where(go, n_new2, n_new)
        if stops is not None:
            stop_open = _read_rows_sharded(pg, mesh, dist, stops) < 0
        n_iters += 1
    settled = mesh.pmax(torch.where(dist >= 0, dist, 0).amax(dim=1))
    return BFSResult(dist, sigma, settled, n_iters, xch)


def bidirectional_bfs_batched_sharded(pg: PartitionedGraph, s, t, *, mesh,
                                      max_levels: int | None = None
                                      ) -> BidirResult:
    """The sharded :func:`bidirectional_bfs_batched`: global frontier
    sizes (psum) pick each sample's side, the meeting test is a psum,
    ``d`` a pmin; both sides come back as (shards held, shard_rows, B)
    stacks."""
    _check_mesh(pg, mesh)
    dev = mesh.device
    max_levels = pg.n_nodes if max_levels is None else max_levels
    s = torch.as_tensor(s, dtype=torch.int32, device=dev).reshape(-1)
    t = torch.as_tensor(t, dtype=torch.int32, device=dev).reshape(-1)
    b = s.shape[0]
    dist_s, sigma_s = _init_state_sharded(pg, mesh, s)
    dist_t, sigma_t = _init_state_sharded(pg, mesh, t)
    rad_s = torch.zeros(b, dtype=torch.int32, device=dev)
    rad_t = torch.zeros(b, dtype=torch.int32, device=dev)
    alive = torch.ones(b, dtype=torch.bool, device=dev)
    xch = torch.zeros(2, dtype=torch.int32, device=dev)
    n_iters = 0
    while True:
        met = mesh.psum(((dist_s >= 0) & (dist_t >= 0)).sum(
            dim=1, dtype=torch.int32)) > 0
        active = (~met) & alive & (rad_s + rad_t < max_levels)
        if not bool(active.any()):
            break
        fs = mesh.psum((dist_s == rad_s).sum(dim=1, dtype=torch.int32))
        ft = mesh.psum((dist_t == rad_t).sum(dim=1, dtype=torch.int32))
        pick_s = fs <= ft
        exp_dist = torch.where(pick_s, dist_s, dist_t)
        exp_sigma = torch.where(pick_s, sigma_s, sigma_t)
        exp_level = torch.where(pick_s, rad_s, rad_t)
        nd, ns, n_new, took = _expand_level_sharded(
            pg, mesh, exp_dist, exp_sigma, exp_level, active)
        xch[0] += 1
        xch[1] += took
        upd_s = pick_s & active
        upd_t = ~pick_s & active
        dist_s = torch.where(upd_s, nd, dist_s)
        sigma_s = torch.where(upd_s, ns, sigma_s)
        rad_s = torch.where(upd_s, rad_s + 1, rad_s)
        dist_t = torch.where(upd_t, nd, dist_t)
        sigma_t = torch.where(upd_t, ns, sigma_t)
        rad_t = torch.where(upd_t, rad_t + 1, rad_t)
        alive = torch.where(active, n_new > 0, alive)
        n_iters += 1

    both = (dist_s >= 0) & (dist_t >= 0)
    dsum = torch.where(both, dist_s + dist_t, _INT32_MAX)
    d = mesh.pmin(dsum.amin(dim=1))
    connected = d < _INT32_MAX
    d = torch.where(connected, d, -1)
    split = torch.minimum(torch.clamp(d - rad_t, min=0), rad_s)
    split = torch.where(connected, split, 0)
    return BidirResult(dist_s, dist_t, sigma_s, sigma_t, d, split, n_iters,
                       xch)
