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

:func:`delta_sssp_batched` is the weighted lane's search: B concurrent
delta-stepping SSSPs in float32 (one min-plus relaxation round a loop
step through the weighted dispatcher), then the shortest-path-DAG count
in rounds (:func:`_dag_count`, below).  It departs from the JAX package
in three faults of the reference that it does not inherit: the window
index is corrected so that k * delta <= m < (k + 1) * delta holds
exactly (R1: a reciprocal multiply could leave the window behind and
stall the loop), and fresh vertices left at the round cap raise; the
DAG count finalizes a vertex once every DAG in-neighbour is final, so
the rounds end after the DAG's hop depth whatever the rescale does (R5:
the reference's fixed point never settles once a column is rescaled,
and leaves sigma in an arbitrary state at its sweep cap); the sharded
round ships a bucket's distances bit for bit (R6: the reference ships
``tent + 1`` and reads back ``fvals - 1``, which rounds).

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

from ..kernels.frontier import (dag_sigma, frontier_expand, frontier_relax,
                                frontier_source_block_bitmap)
from .graph import Graph
from .partition import PartitionedGraph
from .shards import SHARD_MESHES

__all__ = ["BFSResult", "BidirResult", "SSSPResult", "bfs_sssp",
           "bfs_sssp_batched", "bfs_sssp_batched_sharded",
           "bidirectional_bfs", "bidirectional_bfs_batched",
           "bidirectional_bfs_batched_sharded", "delta_sssp_batched",
           "delta_sssp_batched_sharded"]

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


class SSSPResult(NamedTuple):
    """B weighted searches run to exhaustion.  ``dist`` is the public
    float encoding (-1 unreached, -3 sink and padding rows); ``levels``
    the DAG hop depth of each column (its longest shortest path in
    edges); ``buckets`` the window advances each column took (0 when
    delta is +inf).  ``n_iters`` counts the relaxation rounds,
    ``n_dag_rounds`` the DAG rounds.  The sharded search returns dist
    and sigma as the (shards held, shard_rows, B) stack and its exchange
    tally, as :class:`BFSResult`."""
    dist: torch.Tensor     # (rows, B) float32
    sigma: torch.Tensor    # (rows, B) float32, rescaled path counts
    levels: torch.Tensor   # (B,) int32
    buckets: torch.Tensor  # (B,) int32
    n_iters: int
    n_dag_rounds: int
    exchange: Optional[torch.Tensor] = None


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


# ---------------------------------------------------------------------------
# The weighted lane: delta-stepping and the shortest-path-DAG count
# ---------------------------------------------------------------------------

_INF = float("inf")


def _default_delta(weight, n_edges: int) -> torch.Tensor:
    """The mean edge weight as a () float32 (the pad slots hold 0.0): the
    float32 division of the weights' sum, taken in float64 and rounded
    once, by the edge count."""
    total = weight.double().sum().to(torch.float32)
    return total / torch.tensor(float(max(int(n_edges), 1)),
                                dtype=torch.float32, device=weight.device)


def _delta_tensor(delta, weight, n_edges: int, device) -> torch.Tensor:
    if delta is None:
        return _default_delta(weight, n_edges)
    d = torch.as_tensor(delta, dtype=torch.float32, device=device).reshape(())
    if not bool(d > 0):
        raise ValueError(f"delta must be > 0, got {float(d)}")
    return d


def _window_start(m, delta):
    """ws = k * delta with k * delta <= m < k * delta + delta in float32:
    k = floor(m / delta), corrected by one either way (a true division
    can still round across an integer)."""
    k = torch.floor(m / delta)
    k = torch.where(k * delta > m, k - 1.0, k)
    k = torch.where(k * delta + delta <= m, k + 1.0, k)
    return k * delta


def _finalize_weighted_dist(tent, grow, n_nodes: int):
    """+inf -> -1 (unreached); rows at or past ``n_nodes`` (``grow`` their
    global ids, broadcast against ``tent``) -> -3."""
    dist = torch.where(torch.isfinite(tent), tent, -1.0)
    return torch.where(grow >= n_nodes, -3.0, dist)


def _delta_stepping(tent, fresh, delta, max_rounds: int, relax, colsum,
                    colmin):
    """The delta-stepping loop over a state of any leading shape with B
    columns last: ``relax(tent, mask) -> cand``, ``colsum(bool) -> (B,)
    int32`` and ``colmin(float) -> (B,)`` the column reductions (local,
    or across shards).  One host sync a round.  Returns (tent, buckets
    (B,), rounds)."""
    b = tent.shape[-1]
    dev = tent.device
    ws = torch.zeros(b, dtype=torch.float32, device=dev)
    nbuckets = torch.zeros(b, dtype=torch.int32, device=dev)
    bellman_ford = bool(torch.isinf(delta))
    anyfresh = colsum(fresh) > 0
    rounds = 0
    while bool(anyfresh.any()):
        if rounds >= max_rounds:
            raise RuntimeError(
                f"delta-stepping left fresh vertices after the round cap "
                f"{max_rounds}; the distances are not final")
        hi = ws + delta
        mask = fresh & (tent < hi)
        cand = relax(tent, mask)
        improved = cand < tent
        tent = torch.where(improved, cand, tent)
        # a relaxed vertex stays fresh only when this round improved it
        fresh = (fresh & ~mask) | improved
        settled = colsum(fresh & (tent < hi)) == 0
        m = colmin(torch.where(fresh, tent, _INF))
        # slide to the window of the closest fresh vertex (Bellman-Ford
        # never slides: its window covers everything)
        ws_next = m if bellman_ford else _window_start(m, delta)
        adv = settled & torch.isfinite(m)
        ws = torch.where(adv, ws_next, ws)
        if not bellman_ford:
            nbuckets = torch.where(adv, nbuckets + 1, nbuckets)
        anyfresh = colsum(fresh) > 0
        rounds += 1
    return tent, nbuckets, rounds


def _dag_count(tent, sigma, final, step, colsum, colmax):
    """Shortest-path counts on converged ``tent`` in rounds: ``step(tent,
    sigma, final) -> (sums, waiting)`` (the weighted dispatcher's DAG
    round) for the local rows, ``sigma`` and ``final`` holding the
    sources (1.0, final) and the unreached cells (final).  A round
    finalizes every cell no on-DAG in-neighbour keeps waiting and takes
    its sum; then the BFS lane's rescale over the round's new cells and
    its floor (a final reached cell keeps sigma >= float32's smallest
    normal).  The rounds run until every cell is final: round k
    finalizes the vertices whose longest DAG path has k edges, so a
    column with open cells finalizes at least one a round unless its DAG
    has a cycle (a weight absorbed beside a distance in float32,
    ``tent[u] + w == tent[u]``), which raises at the first round that
    finalizes none.  One host sync a round.  Returns (sigma, depth (B,)
    int32: the last round that finalized a cell of the column,
    rounds)."""
    b = tent.shape[-1]
    reached = torch.isfinite(tent)
    depth = torch.zeros(b, dtype=torch.int32, device=tent.device)
    rounds = 0
    n_open = colsum(~final)
    go = bool((n_open > 0).any())
    while go:
        sums, waiting = step(tent, sigma, final)
        new = ~final & ~waiting
        n_new = colsum(new)
        rounds += 1
        sigma = torch.where(new, sums, sigma)
        final = final | new
        m = colmax(torch.where(new, sigma, 0.0))
        scale = torch.where(m > _RESCALE_THRESHOLD, 1.0 / m, 1.0)
        sigma = sigma * scale
        sigma = torch.where(final & reached, sigma.clamp_min(_SIGMA_FLOOR),
                            sigma)
        depth = torch.where(n_new > 0, rounds, depth).to(torch.int32)
        stuck = ((n_open > 0) & (n_new == 0)).any()
        n_open = colsum(~final)
        stuck, go = torch.stack([stuck, (n_open > 0).any()]).tolist()
        if stuck:
            raise RuntimeError(
                f"the DAG count finalized no cell in round {rounds} while "
                f"cells were open: the shortest-path DAG has a cycle (a "
                f"weight absorbed by a float32 distance)")
    return sigma, depth, rounds


def delta_sssp_batched(graph: Graph, sources, *, delta=None) -> SSSPResult:
    """B concurrent weighted SSSPs (bucketed delta-stepping) with
    shortest-path counting.

    Needs ``graph.weight`` (:func:`~repro_torch.core.graph.with_weights`).
    ``delta`` is the bucket width: the mean edge weight by default,
    ``float("inf")`` for batched Bellman-Ford.  Every round relaxes, for
    each column, the fresh vertices inside its window [ws, ws + delta)
    through :func:`~repro_torch.kernels.frontier.frontier_relax` (on the
    card W1 over ``graph.relax_plan()``); a column's window moves to the
    bucket of its closest fresh vertex once no fresh vertex is left
    inside it.  Then the DAG count runs in rounds through
    :func:`~repro_torch.kernels.frontier.dag_sigma` (W2).
    """
    if graph.weight is None:
        raise ValueError("delta_sssp_batched needs per-edge weights; attach "
                         "them with repro_torch.core.graph.with_weights")
    sources = _as_index(sources, graph).reshape(-1)
    b = sources.shape[0]
    dev = graph.device
    rows = _state_rows(graph)
    delta_t = _delta_tensor(delta, graph.weight, graph.n_edges, dev)
    cols = torch.arange(b, device=dev)
    src_rows = sources.long()
    tent = torch.full((rows, b), _INF, dtype=torch.float32, device=dev)
    tent[src_rows, cols] = 0.0
    fresh = torch.zeros((rows, b), dtype=torch.bool, device=dev)
    fresh[src_rows, cols] = True

    def relax(t, mask):
        return frontier_relax(graph.src, graph.dst, graph.weight, t, mask,
                              plan=graph.relax_plan)

    def colsum(x):
        return x.sum(dim=0, dtype=torch.int32)

    tent, nbuckets, n_iters = _delta_stepping(
        tent, fresh, delta_t, 4 * graph.n_nodes + 8, relax, colsum,
        lambda x: x.amin(dim=0))
    sigma = torch.zeros((rows, b), dtype=torch.float32, device=dev)
    sigma[src_rows, cols] = 1.0
    final = ~torch.isfinite(tent)
    final[src_rows, cols] = True

    def step(t, sg, fin):
        return dag_sigma(graph.src, graph.dst, graph.weight, t, sg, fin,
                         plan=graph.relax_plan)

    sigma, depth, n_dag = _dag_count(tent, sigma, final, step, colsum,
                                     lambda x: x.amax(dim=0))
    grow = torch.arange(rows, device=dev)[:, None]
    return SSSPResult(_finalize_weighted_dist(tent, grow, graph.n_nodes),
                      sigma, depth, nbuckets, n_iters, n_dag)


def _relax_round_sharded(pg: PartitionedGraph, mesh, tent, mask):
    """One sharded relaxation round: the bucket (the ``mask`` cells of
    ``tent``) ships through the frontier exchange with the chunks holding
    an active cell as its bits; every held shard's rows are then relaxed
    from the gathered values in one launch.  A bucket cell travels as its
    float32 bits plus one, read back as a float32 (a source sits at 0, and
    the exchange zeroes everything off its chunks): a finite ``tent >= 0``
    maps one to one onto the positive bit patterns, so the relaxation
    starts from the exact distance, where ``tent + 1 - 1`` would round
    (0.1 comes back as 0.10000002).  Returns (cand (S, R, B),
    took_sparse)."""
    s, r, b = tent.shape
    fvals_local = torch.where(mask, tent.view(torch.int32) + 1, 0).view(
        torch.float32)
    bits_local = mask.any(dim=2).view(
        s, pg.exchange_chunks_per_shard, pg.exchange_chunk_rows).any(
        dim=2).to(torch.int32)
    fvals, _src_bits, took = _exchange_masked_values(pg, mesh, fvals_local,
                                                     bits_local)
    bits = fvals.view(torch.int32)
    active_g = bits > 0
    tent_g = torch.where(active_g, (bits - 1).view(torch.float32), _INF)
    cand = frontier_relax(None, None, None, tent_g, active_g,
                          shards=pg.shards)
    return cand, took


def delta_sssp_batched_sharded(pg: PartitionedGraph, sources, *, mesh,
                               delta=None) -> SSSPResult:
    """The sharded :func:`delta_sssp_batched` over ``mesh`` (a
    ``ShardMesh`` or ``GroupShardMesh``): the state stays sharded, a
    round exchanges only its bucket (:func:`_relax_round_sharded`), and
    the window decision reads replicated values (one psum of the cells
    left in the window, one pmin of the closest fresh distance), so every
    shard slides in lockstep.  The DAG count gathers the distances once,
    then each round the sigma state (final cells as their sigma, open
    ones as -1).  dist and sigma come back as the (shards held,
    shard_rows, B) stack; levels, buckets and the exchange tally once."""
    _check_mesh(pg, mesh)
    if pg.weight is None or pg.shards.weight is None:
        raise ValueError("delta_sssp_batched_sharded needs a weighted "
                         "partition; partition a graph built with "
                         "with_weights")
    dev = mesh.device
    sources = torch.as_tensor(sources, dtype=torch.int32,
                              device=dev).reshape(-1)
    b = sources.shape[0]
    delta_t = _delta_tensor(delta, pg.weight, pg.n_edges, dev)
    dist0, sigma = _init_state_sharded(pg, mesh, sources)
    own = dist0 == 0                                    # the sources' cells
    tent = torch.where(own, 0.0, _INF)
    xch = torch.zeros(2, dtype=torch.int32, device=dev)

    def relax(t, mask):
        cand, took = _relax_round_sharded(pg, mesh, t, mask)
        xch[0] += 1
        xch[1] += took
        return cand

    def colsum(x):
        return mesh.psum(x.sum(dim=1, dtype=torch.int32))

    tent, nbuckets, n_iters = _delta_stepping(
        tent, own.clone(), delta_t, 4 * pg.n_nodes + 8, relax, colsum,
        lambda x: mesh.pmin(x.amin(dim=1)))
    tent_g = mesh.all_gather(tent, what="state")
    final = own | ~torch.isfinite(tent)

    def step(_t, sg, fin):
        # the open cells' sigma is never read by a cell that finalizes
        packed = mesh.all_gather(torch.where(fin, sg, -1.0), what="state")
        return dag_sigma(None, None, None, tent_g, packed, packed >= 0.0,
                         shards=pg.shards)

    sigma, depth, n_dag = _dag_count(tent, sigma, final, step, colsum,
                                     lambda x: mesh.pmax(x.amax(dim=1)))
    rows = pg.shard_rows
    grow = (mesh.axis_index()[:, None] * rows
            + torch.arange(rows, device=dev)[None, :])[:, :, None]
    return SSSPResult(_finalize_weighted_dist(tent, grow, pg.n_nodes),
                      sigma, depth, nbuckets, n_iters, n_dag, xch)
