"""Plain PyTorch versions of the frontier-expansion kernels.

Contract (one BFS level, edge-centric, batched over B samples,
vertex-major state), the same as ``repro.kernels.frontier.ref``:

    contrib[v, b] = sum_{e: dst[e] == v}
                        sigma[src[e], b] * [dist[src[e], b] == levels[b]]

  src, dst : (E,) int32 COO edges; padded slots point at the sink row
  dist     : (rows, B) int32, the sink row and padding rows hold -3
  sigma    : (rows, B) float32
  levels   : (B,) int32
  contrib  : (rows, B) float32

The node-blocked version runs the same sum over a ``CSCLayout``'s edge
order and keeps the row count it was handed.  The sharded version runs
it over one shard's local view (global ``src``, local ``dst``) from the
gathered global state and returns the shard's (shard_rows, B) tile; the
sharded level version stacks every shard's tile, from the gathered
masked values alone.  ``frontier_pull_ref`` runs
it over a pull plan (``kernel.build_pull_plan``) in the pull kernel's
order of additions.  ``frontier_words_ref`` is the plain version of the
words pass both routes start with: the frontier packed 32 samples to an
int32 word.  While sigma holds exact integers below 2^24 every summation
order gives the same bits, so these versions and the kernels agree bit
for bit on BFS-derived state.

The weighted lane's plain versions follow, the JAX package's
``frontier_relax_*_ref`` and ``dag_sigma_*_ref`` (XLA-only there):

    cand[v, b] = min over edges (u -> v) with active[u, b]
                     of tent[u, b] + weight(u, v)        (+inf if none)

and one round of the shortest-path-DAG count on converged distances
(``dag_round_*``): an edge is on the DAG iff ``tent[u]`` is finite and
``tent[u] + w == tent[v]``; a cell not yet ``final`` gets the sum of its
on-DAG in-neighbours' sigma and whether one of them is not final, a
final cell 0 and False.  ``frontier_relax_pull_ref`` and
``dag_sigma_pull_ref`` run the same over a relax plan
(``kernel.build_relax_plan``) in the kernels' order.  Min is exact in any
order; the DAG sums add in edge order (COO, or plan order), which is a
destination's in-edges in source order either way.
"""
from __future__ import annotations

import torch

__all__ = ["dag_round_batched_ref", "dag_round_sharded_level_ref",
           "dag_round_sharded_ref",
           "dag_sigma_batched_ref", "dag_sigma_pull_ref",
           "dag_sigma_sharded_ref", "frontier_expand_batched_ref",
           "frontier_expand_node_blocked_ref",
           "frontier_expand_sharded_level_ref",
           "frontier_expand_sharded_ref", "frontier_pull_ref",
           "frontier_relax_batched_ref", "frontier_relax_pull_ref",
           "frontier_relax_sharded_level_ref", "frontier_relax_sharded_ref",
           "frontier_words_ref"]


# (edge, sample) cells gathered at once; bounds the temporaries at full
# graph size to a few hundred MB
_CHUNK_CELLS = 1 << 26


def _expand(src, dst, dist, sigma, levels, rows: int):
    out = torch.zeros((rows, dist.shape[1]), dtype=torch.float32,
                      device=dist.device)
    chunk = max(1, _CHUNK_CELLS // max(dist.shape[1], 1))
    for lo in range(0, src.shape[0], chunk):
        s = src[lo: lo + chunk].long()
        vals = torch.where(dist[s] == levels[None, :], sigma[s], 0.0)
        out.index_add_(0, dst[lo: lo + chunk].long(), vals)
    return out


def frontier_expand_batched_ref(src, dst, dist, sigma, levels):
    return _expand(src, dst, dist, sigma, levels, dist.shape[0])


def frontier_expand_node_blocked_ref(csc, dist, sigma, levels):
    """Expand over the CSC edge order; (V+1, B) or (csc.v_pad, B) in, the
    same row count out."""
    rows = dist.shape[0]
    out = _expand(csc.src, csc.dst, dist, sigma, levels,
                  max(csc.v_pad, rows))
    return out if rows >= csc.v_pad else out[:rows]


def frontier_expand_sharded_ref(shard, dist, sigma, levels):
    """One shard's rows of the level, from the gathered state.

    ``shard`` is one shard's :class:`CSCLayout` view
    (``ShardedCSCLayout.shard(s)``: global ``src``, local ``dst``,
    ``v_pad == shard_rows``); ``dist``/``sigma`` cover the global padded
    rows.  Returns the (shard_rows, B) tile; padding slots (``dst ==
    shard_rows``) land on a scratch row that is cut off.
    """
    return _expand(shard.src, shard.dst, dist, sigma, levels,
                   shard.v_pad + 1)[: shard.v_pad]


def frontier_expand_sharded_level_ref(shards, fvals, levels):
    """Every held shard's tile of the level, stacked (n_local_shards,
    shard_rows, B): the
    per-shard version over ``shards.shard(s)`` with the gathered masked
    values ``fvals`` as sigma and their synthesized dist
    ``where(fvals > 0, levels, -1)``, as the reference hands each device
    its wide_state call."""
    fdist = torch.where(fvals > 0.0, levels[None, :], -1).to(torch.int32)
    return torch.stack([
        frontier_expand_sharded_ref(shards.shard(s), fdist, fvals, levels)
        for s in range(shards.n_local_shards)])


def _plan_units(plan, rows: int):
    """(seg, unit) of every plan entry: its row, and the row it adds into
    (its row, or for a row cut into items ``rows`` + its item)."""
    dev = plan.offsets.device
    counts = torch.diff(plan.offsets)
    heavy = counts > plan.split
    seg = torch.repeat_interleave(
        torch.arange(counts.shape[0], device=dev), counts)
    unit = seg.clone()
    on_item = heavy[seg]
    pos = torch.arange(seg.shape[0], device=dev)[on_item]
    unit[on_item] = rows + torch.searchsorted(plan.item_begin, pos,
                                              right=True) - 1
    return seg, unit


def _item_owner(plan):
    return torch.repeat_interleave(plan.split_seg.long(),
                                   torch.diff(plan.split_first))


def frontier_pull_ref(plan, dist, sigma, levels):
    """The pull over ``plan`` (the in-edge plan of the COO edges, rows
    [0, plan.n_segments) of the state; later rows are zeros).

    A row of at most ``plan.split`` in-edges sums them in plan order; a
    longer row sums each item into a partial row, then the partials in
    item order.  On the CPU ``index_add_`` adds in index order, so this
    is the kernel's order of additions, and the two agree bit for bit on
    any sigma.
    """
    rows, batch = dist.shape
    _seg, unit = _plan_units(plan, rows)
    sums = torch.zeros((rows + plan.n_items, batch), dtype=torch.float32,
                       device=dist.device)
    chunk = max(1, _CHUNK_CELLS // max(batch, 1))
    for lo in range(0, unit.shape[0], chunk):
        s = plan.ids_sorted[lo: lo + chunk].long()
        vals = torch.where(dist[s] == levels[None, :], sigma[s], 0.0)
        sums.index_add_(0, unit[lo: lo + chunk], vals)
    out = sums[:rows]
    out.index_add_(0, _item_owner(plan), sums[rows:])
    return out


# ---------------------------------------------------------------------------
# The weighted lane: min-plus relaxation and the DAG count
# ---------------------------------------------------------------------------

def _relax(src, dst, weight, tent, active, rows: int):
    out = torch.full((rows, tent.shape[1]), float("inf"),
                     dtype=torch.float32, device=tent.device)
    chunk = max(1, _CHUNK_CELLS // max(tent.shape[1], 1))
    for lo in range(0, src.shape[0], chunk):
        s = src[lo: lo + chunk].long()
        vals = torch.where(active[s], tent[s] + weight[lo: lo + chunk, None],
                           float("inf"))
        d = dst[lo: lo + chunk].long()[:, None].expand_as(vals)
        out.scatter_reduce_(0, d, vals, reduce="amin")
    return out


def frontier_relax_batched_ref(src, dst, weight, tent, active):
    """One min-plus round over the COO edges: (E,) edges and weights
    against the (rows, B) float32 ``tent`` and bool ``active``; inactive
    and sink sources give +inf."""
    return _relax(src, dst, weight, tent, active, tent.shape[0])


def frontier_relax_sharded_ref(shard, tent, active):
    """One shard's (shard_rows, B) candidate tile from the gathered
    (v_pad, B) state, over the shard's view (global ``src``, local
    ``dst``, its bucketed ``weight``); padding slots land on a scratch
    row that is cut off."""
    return _relax(shard.src, shard.dst, shard.weight, tent, active,
                  shard.v_pad + 1)[: shard.v_pad]


def frontier_relax_sharded_level_ref(shards, tent, active):
    """Every held shard's candidate tile, stacked (n_local_shards,
    shard_rows, B)."""
    return torch.stack([frontier_relax_sharded_ref(shards.shard(s), tent,
                                                   active)
                        for s in range(shards.n_local_shards)])


def frontier_relax_pull_ref(rplan, tent, active, out_rows: int):
    """The relaxation over a relax plan: output row v < plan rows is the
    min over its in-edges in the plan, later rows +inf (min is exact, so
    any order gives the kernel's bits)."""
    plan = rplan.plan
    seg, _unit = _plan_units(plan, out_rows)
    out = _relax(plan.ids_sorted, seg, rplan.weight, tent, active,
                 out_rows + 1)
    return out[:out_rows]


def _dag(src, dst, weight, tent, tent_dst, sigma, final, rows: int):
    """(sums, waiting counts) over edges (src, dst) into ``rows`` output
    rows: sources index ``tent``/``sigma``/``final``, destinations
    ``tent_dst`` (clamped: a padding slot's sink source is never on the
    DAG, and its row is cut off)."""
    batch = tent.shape[1]
    dev = tent.device
    sums = torch.zeros((rows, batch), dtype=torch.float32, device=dev)
    waiting = torch.zeros((rows, batch), dtype=torch.int32, device=dev)
    chunk = max(1, _CHUNK_CELLS // max(batch, 1))
    top = tent_dst.shape[0] - 1
    for lo in range(0, src.shape[0], chunk):
        s = src[lo: lo + chunk].long()
        d = dst[lo: lo + chunk].long().clamp(max=min(top, rows - 1))
        t_u = tent[s]
        on = torch.isfinite(t_u) & (
            t_u + weight[lo: lo + chunk, None] == tent_dst[d])
        sums.index_add_(0, d, torch.where(on, sigma[s], 0.0))
        if final is not None:
            waiting.index_add_(0, d, (on & ~final[s]).to(torch.int32))
    return sums, waiting


def _finish_round(sums, waiting, final_dst):
    """A round's outputs with the final cells zeroed."""
    return (torch.where(final_dst, 0.0, sums),
            (waiting > 0) & ~final_dst)


def dag_sigma_batched_ref(src, dst, weight, tent, sigma):
    """One sweep of the DAG count over the COO edges (the JAX package's
    ``dag_sigma_batched_ref``): each row's sum of its on-DAG
    in-neighbours' sigma, in edge order."""
    return _dag(src, dst, weight, tent, tent, sigma, None, tent.shape[0])[0]


def dag_sigma_sharded_ref(shard, tent_global, sigma_global, tent_local):
    """One shard's sweep from the gathered state (the JAX package's
    ``dag_sigma_sharded_ref``): ``tent_local`` is the shard's own
    (shard_rows, B) rows, the destinations' side of the DAG test."""
    rows = shard.v_pad
    return _dag(shard.src, shard.dst, shard.weight, tent_global, tent_local,
                sigma_global, None, rows + 1)[0][:rows]


def dag_round_batched_ref(src, dst, weight, tent, sigma, final):
    """One round of the DAG count over the COO edges: ``(sums, waiting)``
    (rows, B), zero and False on the ``final`` cells."""
    sums, waiting = _dag(src, dst, weight, tent, tent, sigma, final,
                         tent.shape[0])
    return _finish_round(sums, waiting, final)


def dag_round_sharded_ref(shard, tent, sigma, final, row0: int = 0):
    """The round for one shard's view from the gathered (v_pad, B) state,
    its local row r being global row ``row0 + r``: ``(sums, waiting)``
    (shard_rows, B); padding slots land on a scratch row cut off."""
    rows = shard.v_pad
    sums, waiting = _dag(shard.src, shard.dst, shard.weight, tent,
                         tent[row0: row0 + rows], sigma, final, rows + 1)
    return _finish_round(sums[:rows], waiting[:rows],
                         final[row0: row0 + rows])


def dag_round_sharded_level_ref(shards, tent, sigma, final):
    """The round for every held shard from the gathered (v_pad, B) state:
    ``(sums, waiting)`` stacked (n_local_shards, shard_rows, B)."""
    got = [dag_round_sharded_ref(shards.shard(s), tent, sigma, final,
                                 (shards.first_shard + s) * shards.shard_rows)
           for s in range(shards.n_local_shards)]
    return (torch.stack([g[0] for g in got]),
            torch.stack([g[1] for g in got]))


def dag_sigma_pull_ref(rplan, tent, sigma, final, out_rows: int):
    """The round over a relax plan in the kernel's order of additions
    (as :func:`frontier_pull_ref`: a cut row's items, then their partial
    rows in item order); output row v is state row ``rplan.dst_offset +
    v``, rows past the plan's give 0 and False."""
    plan = rplan.plan
    off = rplan.dst_offset
    _seg, unit = _plan_units(plan, out_rows)
    # each unit's destination row: rows are their own, items their row's
    unit_dst = torch.arange(out_rows + plan.n_items, device=tent.device)
    unit_dst[out_rows:] = _item_owner(plan)
    batch = tent.shape[1]
    dev = tent.device
    sums = torch.zeros((out_rows + plan.n_items, batch), dtype=torch.float32,
                       device=dev)
    waiting = torch.zeros(sums.shape, dtype=torch.int32, device=dev)
    chunk = max(1, _CHUNK_CELLS // max(batch, 1))
    for lo in range(0, unit.shape[0], chunk):
        s = plan.ids_sorted[lo: lo + chunk].long()
        u = unit[lo: lo + chunk]
        t_u = tent[s]
        on = torch.isfinite(t_u) & (
            t_u + rplan.weight[lo: lo + chunk, None]
            == tent[unit_dst[u] + off])
        sums.index_add_(0, u, torch.where(on, sigma[s], 0.0))
        waiting.index_add_(0, u, (on & ~final[s]).to(torch.int32))
    owner = _item_owner(plan)
    out_s, out_w = sums[:out_rows], waiting[:out_rows]
    out_s.index_add_(0, owner, sums[out_rows:])
    out_w.index_add_(0, owner, waiting[out_rows:])
    return _finish_round(out_s, out_w, final[off: off + out_rows])


def frontier_words_ref(dist, levels):
    """(rows, ceil(B / 32)) int32: bit b % 32 of word b // 32 is set iff
    ``dist[v, b] == levels[b]`` (bit 31 makes a word negative)."""
    rows, batch = dist.shape
    n_words = -(-batch // 32)
    hit = torch.zeros((rows, n_words * 32), dtype=torch.int64,
                      device=dist.device)
    hit[:, :batch] = dist == levels[None, :]
    weight = torch.bitwise_left_shift(
        torch.ones(32, dtype=torch.int64, device=dist.device),
        torch.arange(32, device=dist.device))
    words = (hit.view(rows, n_words, 32) * weight).sum(dim=2)
    # keep the low 32 bits as a two's-complement int32
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(
        torch.int32)
