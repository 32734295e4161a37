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
"""
from __future__ import annotations

import torch

__all__ = ["frontier_expand_batched_ref", "frontier_expand_node_blocked_ref",
           "frontier_expand_sharded_level_ref",
           "frontier_expand_sharded_ref", "frontier_pull_ref",
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
    dev = dist.device
    counts = torch.diff(plan.offsets)
    heavy = counts > plan.split
    n_seg = counts.shape[0]
    seg = torch.repeat_interleave(torch.arange(n_seg, device=dev), counts)
    # each entry's unit: its row, or for a split row rows + its item
    unit = seg.clone()
    on_item = heavy[seg]
    pos = torch.arange(seg.shape[0], device=dev)[on_item]
    unit[on_item] = rows + torch.searchsorted(plan.item_begin, pos,
                                              right=True) - 1
    sums = torch.zeros((rows + plan.n_items, batch), dtype=torch.float32,
                       device=dev)
    chunk = max(1, _CHUNK_CELLS // max(batch, 1))
    for lo in range(0, seg.shape[0], chunk):
        s = plan.ids_sorted[lo: lo + chunk].long()
        vals = torch.where(dist[s] == levels[None, :], sigma[s], 0.0)
        sums.index_add_(0, unit[lo: lo + chunk], vals)
    out = sums[:rows]
    owner = torch.repeat_interleave(plan.split_seg.long(),
                                    torch.diff(plan.split_first))
    out.index_add_(0, owner, sums[rows:])
    return out


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
