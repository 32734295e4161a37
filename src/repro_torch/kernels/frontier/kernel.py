"""Wrappers of the hand-written CUDA frontier kernels, plus the bitmap
helpers of the node-blocked route.

The kernels live in ``csrc/frontier.cu`` (the source note there says
which TPU kernel each replaces, what bounds it on the card and how the
design answers that bound).  Both routes run a level in one C call:

* :func:`frontier_expand_flat`: the words pass, then
  ``frontier_pull_kernel`` over a pull plan (:func:`build_pull_plan`,
  the in-edge lists of the COO edges with their hub rows cut into
  items), and ``frontier_pull_combine_kernel`` when a row was cut
  (replaces ``frontier_expand_batched_pallas``);
* :func:`frontier_expand_node_blocked`: the words pass, then
  ``frontier_nb_kernel`` over a ``CSCLayout``, which skips edge blocks
  without a frontier source by itself (replaces
  ``frontier_expand_node_blocked_pallas``); with ``wide_state=True`` it
  takes one vertex shard's layout and the gathered global state, and
  writes the shard's tile (the sharded lane's mode of the same TPU
  kernel, one call a shard as the reference makes it on each device);
* :func:`frontier_expand_sharded_level`: the same mode for every shard
  of a one-card mesh at once: one words pass over the gathered masked
  values, then one ``frontier_nb_kernel`` launch over the layout's real
  edge blocks (``ShardedCSCLayout.real_blocks``), into the
  (S, shard_rows, B) stack.

:func:`frontier_relax_pull` (W1) and :func:`dag_sigma_pull` (W2) are
the weighted lane's two pulls, in ``csrc/relax.cu`` (its own library):
one min-plus relaxation round and one round of the shortest-path-DAG
count, over a :class:`RelaxPlan` (:func:`build_relax_plan`, the in-edge
plan with the weights in plan order; :func:`build_sharded_relax_plan`
stacks the held shards' rows of a sharded layout over global sources).
They count under ``RELAX`` and ``DAG_SIGMA`` in
``weighted_launch_counts`` (reset with the others), one a round.

:func:`frontier_words` launches the words pass alone: the (rows, W)
frontier bit-words of a level and the zeroed (rows, B) output.  Besides
their launches the wrappers allocate with ``torch.empty`` and run no
other PyTorch op.  :func:`frontier_row_mask`,
:func:`frontier_block_bitmap`, :func:`frontier_source_block_bitmap` and
:func:`edge_bitmap_from_source_bits` are the JAX package's helpers (the
sharded lane's exchange schedule and the parity tests use them); no
kernel path calls them.

On a CUDA tensor a wrapper launches its kernel or raises; it runs the
plain version in ``ref.py`` only because the tensor it was given lies on
the CPU.  Each launch adds one to ``launch_counts[<kernel>]``, a plain
int that a run resets and reads to show which kernels it went through:
a level adds one to its route's count and one to ``WORDS``; a shard's
wide level, and a sharded level of all shards, count under
``NODE_BLOCKED_WIDE``.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import NamedTuple, Optional

import torch

from .. import _build
from ..segsum.kernel import SegmentPlan, build_plan
from .ref import (dag_sigma_pull_ref, frontier_expand_node_blocked_ref,
                  frontier_expand_sharded_level_ref,
                  frontier_expand_sharded_ref, frontier_pull_ref,
                  frontier_relax_pull_ref, frontier_words_ref)

__all__ = ["DAG_SIGMA", "FLAT", "NODE_BLOCKED", "NODE_BLOCKED_WIDE",
           "PULL_SPLIT", "RELAX", "RELAX_SOURCE", "RelaxPlan", "SOURCE",
           "WORDS", "build_pull_plan", "build_relax_plan",
           "build_sharded_relax_plan", "dag_sigma_pull",
           "edge_bitmap_from_source_bits", "frontier_block_bitmap",
           "frontier_expand_flat", "frontier_expand_node_blocked",
           "frontier_expand_sharded_level", "frontier_relax_pull",
           "frontier_row_mask", "frontier_source_block_bitmap",
           "frontier_words", "launch_counts", "library",
           "node_blocked_smem_bytes", "relax_library",
           "reset_launch_counts", "weighted_launch_counts",
           "MAX_SMEM_BYTES"]

FLAT = "frontier_flat"
NODE_BLOCKED = "frontier_node_blocked"
NODE_BLOCKED_WIDE = "frontier_node_blocked_wide"
WORDS = "frontier_words"
RELAX = "frontier_relax"
DAG_SIGMA = "dag_sigma"
SOURCE = Path(__file__).resolve().parent / "csrc" / "frontier.cu"
RELAX_SOURCE = Path(__file__).resolve().parent / "csrc" / "relax.cu"
# dynamic shared memory one block may use on an H100 (227 KB)
MAX_SMEM_BYTES = 232_448
# in-edges one lane group of the pull sums before a row is cut into items
PULL_SPLIT = 512

launch_counts = {FLAT: 0, NODE_BLOCKED: 0, NODE_BLOCKED_WIDE: 0, WORDS: 0}
# the weighted lane's kernels, counted apart from the BFS levels' routes
weighted_launch_counts = {RELAX: 0, DAG_SIGMA: 0}


def reset_launch_counts() -> None:
    for counts in (launch_counts, weighted_launch_counts):
        for k in counts:
            counts[k] = 0


def _declare(lib) -> None:
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.frontier_pull_launch.argtypes = [p, p, p, p, p, p, i64, i32, p, p,
                                         i64, i64, p, p, i64, p, p, i64, p]
    lib.frontier_pull_launch.restype = i32
    lib.frontier_words_launch.argtypes = [p, p, p, p, i64, i32, p]
    lib.frontier_words_launch.restype = i32
    lib.frontier_nb_launch.argtypes = [p, p, p, p, p, p, p, p, i64, i32,
                                       i32, i32, i32, p]
    lib.frontier_nb_launch.restype = i32
    lib.frontier_nb_wide_launch.argtypes = [p, p, p, p, p, p, p, p, i64,
                                            i64, i32, i32, i32, i32, p]
    lib.frontier_nb_wide_launch.restype = i32
    lib.frontier_nb_sharded_level_launch.argtypes = [
        p, p, p, p, i32, p, p, p, i64, i64, i32, i32, i32, i32, i32, p]
    lib.frontier_nb_sharded_level_launch.restype = i32


def library() -> ctypes.CDLL:
    """The built frontier library (compiled with nvcc on first use)."""
    return _build.load("frontier", SOURCE, _declare)


def _declare_relax(lib) -> None:
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.relax_pull_launch.argtypes = [p, p, p, p, p, i64, p, p, i64, p, p,
                                      p, p, i64, i64, i64, i32, p]
    lib.relax_pull_launch.restype = i32
    lib.dag_sigma_pull_launch.argtypes = [p, p, p, p, p, p, i64, p, p, i64,
                                          p, p, p, p, p, p, p, i64, i64, i64,
                                          i32, i64, p]
    lib.dag_sigma_pull_launch.restype = i32


def relax_library() -> ctypes.CDLL:
    """The built library of the weighted lane's two kernels (W1, W2),
    compiled with nvcc on first use."""
    return _build.load("relax", RELAX_SOURCE, _declare_relax)


def node_blocked_smem_bytes(block_e: int) -> int:
    """Shared memory of one node-blocked thread block: the edge block's
    staged source ids and destination ids (the sort's keys)."""
    return 2 * 4 * int(block_e)


def frontier_row_mask(dist, levels, active=None):
    """(rows,) bool: the row is on some sample's frontier this level.

    ``active`` (optional (B,) bool) drops finished samples, whose frozen
    level would otherwise keep their last frontier in the mask.
    """
    hit = dist == levels[None, :]
    if active is not None:
        hit = hit & active[None, :]
    return hit.any(dim=1)


def frontier_block_bitmap(csc, dist, levels):
    """(n_edge_blocks,) int32: 1 exactly on the edge blocks holding an
    edge whose source is on some sample's frontier."""
    hit = frontier_row_mask(dist, levels)[csc.src.long()]
    return (hit.view(csc.n_edge_blocks, csc.block_e).any(dim=1)
            .to(torch.int32))


def frontier_source_block_bitmap(dist, levels, block_rows: int,
                                 active=None):
    """(rows // block_rows,) int32: 1 iff the ``block_rows``-row block
    holds a frontier row (the sharded lane's exchange schedule, at the
    partition's chunk rows; ``rows`` a multiple of ``block_rows``)."""
    mask = frontier_row_mask(dist, levels, active)
    return mask.view(-1, block_rows).any(dim=1).to(torch.int32)


def edge_bitmap_from_source_bits(csc, src_bits, chunk_rows: int):
    """(n_edge_blocks,) int32 from per-source-chunk bits over the global
    rows: 1 when some source of the edge block lies in an active chunk (a
    superset of :func:`frontier_block_bitmap`)."""
    hit = src_bits[torch.div(csc.src.long(), chunk_rows,
                             rounding_mode="floor")]
    return hit.view(csc.n_edge_blocks, csc.block_e).amax(dim=1)


def _check_state(dist, sigma, levels):
    rows, batch = dist.shape
    if dist.dtype != torch.int32 or sigma.dtype != torch.float32:
        raise TypeError("dist must be int32 and sigma float32, got "
                        f"{dist.dtype} / {sigma.dtype}")
    if sigma.shape != dist.shape or levels.shape != (batch,):
        raise ValueError(f"shapes dist {tuple(dist.shape)}, sigma "
                         f"{tuple(sigma.shape)}, levels "
                         f"{tuple(levels.shape)} do not agree")
    if not (dist.is_contiguous() and sigma.is_contiguous()):
        raise ValueError("dist and sigma must be contiguous (rows, B)")
    for t in (sigma, levels):
        if t.device != dist.device:
            raise ValueError("dist, sigma and levels must share a device")


def _levels(levels, batch, device):
    return torch.as_tensor(levels, dtype=torch.int32,
                           device=device).reshape(batch).contiguous()


def build_pull_plan(src, dst, rows: int, *,
                    split: int = PULL_SPLIT) -> SegmentPlan:
    """The pull's plan of the COO edges (src, dst) over ``rows`` state
    rows: the gather-segment-sum kernel's segment plan with ids = src and
    seg = dst.  ``ids_sorted`` lists the sources in destination order (a
    stable sort: a row keeps its edges' COO order), ``offsets`` bounds
    each row's run, and each row of more than ``split`` in-edges is cut
    into items.  Nothing assumes the edges symmetric.  The pull gathers
    no per-edge weight and marks no hot source, so the plan keeps no
    ``order`` and its ``ids_sorted`` are the plain ids.  Raises unless
    every id lies in [0, rows) (one sync on the card); build it once per
    graph (``Graph.pull_plan``)."""
    return build_plan(src, dst, rows, rows, split=split, hot_rows=0,
                      keep_order=False, transpose=False)


def frontier_expand_flat(src, dst, dist, sigma, levels, plan=None):
    """One batched level over the COO edges: the words pass, then the
    pull over ``plan``, which must be ``build_pull_plan`` of these edges
    on the state's device over at most its rows (built here when None)."""
    levels = _levels(levels, dist.shape[1], dist.device)
    _check_state(dist, sigma, levels)
    rows, batch = dist.shape
    if plan is None:
        plan = build_pull_plan(src, dst, rows)
    elif plan.ids.data_ptr() != src.data_ptr() \
            or plan.seg.data_ptr() != dst.data_ptr() \
            or plan.n_entries != src.shape[0] or dst.shape != src.shape \
            or plan.ids_sorted.device != dist.device:
        raise ValueError("the pull plan was not built for these edges on "
                         "the state's device")
    elif plan.n_hot:
        # bit 31 of a hot-marked id would send the pull out of bounds
        raise ValueError("the pull plan marks hot sources; build it with "
                         "build_pull_plan (hot_rows=0)")
    if max(plan.n_segments, plan.n_rows) > rows:
        raise ValueError(f"the pull plan spans {plan.n_segments} rows, "
                         f"more than the state's {rows}")
    if not dist.is_cuda:
        return frontier_pull_ref(plan, dist, sigma, levels)
    words, out = _level_buffers(dist)
    partial = torch.empty((max(plan.n_items, 1), batch), dtype=torch.float32,
                          device=dist.device)
    # one C call launches the words pass, the pull and the combine
    code = library().frontier_pull_launch(
        dist.data_ptr(), levels.data_ptr(), sigma.data_ptr(),
        words.data_ptr(), out.data_ptr(), partial.data_ptr(), rows, batch,
        plan.offsets.data_ptr(), plan.ids_sorted.data_ptr(),
        plan.n_segments, plan.split, plan.item_begin.data_ptr(),
        plan.item_end.data_ptr(), plan.n_items, plan.split_seg.data_ptr(),
        plan.split_first.data_ptr(), plan.split_seg.shape[0],
        _build.raw_stream(dist.device))
    _build.check(code, "frontier_words_kernel / frontier_pull_kernel launch")
    launch_counts[WORDS] += 1
    launch_counts[FLAT] += 1
    return out


def _level_buffers(dist, out_rows=None):
    """Uninitialised (rows, ceil(B / 32)) int32 words and (out_rows, B)
    float32 output (``out_rows`` defaults to the state's rows) on
    ``dist``'s device."""
    rows, batch = dist.shape
    return (torch.empty((rows, -(-batch // 32)), dtype=torch.int32,
                        device=dist.device),
            torch.empty((rows if out_rows is None else out_rows, batch),
                        dtype=torch.float32, device=dist.device))


def frontier_words(dist, levels):
    """``(words, out)`` of one level (``frontier_words_kernel``): words
    (rows, ceil(B / 32)) int32, bit b % 32 of word b // 32 set iff
    ``dist[v, b] == levels[b]``, and ``out`` (rows, B) float32 zeros.
    ``dist`` and ``levels`` must be checked CUDA state, or lie on the
    CPU (plain version, no launch)."""
    if not dist.is_cuda:
        return (frontier_words_ref(dist, levels),
                torch.zeros(dist.shape, dtype=torch.float32))
    words, out = _level_buffers(dist)
    code = library().frontier_words_launch(
        dist.data_ptr(), levels.data_ptr(), words.data_ptr(), out.data_ptr(),
        dist.shape[0], dist.shape[1], _build.raw_stream(dist.device))
    _build.check(code, "frontier_words_kernel launch")
    launch_counts[WORDS] += 1
    return words, out


def frontier_expand_node_blocked(csc, dist, sigma, levels, *,
                                 wide_state: bool = False):
    """One batched level over a CSC layout: the words pass, then
    ``frontier_nb_kernel``, which skips every edge block without a
    frontier source.

    ``dist``/``sigma`` are (V+1, B) or (csc.v_pad, B); the output keeps
    that row count.  With ``wide_state=True``, ``csc`` is one shard's
    view (``ShardedCSCLayout.shard(s)``: global ``src``, local ``dst``)
    and ``dist``/``sigma`` the gathered state over at least the global
    rows its sources tile; the output is the shard's (csc.v_pad, B) tile.
    """
    levels = _levels(levels, dist.shape[1], dist.device)
    _check_state(dist, sigma, levels)
    rows = dist.shape[0]
    if wide_state:
        need = max(csc.v_pad, csc.n_src_blocks * csc.block_v)
        if rows < need:
            raise ValueError(f"wide_state expects >= {need} gathered rows, "
                             f"got {rows}")
    if not dist.is_cuda:
        if wide_state:
            return frontier_expand_sharded_ref(csc, dist, sigma, levels)
        return frontier_expand_node_blocked_ref(csc, dist, sigma, levels)
    if csc.src.device != dist.device:
        raise ValueError("the CSC layout must live on the state's device")
    if rows < csc.n_nodes + 1:
        raise ValueError(f"state rows {rows} do not cover the sink row "
                         f"{csc.n_nodes}")
    smem = node_blocked_smem_bytes(csc.block_e)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"block_e={csc.block_e} stages {smem} bytes of "
                         f"shared memory, over the card's {MAX_SMEM_BYTES}")
    words, out = _level_buffers(dist, csc.v_pad if wide_state else rows)
    ids = (csc.src.data_ptr(), csc.dst.data_ptr(), csc.block_nb.data_ptr(),
           dist.data_ptr(), levels.data_ptr(), sigma.data_ptr(),
           words.data_ptr(), out.data_ptr())
    stream = _build.raw_stream(dist.device)
    # one C call launches both kernels
    if wide_state:
        code = library().frontier_nb_wide_launch(
            *ids, rows, csc.v_pad, csc.n_edge_blocks, csc.block_e,
            csc.block_v, dist.shape[1], stream)
        _build.check(code, "frontier_words_kernel / frontier_nb_kernel "
                     "(wide_state) launch")
        launch_counts[NODE_BLOCKED_WIDE] += 1
    else:
        code = library().frontier_nb_launch(
            *ids, rows, csc.n_edge_blocks, csc.block_e, csc.block_v,
            dist.shape[1], stream)
        _build.check(code, "frontier_words_kernel / frontier_nb_kernel "
                     "launch")
        launch_counts[NODE_BLOCKED] += 1
    launch_counts[WORDS] += 1
    return out


def frontier_expand_sharded_level(shards, fvals, levels):
    """One BFS level of every shard held in ``shards`` (a
    ``ShardedCSCLayout``, whole or local) from the gathered masked
    frontier values: the (n_local_shards, shard_rows, B) stack of the
    held shards' tiles, each the sum over the shard's edges of
    ``fvals[src]`` where it is above +0.  The source ids are global, so
    a local layout (one process's shard) reads the same gathered rows.

    ``fvals`` is (>= v_pad, B) float32, the lane's gathered values (zero
    off the frontier); ``levels`` (B,) only shapes the plain version's
    synthesized dist (``where(fvals > 0, levels, -1)``), on which the
    result does not depend.  On the card: one C call, the words pass over
    ``fvals`` (which zeroes the stack), then ``frontier_nb_kernel`` over
    the layout's real edge blocks.
    """
    rows, batch = fvals.shape
    levels = _levels(levels, batch, fvals.device)
    if fvals.dtype != torch.float32:
        raise TypeError(f"fvals must be float32, got {fvals.dtype}")
    if rows < shards.v_pad:
        raise ValueError(f"the sharded level expects >= {shards.v_pad} "
                         f"gathered rows, got {rows}")
    if not fvals.is_cuda:
        return frontier_expand_sharded_level_ref(shards, fvals, levels)
    if shards.src.device != fvals.device:
        raise ValueError("the sharded layout must live on the state's "
                         "device")
    if not fvals.is_contiguous():
        raise ValueError("fvals must be contiguous (rows, B)")
    smem = node_blocked_smem_bytes(shards.block_e)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"block_e={shards.block_e} stages {smem} bytes of "
                         f"shared memory, over the card's {MAX_SMEM_BYTES}")
    real = shards.real_blocks()
    n_loc = shards.n_local_shards
    words, out = _level_buffers(fvals, n_loc * shards.shard_rows)
    # one C call launches both kernels; the stack's rows are the held
    # shards, so a block's tile index is local
    code = library().frontier_nb_sharded_level_launch(
        shards.src.data_ptr(), shards.dst.data_ptr(),
        shards.block_nb.data_ptr(), real.data_ptr(), real.shape[0],
        fvals.data_ptr(), words.data_ptr(), out.data_ptr(), rows,
        shards.shard_rows, n_loc, shards.n_edge_blocks,
        shards.block_e, shards.block_v, batch,
        _build.raw_stream(fvals.device))
    _build.check(code, "frontier_words_kernel / frontier_nb_kernel "
                 "(sharded level) launch")
    launch_counts[NODE_BLOCKED_WIDE] += 1
    launch_counts[WORDS] += 1
    return out.view(n_loc, shards.shard_rows, batch)


# ---------------------------------------------------------------------------
# The weighted lane: W1 (min-plus relaxation) and W2 (the DAG count)
# ---------------------------------------------------------------------------

class RelaxPlan(NamedTuple):
    """The weighted lane's plan: ``plan``, the in-edge plan (sources in
    destination order, the rows of more than ``split`` in-edges cut into
    items), the weights in plan order (``weight``), each item's output
    row (``item_row``), the weight tensor it was built from
    (``source_weight``, the cache key), ``dst_offset``, the state row of
    output row 0, and ``out_rows``, the rows a round writes (None: the
    state's rows)."""
    plan: SegmentPlan
    weight: torch.Tensor
    item_row: torch.Tensor
    source_weight: torch.Tensor
    dst_offset: int = 0
    out_rows: Optional[int] = None


def _relax_plan(ids, seg, w, n_segments: int, n_rows: int, source_weight,
                dst_offset: int, out_rows, split: int) -> RelaxPlan:
    plan = build_plan(ids, seg, n_segments, n_rows, split=split, hot_rows=0,
                      keep_order=True, transpose=False)
    item_row = torch.repeat_interleave(
        plan.split_seg, torch.diff(plan.split_first)).to(torch.int32)
    return RelaxPlan(plan, w.index_select(0, plan.order.long()).contiguous(),
                     item_row, source_weight, int(dst_offset), out_rows)


def build_relax_plan(src, dst, weight, rows: int, *,
                     split: int = PULL_SPLIT) -> RelaxPlan:
    """The relax plan of the COO edges (src, dst) with their ``weight``
    over ``rows`` state rows (a stable sort: a row keeps its edges' COO
    order, its sources ascending).  Raises unless every id lies in [0,
    rows) (one sync on the card); build it once per graph
    (``Graph.relax_plan``)."""
    if weight.shape != src.shape:
        raise ValueError(f"weight {tuple(weight.shape)} does not match the "
                         f"edges {tuple(src.shape)}")
    return _relax_plan(src, dst, weight.to(torch.float32), rows, rows,
                       weight, 0, None, split)


def build_sharded_relax_plan(shards, *, split: int = PULL_SPLIT
                             ) -> RelaxPlan:
    """The relax plan of every held shard of a weighted sharded layout:
    output row ``s * shard_rows + r`` is local row r of held shard s,
    state row ``first_shard * shard_rows`` + that row, and its in-edges
    are the shard's real slots (global sources, in bucketed order, which
    is ascending source order within a row)."""
    if shards.weight is None:
        raise ValueError("the sharded layout carries no weights")
    rows = shards.shard_rows
    n_loc = shards.n_local_shards
    real = shards.dst < rows
    seg = shards.dst + (torch.arange(n_loc, device=shards.dst.device)
                        * rows).to(torch.int32)[:, None]
    return _relax_plan(shards.src[real], seg[real], shards.weight[real],
                       n_loc * rows, shards.v_pad, shards.weight,
                       shards.first_shard * rows, n_loc * rows, split)


def _round_rows(rplan: RelaxPlan, tent) -> int:
    rows = tent.shape[0]
    out_rows = rows if rplan.out_rows is None else rplan.out_rows
    plan = rplan.plan
    if plan.n_rows > rows or plan.n_segments > out_rows \
            or rplan.dst_offset + out_rows > rows:
        raise ValueError(f"the relax plan ({plan.n_segments} rows from "
                         f"{plan.n_rows}, offset {rplan.dst_offset}) does "
                         f"not fit a state of {rows} rows")
    if plan.ids_sorted.device != tent.device:
        raise ValueError("the relax plan must live on the state's device")
    return out_rows


def _check_weighted(tent, *masks):
    if tent.dtype != torch.float32 or tent.dim() != 2:
        raise TypeError(f"tent must be (rows, B) float32, got {tent.dtype} "
                        f"{tuple(tent.shape)}")
    for m in masks:
        if m.dtype != torch.bool or m.shape != tent.shape:
            raise TypeError(f"masks must be bool {tuple(tent.shape)}, got "
                            f"{m.dtype} {tuple(m.shape)}")
        if m.device != tent.device:
            raise ValueError("the state's tensors must share a device")


def frontier_relax_pull(rplan: RelaxPlan, tent, active):
    """One relaxation round (W1) over ``rplan``: (out_rows, B) float32,
    row v the min over its in-edges (u -> v) with ``active[u]`` of
    ``tent[u] + w`` (+inf without one).  ``tent`` (rows, B) float32 and
    ``active`` (rows, B) bool cover the plan's source rows."""
    _check_weighted(tent, active)
    out_rows = _round_rows(rplan, tent)
    if not tent.is_cuda:
        return frontier_relax_pull_ref(rplan, tent, active, out_rows)
    tent, active = tent.contiguous(), active.contiguous()
    plan = rplan.plan
    batch = tent.shape[1]
    out = torch.empty((out_rows, batch), dtype=torch.float32,
                      device=tent.device)
    partial = torch.empty((max(plan.n_items, 1), batch), dtype=torch.float32,
                          device=tent.device)
    code = relax_library().relax_pull_launch(
        plan.offsets.data_ptr(), plan.ids_sorted.data_ptr(),
        rplan.weight.data_ptr(), plan.item_begin.data_ptr(),
        plan.item_end.data_ptr(), plan.n_items, plan.split_seg.data_ptr(),
        plan.split_first.data_ptr(), plan.split_seg.shape[0],
        tent.data_ptr(), active.data_ptr(), out.data_ptr(),
        partial.data_ptr(), out_rows, plan.n_segments, plan.split, batch,
        _build.raw_stream(tent.device))
    _build.check(code, "relax_pull_kernel launch")
    weighted_launch_counts[RELAX] += 1
    return out


def dag_sigma_pull(rplan: RelaxPlan, tent, sigma, final):
    """One round of the DAG count (W2) over ``rplan``: ``(sums,
    waiting)``, (out_rows, B) float32 and bool.  For a cell (v, b) not
    ``final`` at its state row ``dst_offset + v``: the sum of
    ``sigma[u, b]`` over the in-edges on the DAG (``tent[u]`` finite and
    ``tent[u] + w == tent[v]``), in plan order, and whether one of those
    u is not final; 0 and False on a final cell."""
    _check_weighted(tent, final)
    if sigma.dtype != torch.float32 or sigma.shape != tent.shape:
        raise TypeError("sigma must be float32 of tent's shape")
    out_rows = _round_rows(rplan, tent)
    if not tent.is_cuda:
        return dag_sigma_pull_ref(rplan, tent, sigma, final, out_rows)
    tent, sigma = tent.contiguous(), sigma.contiguous()
    final = final.contiguous()
    plan = rplan.plan
    batch = tent.shape[1]
    dev = tent.device
    sums = torch.empty((out_rows, batch), dtype=torch.float32, device=dev)
    waiting = torch.empty((out_rows, batch), dtype=torch.bool, device=dev)
    n_part = max(plan.n_items, 1)
    psums = torch.empty((n_part, batch), dtype=torch.float32, device=dev)
    pwait = torch.empty((n_part, batch), dtype=torch.bool, device=dev)
    code = relax_library().dag_sigma_pull_launch(
        plan.offsets.data_ptr(), plan.ids_sorted.data_ptr(),
        rplan.weight.data_ptr(), plan.item_begin.data_ptr(),
        plan.item_end.data_ptr(), rplan.item_row.data_ptr(), plan.n_items,
        plan.split_seg.data_ptr(), plan.split_first.data_ptr(),
        plan.split_seg.shape[0], tent.data_ptr(), sigma.data_ptr(),
        final.data_ptr(), sums.data_ptr(), waiting.data_ptr(),
        psums.data_ptr(), pwait.data_ptr(), out_rows, plan.n_segments,
        plan.split, batch, rplan.dst_offset, _build.raw_stream(dev))
    _build.check(code, "dag_sigma_pull_kernel launch")
    weighted_launch_counts[DAG_SIGMA] += 1
    return sums, waiting
