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
  ``frontier_expand_node_blocked_pallas``).

:func:`frontier_words` launches the words pass alone: the (rows, W)
frontier bit-words of a level and the zeroed (rows, B) output.  Besides
their launches the wrappers allocate with ``torch.empty`` and run no
other PyTorch op.  :func:`frontier_row_mask` and
:func:`frontier_block_bitmap` are the JAX package's helpers (its parity
tests and the sharded lane use them); no kernel path calls them.

On a CUDA tensor a wrapper launches its kernel or raises; it runs the
plain version in ``ref.py`` only because the tensor it was given lies on
the CPU.  Each launch adds one to ``launch_counts[<kernel>]``, a plain
int that a run resets and reads to show which kernels it went through:
a level adds one to its route's count and one to ``WORDS``.
"""
from __future__ import annotations

import ctypes
import dataclasses
from pathlib import Path

import torch

from .. import _build
from ..segsum.kernel import SegmentPlan, build_plan
from .ref import (frontier_expand_node_blocked_ref, frontier_pull_ref,
                  frontier_words_ref)

__all__ = ["FLAT", "NODE_BLOCKED", "PULL_SPLIT", "SOURCE", "WORDS",
           "build_pull_plan", "frontier_block_bitmap", "frontier_expand_flat",
           "frontier_expand_node_blocked", "frontier_row_mask",
           "frontier_words", "launch_counts", "library",
           "node_blocked_smem_bytes", "reset_launch_counts",
           "MAX_SMEM_BYTES"]

FLAT = "frontier_flat"
NODE_BLOCKED = "frontier_node_blocked"
WORDS = "frontier_words"
SOURCE = Path(__file__).resolve().parent / "csrc" / "frontier.cu"
# dynamic shared memory one block may use on an H100 (227 KB)
MAX_SMEM_BYTES = 232_448
# in-edges one lane group of the pull sums before a row is cut into items
PULL_SPLIT = 512

launch_counts = {FLAT: 0, NODE_BLOCKED: 0, WORDS: 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


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


def library() -> ctypes.CDLL:
    """The built frontier library (compiled with nvcc on first use)."""
    return _build.load("frontier", SOURCE, _declare)


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
    no per-edge weight, so the plan keeps no ``order``.  Raises unless
    every id lies in [0, rows) (one sync on the card); build it once per
    graph (``Graph.pull_plan``)."""
    plan = build_plan(src, dst, rows, rows, split=split, transpose=False)
    return dataclasses.replace(plan, order=None)


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


def _level_buffers(dist):
    """Uninitialised (rows, ceil(B / 32)) int32 words and (rows, B)
    float32 output on ``dist``'s device."""
    rows, batch = dist.shape
    return (torch.empty((rows, -(-batch // 32)), dtype=torch.int32,
                        device=dist.device),
            torch.empty((rows, batch), dtype=torch.float32,
                        device=dist.device))


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


def frontier_expand_node_blocked(csc, dist, sigma, levels):
    """One batched level over a CSC layout: the words pass, then
    ``frontier_nb_kernel``, which skips every edge block without a
    frontier source.

    ``dist``/``sigma`` are (V+1, B) or (csc.v_pad, B); the output keeps
    that row count.
    """
    levels = _levels(levels, dist.shape[1], dist.device)
    _check_state(dist, sigma, levels)
    if not dist.is_cuda:
        return frontier_expand_node_blocked_ref(csc, dist, sigma, levels)
    if csc.src.device != dist.device:
        raise ValueError("the CSC layout must live on the state's device")
    if dist.shape[0] < csc.n_nodes + 1:
        raise ValueError(f"state rows {dist.shape[0]} do not cover the "
                         f"sink row {csc.n_nodes}")
    smem = node_blocked_smem_bytes(csc.block_e)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"block_e={csc.block_e} stages {smem} bytes of "
                         f"shared memory, over the card's {MAX_SMEM_BYTES}")
    words, out = _level_buffers(dist)
    # one C call launches both kernels
    code = library().frontier_nb_launch(
        csc.src.data_ptr(), csc.dst.data_ptr(), csc.block_nb.data_ptr(),
        dist.data_ptr(), levels.data_ptr(), sigma.data_ptr(),
        words.data_ptr(), out.data_ptr(), dist.shape[0], csc.n_edge_blocks,
        csc.block_e, csc.block_v, dist.shape[1],
        _build.raw_stream(dist.device))
    _build.check(code, "frontier_words_kernel / frontier_nb_kernel launch")
    launch_counts[WORDS] += 1
    launch_counts[NODE_BLOCKED] += 1
    return out
