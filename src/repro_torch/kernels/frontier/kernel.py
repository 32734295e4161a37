"""Wrappers of the hand-written CUDA frontier kernels, plus the bitmap
helpers of the node-blocked route.

The kernels live in ``csrc/frontier.cu`` (the source note there says
which TPU kernel each replaces, what bounds it on the card and how the
design answers that bound):

* :func:`frontier_expand_flat` launches ``frontier_flat_kernel`` over
  the COO edge list (replaces ``frontier_expand_batched_pallas``);
* :func:`frontier_expand_node_blocked` launches ``frontier_nb_kernel``
  over a ``CSCLayout``, skipping edge blocks without a frontier source
  (replaces ``frontier_expand_node_blocked_pallas``).

On a CUDA tensor a wrapper launches its kernel or raises; it runs the
plain version in ``ref.py`` only because the tensor it was given lies on
the CPU.  Each launch adds one to ``launch_counts[<kernel>]``, a plain
int that a run resets and reads to show which kernels it went through.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .. import _build
from .ref import frontier_expand_batched_ref, frontier_expand_node_blocked_ref

__all__ = ["FLAT", "NODE_BLOCKED", "SOURCE", "frontier_block_bitmap",
           "frontier_expand_flat", "frontier_expand_node_blocked",
           "frontier_row_mask", "launch_counts", "library",
           "node_blocked_smem_bytes", "reset_launch_counts",
           "MAX_SMEM_BYTES"]

FLAT = "frontier_flat"
NODE_BLOCKED = "frontier_node_blocked"
SOURCE = Path(__file__).resolve().parent / "csrc" / "frontier.cu"
# dynamic shared memory one block may use on an H100 (227 KB)
MAX_SMEM_BYTES = 232_448

launch_counts = {FLAT: 0, NODE_BLOCKED: 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _declare(lib) -> None:
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.frontier_flat_launch.argtypes = [p, p, p, p, p, p, i64, i32, p]
    lib.frontier_flat_launch.restype = i32
    lib.frontier_nb_launch.argtypes = [p, p, p, p, p, p, p, i32, i32, i32, p]
    lib.frontier_nb_launch.restype = i32


def library() -> ctypes.CDLL:
    """The built frontier library (compiled with nvcc on first use)."""
    return _build.load("frontier", SOURCE, _declare)


def node_blocked_smem_bytes(block_e: int) -> int:
    """Shared memory of one node-blocked thread block: the edge block's
    staged source and destination ids."""
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


def frontier_expand_flat(src, dst, dist, sigma, levels):
    """One batched level over the COO edges (``frontier_flat_kernel``)."""
    levels = _levels(levels, dist.shape[1], dist.device)
    _check_state(dist, sigma, levels)
    if not dist.is_cuda:
        return frontier_expand_batched_ref(src, dst, dist, sigma, levels)
    for t in (src, dst):
        if t.dtype != torch.int32 or not t.is_contiguous() \
                or t.device != dist.device:
            raise ValueError("src/dst must be contiguous int32 on the "
                             "state's device")
    out = torch.zeros(dist.shape, dtype=torch.float32, device=dist.device)
    code = library().frontier_flat_launch(
        src.data_ptr(), dst.data_ptr(), dist.data_ptr(), sigma.data_ptr(),
        levels.data_ptr(), out.data_ptr(), int(src.shape[0]),
        int(dist.shape[1]), torch.cuda.current_stream(dist.device).cuda_stream)
    _build.check(code, "frontier_flat_kernel launch")
    launch_counts[FLAT] += 1
    return out


def frontier_expand_node_blocked(csc, dist, sigma, levels):
    """One batched level over a CSC layout (``frontier_nb_kernel``).

    ``dist``/``sigma`` are (V+1, B) or (csc.v_pad, B); the output keeps
    that row count.  Edge blocks outside :func:`frontier_block_bitmap`
    are skipped.
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
    return _launch_node_blocked(csc, dist, sigma, levels,
                                frontier_block_bitmap(csc, dist, levels))


def _launch_node_blocked(csc, dist, sigma, levels, block_active):
    """Launch ``frontier_nb_kernel`` on checked CUDA state; any superset
    of the exact bitmap gives the same result."""
    block_active = block_active.to(torch.int32).contiguous()
    out = torch.zeros(dist.shape, dtype=torch.float32, device=dist.device)
    code = library().frontier_nb_launch(
        csc.src.data_ptr(), csc.dst.data_ptr(), block_active.data_ptr(),
        dist.data_ptr(), sigma.data_ptr(), levels.data_ptr(), out.data_ptr(),
        int(csc.n_edge_blocks), int(csc.block_e), int(dist.shape[1]),
        torch.cuda.current_stream(dist.device).cuda_stream)
    _build.check(code, "frontier_nb_kernel launch")
    launch_counts[NODE_BLOCKED] += 1
    return out
