"""Wrapper of the hand-written CUDA gather-segment-sum kernel (K4), and
the segment plan it reads.

The kernel lives in ``csrc/segsum.cu`` (its source note says which TPU
kernel it replaces, what bounds it on the card and how the design
answers that bound).  It reads the entries in segment order, so it needs
a :class:`SegmentPlan`: the stable sort of ``seg``, the segment offsets,
and the cut of every segment longer than ``split`` entries into items.
A plan is PyTorch preprocessing, built once per (ids, seg) pair and
cached by the caller (``GraphBatch`` keeps the plans of its edges); its
``transpose`` is the plan of (seg, ids), which the gradient uses.

:func:`gather_segment_sum_cuda` launches the kernel on CUDA tensors; on
CPU tensors it runs the plain version in ``ref.py``, and only because
the tensors lie on the CPU.  Each launch adds one to
``launch_counts["gather_segment_sum"]``.
"""
from __future__ import annotations

import ctypes
import dataclasses
from pathlib import Path
from typing import Optional

import torch

from .. import _build
from .ref import gather_segment_sum_ref

__all__ = ["SEGSUM", "SOURCE", "SPLIT", "SegmentPlan", "build_plan",
           "check_ranges", "gather_segment_sum_cuda", "launch_counts",
           "library", "reset_launch_counts"]

SEGSUM = "gather_segment_sum"
SOURCE = Path(__file__).resolve().parent / "csrc" / "segsum.cu"
# entries one warp sums before a segment is cut into items
SPLIT = 512
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launch_counts = {SEGSUM: 0}


def reset_launch_counts() -> None:
    launch_counts[SEGSUM] = 0


@dataclasses.dataclass(frozen=True)
class SegmentPlan:
    """The entries of (ids, seg) in segment order, for ``n_segments``
    output rows gathered from a table of ``n_rows`` rows.

    ``order`` is the stable sort of ``seg`` (entries of one segment keep
    their input order; None in a plan that gathers no per-entry weights,
    as the frontier pull's), ``ids_sorted = ids[order]`` and segment s owns
    sorted entries ``offsets[s] .. offsets[s+1] - 1``.  Segments with
    more than ``split`` entries are listed in ``split_seg``; their
    entries are cut into items ``item_begin[h] .. item_end[h] - 1`` of at
    most ``split`` entries, and segment ``split_seg[q]`` owns items
    ``split_first[q] .. split_first[q+1] - 1``.
    """

    n_segments: int
    n_rows: int
    split: int
    ids: torch.Tensor          # (N,) the ids the plan was built from
    seg: torch.Tensor          # (N,) the segments it was built from
    order: Optional[torch.Tensor]  # (N,) int64, or None
    ids_sorted: torch.Tensor   # (N,) int32
    offsets: torch.Tensor      # (S+1,) int64
    item_begin: torch.Tensor   # (H,) int64
    item_end: torch.Tensor     # (H,) int64
    split_seg: torch.Tensor    # (Q,) int32
    split_first: torch.Tensor  # (Q+1,) int64
    transpose: Optional["SegmentPlan"] = None

    @property
    def n_entries(self) -> int:
        return int(self.ids_sorted.shape[0])

    @property
    def n_items(self) -> int:
        return int(self.item_begin.shape[0])


def check_ranges(ids, seg, n_rows: int, n_segments: int) -> None:
    """Raise unless ids lie in [0, n_rows) and seg in [0, n_segments)
    (one device sync on CUDA tensors)."""
    if ids.shape != seg.shape or ids.dim() != 1:
        raise ValueError(f"ids and seg must be one (N,) shape, got "
                         f"{tuple(ids.shape)} and {tuple(seg.shape)}")
    if ids.numel() == 0:
        return
    lo_i, hi_i = torch.aminmax(ids)
    lo_s, hi_s = torch.aminmax(seg)
    bounds = torch.stack([lo_i, hi_i, lo_s, hi_s]).tolist()
    if bounds[0] < 0 or bounds[1] >= n_rows:
        raise ValueError(f"ids span [{bounds[0]}, {bounds[1]}], outside the "
                         f"table's rows [0, {n_rows})")
    if bounds[2] < 0 or bounds[3] >= n_segments:
        raise ValueError(f"seg spans [{bounds[2]}, {bounds[3]}], outside "
                         f"[0, {n_segments})")


def _one_plan(ids, seg, n_segments: int, n_rows: int,
              split: int) -> SegmentPlan:
    dev = seg.device
    seg64 = seg.long()
    order = torch.sort(seg64, stable=True).indices
    counts = torch.bincount(seg64, minlength=n_segments)
    offsets = torch.zeros(n_segments + 1, dtype=torch.int64, device=dev)
    offsets[1:] = torch.cumsum(counts, 0)
    heavy = torch.nonzero(counts > split).squeeze(1)
    n_chunks = (counts[heavy] + split - 1) // split
    split_first = torch.zeros(heavy.shape[0] + 1, dtype=torch.int64,
                              device=dev)
    split_first[1:] = torch.cumsum(n_chunks, 0)
    owner = torch.repeat_interleave(
        torch.arange(heavy.shape[0], device=dev), n_chunks)
    k = torch.arange(owner.shape[0], device=dev) - split_first[owner]
    item_begin = offsets[heavy][owner] + k * split
    item_end = torch.minimum(item_begin + split, offsets[heavy + 1][owner])
    return SegmentPlan(
        n_segments=int(n_segments), n_rows=int(n_rows), split=int(split),
        ids=ids, seg=seg, order=order,
        ids_sorted=ids.index_select(0, order).to(torch.int32),
        offsets=offsets, item_begin=item_begin, item_end=item_end,
        split_seg=heavy.to(torch.int32), split_first=split_first)


def build_plan(ids, seg, n_segments: int, n_rows: int, *,
               split: int = SPLIT, transpose: bool = True) -> SegmentPlan:
    """The plan of (ids, seg) and, as its ``transpose`` (unless
    ``transpose=False``), that of (seg, ids).  Checks the index ranges
    once (one sync on the card)."""
    if split < 1:
        raise ValueError(f"split must be >= 1, got {split}")
    check_ranges(ids, seg, n_rows, n_segments)
    plan = _one_plan(ids, seg, n_segments, n_rows, split)
    if not transpose:
        return plan
    return dataclasses.replace(
        plan, transpose=_one_plan(seg, ids, n_rows, n_segments, split))


def _declare(lib) -> None:
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.segsum_launch.argtypes = [p, p, p, p, p, p, i32, i32, i32, i64, i64,
                                  p, p, i64, p, p, i64, p, p]
    lib.segsum_launch.restype = i32


def library() -> ctypes.CDLL:
    """The built gather-segment-sum library (compiled with nvcc on first
    use)."""
    return _build.load("segsum", SOURCE, _declare)


def _vec_width(table, out) -> int:
    """4 columns a lane when every row starts on a 4-element boundary."""
    align = 4 * table.element_size()
    if table.shape[1] % 4 == 0 and table.data_ptr() % align == 0 \
            and out.data_ptr() % align == 0:
        return 4
    return 1


def gather_segment_sum_cuda(ids, seg, w, table, n_segments: int,
                            plan: SegmentPlan):
    """``out[s] = sum_{seg[i]=s} w[i] table[ids[i]]`` (S, D) in
    ``table.dtype``, one kernel call (two launches when a segment is
    split; one count).  ``plan`` must be the plan of these ``ids`` and
    ``seg``."""
    if not table.is_cuda:
        return gather_segment_sum_ref(ids, seg, w, table, n_segments)
    if table.dtype not in _DTYPES or table.dim() != 2 \
            or not table.is_contiguous():
        raise ValueError("table must be a contiguous (V1, D) float32 or "
                         f"bfloat16 tensor, got {table.dtype} "
                         f"{tuple(table.shape)}")
    n = ids.shape[0]
    if w.dtype != torch.float32 or w.shape != (n,) or not w.is_contiguous() \
            or w.device != table.device:
        raise ValueError("w must be a contiguous (N,) float32 tensor on the "
                         "table's device")
    if plan.n_entries != n or plan.n_segments != n_segments \
            or plan.n_rows != table.shape[0] \
            or plan.ids.data_ptr() != ids.data_ptr() \
            or plan.seg.data_ptr() != seg.data_ptr() \
            or plan.order is None or plan.order.device != table.device:
        raise ValueError("the plan was not built for these ids, seg, "
                         "n_segments and table rows on this device")
    d = table.shape[1]
    out = torch.empty((n_segments, d), dtype=table.dtype,
                      device=table.device)
    if n_segments == 0 or d == 0:
        return out
    scratch = torch.empty((max(plan.n_items, 1), d), dtype=torch.float32,
                          device=table.device)
    stream = torch.cuda.current_stream(table.device).cuda_stream
    code = library().segsum_launch(
        plan.offsets.data_ptr(), plan.ids_sorted.data_ptr(),
        plan.order.data_ptr(), w.data_ptr(), table.data_ptr(),
        out.data_ptr(), _DTYPES[table.dtype], d, _vec_width(table, out),
        n_segments, plan.split, plan.item_begin.data_ptr(),
        plan.item_end.data_ptr(), plan.n_items, plan.split_seg.data_ptr(),
        plan.split_first.data_ptr(), plan.split_seg.shape[0],
        scratch.data_ptr(), stream)
    _build.check(code, "gather_segment_sum kernel launch")
    launch_counts[SEGSUM] += 1
    return out
