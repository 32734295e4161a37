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

The plan also ranks the sources: ``hot`` lists the ``HOT_ROWS`` ids with
the most entries (most first, ties by id), and bit 31 of a plan id marks
an entry of one of them.  The kernel reads those rows under an L2
``evict_last`` policy, so the colder rows streaming through L2 do not
evict them; the mark changes which cache keeps a row, never the sum.
The kernel reads the weights in plan order: the plan keeps ``w[order]``
for the weight tensor it last saw (:meth:`SegmentPlan.weights_in_order`),
recomputed when another tensor comes or the same one was changed in
place (its ``_version``).  A write that bypasses the version counter
(through ``w.data``, DLPack or NumPy sharing its memory, a raw pointer)
goes unseen: change ``w`` only by ops that autograd tracks, or pass a
new tensor.

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

__all__ = ["HOT_MARK", "HOT_ROWS", "SEGSUM", "SOURCE", "SPLIT",
           "SegmentPlan", "build_plan", "check_ranges",
           "gather_segment_sum_cuda", "launch_counts", "library",
           "reset_launch_counts"]

SEGSUM = "gather_segment_sum"
SOURCE = Path(__file__).resolve().parent / "csrc" / "segsum.cu"
# entries one warp sums before a segment is cut into items
SPLIT = 512
# the hot tier: the sources of most entries, whose rows the kernel keeps
# in L2: 8 MB of 512-byte rows (128 float32 columns).  At GraphSAGE's
# layer call tools/segsum_probe.py measured 8 MB the best of 4 to 40 MB,
# each faster than no tier
HOT_ROWS = 1 << 14
HOT_MARK = -(1 << 31)   # bit 31 of an int32 plan id
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launch_counts = {SEGSUM: 0}


def reset_launch_counts() -> None:
    launch_counts[SEGSUM] = 0


@dataclasses.dataclass(frozen=True)
class SegmentPlan:
    """The entries of (ids, seg) in segment order, for ``n_segments``
    output rows gathered from a table of ``n_rows`` rows.

    ``order`` is the stable sort of ``seg`` as int32 (entries of one
    segment keep their input order; None in a plan built with
    ``keep_order=False``, which gathers no per-entry weights, as the
    frontier pull's), and segment s owns
    sorted entries ``offsets[s] .. offsets[s+1] - 1``.  ``ids_sorted`` is
    ``ids[order]`` as int32, with bit 31 set on the entries whose id is
    in ``hot``: the ids of the ``len(hot)`` sources with the most entries
    (most first, ties by id; empty in a plan built with ``hot_rows=0``,
    whose ``ids_sorted`` are the plain ids).  Segments with more than
    ``split`` entries are listed in ``split_seg``; their entries are cut
    into items ``item_begin[h] .. item_end[h] - 1`` of at most ``split``
    entries, and segment ``split_seg[q]`` owns items ``split_first[q] ..
    split_first[q+1] - 1``.
    """

    n_segments: int
    n_rows: int
    split: int
    ids: torch.Tensor          # (N,) the ids the plan was built from
    seg: torch.Tensor          # (N,) the segments it was built from
    order: Optional[torch.Tensor]  # (N,) int32, or None
    ids_sorted: torch.Tensor   # (N,) int32, bit 31 marks a hot source
    offsets: torch.Tensor      # (S+1,) int64
    item_begin: torch.Tensor   # (H,) int64
    item_end: torch.Tensor     # (H,) int64
    split_seg: torch.Tensor    # (Q,) int32
    split_first: torch.Tensor  # (Q+1,) int64
    hot: torch.Tensor          # (n_hot,) int32
    transpose: Optional["SegmentPlan"] = None
    # the weights in plan order for one weight tensor: (w, its _version,
    # w[order]); a new plan (dataclasses.replace too) starts empty
    _w_sorted: list = dataclasses.field(
        default_factory=list, init=False, repr=False, compare=False)

    @property
    def n_entries(self) -> int:
        return int(self.ids_sorted.shape[0])

    @property
    def n_items(self) -> int:
        return int(self.item_begin.shape[0])

    @property
    def n_hot(self) -> int:
        return int(self.hot.shape[0])

    def sorted_ids(self) -> torch.Tensor:
        """``ids[order]`` (int32, the hot mark cleared)."""
        return self.ids_sorted & ~HOT_MARK

    def weights_in_order(self, w) -> torch.Tensor:
        """``w[order]``, computed once for the weight tensor ``w`` and
        kept until another tensor comes or ``w._version`` moves (an
        in-place op that autograd tracks; a write around the version
        counter goes unseen)."""
        if self.order is None:
            raise ValueError("this plan keeps no order to permute weights")
        if w.is_inference():    # no version counter: nothing to key on
            return w.index_select(0, self.order)
        held = self._w_sorted
        if not held or held[0] is not w or held[1] != w._version:
            held[:] = [w, w._version, w.index_select(0, self.order)]
        return held[2]


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


def _hot_sources(ids, n_rows: int, hot_rows: int) -> torch.Tensor:
    """The ``hot_rows`` ids with the most entries in ``ids`` (most first,
    ties by id), as int32."""
    counts = torch.bincount(ids.long(), minlength=n_rows)
    ranked = torch.sort(counts, descending=True, stable=True).indices
    return ranked[:min(hot_rows, n_rows)].to(torch.int32)


def _one_plan(ids, seg, n_segments: int, n_rows: int, split: int,
              hot_rows: int, keep_order: bool) -> SegmentPlan:
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
    ids_sorted = ids.index_select(0, order).to(torch.int32)
    hot = _hot_sources(ids, n_rows, hot_rows)
    if hot.numel():
        is_hot = torch.zeros(n_rows, dtype=torch.bool, device=dev)
        is_hot[hot.long()] = True
        ids_sorted = torch.where(is_hot[ids_sorted.long()],
                                 ids_sorted | HOT_MARK, ids_sorted)
    return SegmentPlan(
        n_segments=int(n_segments), n_rows=int(n_rows), split=int(split),
        ids=ids, seg=seg,
        order=order.to(torch.int32) if keep_order else None,
        ids_sorted=ids_sorted,
        offsets=offsets, item_begin=item_begin, item_end=item_end,
        split_seg=heavy.to(torch.int32), split_first=split_first, hot=hot)


def build_plan(ids, seg, n_segments: int, n_rows: int, *,
               split: int = SPLIT, hot_rows: int = HOT_ROWS,
               keep_order: bool = True,
               transpose: bool = True) -> SegmentPlan:
    """The plan of (ids, seg) and, as its ``transpose`` (unless
    ``transpose=False``), that of (seg, ids); each marks its
    ``hot_rows`` hottest sources and, unless ``keep_order=False``, keeps
    its int32 ``order`` (fewer than 2^31 entries).  Checks the index
    ranges once (one sync on the card)."""
    if split < 1:
        raise ValueError(f"split must be >= 1, got {split}")
    if hot_rows < 0:
        raise ValueError(f"hot_rows must be >= 0, got {hot_rows}")
    if max(n_rows, n_segments) >= 1 << 31:
        raise ValueError("a plan takes fewer than 2^31 rows and segments "
                         "(int32 ids)")
    if keep_order and ids.shape[0] >= 1 << 31:
        raise ValueError("a plan that keeps its int32 order takes fewer "
                         "than 2^31 entries")
    check_ranges(ids, seg, n_rows, n_segments)
    plan = _one_plan(ids, seg, n_segments, n_rows, split, hot_rows,
                     keep_order)
    if not transpose:
        return plan
    return dataclasses.replace(
        plan, transpose=_one_plan(seg, ids, n_rows, n_segments, split,
                                  hot_rows, keep_order))


def _declare(lib) -> None:
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.segsum_launch.argtypes = [p, p, p, p, p, i32, i32, i32, i64, i64, p,
                                  p, i64, p, p, i64, p, p]
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
    ``seg``; it keeps ``w`` in plan order for the next call, so change
    ``w`` only by ops that bump its version counter (in-place ops that
    autograd tracks, not writes through ``w.data`` or shared memory), or
    pass a new tensor."""
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
    w_sorted = plan.weights_in_order(w)
    scratch = torch.empty((max(plan.n_items, 1), d), dtype=torch.float32,
                          device=table.device)
    code = library().segsum_launch(
        plan.offsets.data_ptr(), plan.ids_sorted.data_ptr(),
        w_sorted.data_ptr(), table.data_ptr(), out.data_ptr(),
        _DTYPES[table.dtype], d, _vec_width(table, out), n_segments,
        plan.split, plan.item_begin.data_ptr(), plan.item_end.data_ptr(),
        plan.n_items, plan.split_seg.data_ptr(), plan.split_first.data_ptr(),
        plan.split_seg.shape[0], scratch.data_ptr(),
        _build.raw_stream(table.device))
    _build.check(code, "gather_segment_sum kernel launch")
    launch_counts[SEGSUM] += 1
    return out
