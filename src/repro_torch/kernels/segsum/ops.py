"""Dispatch of the fused gather + segment sum, with its gradient
(``repro.kernels.segsum.ops``).

:func:`gather_segment_sum` routes to the CUDA kernel K4 for a CUDA table
and to the plain version for a CPU table, as the JAX
``gather_segment_sum(..., use_pallas=)`` selects its backend.
``use_kernel=True`` on a CPU table raises; ``use_kernel=False`` runs the
plain version on either device (the card's reference route).  Nothing
falls back quietly.

The JAX package's ``pallas_supported`` (250K table rows, 4096 segments)
is a VMEM fit limit of the TPU kernel.  K4 keeps neither the table nor
the output on chip, so it has no such limit and no counterpart here.

Gradient: ``d table = gather_segment_sum(seg, ids, w, d out, V1)``, the
same function with ids and seg exchanged, through the same route (the
kernel reads the plan's ``transpose``).  ``w`` takes no gradient: a call
with ``w.requires_grad`` raises.
"""
from __future__ import annotations

import torch

from .kernel import (SegmentPlan, build_plan, check_ranges,
                     gather_segment_sum_cuda)
from .ref import gather_segment_sum_ref

__all__ = ["gather_segment_sum"]


def _route(table, use_kernel) -> bool:
    if use_kernel is None:
        return table.is_cuda
    if use_kernel and not table.is_cuda:
        raise ValueError("the gather-segment-sum kernel is a CUDA kernel but "
                         "the table lies on the CPU; use use_kernel=None or "
                         "False")
    return bool(use_kernel)


def _apply(ids, seg, w, table, n_segments: int, plan, use_kernel: bool):
    if use_kernel:
        return gather_segment_sum_cuda(ids, seg, w, table, n_segments, plan)
    return gather_segment_sum_ref(ids, seg, w, table, n_segments)


class _GatherSegmentSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, ids, seg, w, n_segments, plan, use_kernel):
        ctx.save_for_backward(ids, seg, w)
        ctx.plan, ctx.use_kernel = plan, use_kernel
        ctx.n_rows = table.shape[0]
        return _apply(ids, seg, w, table, n_segments, plan, use_kernel)

    @staticmethod
    def backward(ctx, d_out):
        ids, seg, w = ctx.saved_tensors
        plan_t = None if ctx.plan is None else ctx.plan.transpose
        d_table = _apply(seg, ids, w, d_out.contiguous(), ctx.n_rows, plan_t,
                         ctx.use_kernel)
        return d_table, None, None, None, None, None, None


def gather_segment_sum(ids, seg, w, table, n_segments: int, *,
                       plan: SegmentPlan | None = None, use_kernel=None):
    """``out[s] = sum_{seg[i]=s} w[i] table[ids[i]]``, (S, D) in
    ``table.dtype`` with float32 accumulation.

    ``plan`` is the kernel's segment plan of (ids, seg) (built here when
    the kernel route has none; the plain route ignores it).  Index
    ranges are checked on the plain route and when a plan is built.
    Differentiable with respect to ``table``.
    """
    use_kernel = _route(table, use_kernel)
    if w.requires_grad:
        raise ValueError("gather_segment_sum takes no gradient for w")
    if use_kernel:
        if plan is None:
            plan = build_plan(ids, seg, n_segments, table.shape[0])
    else:
        check_ranges(ids, seg, table.shape[0], n_segments)
    if table.requires_grad and torch.is_grad_enabled():
        return _GatherSegmentSum.apply(table, ids, seg, w, n_segments, plan,
                                       use_kernel)
    return _apply(ids, seg, w, table, n_segments, plan, use_kernel)
