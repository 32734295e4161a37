"""Fused gather + weighted segment sum (K4: CUDA kernel, its segment
plan, plain version, dispatcher with its gradient)."""
from .kernel import (SEGSUM, SegmentPlan, build_plan,
                     gather_segment_sum_cuda, launch_counts,
                     reset_launch_counts)
from .ops import gather_segment_sum
from .ref import gather_segment_sum_ref

__all__ = ["SEGSUM", "SegmentPlan", "build_plan",
           "gather_segment_sum", "gather_segment_sum_cuda",
           "gather_segment_sum_ref", "launch_counts", "reset_launch_counts"]
