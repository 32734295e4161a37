"""BFS frontier expansion: CUDA kernels, plain versions, dispatcher."""
from .kernel import (FLAT, NODE_BLOCKED, PULL_SPLIT, WORDS, build_pull_plan,
                     frontier_block_bitmap, frontier_expand_flat,
                     frontier_expand_node_blocked, frontier_row_mask,
                     frontier_words, launch_counts, reset_launch_counts)
from .ops import LANES, frontier_expand, select_route
from .ref import (frontier_expand_batched_ref,
                  frontier_expand_node_blocked_ref, frontier_pull_ref,
                  frontier_words_ref)

__all__ = ["FLAT", "LANES", "NODE_BLOCKED", "PULL_SPLIT", "WORDS",
           "build_pull_plan", "frontier_block_bitmap", "frontier_expand",
           "frontier_expand_batched_ref", "frontier_expand_flat",
           "frontier_expand_node_blocked", "frontier_expand_node_blocked_ref",
           "frontier_pull_ref", "frontier_row_mask", "frontier_words",
           "frontier_words_ref", "launch_counts", "reset_launch_counts",
           "select_route"]
