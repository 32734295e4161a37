"""Flash attention (K5: CUDA kernel and its backward, plain versions,
dispatcher with GQA folding and a gradient)."""
from .kernel import (FLASHATTN, FLASHATTN_BWD, FLASHATTN_BWD_WINDOW,
                     FLASHATTN_WINDOW, flash_attention_bwd_cuda,
                     flash_attention_cuda, launch_counts,
                     reset_launch_counts)
from .ops import FlashAttention, flash_attention
from .ref import (flash_attention_bwd_ref, flash_attention_gqa_bwd_ref,
                  flash_attention_gqa_ref, flash_attention_ref)

__all__ = ["FLASHATTN", "FLASHATTN_BWD", "FLASHATTN_BWD_WINDOW",
           "FLASHATTN_WINDOW", "FlashAttention", "flash_attention",
           "flash_attention_bwd_cuda", "flash_attention_bwd_ref",
           "flash_attention_cuda", "flash_attention_gqa_bwd_ref",
           "flash_attention_gqa_ref", "flash_attention_ref", "launch_counts",
           "reset_launch_counts"]
