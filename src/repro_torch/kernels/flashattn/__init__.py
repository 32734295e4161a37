"""Flash attention (K5: CUDA kernel, plain version, dispatcher with GQA
folding)."""
from .kernel import (FLASHATTN, FLASHATTN_WINDOW, flash_attention_cuda,
                     launch_counts, reset_launch_counts)
from .ops import flash_attention
from .ref import flash_attention_gqa_ref, flash_attention_ref

__all__ = ["FLASHATTN", "FLASHATTN_WINDOW", "flash_attention",
           "flash_attention_cuda", "flash_attention_gqa_ref",
           "flash_attention_ref", "launch_counts", "reset_launch_counts"]
