"""Dispatch of flash attention with GQA (``repro.kernels.flashattn.ops``).

:func:`flash_attention` takes the model's layout, q (B, S, H, dh) and
k, v (B, S, KV, dh), and routes to the CUDA kernel K5 for CUDA tensors
and to the plain version for CPU tensors, as the JAX
``flash_attention(..., use_pallas=)`` selects its backend.  The plain
route folds GQA by repeating KV heads, exactly as the JAX ``_fold_gqa``
does; the kernel maps heads without copies.  ``use_kernel=True`` on CPU
tensors raises; ``use_kernel=False`` runs the plain version on either
device (the card's reference route).  Nothing falls back quietly.  ``window``
(causal only) keeps row r to keys r - window < k <= r, the JAX
package's sliding-window mask: the kernel's window mode, or the plain
version's.

There is no backward: the TPU kernel has none either.  A call on a
tensor that requires a gradient, in grad mode, raises.
"""
from __future__ import annotations

import torch

from .kernel import flash_attention_cuda
from .ref import check_window, flash_attention_gqa_ref

__all__ = ["flash_attention"]


def flash_attention(q, k, v, *, causal: bool = True, window=None,
                    use_kernel=None):
    """q (B, S, H, dh), k, v (B, S, KV, dh) -> (B, S, H, dh) in
    ``q.dtype``, float32 softmax."""
    check_window(causal, window)
    if use_kernel is None:
        use_kernel = q.is_cuda
    if use_kernel and not q.is_cuda:
        raise ValueError("the flash-attention kernel is a CUDA kernel but q "
                         "lies on the CPU; use use_kernel=None or False")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise ValueError("flash_attention has no backward; call it under "
                         "torch.no_grad() or on tensors without gradients")
    if use_kernel:
        return flash_attention_cuda(q, k, v, causal=causal, window=window)
    return flash_attention_gqa_ref(q, k, v, causal=causal, window=window)
