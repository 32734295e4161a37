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

In grad mode, on a tensor that requires a gradient, the call goes
through :class:`FlashAttention`, an autograd function: its forward runs
K5 with its row-logsumexp output (or the plain forward with its
logsumexp), saves q, k, v, the output and the logsumexp, and its
backward runs the backward kernel (``flash_attention_bwd_cuda``) or the
plain backward on the same route.  Under ``torch.no_grad()``, or on
tensors without gradients, the call is the serving path: one forward
launch, no logsumexp.
"""
from __future__ import annotations

import torch

from .kernel import flash_attention_bwd_cuda, flash_attention_cuda
from .ref import check_window, flash_attention_gqa_bwd_ref, \
    flash_attention_gqa_ref

__all__ = ["FlashAttention", "flash_attention"]


class FlashAttention(torch.autograd.Function):
    """Flash attention with a gradient: K5 and its backward kernel when
    ``use_kernel``, else the plain forward and backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, use_kernel):
        if use_kernel:
            out, lse = flash_attention_cuda(q, k, v, causal=causal,
                                            window=window, return_lse=True)
        else:
            out, lse = flash_attention_gqa_ref(q, k, v, causal=causal,
                                               window=window, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.route = causal, window, use_kernel
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        causal, window, use_kernel = ctx.route
        bwd = flash_attention_bwd_cuda if use_kernel \
            else flash_attention_gqa_bwd_ref
        dq, dk, dv = bwd(q, k, v, out, lse, dout, causal=causal,
                         window=window)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, *, causal: bool = True, window=None,
                    use_kernel=None):
    """q (B, S, H, dh), k, v (B, S, KV, dh) -> (B, S, H, dh) in
    ``q.dtype``, float32 softmax; differentiable in q, k and v."""
    check_window(causal, window)
    if use_kernel is None:
        use_kernel = q.is_cuda
    if use_kernel and not q.is_cuda:
        raise ValueError("the flash-attention kernel is a CUDA kernel but q "
                         "lies on the CPU; use use_kernel=None or False")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttention.apply(q, k, v, causal, window, use_kernel)
    if use_kernel:
        return flash_attention_cuda(q, k, v, causal=causal, window=window)
    return flash_attention_gqa_ref(q, k, v, causal=causal, window=window)
