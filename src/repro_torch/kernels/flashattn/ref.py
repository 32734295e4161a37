"""Plain PyTorch version of the flash-attention kernel
(``repro.kernels.flashattn.ref``): a dense softmax.

:func:`flash_attention_ref` takes the kernel's folded layout, q, k, v
(BH, S, dh).  The scores, the softmax and its product with v are
float32 whatever the inputs' type; masked scores are -1e30 and the
output is cast to ``q.dtype``.  Query rows go through in blocks of at
most ``budget`` score elements (2^28 by default, 1 GiB of float32), so
a 32768-token prompt over 48 heads needs a few GB and not the 200 GB of
its full score matrix; a causal block only scores the keys up to its
last row, since the rest are masked.  With a sliding ``window`` (causal
only: row r sees keys r - window < k <= r, as the JAX
``dense_attention(window=)`` masks them) a block of rows [lo, hi) only
scores keys [max(0, lo - window + 1), hi), and its rows are as many as
keep that block's scores within the budget.

:func:`flash_attention_gqa_ref` takes the model's layout, q (B, S, H,
dh) and k, v (B, S, KV, dh): it repeats each KV head H / KV times, as
the JAX wrapper's ``_fold_gqa`` does, folds (B, H) and calls the above.
"""
from __future__ import annotations

import math

import torch

__all__ = ["BUDGET", "check_window", "flash_attention_gqa_ref",
           "flash_attention_ref"]

BUDGET = 1 << 28
_NEG_INF = -1e30


def check_window(causal: bool, window) -> None:
    """Raise unless ``window`` is None or a positive int on a causal
    call (the JAX package windows only causal layers)."""
    if window is None:
        return
    if not causal:
        raise ValueError("a sliding window needs causal=True")
    if int(window) < 1:
        raise ValueError(f"window must be at least 1, got {window}")


def _window_rows(bh: int, s: int, window: int, budget: int) -> int:
    """The most rows r whose block scores r + window - 1 keys within
    ``budget`` elements over ``bh`` heads."""
    cap = budget // max(bh, 1)
    w = window - 1
    r = (math.isqrt(w * w + 4 * cap) - w) // 2
    return max(1, min(s, r))


def flash_attention_ref(q, k, v, *, causal: bool = True, window=None,
                        budget: int = BUDGET):
    """q, k, v (BH, S, dh) -> (BH, S, dh) in ``q.dtype``."""
    check_window(causal, window)
    bh, s, dh = q.shape
    kf, vf = k.float(), v.float()
    out = torch.empty((bh, s, dh), dtype=q.dtype, device=q.device)
    if window is None:
        rows = max(1, min(s, budget // max(bh * s, 1)))
    else:
        rows = _window_rows(bh, s, int(window), budget)
    for lo in range(0, s, rows):
        hi = min(s, lo + rows)
        k_lo = 0 if window is None else max(0, lo - int(window) + 1)
        k_hi = hi if causal else s
        scores = torch.matmul(q[:, lo:hi].float(),
                              kf[:, k_lo:k_hi].transpose(1, 2)) / (dh ** 0.5)
        if causal:
            qpos = torch.arange(lo, hi, device=q.device)[:, None]
            kpos = torch.arange(k_lo, k_hi, device=q.device)[None, :]
            masked = kpos > qpos
            if window is not None:
                masked |= qpos - kpos >= int(window)
            scores = scores.masked_fill(masked, _NEG_INF)
        probs = torch.softmax(scores, dim=-1)
        del scores
        out[:, lo:hi] = torch.matmul(probs, vf[:, k_lo:k_hi]).to(q.dtype)
    return out


def _fold_gqa(q, k, v):
    """Model layout to the kernel's: KV heads repeated, (B, H) folded."""
    b, s, h, dh = q.shape
    g = h // k.shape[2]
    kr = torch.repeat_interleave(k, g, dim=2)
    vr = torch.repeat_interleave(v, g, dim=2)

    def fold(x):
        return x.transpose(1, 2).reshape(b * h, s, dh)

    return fold(q), fold(kr), fold(vr)


def flash_attention_gqa_ref(q, k, v, *, causal: bool = True, window=None):
    """q (B, S, H, dh), k, v (B, S, KV, dh) -> (B, S, H, dh)."""
    check_window(causal, window)
    b, s, h, dh = q.shape
    out = flash_attention_ref(*_fold_gqa(q, k, v), causal=causal,
                              window=window)
    return out.reshape(b, h, s, dh).transpose(1, 2)
