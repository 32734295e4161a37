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

With ``return_lse`` each also returns the row logsumexp of the scaled,
masked scores, float32 (BH, S) or (B, H, S), the residual the backward
needs.  Every row of a causal or windowed call sees at least its own
key, so no row is wholly masked; a row that were would give -1e30 +
log(keys), where the kernel floors its sum at 1e-30.

:func:`flash_attention_bwd_ref` is the plain backward, the standard
FlashAttention-2 formulas in float32 over the same row blocks and
budget as the forward: D = rowsum(dO * O), P = exp(S scale - lse), dV =
P^T dO, dS = P * (dO V^T - D), dQ = dS K scale, dK = dS^T Q scale, the
mask the forward's.  :func:`flash_attention_gqa_bwd_ref` takes the
model's layout and sums dK and dV over the H / KV query heads of each
KV head (in float32, before the cast), so it returns no repeated heads.
The JAX package has no backward of its kernel: it differentiates its
XLA attention (``dense_attention``, ``masked_chunk_attention``), which
the CPU tests hold this against.  Autograd never differentiates the
plain forward's in-place block writes: the dispatcher's autograd
function calls this backward instead.
"""
from __future__ import annotations

import math

import torch

__all__ = ["BUDGET", "check_window", "flash_attention_bwd_ref",
           "flash_attention_gqa_bwd_ref", "flash_attention_gqa_ref",
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


def _blocks(bh: int, s: int, causal: bool, window, budget: int):
    """The forward's row blocks: (lo, hi, k_lo, k_hi) with the keys
    [k_lo, k_hi) that rows [lo, hi) may see."""
    if window is None:
        rows = max(1, min(s, budget // max(bh * s, 1)))
    else:
        rows = _window_rows(bh, s, int(window), budget)
    for lo in range(0, s, rows):
        hi = min(s, lo + rows)
        k_lo = 0 if window is None else max(0, lo - int(window) + 1)
        yield lo, hi, k_lo, hi if causal else s


def _masked(lo, hi, k_lo, k_hi, window, device):
    """True where row lo.. may not see key k_lo.. (causal, and windowed)."""
    qpos = torch.arange(lo, hi, device=device)[:, None]
    kpos = torch.arange(k_lo, k_hi, device=device)[None, :]
    masked = kpos > qpos
    if window is not None:
        masked |= qpos - kpos >= int(window)
    return masked


def flash_attention_ref(q, k, v, *, causal: bool = True, window=None,
                        budget: int = BUDGET, return_lse: bool = False):
    """q, k, v (BH, S, dh) -> (BH, S, dh) in ``q.dtype`` (and, with
    ``return_lse``, the (BH, S) float32 row logsumexp)."""
    check_window(causal, window)
    bh, s, dh = q.shape
    kf, vf = k.float(), v.float()
    out = torch.empty((bh, s, dh), dtype=q.dtype, device=q.device)
    lse = torch.empty((bh, s), dtype=torch.float32, device=q.device) \
        if return_lse else None
    for lo, hi, k_lo, k_hi in _blocks(bh, s, causal, window, budget):
        scores = torch.matmul(q[:, lo:hi].float(),
                              kf[:, k_lo:k_hi].transpose(1, 2)) / (dh ** 0.5)
        if causal:
            scores = scores.masked_fill(
                _masked(lo, hi, k_lo, k_hi, window, q.device), _NEG_INF)
        if return_lse:
            lse[:, lo:hi] = torch.logsumexp(scores, dim=-1)
        probs = torch.softmax(scores, dim=-1)
        del scores
        out[:, lo:hi] = torch.matmul(probs, vf[:, k_lo:k_hi]).to(q.dtype)
    return (out, lse) if return_lse else out


def flash_attention_bwd_ref(q, k, v, o, lse, do, *, causal: bool = True,
                            window=None, budget: int = BUDGET):
    """The backward of :func:`flash_attention_ref`: q, k, v, o, do (BH,
    S, dh) and lse (BH, S) -> (dq, dk, dv), each (BH, S, dh) float32."""
    check_window(causal, window)
    bh, s, dh = q.shape
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    delta = (dof * o.float()).sum(dim=-1)                     # (BH, S)
    lse = lse.float()
    dq = torch.zeros((bh, s, dh), dtype=torch.float32, device=q.device)
    dk, dv = torch.zeros_like(dq), torch.zeros_like(dq)
    for lo, hi, k_lo, k_hi in _blocks(bh, s, causal, window, budget):
        kb, vb = kf[:, k_lo:k_hi], vf[:, k_lo:k_hi]
        scores = torch.matmul(qf[:, lo:hi], kb.transpose(1, 2)) / (dh ** 0.5)
        p = torch.exp(scores - lse[:, lo:hi, None])
        del scores
        if causal:
            p = p.masked_fill(_masked(lo, hi, k_lo, k_hi, window, q.device),
                              0.0)
        dv[:, k_lo:k_hi] += torch.matmul(p.transpose(1, 2), dof[:, lo:hi])
        ds = p * (torch.matmul(dof[:, lo:hi], vb.transpose(1, 2))
                  - delta[:, lo:hi, None])
        del p
        dq[:, lo:hi] = torch.matmul(ds, kb) / (dh ** 0.5)
        dk[:, k_lo:k_hi] += torch.matmul(ds.transpose(1, 2),
                                         qf[:, lo:hi]) / (dh ** 0.5)
    return dq, dk, dv


def _fold_gqa(q, k, v):
    """Model layout to the kernel's: KV heads repeated, (B, H) folded."""
    g = q.shape[2] // k.shape[2]
    kr = torch.repeat_interleave(k, g, dim=2)
    vr = torch.repeat_interleave(v, g, dim=2)
    return _fold(q), _fold(kr), _fold(vr)


def _fold(x):
    """(B, S, H, dh) -> (B H, S, dh)."""
    b, s, h, dh = x.shape
    return x.transpose(1, 2).reshape(b * h, s, dh)


def flash_attention_gqa_ref(q, k, v, *, causal: bool = True, window=None,
                            return_lse: bool = False):
    """q (B, S, H, dh), k, v (B, S, KV, dh) -> (B, S, H, dh) (and, with
    ``return_lse``, the (B, H, S) float32 row logsumexp)."""
    check_window(causal, window)
    b, s, h, dh = q.shape
    out = flash_attention_ref(*_fold_gqa(q, k, v), causal=causal,
                              window=window, return_lse=return_lse)
    out, lse = out if return_lse else (out, None)
    out = out.reshape(b, h, s, dh).transpose(1, 2)
    return (out, lse.reshape(b, h, s)) if return_lse else out


def flash_attention_gqa_bwd_ref(q, k, v, o, lse, do, *, causal: bool = True,
                                window=None):
    """The backward of :func:`flash_attention_gqa_ref`: q, o, do (B, S,
    H, dh), k, v (B, S, KV, dh), lse (B, H, S) -> (dq, dk, dv) in q's,
    k's and v's types; dk and dv summed over each KV head's H / KV query
    heads in float32."""
    check_window(causal, window)
    b, s, h, dh = q.shape
    n_kv = k.shape[2]
    fq, fk, fv = _fold_gqa(q, k, v)
    dq, dk, dv = flash_attention_bwd_ref(
        fq, fk, fv, _fold(o), lse.reshape(b * h, s), _fold(do),
        causal=causal, window=window)

    def unfold(x, heads, dtype):
        return x.reshape(b, heads, s, dh).transpose(1, 2).to(dtype)

    def kv_sum(x):
        return x.reshape(b, n_kv, h // n_kv, s, dh).sum(dim=2).reshape(
            b * n_kv, s, dh)

    return (unfold(dq, h, q.dtype), unfold(kv_sum(dk), n_kv, k.dtype),
            unfold(kv_sum(dv), n_kv, v.dtype))
