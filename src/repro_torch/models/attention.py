"""Attention of the LM (``repro.models.attention``): dense and decode.

GQA-aware products: q (B, Sq, KV, G, dh) against k, v (B, Sk, KV, dh)
with G = H / KV, so the repeated KV heads are never materialised.  Both
functions are plain PyTorch, as the JAX package computes them in XLA.
A full-attention prefill on the card does not come here: it goes
through the flash-attention dispatcher (``kernels/flashattn``).

``masked_chunk_attention`` and ``trapezoid_attention`` (the chunked
schedules of long sliding-window prefills) wait for their slice
(ROADMAP).
"""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["decode_attention", "dense_attention"]

_NEG_INF = -1e30


def _gqa_split(q, n_kv: int):
    b, s, h, dh = q.shape
    return q.reshape(b, s, n_kv, h // n_kv, dh)


def dense_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None, q_offset: int = 0):
    """O(S^2)-memory attention: q (B, Sq, H, dh), k, v (B, Sk, KV, dh) ->
    (B, Sq, H, dh).  Float32 scores and softmax; the probabilities are
    cast to ``v.dtype`` for their product with v, as in the reference."""
    b, sq, h, dh = q.shape
    sk, n_kv = k.shape[1], k.shape[2]
    qh = _gqa_split(q, n_kv)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qh.float(),
                          k.float()) / (dh ** 0.5)
    qpos = torch.arange(sq, device=q.device) + q_offset
    kpos = torch.arange(sk, device=q.device)
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos[:, None] >= kpos[None, :]
    if window is not None:
        mask &= (qpos[:, None] - kpos[None, :]) < window
    scores = scores.masked_fill(~mask, _NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs.to(v.dtype), v)
    return out.reshape(b, sq, h, dh)


def decode_attention(q, k_cache, v_cache, cache_len: int, *,
                     window: Optional[int] = None):
    """One new token against a dense KV cache.

    q (B, 1, H, dh); caches (B, S_max, KV, dh) where slot i holds
    position i; ``cache_len`` (a Python int) is the new token's position
    and slots above it are masked.  A sliding-window layer first slices
    the ``window`` live slots, so it reads no more of the cache.
    """
    qpos = int(cache_len)
    s_max = k_cache.shape[1]
    kpos0 = 0
    if window is not None and s_max > window:
        kpos0 = min(max(qpos + 1 - window, 0), s_max - window)
        k_cache = k_cache[:, kpos0:kpos0 + window]
        v_cache = v_cache[:, kpos0:kpos0 + window]
    b, sq, h, dh = q.shape
    sk, n_kv = k_cache.shape[1], k_cache.shape[2]
    qh = _gqa_split(q, n_kv).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qh, k_cache.float()) / (dh ** 0.5)
    kpos = kpos0 + torch.arange(sk, device=q.device)
    s = s.masked_fill((kpos > qpos)[None, None, None, None, :], _NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p.to(v_cache.dtype), v_cache)
    return out.reshape(b, sq, h, dh)
