"""Attention of the LM (``repro.models.attention``): dense, the two
chunked schedules, and decode.

GQA-aware products: q (B, Sq, KV, G, dh) against k, v (B, Sk, KV, dh)
with G = H / KV, so the repeated KV heads are never materialised.  Every
function is plain PyTorch, as the JAX package computes them in XLA.  A
prefill on the card does not come here: every layer, sliding-window or
not, goes through the flash-attention dispatcher (``kernels/flashattn``),
whose kernel K5 has a window mode.  On the CPU a sliding-window layer
comes here, by the reference's dispatch.

``masked_chunk_attention`` is the reference's online softmax over KV
chunks with the causal / window mask applied per chunk, and
``trapezoid_attention`` its block-causal schedule, which visits only the
chunks a query chunk can see.  The JAX ``lax.scan`` over chunks is a
Python loop here; ``LoopConfig`` (the dry-run's chunk truncation and
unrolling) has no counterpart.
"""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["decode_attention", "dense_attention", "masked_chunk_attention",
           "trapezoid_attention"]

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


def trapezoid_attention(q, k, v, *, window: Optional[int] = None,
                        chunk: int = 1024):
    """Block-causal schedule: query chunk i visits only the KV chunks it
    can see, [0, i] for a causal layer and [i - ceil(window / chunk), i]
    for a sliding-window one, each through ``masked_chunk_attention``
    with its query offset.  Needs Sq == Sk, a multiple of the chunk."""
    b, sq, h, dh = q.shape
    sk = k.shape[1]
    chunk = min(chunk, sk)
    assert sk % chunk == 0 and sq == sk, (sq, sk, chunk)
    wc = None if window is None else max(0, -(-window // chunk))
    outs = []
    for i in range(sk // chunk):
        lo = 0 if wc is None else max(0, i - wc)
        kv_lo, kv_hi = lo * chunk, (i + 1) * chunk
        outs.append(masked_chunk_attention(
            q[:, i * chunk:(i + 1) * chunk], k[:, kv_lo:kv_hi],
            v[:, kv_lo:kv_hi], causal=True, window=window, chunk=chunk,
            q_offset=i * chunk - kv_lo))
    return torch.cat(outs, dim=1)


def masked_chunk_attention(q, k, v, *, causal: bool = True,
                           window: Optional[int] = None, chunk: int = 1024,
                           q_offset: int = 0):
    """Online-softmax attention over KV chunks of ``chunk`` keys (Sk a
    multiple of it): q (B, Sq, H, dh), k, v (B, Sk, KV, dh) -> (B, Sq, H,
    dh).  The reference's arithmetic: float32 scores scaled by
    1/sqrt(dh), masked ones -1e30, a float32 running max and sum, and
    the accumulator in ``v.dtype`` (bfloat16 in a bfloat16 model).  A
    row wholly masked in a chunk takes exp(0) = 1 for each of its keys
    there; the first later chunk with a key it sees scales that away by
    exp(-1e30 - m) = 0, as in the reference."""
    b, sq, h, dh = q.shape
    sk, n_kv = k.shape[1], k.shape[2]
    g = h // n_kv
    chunk = min(chunk, sk)
    assert sk % chunk == 0, (sk, chunk)
    qh = _gqa_split(q, n_kv).float()
    qpos = torch.arange(sq, device=q.device) + q_offset
    m = torch.full((b, n_kv, g, sq), _NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, n_kv, g, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, n_kv, g, sq, dh), dtype=v.dtype, device=q.device)
    for j in range(sk // chunk):
        kj = k[:, j * chunk:(j + 1) * chunk]
        vj = v[:, j * chunk:(j + 1) * chunk]
        kpos = j * chunk + torch.arange(chunk, device=q.device)
        s = torch.einsum("bqhgd,bkhd->bhgqk", qh, kj.float()) / (dh ** 0.5)
        mask = torch.ones((sq, chunk), dtype=torch.bool, device=q.device)
        if causal:
            mask &= qpos[:, None] >= kpos[None, :]
        if window is not None:
            mask &= (qpos[:, None] - kpos[None, :]) < window
        s = s.masked_fill(~mask, _NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        scale = torch.exp(m - m_new)
        l = l * scale + p.sum(dim=-1)
        pv = torch.einsum("bhgqk,bkhd->bhgqd", p.to(vj.dtype), vj)
        acc = acc * scale[..., None].to(acc.dtype) + pv
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None].to(acc.dtype)
    return out.movedim(3, 1).reshape(b, sq, h, dh)


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
