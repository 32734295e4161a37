"""The arithmetic of K5 bwd's float32 route, emulated on the CPU.

The CUDA kernels (``src/repro_torch/kernels/flashattn/csrc/
flashattn_bwd.cu``, ``bwd_dkdv_tf32_kernel`` and ``bwd_dq_tf32_kernel``)
run each of the backward's seven products (S = q k^T and dP = dO v^T in
both kernels, dV = P^T dO, dK = dS^T q, dQ = dS k) on the tensor cores
as three TF32 products: every float32 operand x is split into x = hi +
lo, hi rounded to TF32 to nearest with ties away from zero, lo = x - hi
read by the tensor core truncated to TF32, and a b is a_lo b_hi + a_hi
b_lo + a_hi b_hi in float32; a_lo b_lo is dropped.  Between the products
everything is float32: P = exp2(S scale log2 e - lse log2 e), D =
rowsum(dO * O), dS = P (dP - D).

This file emulates that arithmetic on numpy-seeded inputs and holds dq,
dk and dv within the route's limit, 1e-5 in relative L2, of ``jax.vjp``
through the JAX package's attention: its kernel's plain version
``flash_attention_ref`` (folded heads, causal and full) and the model's
``dense_attention(window=)`` (GQA, a window, a ragged length).  Its
control shows that the limit would catch a lost correction term: one
TF32 product a matmul lands at least 3x beyond it.  The card holds the
kernels themselves against the plain backward (``chip_smoke.py`` [23a],
``tests/test_torch_kernels_gpu.py``).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flashattn import flash_attention_ref as j_ref
from repro.models.attention import dense_attention as j_dense
from repro_torch.kernels import flashattn as tf

GRAD_REL = 1e-5       # the float32 route's limit (chip_smoke.TRAIN_BWD_REL)
LOG2E = 1.4426950408889634


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 mantissa bits), to nearest, ties away
    from zero: half a unit of TF32's last place added to the bits, the
    13 low bits cleared."""
    return ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_read(x: torch.Tensor) -> torch.Tensor:
    """What the tensor core reads of a float32 operand: its top 19 bits
    (TF32, truncated)."""
    return (x.view(torch.int32) & ~0x1FFF).view(torch.float32)


def mm_split(a, b):
    """a @ b as the kernels take it: three TF32 products, small first."""
    ah, bh = tf32(a), tf32(b)
    al, bl = tf32_read(a - ah), tf32_read(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def mm_one_pass(a, b):
    return tf32(a) @ tf32(b)


def backward(q, k, v, o, lse, do, keep, mm):
    """(BH, S, dh) float32, lse (BH, S), keep (S, S) the mask: dq, dk,
    dv with each of the seven products taken by ``mm`` (S and dP once:
    both kernels compute the same values)."""
    scale = q.shape[-1] ** -0.5
    s = mm(q, k.transpose(1, 2))
    p = torch.exp2(s * (scale * LOG2E) - lse[..., None] * LOG2E)
    p = p.masked_fill(~keep, 0.0)
    dp = mm(do, v.transpose(1, 2))
    ds = p * (dp - (do * o).sum(-1, keepdim=True))
    return (mm(ds, k) * scale, mm(ds.transpose(1, 2), q) * scale,
            mm(p.transpose(1, 2), do))


def mask(s: int, causal: bool, window=None) -> torch.Tensor:
    pos = torch.arange(s)
    keep = torch.ones(s, s, dtype=torch.bool)
    if causal:
        keep &= pos[:, None] >= pos[None, :]
    if window is not None:
        keep &= pos[:, None] - pos[None, :] < window
    return keep


def _normal(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _rel(got, want) -> float:
    """As ``tests/test_torch_flashattn_bwd.py``: the L2 distance relative
    to the larger of the norm and sqrt(the elements)."""
    got, want = got.double().numpy(), np.asarray(want, np.float64)
    scale = max(np.linalg.norm(want), np.sqrt(want.size))
    return float(np.linalg.norm(got - want) / scale)


def _jax_vjp(fn, arrays, cotangent):
    """fn's vjp against ``cotangent``, one jit at XLA's lowest backend
    optimization (as ``tests/test_torch_flashattn_bwd.py``)."""
    def pull(args, ct):
        return jax.vjp(fn, *args)[1](ct)

    args = [jnp.asarray(a) for a in arrays], jnp.asarray(cotangent)
    grads = jax.jit(pull).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})(*args)
    return [np.asarray(g) for g in grads]


@functools.lru_cache(maxsize=None)
def _folded(dh: int, causal: bool):
    """(BH 4, S 512) inputs, the plain forward's output and logsumexp,
    and JAX's gradients through its kernel's plain version."""
    q, k, v, do = (_normal((4, 512, dh), 10 * dh + i) for i in range(4))
    grads = _jax_vjp(lambda a, b, c: j_ref(a, b, c, causal=causal),
                     (q, k, v), do)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = tf.flash_attention_ref(tq, tk, tv, causal=causal,
                                    return_lse=True)
    return (tq, tk, tv, o, lse, tdo), grads


@pytest.mark.parametrize("dh", [16, 64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_three_products_within_the_limit_of_jax_kernel_ref(dh, causal):
    """Folded heads: the emulated kernels' dq, dk, dv within 1e-5 of
    jax.vjp through ``flash_attention_ref``."""
    inputs, grads = _folded(dh, causal)
    got = backward(*inputs, mask(512, causal), mm_split)
    for g, w in zip(got, grads):
        assert _rel(g, w) <= GRAD_REL


@pytest.mark.parametrize("dh", [16, 64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_one_pass_lies_beyond_the_limit(dh, causal):
    """The control: one TF32 product a matmul misses 1e-5 by 3x or more
    in some gradient, where the three products stay within it."""
    inputs, grads = _folded(dh, causal)
    keep = mask(512, causal)
    split3 = backward(*inputs, keep, mm_split)
    one = backward(*inputs, keep, mm_one_pass)
    assert max(_rel(g, w) for g, w in zip(split3, grads)) <= GRAD_REL
    assert max(_rel(g, w) for g, w in zip(one, grads)) >= 3 * GRAD_REL


@pytest.mark.parametrize("s,window", [(137, None), (137, 40), (100, 1)])
def test_three_products_within_the_limit_of_jax_dense_attention(s, window):
    """The model's layout, 4 query heads over 2 KV heads, causal, with and
    without a window (a window of 1: dq = dk = 0, held by their largest
    entry): the emulated kernels on each query head (k, v repeated), dk
    and dv summed over each KV head's query heads, within 1e-5 of jax.vjp
    through ``dense_attention(window=)``."""
    b, h, kv, dh = 2, 4, 2, 64
    q, do = (_normal((b, s, h, dh), s + i) for i in (0, 1))
    k, v = (_normal((b, s, kv, dh), s + i) for i in (2, 3))
    grads = _jax_vjp(
        lambda a, c, d: j_dense(a, c, d, causal=True, window=window),
        (q, k, v), do)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = tf.flash_attention_gqa_ref(tq, tk, tv, window=window,
                                        return_lse=True)

    def fold(x):                   # (B, S, H, dh) -> (B H, S, dh)
        return x.permute(0, 2, 1, 3).reshape(b * h, s, dh)

    g = h // kv
    dq, dk, dv = backward(
        fold(tq), fold(tk.repeat_interleave(g, dim=2)),
        fold(tv.repeat_interleave(g, dim=2)), fold(o),
        lse.reshape(b * h, s), fold(tdo), mask(s, True, window), mm_split)
    got = (dq.reshape(b, h, s, dh).permute(0, 2, 1, 3),
           *(x.reshape(b, kv, g, s, dh).sum(2).permute(0, 2, 1, 3)
             for x in (dk, dv)))
    for i, (x, w) in enumerate(zip(got, grads)):
        assert tuple(x.shape) == w.shape
        gap = float(np.abs(x.numpy() - w).max()) if window == 1 and i < 2 \
            else _rel(x, w)
        assert gap <= GRAD_REL
