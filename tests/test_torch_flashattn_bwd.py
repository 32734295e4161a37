"""The plain backward of the port's flash attention (K5 bwd's plain
version) and the dispatcher's gradient, on the CPU, against ``jax.vjp``
through the JAX package's attention: its kernel's plain version
``flash_attention_ref`` (folded heads, causal or not) and the model's
``dense_attention(window=)`` (GQA, sliding windows, ragged lengths).  The
JAX package has no backward of its kernel: it trains through XLA's
autodiff of these functions.  The CUDA backward kernel is held against
this plain version on the card (``tests/test_torch_kernels_gpu.py``,
``chip_smoke.py`` [23]).

Tolerance, float32: each gradient within an L2 distance of 1e-5 of
JAX's, relative to the larger of its norm and sqrt(its elements) (both
sum the same float32 products in other orders, ~1e-7; the inputs are
N(0, 1), and a gradient that is 0 by construction, a lone key's, is so
held to 1e-5 an entry); the row logsumexp within 1e-5 absolute.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flashattn import flash_attention_ref as j_ref
from repro.models.attention import dense_attention as j_dense
from repro_torch.kernels import flashattn as tf
from _torch_parity import np_

GRAD_REL = 1e-5


def _normal(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _rel(got, want):
    got, want = np_(got).astype(np.float64), np.asarray(want, np.float64)
    scale = max(np.linalg.norm(want), np.sqrt(want.size))
    return float(np.linalg.norm(got - want) / scale)


def _jax_vjp(fn, arrays, cotangent):
    """fn's output and its vjp against ``cotangent``, one jit at XLA's
    lowest backend optimization (a third of the compile time, the same
    float32 operations)."""
    def both(args, ct):
        out, pull = jax.vjp(fn, *args)
        return out, pull(ct)

    args = [jnp.asarray(a) for a in arrays], jnp.asarray(cotangent)
    out, grads = jax.jit(both).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})(*args)
    return np.asarray(out), grads


@pytest.mark.parametrize("bh,s,dh,causal", [
    (3, 1, 16, True), (3, 37, 16, True), (2, 100, 64, True),
    (2, 100, 64, False), (4, 130, 16, False)])
def test_folded_backward_matches_jax_kernel_ref(bh, s, dh, causal):
    """(BH, S, dh): the plain forward's output and logsumexp, and the
    plain backward's dq, dk, dv against jax.vjp of the reference's
    ``flash_attention_ref``."""
    q, k, v, do = [_normal((bh, s, dh), s + dh + i) for i in range(4)]
    want_o, grads = _jax_vjp(lambda a, b, c: j_ref(a, b, c, causal=causal),
                             (q, k, v), do)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = tf.flash_attention_ref(tq, tk, tv, causal=causal,
                                    return_lse=True)
    np.testing.assert_allclose(np_(o), want_o, rtol=3e-5, atol=3e-5)
    scores = np.einsum("bqd,bkd->bqk", q, k) / dh ** 0.5
    if causal:
        scores = np.where(np.tril(np.ones((s, s), bool)), scores, -1e30)
    np.testing.assert_allclose(np_(lse), jax.nn.logsumexp(scores, axis=-1),
                               rtol=0, atol=1e-5)
    got = tf.flash_attention_bwd_ref(tq, tk, tv, o, lse, tdo, causal=causal)
    for g, w in zip(got, grads):
        assert g.dtype == torch.float32
        assert _rel(g, w) <= GRAD_REL


@pytest.mark.parametrize("s,window", [
    (37, None), (37, 1), (37, 5), (100, 40), (100, 100), (129, 64)])
def test_gqa_backward_matches_jax_dense_attention(s, window):
    """The model's layout, 6 query heads over 2 KV heads: dq (B, S, H,
    dh) and dk, dv summed over each KV head's 3 query heads (B, S, KV,
    dh), against jax.vjp of ``dense_attention(causal=True, window=)``,
    whose GQA never repeats heads."""
    b, h, kv, dh = 2, 6, 2, 16
    q, do = (_normal((b, s, h, dh), s + i) for i in (0, 1))
    k, v = (_normal((b, s, kv, dh), s + i) for i in (2, 3))
    want_o, grads = _jax_vjp(
        lambda a, c, d: j_dense(a, c, d, causal=True, window=window),
        (q, k, v), do)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = tf.flash_attention_gqa_ref(tq, tk, tv, window=window,
                                        return_lse=True)
    assert tuple(lse.shape) == (b, h, s)
    np.testing.assert_allclose(np_(o), want_o, rtol=3e-5, atol=3e-5)
    got = tf.flash_attention_gqa_bwd_ref(tq, tk, tv, o, lse, tdo,
                                         window=window)
    for g, w, x in zip(got, grads, (q, k, v)):
        assert tuple(g.shape) == x.shape
        assert _rel(g, w) <= GRAD_REL


@pytest.mark.parametrize("window", [None, 7])
def test_dispatcher_gradient_is_the_plain_backward(window):
    """On CPU tensors that require a gradient, ``flash_attention`` runs
    the autograd function: its output is the plain forward's and its
    gradients the plain backward's, bitwise; with ``use_kernel=True`` it
    still raises, and under ``torch.no_grad()`` it is the serving call."""
    b, s, h, kv, dh = 2, 50, 4, 2, 16
    q = torch.from_numpy(_normal((b, s, h, dh), 1)).requires_grad_(True)
    k = torch.from_numpy(_normal((b, s, kv, dh), 2)).requires_grad_(True)
    v = torch.from_numpy(_normal((b, s, kv, dh), 3)).requires_grad_(True)
    do = torch.from_numpy(_normal((b, s, h, dh), 4))
    out = tf.flash_attention(q, k, v, window=window)
    assert out.grad_fn is not None
    out.backward(do)
    with torch.no_grad():
        o, lse = tf.flash_attention_gqa_ref(q, k, v, window=window,
                                            return_lse=True)
        assert torch.equal(tf.flash_attention(q, k, v, window=window), o)
        want = tf.flash_attention_gqa_bwd_ref(q, k, v, o, lse, do,
                                              window=window)
    assert torch.equal(out.detach(), o)
    for t, w in zip((q, k, v), want):
        assert torch.equal(t.grad, w)
    with pytest.raises(ValueError, match="CUDA kernel"):
        tf.flash_attention(q, k, v, use_kernel=True)


def test_bfloat16_backward_rounds_once():
    """bfloat16 inputs: the plain backward computes in float32 and rounds
    each gradient once to bfloat16, so it lies within bfloat16's
    rounding (2^-8 relative) of the float32 backward on the same
    (rounded) inputs."""
    b, s, h, kv, dh = 1, 64, 4, 2, 64
    q, do = (torch.from_numpy(_normal((b, s, h, dh), i)).bfloat16()
             for i in (5, 6))
    k, v = (torch.from_numpy(_normal((b, s, kv, dh), i)).bfloat16()
            for i in (7, 8))
    o, lse = tf.flash_attention_gqa_ref(q, k, v, return_lse=True)
    got = tf.flash_attention_gqa_bwd_ref(q, k, v, o, lse, do)
    want = tf.flash_attention_gqa_bwd_ref(q.float(), k.float(), v.float(),
                                          o.float(), lse, do.float())
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        assert _rel(g.float(), w.numpy()) <= 2.0 ** -8


def test_backward_kernel_refuses_cpu_tensors():
    q = torch.zeros(1, 8, 2, 64)
    k = torch.zeros(1, 8, 1, 64)
    lse = torch.zeros(1, 2, 8)
    with pytest.raises(ValueError, match="CUDA kernel"):
        tf.flash_attention_bwd_cuda(q, k, k, q, lse, q)
