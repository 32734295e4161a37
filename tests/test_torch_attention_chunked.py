"""The chunked attention schedules of sliding-window prefill on the CPU
against the JAX package: ``masked_chunk_attention`` and
``trapezoid_attention`` (``repro_torch.models.attention``), and the
flash-attention dispatcher's plain route with a window against the JAX
``dense_attention(window=)`` (the JAX kernel K5 has no window, so there
is nothing of it to compare).  Inputs are numpy N(0, 1) draws from a
seed; GQA with 4 query heads over 2 KV heads.

Tolerances.  Float32: 1e-5 absolute and relative; both packages compute
the same float32 expressions and sum in other orders (~1e-7).  Bfloat16:
2e-2 absolute and relative, the repo's bfloat16 attention tolerance; the
accumulator is bfloat16 on both sides (the reference's ``acc0`` is in
``v.dtype``) and each chunk rounds P, P V and the rescaled accumulator
to bfloat16, so one rounding (2^-8 relative) that falls the other way on
one side is carried through the later chunks.  (Measured on a CPU: the
masked-chunk cases agree to 1.8e-7 in float32 and bitwise in bfloat16.)

The JAX side runs with ``LoopConfig(unroll=True)``, its own Python loop
over the chunks in place of ``lax.scan``: the same body, run op by op,
so that the many cases here do not each compile a scan.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.attention as jatt
from repro.models.common import LoopConfig
import repro_torch.models.attention as tatt
from repro_torch.kernels import flashattn as tf
from _torch_parity import np_

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
UNROLL = LoopConfig(unroll=True)
TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}
H, KV, DH = 4, 2, 16


def _normal(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _qkv(sq, sk, dtype, seed=0):
    """q (2, sq, H, DH), k and v (2, sk, KV, DH) as JAX arrays and torch
    tensors of ``dtype`` (both round float32 to bfloat16 to nearest
    even)."""
    arrays = (_normal((2, sq, H, DH), seed), _normal((2, sk, KV, DH),
                                                     seed + 1),
              _normal((2, sk, KV, DH), seed + 2))
    jx = [jnp.asarray(a, jnp.dtype(dtype)) for a in arrays]
    tx = [torch.from_numpy(a).to(TORCH_DTYPE[dtype]) for a in arrays]
    return jx, tx


def _close(got, want, dtype):
    tol = TOL[dtype]
    np.testing.assert_allclose(np_(got.float()),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("chunk", [8, 16])
@pytest.mark.parametrize("window", [None, 16, 20, 40])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,q_offset", [(48, 0), (16, 13)])
def test_masked_chunk_attention_matches_jax(sq, q_offset, causal, window,
                                            chunk, dtype):
    """48 keys in chunks of 8 or 16; the queries either every position or
    a later block of them at an offset off the chunk grid (trapezoid
    passes offsets on it).  Windows of 16 and 20 leave rows wholly masked in their first
    chunks (the exp(0) = 1 garbage a later chunk erases), 40 reaches
    across chunks, and without ``causal`` a window keeps every later
    key, as the reference's mask does."""
    (jq, jk, jv), (q, k, v) = _qkv(sq, 48, dtype, seed=sq + q_offset)
    got = tatt.masked_chunk_attention(q, k, v, causal=causal, window=window,
                                      chunk=chunk, q_offset=q_offset)
    want = jatt.masked_chunk_attention(jq, jk, jv, causal=causal,
                                       window=window, chunk=chunk,
                                       q_offset=q_offset, loop=UNROLL)
    assert got.shape == (2, sq, H, DH) and got.dtype == q.dtype
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("chunk", [8, 16])
@pytest.mark.parametrize("window", [None, 16, 20, 40])
def test_trapezoid_attention_matches_jax(window, chunk, dtype):
    """The block-causal schedule over 48 positions: query chunk i visits
    KV chunks [i - ceil(window / chunk), i] (or [0, i]), each with its
    query offset."""
    (jq, jk, jv), (q, k, v) = _qkv(48, 48, dtype, seed=7)
    got = tatt.trapezoid_attention(q, k, v, window=window, chunk=chunk)
    want = jatt.trapezoid_attention(jq, jk, jv, window=window, chunk=chunk,
                                    loop=UNROLL)
    assert got.shape == (2, 48, H, DH)
    _close(got, want, dtype)


@pytest.mark.parametrize("window", [None, 16, 20, 40])
def test_chunked_schedules_equal_dense_attention(window):
    """Both schedules compute the dense, causal, windowed attention of the
    reference (``dense_attention``) in float32."""
    (jq, jk, jv), (q, k, v) = _qkv(64, 64, "float32", seed=11)
    want = jatt.dense_attention(jq, jk, jv, causal=True, window=window)
    for got in (tatt.masked_chunk_attention(q, k, v, window=window, chunk=16),
                tatt.trapezoid_attention(q, k, v, window=window, chunk=16),
                tatt.dense_attention(q, k, v, window=window)):
        _close(got, want, "float32")


def test_chunk_must_divide_the_keys():
    _, (q, k, v) = _qkv(40, 40, "float32")
    with pytest.raises(AssertionError):
        tatt.masked_chunk_attention(q, k, v, chunk=16)
    with pytest.raises(AssertionError):
        tatt.trapezoid_attention(q[:, :32], k, v, chunk=8)
    # a chunk wider than the keys is cut to them
    _close(tatt.masked_chunk_attention(q, k, v, chunk=64),
           jatt.dense_attention(*_qkv(40, 40, "float32")[0]), "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [1, 16, 20, 40, 100])
@pytest.mark.parametrize("s", [50, 64])
def test_windowed_flash_plain_route_matches_jax_dense(s, window, dtype):
    """The dispatcher's plain route with a window (GQA folded by repeated
    KV heads, a dense float32 softmax) against the JAX
    ``dense_attention(window=)``, at a ragged and a whole S; a window of
    1 keeps each row's own key only, 100 is wider than S."""
    (jq, jk, jv), (q, k, v) = _qkv(s, s, dtype, seed=s + window)
    want = jatt.dense_attention(jq, jk, jv, causal=True, window=window)
    tf.reset_launch_counts()
    for use_kernel in (None, False):
        got = tf.flash_attention(q, k, v, window=window,
                                 use_kernel=use_kernel)
        assert got.shape == (2, s, H, DH) and got.dtype == q.dtype
        _close(got, want, dtype)
    assert tf.launch_counts == {tf.FLASHATTN: 0, tf.FLASHATTN_WINDOW: 0,
                                tf.FLASHATTN_BWD: 0,
                                tf.FLASHATTN_BWD_WINDOW: 0}


@pytest.mark.parametrize("window", [1, 7, 30])
def test_windowed_plain_in_row_blocks_is_the_unblocked_plain(window):
    """A budget of a few rows (each block scoring only keys [lo - window
    + 1, hi)) agrees with one block over every row: the keys a block
    leaves out are masked for every row of it."""
    q, k, v = [torch.from_numpy(_normal((3, 70, 32), i)) for i in range(3)]
    whole = tf.flash_attention_ref(q, k, v, window=window, budget=1 << 40)
    for budget in (1, 3 * 70, 3 * 8 * (8 + window)):
        blocks = tf.flash_attention_ref(q, k, v, window=window,
                                        budget=budget)
        torch.testing.assert_close(blocks, whole, rtol=1e-6, atol=1e-6)
    # the model layout's dense attention, (3, 70, 32) as (1, 70, 3, 32)
    dense = tatt.dense_attention(*(x.transpose(0, 1)[None]
                                   for x in (q, k, v)), window=window)
    torch.testing.assert_close(whole, dense[0].transpose(0, 1), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("fn", ["flash_attention", "flash_attention_gqa_ref",
                                "flash_attention_ref"])
def test_window_needs_causal_and_a_positive_width(fn):
    """The JAX package windows only causal layers: a window without
    ``causal`` raises, as does a window below 1."""
    _, (q, k, v) = _qkv(16, 16, "float32")
    if fn == "flash_attention_ref":
        q, k, v = (x[:, :, 0] for x in (q, k, v))
    call = getattr(tf, fn)
    with pytest.raises(ValueError, match="causal"):
        call(q, k, v, causal=False, window=4)
    with pytest.raises(ValueError, match="at least 1"):
        call(q, k, v, window=0)
    call(q, k, v, causal=False)     # no window: full attention is fine
