"""The port's flash attention (K5's plain version and dispatcher with GQA)
on the CPU, against the JAX package's plain version and its Pallas
kernel in interpret mode.  The CUDA kernel itself is held against the
plain version on the card (``tests/test_torch_kernels_gpu.py``,
``chip_smoke.py``).

Tolerances are the JAX sweep's: 3e-5 in float32 (the two softmaxes sum
in different orders) and 2e-2 in bfloat16 (each side rounds its output
to bfloat16, 2^-8 relative, and the Pallas kernel rounds nothing else).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st

from repro.kernels.flashattn import flash_attention as j_flash
from repro.kernels.flashattn import flash_attention_pallas
from repro.kernels.flashattn import flash_attention_ref as j_ref
from repro_torch.kernels import flashattn as tf
from _torch_parity import np_

TOL = {"float32": 3e-5, "bfloat16": 2e-2}
TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _normal(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _both(x, dtype):
    """One numpy array as a JAX array and a torch tensor of ``dtype``
    (both round float32 to bfloat16 to nearest even)."""
    return (jnp.asarray(x, jnp.dtype(dtype)),
            torch.from_numpy(x).to(TORCH_DTYPE[dtype]))


def _f32(x):
    return np_(x.float() if hasattr(x, "detach") else x).astype(np.float32)


# the shapes of tests/test_flashattn_kernel.py::test_flash_kernel_sweep with
# S <= 256 (the Pallas kernel's blocks as there)
@pytest.mark.parametrize("bh,s,dh,bq,bk,causal,dtype", [
    (2, 256, 64, 128, 128, True, "float32"),
    (4, 256, 128, 64, 128, True, "float32"),
    (2, 128, 64, 128, 64, False, "float32"),
    (2, 256, 64, 128, 128, True, "bfloat16"),
])
def test_plain_matches_jax_ref_and_pallas(bh, s, dh, bq, bk, causal, dtype):
    (jq, tq), (jk, tk), (jv, tv) = [
        _both(_normal((bh, s, dh), bh + s + i), dtype) for i in range(3)]
    got = _f32(tf.flash_attention_ref(tq, tk, tv, causal=causal))
    tol = TOL[dtype]
    for want in (j_ref(jq, jk, jv, causal=causal),
                 flash_attention_pallas(jq, jk, jv, causal=causal,
                                        block_q=bq, block_k=bk)):
        np.testing.assert_allclose(got, _f32(want), rtol=tol, atol=tol)


def test_plain_in_row_blocks_is_the_unblocked_plain():
    """A budget of a few rows agrees with one block over every row (a
    causal block scores only the keys up to its last row; the masked
    keys it leaves out weigh exactly 0)."""
    q, k, v = [torch.from_numpy(_normal((3, 70, 64), i)) for i in range(3)]
    for causal in (True, False):
        whole = tf.flash_attention_ref(q, k, v, causal=causal)
        blocks = tf.flash_attention_ref(q, k, v, causal=causal,
                                        budget=3 * 70 * 8)
        torch.testing.assert_close(blocks, whole, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("b,s,h,n_kv,dh,causal", [
    (2, 128, 6, 2, 64, True),
    (2, 128, 4, 2, 64, True),
    (1, 128, 6, 2, 128, False),
    (2, 100, 6, 2, 64, True),       # ragged S
    (1, 100, 4, 2, 64, False),
])
def test_dispatcher_matches_jax_gqa_wrapper(b, s, h, n_kv, dh, causal):
    """The model layout with GQA: the port's dispatcher (plain route on
    the CPU) against the JAX wrapper over the Pallas kernel."""
    q, k, v = (_normal((b, s, h, dh), 1), _normal((b, s, n_kv, dh), 2),
               _normal((b, s, n_kv, dh), 3))
    want = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   causal=causal)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    tf.reset_launch_counts()
    for got in (tf.flash_attention(tq, tk, tv, causal=causal),
                tf.flash_attention(tq, tk, tv, causal=causal,
                                   use_kernel=False)):
        assert got.shape == (b, s, h, dh)
        np.testing.assert_allclose(np_(got), np.asarray(want), rtol=3e-5,
                                   atol=3e-5)
    assert tf.launch_counts[tf.FLASHATTN] == 0      # no kernel on the CPU


@settings(max_examples=6, deadline=None)
@given(st.integers(0, 2 ** 31 - 1), st.booleans())
def test_plain_property_convex_hull(seed, causal):
    """The property of test_flash_kernel_property: the port's plain
    version equals the JAX one, and every output row is a convex
    combination of v's rows (inside each column's min/max envelope)."""
    bh, s, dh = 2, 256, 64
    q, k, v = [_normal((bh, s, dh), seed % 10 ** 6 + i) for i in range(3)]
    got = np_(tf.flash_attention_ref(*(torch.from_numpy(x)
                                       for x in (q, k, v)), causal=causal))
    want = np.asarray(j_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            causal=causal))
    np.testing.assert_allclose(got, want, rtol=5e-5, atol=5e-5)
    vmin = v.min(axis=1, keepdims=True) - 1e-4
    vmax = v.max(axis=1, keepdims=True) + 1e-4
    assert (got >= vmin).all() and (got <= vmax).all()


# the bfloat16 kernel's KV tile and the depth of its K/V ring
KV_TILE, KV_STAGES = 128, 2
FLASH_ROW_REL = 1e-2


def _stale_ring_slot(x):
    """(BH, S, dh) with the keys of tile KV_STAGES read as tile 0: what
    a consumer sees when it reads a ring slot before its refill lands
    (the slot still holds the tile KV_STAGES before)."""
    x = x.clone()
    lo = KV_STAGES * KV_TILE
    x[:, lo:lo + KV_TILE] = x[:, :KV_TILE]
    return x


@pytest.mark.parametrize("s", [384, 512])
def test_stale_ring_slot_control_exceeds_the_row_limit(s):
    """The control that chip_smoke.py reads beside the bfloat16 kernel:
    built through the plain version, it must lie beyond the per-row
    limit (||diff|| / ||plain|| <= 1e-2) in every row that sees the
    whole stale tile, so that the limit would catch a ring race.  S =
    384 spans three tiles; 512 adds rows past the stale one."""
    bh, dh = 16, 128
    q, k, v = [torch.from_numpy(_normal((bh, s, dh), s + i)).to(
        torch.bfloat16) for i in range(3)]
    want = tf.flash_attention_ref(q, k, v, causal=True).float()
    bad = tf.flash_attention_ref(q, _stale_ring_slot(k), _stale_ring_slot(v),
                                 causal=True).float()
    first = (KV_STAGES + 1) * KV_TILE - 1      # sees keys 256 .. 383
    rel = ((bad - want).norm(dim=-1)
           / want.norm(dim=-1).clamp_min(1e-30))[:, first:]
    assert rel.shape == (bh, s - first)
    assert float(rel.min()) > FLASH_ROW_REL
    # rows before the stale tile are untouched
    assert torch.equal(bad[:, :KV_STAGES * KV_TILE],
                       want[:, :KV_STAGES * KV_TILE])


def test_stale_ring_slot_control_reaches_every_consumer_slab_at_dh_64():
    """The same control at head dim 64 (granite-moe's), held as
    chip_smoke.py holds it: a stale read corrupts the 64 query rows of
    one head that the reading consumer warpgroup owns, so in every such
    slab past the stale tile at least one row lies beyond the per-row
    limit.  S = 1024 gives ten slabs a head."""
    bh, s, dh, slab = 16, 1024, 64, 64
    q, k, v = [torch.from_numpy(_normal((bh, s, dh), 7 + i)).to(
        torch.bfloat16) for i in range(3)]
    want = tf.flash_attention_ref(q, k, v, causal=True).float()
    bad = tf.flash_attention_ref(q, _stale_ring_slot(k), _stale_ring_slot(v),
                                 causal=True).float()
    past = (KV_STAGES + 1) * KV_TILE
    rel = ((bad - want).norm(dim=-1)
           / want.norm(dim=-1).clamp_min(1e-30))[:, past:]
    per_slab = rel.unflatten(1, (-1, slab)).amax(-1)
    assert per_slab.shape == (bh, (s - past) // slab)
    assert float(per_slab.min()) > FLASH_ROW_REL


def test_dispatcher_refuses_what_it_cannot_honour():
    q = torch.zeros(1, 8, 2, 64)
    k = torch.zeros(1, 8, 1, 64)
    with pytest.raises(ValueError, match="CUDA kernel"):
        tf.flash_attention(q, k, k, use_kernel=True)
    with pytest.raises(ValueError, match="CUDA kernel"):
        tf.flash_attention_cuda(q, k, k)
    # the CPU route has a gradient: the plain backward's
    out = tf.flash_attention(q.requires_grad_(True), k, k)
    (grad,) = torch.autograd.grad(out.sum(), q)
    assert grad.shape == q.shape and bool(torch.isfinite(grad).all())
    with torch.no_grad():
        assert tf.flash_attention(q, k, k).shape == (1, 8, 2, 64)


@pytest.mark.parametrize("dtype,dh,takes", [
    (torch.float32, 16, True), (torch.float32, 64, True),
    (torch.float32, 128, True), (torch.bfloat16, 64, True),
    (torch.bfloat16, 128, True), (torch.bfloat16, 16, False),
    (torch.float32, 32, False)])
def test_kernel_head_dims_by_type(dtype, dh, takes):
    """The kernel takes float32 at head dim 16 (every smoke config's), 64
    and 128, bfloat16 at 64 and 128; any other pair raises an error that
    names the type and the dims it takes."""
    from repro_torch.kernels.flashattn.kernel import HEAD_DIMS, check_inputs
    q = torch.zeros(1, 8, 4, dh, dtype=dtype)
    k = torch.zeros(1, 8, 2, dh, dtype=dtype)
    assert (dh in HEAD_DIMS[dtype]) == takes
    if takes:
        check_inputs(q, k, k)
    else:
        with pytest.raises(ValueError, match=rf"head_dim {dh} .*{dtype}.*"
                                             rf"{HEAD_DIMS[dtype]}"):
            check_inputs(q, k, k)
