"""The arithmetic of K5's float32 route, emulated on the CPU.

The CUDA kernel (``src/repro_torch/kernels/flashattn/csrc/flashattn.cu``,
``flash_f32_kernel``) runs q K^T and P V on the tensor cores as three
TF32 products: every float32 operand x is split into x = hi + lo with
hi = tf32(x) and lo = tf32(x - hi), both rounded to nearest with ties
away from zero (``cvt.rna.tf32.f32``), and a b is a_lo b_hi + a_hi b_lo
+ a_hi b_hi summed in float32; a_lo b_lo is dropped.  Scores, softmax
and P stay float32 between the two products.

This file emulates that arithmetic with numpy-seeded inputs and holds
it within the route's tolerance, 3e-5 absolute and relative, of the
plain versions (the port's ``flash_attention_ref`` and the JAX
package's).  Its control shows that the tolerance would catch a lost
correction term: one TF32 product a matmul, and q, k, v rounded to
TF32 before the plain version, each lie beyond 3e-5.  The card holds
the kernel itself against the plain version (``chip_smoke.py`` [11],
``tests/test_torch_kernels_gpu.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flashattn import flash_attention_ref as j_ref
from repro_torch.kernels.flashattn import flash_attention_ref

TOL = 3e-5     # the float32 route's atol = rtol


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 mantissa bits), to nearest, ties away
    from zero: add half a unit of TF32's last place to the bits, then
    clear the 13 low bits (a carry into the exponent is the right
    result)."""
    return ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x):
    hi = tf32(x)
    return hi, tf32(x - hi)


def mm_split(a, b):
    """a @ b as the kernel takes it: three TF32 products, small first."""
    ah, al = split(a)
    bh, bl = split(b)
    return al @ bh + ah @ bl + ah @ bh


def mm_one_pass(a, b):
    return tf32(a) @ tf32(b)


def attention(q, k, v, causal: bool, mm):
    """(BH, S, dh) float32: softmax(q k^T / sqrt(dh)) v, masked keys at
    -1e30, with both products taken by ``mm``."""
    s, dh = q.shape[1], q.shape[2]
    scores = mm(q, k.transpose(1, 2)) * (1.0 / dh ** 0.5)
    if causal:
        scores = scores.masked_fill(
            torch.ones(s, s, dtype=torch.bool).triu(1), -1e30)
    p = torch.exp(scores - scores.amax(-1, keepdim=True))
    return mm(p, v) / p.sum(-1, keepdim=True).clamp_min(1e-30)


def excess(got, want) -> float:
    """The largest |got - want| / (TOL + TOL |want|): at most 1 within
    the tolerance."""
    return float(((got - want).abs() / (TOL + TOL * want.abs())).max())


def _inputs(dh: int, s: int, sharp: float):
    rng = np.random.default_rng(dh * 1000 + s)
    q, k, v = [rng.standard_normal((4, s, dh)).astype(np.float32)
               for _ in range(3)]
    return q * sharp, k * sharp, v


def test_tf32_rounding():
    """hi keeps 11 significant bits and is the nearest such value, ties
    away from zero; hi + lo holds x to 2^-22 of |x|."""
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        100_000).astype(np.float32) * 1e3)
    hi, lo = split(x)
    assert torch.equal(hi.view(torch.int32) & 0x1FFF, torch.zeros_like(
        hi.view(torch.int32)))
    ulp = torch.ldexp(torch.ones_like(x), torch.frexp(x)[1] - 11)
    assert bool(((x - hi).abs() <= ulp / 2).all())
    xd, hd, ld = x.double(), hi.double(), lo.double()
    assert bool(((hd + ld - xd).abs() <= xd.abs() * 2.0 ** -22).all())
    ties = torch.tensor([1 + 2 ** -11, -(1 + 2 ** -11), 1 + 3 * 2 ** -11],
                        dtype=torch.float32)
    assert tf32(ties).tolist() == [1 + 2 ** -10, -(1 + 2 ** -10),
                                   1 + 2 * 2 ** -10]


@pytest.mark.parametrize("dh", [16, 64, 128])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s,sharp", [(512, 1.0), (320, 2.0)])
def test_three_products_within_float32_tolerance(dh, causal, s, sharp):
    """The emulated kernel within 3e-5 of both plain versions, on N(0, 1)
    inputs and on q and k doubled (scores 4x as sharp)."""
    q, k, v = _inputs(dh, s, sharp)
    got = attention(*(torch.from_numpy(x) for x in (q, k, v)), causal,
                    mm_split)
    port = flash_attention_ref(*(torch.from_numpy(x) for x in (q, k, v)),
                               causal=causal)
    jax = torch.from_numpy(np.array(j_ref(
        *(jnp.asarray(x) for x in (q, k, v)), causal=causal)))
    for want in (port, jax):
        assert excess(got, want) <= 1.0
        torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("dh", [16, 64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_one_pass_and_tf32_inputs_lie_beyond_the_tolerance(dh, causal):
    """The control: one TF32 product a matmul, and the plain version on
    q, k, v rounded to TF32, each miss 3e-5 (7-26x at S 320 and 512 in
    tools/flash_f32_emulation.py), so the tolerance separates the three-product
    kernel from a kernel that lost its correction terms."""
    q, k, v = (torch.from_numpy(x) for x in _inputs(dh, 512, 1.0))
    want = flash_attention_ref(q, k, v, causal=causal)
    one_pass = attention(q, k, v, causal, mm_one_pass)
    rounded = flash_attention_ref(tf32(q), tf32(k), tf32(v), causal=causal)
    split3 = attention(q, k, v, causal, mm_split)
    assert excess(split3, want) <= 1.0 < excess(one_pass, want)
    assert 1.0 < excess(rounded, want)
