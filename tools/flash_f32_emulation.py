"""CPU emulation of the flash-attention kernel's float32 route (K5's
``flash_f32_kernel``, ``src/repro_torch/kernels/flashattn/csrc/flashattn.cu``):
how far split TF32 lies from the plain version, against the route's
tolerance of 3e-5 (absolute and relative).

The kernel takes every product on the tensor cores as three TF32
products: x = hi + lo with hi rounded to TF32 to nearest (ties away
from zero) and lo = x - hi, which the tensor core reads truncated to
TF32; a b = a_lo b_hi + a_hi b_lo + a_hi b_hi in float32.  On seeded
N(0, 1) inputs, with q and k also scaled by 2 and 4 (scores 4 and 16
times as large), this prints the largest |got - want| / (3e-5 + 3e-5
|want|) (at most 1 inside the tolerance) of:

* ``kernel``: the emulation above, against the plain float32 version;
* ``lo rounded``: the same with lo rounded to TF32 to nearest too
  (``cvt.rna.tf32.f32`` on both halves);
* ``one pass``: one TF32 product a matmul;
* ``tf32 inputs``: the plain version on q, k, v rounded to TF32;
* ``plain vs f64``: the plain float32 version against a float64 one,
  which shows where float32 itself reaches the tolerance.

Run: ``PYTHONPATH=src python tools/flash_f32_emulation.py`` (a few
seconds).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.flashattn import flash_attention_ref

TOL = 3e-5


def tf32_rna(x):
    return ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_trunc(x):
    return (x.view(torch.int32) & ~0x1FFF).view(torch.float32)


def mm_split(lo_round):
    def mm(a, b):
        ah, bh = tf32_rna(a), tf32_rna(b)
        al, bl = lo_round(a - ah), lo_round(b - bh)
        return al @ bh + ah @ bl + ah @ bh
    return mm


def mm_one_pass(a, b):
    return tf32_rna(a) @ tf32_rna(b)


def attention(q, k, v, causal: bool, mm, dtype=torch.float32):
    """(BH, S, dh): softmax(q k^T / sqrt(dh)) v, masked keys at -1e30,
    both products by ``mm``, in ``dtype``."""
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    s, dh = q.shape[1], q.shape[2]
    scores = mm(q, k.transpose(1, 2)) * (1.0 / dh ** 0.5)
    if causal:
        scores = scores.masked_fill(
            torch.ones(s, s, dtype=torch.bool).triu(1), -1e30)
    p = torch.exp(scores - scores.amax(-1, keepdim=True))
    return mm(p, v) / p.sum(-1, keepdim=True).clamp_min(1e-30)


def excess(got, want) -> float:
    got, want = got.double(), want.double()
    return float(((got - want).abs() / (TOL + TOL * want.abs())).max())


def main() -> None:
    print("largest gap / allowed (3e-5): at most 1 inside the tolerance")
    print(f"{'dh':>4} {'S':>5} {'causal':>6} {'q,k x':>5} {'kernel':>8} "
          f"{'lo rounded':>10} {'one pass':>9} {'tf32 inputs':>11} "
          f"{'plain vs f64':>12}")
    for scale in (1.0, 2.0, 4.0):
        for dh in (16, 64, 128):
            for s in (320, 512):
                for causal in (True, False):
                    rng = np.random.default_rng(dh * 1000 + s)
                    q, k, v = [torch.from_numpy(rng.standard_normal(
                        (4, s, dh)).astype(np.float32)) for _ in range(3)]
                    q, k = q * scale, k * scale
                    want = flash_attention_ref(q, k, v, causal=causal)
                    f64 = attention(q, k, v, causal, torch.matmul,
                                    torch.float64)
                    row = [
                        attention(q, k, v, causal, mm_split(tf32_trunc)),
                        attention(q, k, v, causal, mm_split(tf32_rna)),
                        attention(q, k, v, causal, mm_one_pass),
                        flash_attention_ref(tf32_rna(q), tf32_rna(k),
                                            tf32_rna(v), causal=causal)]
                    gaps = [excess(x, want) for x in row]
                    print(f"{dh:>4} {s:>5} {str(causal):>6} {scale:>5g} "
                          f"{gaps[0]:>8.3f} {gaps[1]:>10.3f} "
                          f"{gaps[2]:>9.2f} {gaps[3]:>11.2f} "
                          f"{excess(want, f64):>12.3f}")


if __name__ == "__main__":
    main()
