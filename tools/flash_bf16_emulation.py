"""CPU emulation of the flash-attention kernel's bfloat16 rounding (K5,
``src/repro_torch/kernels/flashattn/csrc/flashattn.cu``), which sets the
limits that ``chip_smoke.py`` holds its bfloat16 route to.

The kernel rounds P to bfloat16 before P V, sums l from the unrounded
P, and rounds its output to bfloat16; the plain version rounds only its
output.  This script reads, on N(0, 1) inputs:

1. the per-row gap ||got - want|| / ||want|| of the emulated kernel
   against the plain version, at S = 4096 (every row) and at the last
   512 rows of S = 32768, and the same for a stale ring slot in the rows
   past it: the kernel's K/V tiles hold 128 keys in a ring of 2 stages,
   so a consumer that reads a slot before its refill lands sees the tile
   two before (keys 256-383 read as keys 0-127);
2. end to end, a narrow llama-shaped bfloat16 model prefilled through
   the emulated kernel and through the plain route: each route's
   relative L2 distance of the last-token logits from the float32 plain
   route on the same bfloat16-valued weights, and their ratio, sound
   and with the stale tile in every layer.

Run: ``PYTHONPATH=src python tools/flash_bf16_emulation.py`` (about a
minute on a few CPU cores).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.kernels.flashattn.ref import _fold_gqa
from repro_torch.models import transformer as lm
from repro_torch.tree import tree_map


def attention(q, k, v, *, round_p: bool, causal: bool = True):
    """(BH, R, dh) queries over (BH, S, dh) keys, float32 softmax; the
    R queries are the last R positions.  ``round_p`` rounds P as the
    kernel does.  The output is rounded to bfloat16."""
    r, s, dh = q.shape[1], k.shape[1], q.shape[2]
    scores = q @ k.transpose(1, 2) / math.sqrt(dh)
    if causal:
        qpos = torch.arange(s - r, s)[:, None]
        scores = scores.masked_fill(torch.arange(s)[None, :] > qpos, -1e30)
    p = torch.exp(scores - scores.max(-1, keepdim=True).values)
    l = p.sum(-1, keepdim=True)
    if round_p:
        p = p.bfloat16().float()
    return ((p @ v) / l).bfloat16().float()


# the kernel's KV tile and ring depth
TILE, STAGES = 128, 2


def stale(x):
    """Keys of tile STAGES (256-383) replaced by those of tile 0."""
    x = x.clone()
    x[:, STAGES * TILE:(STAGES + 1) * TILE] = x[:, :TILE]
    return x


def row_gap(got, want):
    return (got - want).norm(dim=-1) / want.norm(dim=-1)


def kernel_level(s: int, heads: int, rows: int, seed: int) -> None:
    gen = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(heads, n, 128, generator=gen).bfloat16().float()
               for n in (rows, s, s))
    want = attention(q, k, v, round_p=False)
    sound = row_gap(attention(q, k, v, round_p=True), want)
    past = slice(max(0, (STAGES + 1) * TILE - (s - rows)), None)
    control = row_gap(attention(q, stale(k), stale(v), round_p=True),
                      want)[:, past]
    print(f"S={s}, last {rows} rows, {heads} heads: row gap max "
          f"{float(sound.max()):.4g}; stale tile, rows past it: min "
          f"{float(control.min()):.4g}")


def emulated_dispatcher(with_stale: bool):
    def flash_attention(q, k, v, *, causal=True, use_kernel=None):
        b, s, h, dh = q.shape
        qf, kf, vf = (x.float() for x in _fold_gqa(q, k, v))
        if with_stale:
            kf, vf = stale(kf), stale(vf)
        o = attention(qf, kf, vf, round_p=True, causal=causal).to(q.dtype)
        return o.reshape(b, h, s, dh).transpose(1, 2)
    return flash_attention


def end_to_end(n_layers: int, s: int) -> None:
    cfg = lm.TransformerConfig(
        name="emulation", n_layers=n_layers, d_model=512, n_heads=8,
        n_kv_heads=2, head_dim=64, d_ff=1024, vocab=2000, rope_theta=5e5,
        dtype=torch.float32)
    p32 = lm.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    p32 = tree_map(lambda x: x.bfloat16().float(), p32)
    p16 = tree_map(lambda x: x.bfloat16(), p32)
    c16 = dataclasses.replace(cfg, dtype=torch.bfloat16)
    tokens = torch.randint(0, cfg.vocab, (1, s),
                           generator=torch.Generator().manual_seed(1))

    def rel(a, b):
        return float((a.float() - b.float()).norm() / b.float().norm())

    plain = lm.flash_attention
    with torch.no_grad():
        exact, _ = lm.prefill_step(p32, tokens, cfg)
        e_plain = rel(lm.prefill_step(p16, tokens, c16)[0], exact)
        try:
            found = []
            for with_stale in (False, True):
                lm.flash_attention = emulated_dispatcher(with_stale)
                found.append(rel(lm.prefill_step(p16, tokens, c16)[0], exact))
        finally:
            lm.flash_attention = plain
    print(f"{n_layers} layers, S={s}: plain {e_plain:.4g} from float32, "
          f"emulated kernel {found[0]:.4g} (ratio {found[0] / e_plain:.3g}), "
          f"stale tile {found[1]:.4g} (ratio {found[1] / e_plain:.3g})")


def main() -> None:
    torch.set_num_threads(4)
    kernel_level(4096, 4, 4096, seed=0)
    kernel_level(32768, 8, 512, seed=0)
    end_to_end(4, 512)
    end_to_end(8, 1024)


if __name__ == "__main__":
    main()
