"""llama3.2-3b [dense] — 28L d_model=3072 24H (GQA kv=8) d_ff=8192,
vocab=128256, head_dim 128, rope_theta 5e5, bfloat16.
[hf:meta-llama/Llama-3.2-3B]

The reference config's values, kept for parity with it: it differs
from the published model in two ways.  Its embeddings are untied (a
separate lm_head, 3.61e9 parameters against the published 3.21e9), and
RoPE runs without the published llama3 rope_scaling."""
import torch

from ..models.transformer import TransformerConfig

__all__ = ["make_config", "make_smoke_config"]


def make_config():
    return TransformerConfig(
        name="llama3.2-3b", n_layers=28, d_model=3072, n_heads=24,
        n_kv_heads=8, d_ff=8192, vocab=128256, head_dim=128,
        rope_theta=500_000.0,
    )


def make_smoke_config():
    return TransformerConfig(
        name="llama-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab=211, dtype=torch.float32, attn_impl="dense",
        remat=False)
