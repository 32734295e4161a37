"""gemma3-27b [dense] — 62L d_model=5376 32H (GQA kv=16) head dim 128,
d_ff=21504, vocab=262144, 5 local : 1 global layers (sliding window
1024), rope_theta 1e6, bfloat16.  [hf:google/gemma-3-27b family]

The reference config's values ("cfg per assignment; unverified"):
untied embeddings, 2.842e10 parameters (52.9 GiB in bfloat16), 10
groups of 6 layers and a remainder of 2 local ones.  Google's published
Gemma 3 also has QK-norm, logit soft-capping, GeLU, a separate RoPE
base for the local layers and sandwich norms; the reference has none of
them, and neither has the port."""
import torch

from ..models.transformer import TransformerConfig

__all__ = ["make_config", "make_smoke_config"]


def make_config():
    return TransformerConfig(
        name="gemma3-27b", n_layers=62, d_model=5376, n_heads=32,
        n_kv_heads=16, d_ff=21504, vocab=262144, head_dim=128,
        layer_pattern=("local", "local", "local", "local", "local",
                       "global"),
        window=1024, rope_theta=1_000_000.0,
    )


def make_smoke_config():
    return TransformerConfig(
        name="gemma3-smoke", n_layers=7, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=128, vocab=211,
        layer_pattern=("local", "local", "global"), window=8,
        dtype=torch.float32, attn_impl="dense", remat=False)
