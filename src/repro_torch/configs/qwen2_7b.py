"""qwen2-7b [dense] — 28L d_model=3584 28H (GQA kv=4), head dim 128,
d_ff=18944, vocab=152064, QKV bias, rope_theta 1e6, bfloat16.
[arXiv:2407.10671]

The reference config's values: untied embeddings, 7.62e9 parameters
(15.2 GB in bfloat16)."""
import torch

from ..models.transformer import TransformerConfig

__all__ = ["make_config", "make_smoke_config"]


def make_config():
    return TransformerConfig(
        name="qwen2-7b", n_layers=28, d_model=3584, n_heads=28,
        n_kv_heads=4, d_ff=18944, vocab=152064, head_dim=128,
        qkv_bias=True, rope_theta=1_000_000.0,
    )


def make_smoke_config():
    return TransformerConfig(
        name="qwen-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab=211, qkv_bias=True, dtype=torch.float32,
        attn_impl="dense", remat=False)
