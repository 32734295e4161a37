"""granite-moe-3b-a800m [moe] — 32L d_model=1536 24H (GQA kv=8), head
dim 64, vocab=49155, MoE 40 experts top-8 of width 512 a layer, bfloat16.
[hf:ibm-granite/granite-3.0-3b-a800m-base family]

The reference config's values, field for field: 3.38e9 parameters
(6.75 GB in bfloat16), 0.96e9 active a token (``active_params()``,
which counts the untied head and the embedding both)."""
import torch

from ..models.moe import MoEConfig
from ..models.transformer import TransformerConfig

__all__ = ["make_config", "make_smoke_config"]


def make_config():
    return TransformerConfig(
        name="granite-moe-3b-a800m", n_layers=32, d_model=1536, n_heads=24,
        n_kv_heads=8, d_ff=0, vocab=49155,
        moe=MoEConfig(n_experts=40, top_k=8, d_model=1536, d_ff=512),
        rope_theta=10_000.0,
    )


def make_smoke_config():
    return TransformerConfig(
        name="granite-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=0, vocab=211,
        moe=MoEConfig(n_experts=4, top_k=2, d_model=64, d_ff=32),
        dtype=torch.float32, attn_impl="dense", remat=False)
