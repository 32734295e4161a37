"""moonshot-v1-16b-a3b [moe] — 48L d_model=2048 16H (kv=16: MHA), head
dim 128, vocab=163840, MoE 64 experts top-6 of width 1408 a layer,
bfloat16.  [hf:moonshotai/Moonlight-16B-A3B]

The reference config's values, kept for parity with it, though they do
not make the model of the name: 48 layers of 64 experts of width 1,408
come to 2.81e10 parameters (56.1 GB in bfloat16), not 1.6e10; the
reference folds the public checkpoint's shared experts into the routed
ones."""
import torch

from ..models.moe import MoEConfig
from ..models.transformer import TransformerConfig

__all__ = ["make_config", "make_smoke_config"]


def make_config():
    return TransformerConfig(
        name="moonshot-v1-16b-a3b", n_layers=48, d_model=2048, n_heads=16,
        n_kv_heads=16, d_ff=0, vocab=163840,
        moe=MoEConfig(n_experts=64, top_k=6, d_model=2048, d_ff=1408),
        rope_theta=50_000.0,
    )


def make_smoke_config():
    return TransformerConfig(
        name="moonshot-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, d_ff=0, vocab=211,
        moe=MoEConfig(n_experts=8, top_k=2, d_model=64, d_ff=48),
        dtype=torch.float32, attn_impl="dense", remat=False)
