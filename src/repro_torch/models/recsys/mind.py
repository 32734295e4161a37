"""MIND: Multi-Interest Network with Dynamic routing (Li et al., 2019),
``repro.models.recsys.mind``.

  user history (B, H) item ids --lookup, masked--> behaviour vectors
  --dynamic routing (B2I, 3 iterations)--> K interest capsules (B, K, D)
  --label-aware attention--> user vector --in-batch softmax--> loss

The lookup is ``F.embedding`` where the JAX package takes rows with
``jnp.take``: it keeps the history axis (B, H, D), masks it and sums
nothing, so no segment sum (K4) computes it.  ``retrieval_scores`` is
one (K, D) @ (D, C) product and a max over K, never a loop over the
candidates.  Routing logits, attention and scores run in float32
whatever ``cfg.dtype`` is, as in the reference.

``param_specs`` (the table row-sharded over a TPU mesh) waits for
FSDP/TP sharding (ROADMAP §1 item 16).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

from ...device import DEFAULT_DEVICE, resolve_device
from ..common import dense_init, embed_init

__all__ = ["MindConfig", "init_params", "interest_capsules",
           "label_aware_user_vector", "retrieval_scores", "serve_interests",
           "train_loss"]

# added to the routing logits of a masked history slot: its coupling
# comes out 1 / K and its vector is 0 (-inf would give NaN)
_MASKED = -1e30


@dataclasses.dataclass(frozen=True)
class MindConfig:
    n_items: int = 2_097_152       # 2^21 rows
    embed_dim: int = 64
    n_interests: int = 4
    capsule_iters: int = 3
    hist_len: int = 50
    pow_p: float = 2.0             # label-aware attention sharpness
    dtype: Any = torch.float32


def init_params(generator: torch.Generator, cfg: MindConfig, *,
                device=DEFAULT_DEVICE) -> dict:
    """``item_embed`` (n_items, D) N(0, 0.02^2) and ``s_matrix`` (D, D)
    in ``cfg.dtype``; ``routing_init`` (K, D) float32, the per-interest
    routing logits' init (its fan in is K, the reference's
    ``shape[0]``)."""
    dev = resolve_device(device)
    d = cfg.embed_dim
    return {"item_embed": embed_init(generator, (cfg.n_items, d), cfg.dtype,
                                     device=dev),
            "s_matrix": dense_init(generator, (d, d), cfg.dtype, device=dev),
            "routing_init": dense_init(generator, (cfg.n_interests, d),
                                       torch.float32, device=dev)}


def _squash(x, dim: int = -1):
    n2 = torch.sum(x * x, dim=dim, keepdim=True)
    return (n2 / (1.0 + n2)) * x / torch.sqrt(n2 + 1e-9)


def interest_capsules(params, hist, hist_mask, cfg: MindConfig):
    """hist (B, H) ids, hist_mask (B, H) -> interests (B, K, D) in
    ``cfg.dtype``."""
    e = F.embedding(hist, params["item_embed"])
    e = e * hist_mask[..., None].to(e.dtype)
    u = (e @ params["s_matrix"]).float()                     # (B, H, D)
    b = torch.einsum("kd,bhd->bkh", params["routing_init"], u)
    mask_neg = (1.0 - hist_mask.float())[:, None, :] * _MASKED
    for _ in range(cfg.capsule_iters):
        c = torch.softmax(b + mask_neg, dim=1)               # over K
        v = _squash(torch.einsum("bkh,bhd->bkd", c, u))
        b = b + torch.einsum("bkd,bhd->bkh", v, u)
    return v.to(cfg.dtype)


def label_aware_user_vector(interests, target_emb, cfg: MindConfig):
    """Interests (B, K, D) attended by the target item (B, D) -> (B, D)
    float32."""
    iv = interests.float()
    att = torch.einsum("bkd,bd->bk", iv, target_emb.float())
    att = (att ** cfg.pow_p if cfg.pow_p == 1.0
           else torch.sign(att) * torch.abs(att) ** cfg.pow_p)
    return torch.einsum("bk,bkd->bd", torch.softmax(att, dim=-1), iv)


def train_loss(params, batch, cfg: MindConfig):
    """Softmax over in-batch negatives: batch = {hist (B, H), hist_mask
    (B, H), target (B,)}.  The reference's mean of logsumexp minus the
    diagonal of the (B, B) float32 logits, as ``F.cross_entropy`` with
    labels arange(B): one fused log-softmax, whose backward needs fewer
    (B, B) temporaries than logsumexp's and the diagonal's (each is
    65,536^2 x 4 bytes = 17.2 GB at the train_batch cell)."""
    interests = interest_capsules(params, batch["hist"], batch["hist_mask"],
                                  cfg)
    tgt = F.embedding(batch["target"], params["item_embed"])
    user = label_aware_user_vector(interests, tgt, cfg)
    logits = user @ tgt.float().T
    labels = torch.arange(logits.shape[0], device=logits.device)
    return F.cross_entropy(logits, labels)


def serve_interests(params, batch, cfg: MindConfig):
    """History -> K interest vectors of unit norm (B, K, D)."""
    v = interest_capsules(params, batch["hist"], batch["hist_mask"], cfg)
    norm = torch.linalg.vector_norm(v.float(), dim=-1, keepdim=True)
    return v / torch.clamp(norm, min=1e-6).to(v.dtype)


def retrieval_scores(params, batch, cfg: MindConfig):
    """One user's (C,) scores: the max over its K interests of their dot
    products with each candidate.  batch = {hist (1, H), hist_mask (1,
    H), candidates (C,)}."""
    v = serve_interests(params, batch, cfg)[0]               # (K, D)
    cand = F.embedding(batch["candidates"], params["item_embed"])
    return torch.amax(v.float() @ cand.float().T, dim=0)
