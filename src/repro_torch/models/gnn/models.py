"""GraphSAGE (``repro.models.gnn.models``, its GraphSAGE part): 2 layers,
mean aggregator (Hamilton et al. '17), as plain functions over a param
dict with the JAX package's names and layout.

EGNN, NequIP and MACE wait for their slice of the port.
"""
from __future__ import annotations

import dataclasses

import torch

from ...device import DEFAULT_DEVICE, resolve_device
from ..common import dense_init
from .message_passing import GraphBatch, node_classification_loss, scatter_mean

__all__ = ["SageConfig", "sage_forward", "sage_init", "sage_loss"]


@dataclasses.dataclass(frozen=True)
class SageConfig:
    n_layers: int = 2
    d_in: int = 602
    d_hidden: int = 128
    n_classes: int = 41
    n_types: int = 32          # fallback embedding when x is absent
    aggregator: str = "mean"
    # "sharded" | "replicated" in the JAX package's multi-device cells;
    # kept for the configs, no effect on one GPU
    node_sharding: str = "sharded"


def sage_init(generator: torch.Generator, cfg: SageConfig, *,
              device=DEFAULT_DEVICE) -> dict:
    """Float32 parameters drawn from ``generator`` in a fixed order
    (embed_in, embed_z, each layer's w_self and w_neigh, head)."""
    dev = resolve_device(device)

    def draw(shape):
        return dense_init(generator, shape, torch.float32, device=dev)

    params = {"embed_in": draw((cfg.d_in, cfg.d_hidden)),
              "embed_z": draw((cfg.n_types, cfg.d_hidden)),
              "layers": []}
    for _ in range(cfg.n_layers):
        params["layers"].append({
            "w_self": draw((cfg.d_hidden, cfg.d_hidden)),
            "w_neigh": draw((cfg.d_hidden, cfg.d_hidden))})
    params["head"] = draw((cfg.d_hidden, cfg.n_classes))
    return params


def sage_forward(params, batch: GraphBatch, cfg: SageConfig, *,
                 use_kernel=None):
    """(N, n_classes) logits.  Each layer's neighbour mean is one
    ``gather_segment_sum`` call (``use_kernel`` as there)."""
    if cfg.aggregator != "mean":
        raise NotImplementedError(f"aggregator {cfg.aggregator!r}: the JAX "
                                  "package implements mean only")
    h = batch.x.float() @ params["embed_in"] \
        + params["embed_z"][batch.z.long()]
    for lp in params["layers"]:
        neigh = scatter_mean(h, batch, use_kernel=use_kernel)
        h = torch.relu(h @ lp["w_self"] + neigh @ lp["w_neigh"])
        h = h / torch.clamp(torch.linalg.vector_norm(h, dim=-1, keepdim=True),
                            min=1e-6)
    return h @ params["head"]


def sage_loss(params, batch: GraphBatch, cfg: SageConfig, *,
              use_kernel=None):
    return node_classification_loss(
        sage_forward(params, batch, cfg, use_kernel=use_kernel), batch)
