"""Data pipeline (``repro.data.pipeline``): the full-batch GraphBatch of
a graph.  The layer-wise ``NeighborSampler`` waits for its slice."""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve_device
from ..models.gnn.message_passing import GraphBatch

__all__ = ["graph_to_batch"]


def graph_to_batch(graph, *, d_feat: int, n_classes: int, seed: int = 0,
                   pad_nodes: Optional[int] = None,
                   pad_edges: Optional[int] = None,
                   device=DEFAULT_DEVICE) -> GraphBatch:
    """Full-batch :class:`GraphBatch` of a port ``Graph``: its directed
    edges (padded edges at node 0 with mask 0) and seeded random
    features, types, coordinates and labels.  The numpy draws are those
    of the JAX package's ``graph_to_batch`` in the same order, so every
    leaf is bitwise the JAX package's."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    n, e = graph.n_nodes, graph.n_edges
    pn = pad_nodes or n
    pe = pad_edges or e

    def host(a):
        return torch.from_numpy(a).to(dev)

    src = torch.zeros(pe, dtype=torch.int32, device=dev)
    dst = torch.zeros(pe, dtype=torch.int32, device=dev)
    src[:e] = graph.src[:e].to(dev)
    dst[:e] = graph.dst[:e].to(dev)
    emask = torch.zeros(pe, dtype=torch.float32, device=dev)
    emask[:e] = 1.0
    nmask = torch.zeros(pn, dtype=torch.float32, device=dev)
    nmask[:n] = 1.0
    x = host(rng.standard_normal((pn, d_feat)).astype(np.float32))
    z = host(rng.integers(0, 16, pn).astype(np.int32))
    pos = host(rng.standard_normal((pn, 3)).astype(np.float32))
    labels = host(rng.integers(0, max(n_classes, 1), pn).astype(np.int32))
    return GraphBatch(
        x=x, z=z, pos=pos, src=src, dst=dst, edge_mask=emask,
        node_mask=nmask, labels=labels,
        graph_id=torch.zeros(pn, dtype=torch.int32, device=dev),
        y=torch.zeros(1, dtype=torch.float32, device=dev), n_graphs=1)
