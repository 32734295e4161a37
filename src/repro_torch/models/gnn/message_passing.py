"""Shared GNN substrate (``repro.models.gnn.message_passing``): padded
graph batches and the scatter/gather ops.

Message passing gathers source rows and sums them into destinations.
Shapes stay fixed: padded edges point at node 0 and carry
``edge_mask == 0``, so they add nothing.  Departure from the JAX
package, which sums with ``jax.ops.segment_sum``: :func:`scatter_mean`
runs its gather and sum as one call of the ``gather_segment_sum``
dispatcher, which on the card is the hand-written kernel K4.  The mask
products are exact (x1.0 or x0.0), so only the order of the sum differs.
The equivariant models' masked sums of per-edge messages,
``scatter_dst(m * edge_mask[:, None], dst, n)`` and ``scatter_mean(m,
dst, n, edge_mask)`` in the JAX package, are :func:`scatter_edges` and
:func:`scatter_edges_mean`: one ``gather_segment_sum(arange(E), dst,
edge_mask, m, n)`` call each, over the batch's second (edge) plan.

The explicit-collective (sharded) helpers of the JAX module,
``sharded_layer_collectives`` and ``sharded_aggregate``, wait for the
rest of the sharded lane (ROADMAP item 12).
"""
from __future__ import annotations

import dataclasses

import torch

from ...device import resolve_device
from ...kernels.segsum import SegmentPlan, build_plan, gather_segment_sum

__all__ = ["GraphBatch", "gather_src", "graph_regression_loss",
           "node_classification_loss", "scatter_dst", "scatter_edges",
           "scatter_edges_mean", "scatter_mean"]


@dataclasses.dataclass
class GraphBatch:
    """A (padded) graph or a disjoint union of graphs.

    x         : (N, F) float — input node features (may be zeros)
    z         : (N,) int32   — node type ids
    pos       : (N, 3) float — coordinates (equivariant models)
    src, dst  : (E,) int32   — directed edges; padded edges carry mask 0
    edge_mask : (E,) float32
    node_mask : (N,) float32
    labels    : (N,) int32   — node labels (classification cells)
    graph_id  : (N,) int32   — graph membership (batched molecules)
    y         : (G,) float32 — per-graph regression targets
    n_graphs  : int

    The batch caches, once each, the segment plan of its edges (src to
    dst, with the dst-to-src plan as its transpose), the plan of its
    edge rows (edge i to dst[i]) and the masked in-degree that the means
    divide by.
    """
    x: torch.Tensor
    z: torch.Tensor
    pos: torch.Tensor
    src: torch.Tensor
    dst: torch.Tensor
    edge_mask: torch.Tensor
    node_mask: torch.Tensor
    labels: torch.Tensor
    graph_id: torch.Tensor
    y: torch.Tensor
    n_graphs: int
    _cache: dict = dataclasses.field(default_factory=dict, repr=False,
                                     compare=False)

    @property
    def n_nodes(self) -> int:
        return int(self.x.shape[0])

    @property
    def n_edges(self) -> int:
        return int(self.src.shape[0])

    def tensors(self) -> dict:
        """The tensor fields by name."""
        return {f.name: getattr(self, f.name)
                for f in dataclasses.fields(self)
                if isinstance(getattr(self, f.name), torch.Tensor)}

    def to(self, device) -> "GraphBatch":
        dev = resolve_device(device)
        return GraphBatch(**{k: v.to(dev) for k, v in self.tensors().items()},
                          n_graphs=self.n_graphs)

    def segment_plan(self) -> SegmentPlan:
        """The plan of (ids=src, seg=dst) over the nodes; its transpose
        is that of (dst, src).  Built on first use."""
        if "plan" not in self._cache:
            self._cache["plan"] = build_plan(self.src, self.dst,
                                             self.n_nodes, self.n_nodes)
        return self._cache["plan"]

    def edge_ids(self) -> torch.Tensor:
        """(E,) int32 ``arange(E)``: the ids of the edge-row plan."""
        if "edge_ids" not in self._cache:
            self._cache["edge_ids"] = torch.arange(
                self.n_edges, dtype=torch.int32, device=self.dst.device)
        return self._cache["edge_ids"]

    def edge_plan(self) -> SegmentPlan:
        """The plan of (ids=arange(E), seg=dst): per-edge message rows
        summed into their destinations; its transpose (every segment one
        entry) carries the gradient back to the edge rows.  No hot tier:
        each edge row is read once.  Built on first use."""
        if "edge_plan" not in self._cache:
            self._cache["edge_plan"] = build_plan(
                self.edge_ids(), self.dst, self.n_nodes, self.n_edges,
                hot_rows=0)
        return self._cache["edge_plan"]

    def in_count(self) -> torch.Tensor:
        """(N, 1) float32: the masked in-degree of every node."""
        if "in_count" not in self._cache:
            self._cache["in_count"] = scatter_dst(
                self.edge_mask[:, None], self.dst, self.n_nodes)
        return self._cache["in_count"]


def gather_src(h, src):
    return h[src.long()]


def scatter_dst(msgs, dst, n_nodes: int):
    """Edge-to-node sum (``jax.ops.segment_sum`` over ``dst``)."""
    out = torch.zeros((n_nodes, *msgs.shape[1:]), dtype=msgs.dtype,
                      device=msgs.device)
    return out.index_add_(0, dst, msgs)


def scatter_mean(h, batch: GraphBatch, *, use_kernel=None):
    """Mean of the source rows ``h[src]`` over every node's masked
    in-edges: the fused form of the JAX package's
    ``scatter_mean(gather_src(h, batch.src), batch.dst, n, batch.edge_mask)``.
    The sum is one ``gather_segment_sum(src, dst, edge_mask, h, n)``
    (``use_kernel`` as there); the count is the batch's cached
    :meth:`GraphBatch.in_count`."""
    n = batch.n_nodes
    s = gather_segment_sum(batch.src, batch.dst, batch.edge_mask, h, n,
                           plan=batch.segment_plan(), use_kernel=use_kernel)
    return s / torch.clamp(batch.in_count(), min=1.0)


def scatter_edges(msgs, batch: GraphBatch, *, use_kernel=None):
    """Masked edge-to-node sum of per-edge messages ``msgs`` (E, D):
    the JAX package's ``scatter_dst(msgs * edge_mask[:, None], dst, n)``
    as one ``gather_segment_sum(arange(E), dst, edge_mask, msgs, n)``
    call over the batch's edge plan (``use_kernel`` as there).  Float32
    accumulation, rounded once to ``msgs.dtype``."""
    return gather_segment_sum(batch.edge_ids(), batch.dst, batch.edge_mask,
                              msgs, batch.n_nodes, plan=batch.edge_plan(),
                              use_kernel=use_kernel)


def scatter_edges_mean(msgs, batch: GraphBatch, *, use_kernel=None):
    """Mean of per-edge messages over every node's masked in-edges: the
    JAX package's ``scatter_mean(msgs, dst, n, edge_mask)``.  One
    :func:`scatter_edges` call over the batch's cached
    :meth:`GraphBatch.in_count`."""
    s = scatter_edges(msgs, batch, use_kernel=use_kernel)
    return s / torch.clamp(batch.in_count(), min=1.0)


def node_classification_loss(logits, batch: GraphBatch):
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, batch.labels.long()[:, None])[:, 0]
    nll = (logz - gold) * batch.node_mask
    return nll.sum() / torch.clamp(batch.node_mask.sum(), min=1.0)


def graph_regression_loss(node_energy, batch: GraphBatch):
    e = scatter_dst(node_energy * batch.node_mask, batch.graph_id,
                    batch.n_graphs)
    return torch.mean((e - batch.y.float()) ** 2)
