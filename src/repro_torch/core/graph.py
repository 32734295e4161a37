"""Graph storage for sampling-based betweenness on one GPU.

The PyTorch counterpart of ``repro.core.graph``.  The graph is replicated
on the device as dense index tensors, in the same three layouts as the
JAX package, array for array:

* CSR (``indptr``/``indices``) for the backward path walk;
* COO (``src``/``dst``, sorted by source), from which the flat frontier
  route's in-edge plan is built on first use (:meth:`Graph.pull_plan`);
* the optional node-blocked CSC layout (:class:`CSCLayout`), edges
  bucketed by destination node block and, inside a bucket, ranged by
  source block, each (destination block, source block) pair padded to a
  multiple of ``block_e``.  It drives the node-blocked frontier kernel,
  which skips edge blocks that hold no frontier source.

The builders run the JAX package's algorithms with torch operations on
the target device (deduplication, the stable sort by source, the block
bucketing), so a graph of 57M directed edges is built on the card in
seconds; random draws still come from numpy's generator, so a seed gives
the JAX package's graph.  At a given blocking every array equals its JAX
twin.  Padded edge slots point at the sink row ``n_nodes``, whose BFS
distance (-3) never matches a frontier level.

The blocking default differs from the JAX package's on purpose: the
TPU kernel sizes its blocks to fit VMEM (block_v=256 at B=64), and at
that blocking the pair padding of a scattered R-MAT graph exceeds the
edges many times over (50,164 of 66,049 pairs populated at scale 16).
The card's node-blocked kernel keeps no state tile in fast memory, so
:func:`choose_csc_blocks` takes large node blocks that bound the number
of pairs instead.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve_device

__all__ = [
    "Graph", "CSCLayout", "bucket_layout", "build_graph", "build_csc_layout",
    "choose_csc_blocks", "with_csc_layout", "from_edge_list",
    "graph_from_numpy", "rmat_graph", "hyperbolic_graph", "grid_graph",
    "erdos_renyi_graph",
]

# The card's node-blocked blocking: 2^14 rows per node block gives 65
# node blocks at 2^20 vertices, so at most 65^2 ~ 4.2K (destination,
# source) block pairs, each padded to at most one extra edge block.
CSC_BLOCK_V = 1 << 14
CSC_BLOCK_E = 1024


@dataclasses.dataclass(frozen=True)
class CSCLayout:
    """Edges bucketed by destination node block (see ``bucket_layout``)."""

    src: torch.Tensor          # (n_edge_blocks * block_e,) int32
    dst: torch.Tensor          # (n_edge_blocks * block_e,) int32
    block_nb: torch.Tensor     # (n_edge_blocks,) int32 destination block
    block_sb: torch.Tensor     # (n_edge_blocks,) int32 source block
    block_first: torch.Tensor  # (n_edge_blocks,) int32 first block of bucket
    block_v: int
    block_e: int
    n_node_blocks: int
    n_edge_blocks: int
    n_nodes: int
    n_src_blocks: int

    @property
    def v_pad(self) -> int:
        return self.n_node_blocks * self.block_v

    @property
    def e_slots(self) -> int:
        return int(self.src.shape[0])

    def to(self, device) -> "CSCLayout":
        dev = resolve_device(device)
        return dataclasses.replace(
            self, src=self.src.to(dev), dst=self.dst.to(dev),
            block_nb=self.block_nb.to(dev), block_sb=self.block_sb.to(dev),
            block_first=self.block_first.to(dev))


@dataclasses.dataclass(frozen=True)
class Graph:
    """An undirected, unweighted graph in CSR + COO form (torch tensors).

    ``n_nodes``/``n_edges`` are the logical sizes (``n_edges`` counts
    directed slots, both directions of every edge); arrays are padded to
    ``e_pad`` slots with sink edges.
    """

    indptr: torch.Tensor   # (V+1,) int32
    indices: torch.Tensor  # (E_pad,) int32
    src: torch.Tensor      # (E_pad,) int32, sorted by source
    dst: torch.Tensor      # (E_pad,) int32
    degree: torch.Tensor   # (V,) int32
    n_nodes: int
    n_edges: int
    max_degree: int
    csc: Optional[CSCLayout] = None
    _cache: dict = dataclasses.field(default_factory=dict, repr=False,
                                     compare=False)

    @property
    def e_pad(self) -> int:
        return int(self.indices.shape[0])

    def pull_plan(self):
        """The flat frontier route's plan of (src, dst) over the V+1
        state rows (``kernels.frontier.build_pull_plan``); built on first
        use, then kept while it is the plan of this graph's edges (a
        ``dataclasses.replace`` copy shares the cache)."""
        plan = self._cache.get("pull")
        if plan is None or plan.ids is not self.src \
                or plan.seg is not self.dst \
                or plan.n_segments != self.n_nodes + 1:
            from ..kernels.frontier import build_pull_plan
            self._cache["pull"] = build_pull_plan(self.src, self.dst,
                                                  self.n_nodes + 1)
        return self._cache["pull"]

    @property
    def device(self) -> torch.device:
        return self.src.device

    def to(self, device) -> "Graph":
        dev = resolve_device(device)
        return dataclasses.replace(
            self, indptr=self.indptr.to(dev), indices=self.indices.to(dev),
            src=self.src.to(dev), dst=self.dst.to(dev),
            degree=self.degree.to(dev),
            csc=None if self.csc is None else self.csc.to(dev), _cache={})


def _tensor(a, dev) -> torch.Tensor:
    a = np.ascontiguousarray(a, np.int32)
    if not a.flags.writeable:     # e.g. a view of a JAX array
        a = a.copy()
    return torch.from_numpy(a).to(dev)


def graph_from_numpy(arrays: dict, n_nodes: int, n_edges: int,
                     max_degree: int, csc: Optional[dict] = None, *,
                     device=DEFAULT_DEVICE) -> Graph:
    """A :class:`Graph` from numpy arrays, e.g. the leaves of a JAX graph.

    ``arrays`` holds ``indptr``, ``indices``, ``src``, ``dst`` and
    ``degree``; ``csc`` (optional) holds the layout's five arrays (``src``,
    ``dst``, ``block_nb``, ``block_sb``, ``block_first``) and its static
    ints (``block_v``, ``block_e``, ``n_node_blocks``, ``n_edge_blocks``,
    ``n_nodes``, ``n_src_blocks``).  The arrays are taken as they are, so
    both packages traverse the same edges in the same order.
    """
    dev = resolve_device(device)
    layout = None
    if csc is not None:
        layout = CSCLayout(
            **{k: _tensor(csc[k], dev) for k in
               ("src", "dst", "block_nb", "block_sb", "block_first")},
            **{k: int(csc[k]) for k in
               ("block_v", "block_e", "n_node_blocks", "n_edge_blocks",
                "n_nodes", "n_src_blocks")})
    return Graph(
        **{k: _tensor(arrays[k], dev) for k in
           ("indptr", "indices", "src", "dst", "degree")},
        n_nodes=int(n_nodes), n_edges=int(n_edges),
        max_degree=int(max_degree), csc=layout)


def _long(a, dev) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device=dev, dtype=torch.int64)
    return torch.from_numpy(np.asarray(a, np.int64).copy()).to(dev)


def from_edge_list(edges, n_nodes: int | None = None, *, pad_to: int = 128,
                   device=DEFAULT_DEVICE) -> Graph:
    """Build a :class:`Graph` from an (M, 2) array of undirected edges.

    Self-loops and duplicate edges are removed.  Vertex ids must be in
    ``[0, n_nodes)``.
    """
    dev = resolve_device(device)
    edges = _long(edges, dev)
    if edges.dim() != 2 or edges.shape[1] != 2:
        raise ValueError(f"edges must be (M, 2), got {tuple(edges.shape)}")
    if n_nodes is None:
        n_nodes = int(edges.max()) + 1 if edges.numel() else 1
    u = torch.minimum(edges[:, 0], edges[:, 1])
    v = torch.maximum(edges[:, 0], edges[:, 1])
    keep = u != v
    uv = torch.unique(u[keep] * n_nodes + v[keep])      # sorted
    u, v = uv // n_nodes, uv % n_nodes
    return build_graph(torch.cat([u, v]), torch.cat([v, u]), n_nodes,
                       pad_to=pad_to, device=dev)


def build_graph(src, dst, n_nodes: int, *, pad_to: int = 128,
                device=DEFAULT_DEVICE) -> Graph:
    """Build from a directed (already symmetrized) edge list."""
    dev = resolve_device(device)
    src, dst = _long(src, dev), _long(dst, dev)
    order = torch.sort(src, stable=True).indices
    src, dst = src[order], dst[order]
    n_edges = int(src.shape[0])
    degree = torch.bincount(src, minlength=n_nodes)
    indptr = torch.zeros(n_nodes + 1, dtype=torch.int64, device=dev)
    indptr[1:] = torch.cumsum(degree, 0)
    # at least one full pad block after the last real edge
    e_pad = (n_edges // pad_to + 2) * pad_to
    fill = torch.full((e_pad - n_edges,), n_nodes, dtype=torch.int64,
                      device=dev)
    src_p = torch.cat([src, fill]).to(torch.int32)
    dst_p = torch.cat([dst, fill]).to(torch.int32)
    return Graph(
        indptr=indptr.to(torch.int32), indices=dst_p, src=src_p,
        dst=dst_p, degree=degree.to(torch.int32),
        n_nodes=int(n_nodes), n_edges=n_edges,
        max_degree=int(degree.max()) if n_nodes else 0)


# ---------------------------------------------------------------------------
# Node-blocked CSC layout
# ---------------------------------------------------------------------------

def bucket_layout(src, dst, nb, n_buckets: int, block_e: int, *,
                  sink_src: int, sink_dst: int, src_block,
                  sink_src_block: int):
    """Bucket an edge list by ``(nb, src_block)`` pairs, block-padded.

    All inputs are int64 tensors on one device.  Within each destination
    bucket ``nb`` the edges are sorted by source block (stable, so CSR
    order within a pair); every (bucket, source block) pair gets its own
    range padded with ``(sink_src, sink_dst)`` edges to a multiple of
    ``block_e``.  Buckets with no edges get one all-pad block.  Returns
    int32 ``(out_src, out_dst, block_nb, block_sb, block_first)``;
    ``block_first`` flags the first edge block of each destination
    bucket.
    """
    dev = src.device
    i64 = dict(dtype=torch.int64, device=dev)
    mult = max(int(sink_src_block),
               int(src_block.max()) if src_block.numel() else 0) + 1
    pair = nb * mult + src_block
    order = torch.sort(pair, stable=True).indices
    pair_sorted = pair[order]
    upairs, counts = torch.unique_consecutive(pair_sorted,
                                              return_counts=True)
    buckets = torch.arange(n_buckets, **i64)
    missing = buckets[~torch.isin(buckets, upairs // mult)]
    if missing.numel():
        upairs = torch.cat([upairs, missing * mult + sink_src_block])
        counts = torch.cat([counts, torch.zeros_like(missing)])
        reorder = torch.sort(upairs, stable=True).indices
        upairs, counts = upairs[reorder], counts[reorder]
    slots = torch.clamp((counts + block_e - 1) // block_e * block_e,
                        min=block_e)
    slot_starts = torch.zeros(upairs.numel() + 1, **i64)
    slot_starts[1:] = torch.cumsum(slots, 0)
    total = int(slot_starts[-1])
    out_src = torch.full((total,), sink_src, dtype=torch.int32, device=dev)
    out_dst = torch.full((total,), sink_dst, dtype=torch.int32, device=dev)
    first_edge = torch.zeros(upairs.numel() + 1, **i64)
    first_edge[1:] = torch.cumsum(counts, 0)
    p = torch.searchsorted(upairs, pair_sorted)
    pos = slot_starts[p] + torch.arange(order.numel(), **i64) - first_edge[p]
    out_src[pos] = src[order].to(torch.int32)
    out_dst[pos] = dst[order].to(torch.int32)
    eblocks = slots // block_e
    block_nb = torch.repeat_interleave((upairs // mult).to(torch.int32),
                                       eblocks)
    block_sb = torch.repeat_interleave((upairs % mult).to(torch.int32),
                                       eblocks)
    is_new_bucket = torch.ones(upairs.numel(), dtype=torch.bool, device=dev)
    is_new_bucket[1:] = (upairs[1:] // mult) != (upairs[:-1] // mult)
    block_first = torch.zeros(block_nb.numel(), dtype=torch.int32,
                              device=dev)
    block_first[slot_starts[:-1][is_new_bucket] // block_e] = 1
    return out_src, out_dst, block_nb, block_sb, block_first


def choose_csc_blocks(n_nodes: int) -> tuple:
    """The card's ``(block_v, block_e)``: node blocks of ``CSC_BLOCK_V``
    rows (128-aligned, capped at the padded vertex count) and edge blocks
    of ``CSC_BLOCK_E`` slots.

    The node-blocked kernel accumulates straight into device memory and
    stages only an edge block's indices in shared memory, so the blocking
    bounds padding and skip granularity, not a fast-memory tile: large
    node blocks keep the number of (destination, source) block pairs, and
    with it the pair padding, small on scattered graphs.
    """
    v_cap = max(128, -(-(n_nodes + 1) // 128) * 128)
    return min(CSC_BLOCK_V, v_cap), CSC_BLOCK_E


def build_csc_layout(graph: Graph, *, block_v: int | None = None,
                     block_e: int | None = None) -> CSCLayout:
    """Bucket ``graph``'s edges by destination node block of ``block_v``.

    Blocking left as ``None`` comes from :func:`choose_csc_blocks`;
    explicit values always win (that is how the layout is compared with
    the JAX package's at its own blocking).
    """
    auto_v, auto_e = choose_csc_blocks(graph.n_nodes)
    block_v = auto_v if block_v is None else int(block_v)
    block_e = auto_e if block_e is None else int(block_e)
    n_nb = -(-(graph.n_nodes + 1) // block_v)
    src = graph.src[: graph.n_edges].long()
    dst = graph.dst[: graph.n_edges].long()
    out_src, out_dst, block_nb, block_sb, block_first = bucket_layout(
        src, dst, dst // block_v, n_nb, block_e,
        sink_src=graph.n_nodes, sink_dst=graph.n_nodes,
        src_block=src // block_v, sink_src_block=graph.n_nodes // block_v)
    return CSCLayout(
        src=out_src, dst=out_dst, block_nb=block_nb, block_sb=block_sb,
        block_first=block_first, block_v=block_v, block_e=block_e,
        n_node_blocks=int(n_nb), n_edge_blocks=int(block_nb.shape[0]),
        n_nodes=int(graph.n_nodes), n_src_blocks=int(n_nb))


def with_csc_layout(graph: Graph, *, block_v: int | None = None,
                    block_e: int | None = None) -> Graph:
    """``graph`` with a :class:`CSCLayout` attached: the BFS drivers then
    allocate their state at ``csc.v_pad`` rows and expand every level
    through the node-blocked route."""
    return dataclasses.replace(
        graph, csc=build_csc_layout(graph, block_v=block_v, block_e=block_e))


# ---------------------------------------------------------------------------
# Generators (numpy, identical to the JAX package's for a given seed)
# ---------------------------------------------------------------------------

def rmat_graph(scale: int, edge_factor: int = 30, *, a: float = 0.57,
               b: float = 0.19, c: float = 0.19, seed: int = 0,
               pad_to: int = 128, device=DEFAULT_DEVICE) -> Graph:
    """R-MAT with the paper's (Graph500) parameters; ``|E| = edge_factor
    * 2^scale`` generated edges before deduplication."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    n = 1 << scale
    m = edge_factor * n
    srcs = torch.zeros(m, dtype=torch.int64, device=dev)
    dsts = torch.zeros(m, dtype=torch.int64, device=dev)
    # one quadrant decision per bit level, drawn on the host (numpy's
    # stream) and applied on the device
    for lvl in range(scale):
        r = torch.from_numpy(rng.random(m)).to(dev)
        go_right = ((r >= a + b) & (r < a + b + c)) | (r >= a + b + c)
        go_down = ((r >= a) & (r < a + b)) | (r >= a + b + c)
        srcs |= go_right.to(torch.int64) << lvl
        dsts |= go_down.to(torch.int64) << lvl
    return from_edge_list(torch.stack([srcs, dsts], dim=1), n,
                          pad_to=pad_to, device=dev)


def hyperbolic_graph(n: int, avg_degree: float = 60.0, *, gamma: float = 3.0,
                     seed: int = 0, pad_to: int = 128,
                     device=DEFAULT_DEVICE) -> Graph:
    """Random hyperbolic graph (threshold model), power-law exponent
    ``gamma``; O(n^2) pairwise distances, for small n."""
    rng = np.random.default_rng(seed)
    alpha = (gamma - 1.0) / 2.0
    R = 2.0 * np.log(8.0 * n * alpha**2 /
                     (np.pi * avg_degree * (alpha - 0.5) ** 2))
    u = rng.random(n)
    r = np.arccosh(1.0 + u * (np.cosh(alpha * R) - 1.0)) / alpha
    phi = rng.random(n) * 2.0 * np.pi
    edges = []
    chunk = max(1, 2_000_000 // max(n, 1))
    for i0 in range(0, n, chunk):
        i1 = min(n, i0 + chunk)
        dphi = np.abs(phi[i0:i1, None] - phi[None, :])
        dphi = np.minimum(dphi, 2.0 * np.pi - dphi)
        ch = (np.cosh(r[i0:i1, None]) * np.cosh(r[None, :])
              - np.sinh(r[i0:i1, None]) * np.sinh(r[None, :]) * np.cos(dphi))
        d = np.arccosh(np.maximum(ch, 1.0))
        ii, jj = np.nonzero(d < R)
        ii = ii + i0
        keep = ii < jj
        edges.append(np.stack([ii[keep], jj[keep]], axis=1))
    edges = np.concatenate(edges) if edges else np.zeros((0, 2), np.int64)
    return from_edge_list(edges, n, pad_to=pad_to, device=device)


def grid_graph(width: int, height: int, *, pad_to: int = 128,
               diag_p: float = 0.0, seed: int = 0,
               device=DEFAULT_DEVICE) -> Graph:
    """2D grid, the stand-in for high-diameter road networks."""
    ii, jj = np.meshgrid(np.arange(height), np.arange(width), indexing="ij")
    nid = (ii * width + jj).astype(np.int64)
    right = np.stack([nid[:, :-1].ravel(), nid[:, 1:].ravel()], axis=1)
    down = np.stack([nid[:-1, :].ravel(), nid[1:, :].ravel()], axis=1)
    edges = [right, down]
    if diag_p > 0:
        rng = np.random.default_rng(seed)
        diag = np.stack([nid[:-1, :-1].ravel(), nid[1:, 1:].ravel()], axis=1)
        edges.append(diag[rng.random(len(diag)) < diag_p])
    return from_edge_list(np.concatenate(edges), width * height,
                          pad_to=pad_to, device=device)


def erdos_renyi_graph(n: int, avg_degree: float = 8.0, *, seed: int = 0,
                      pad_to: int = 128, device=DEFAULT_DEVICE) -> Graph:
    rng = np.random.default_rng(seed)
    m = int(n * avg_degree / 2)
    e = rng.integers(0, n, size=(int(m * 1.2), 2))
    return from_edge_list(e, n, pad_to=pad_to, device=device)
