"""Vertex-partitioned graph shards (``repro.core.partition``).

The sharded cooperative lane cuts the vertices into ``n_shards``
contiguous ranges of ``shard_rows = blocks_per_shard * block_v`` rows
(whole node blocks of the node-blocked CSC layout).  Every directed edge
lives in the shard that owns its destination, so a shard expands a BFS
level into its own rows from its own edges and the gathered frontier.

Sharding contract, as in the JAX package:

* the global padded row space is ``v_pad = n_shards * shard_rows``;
  global row == vertex id, rows at or past ``n_nodes`` (the sink and the
  tile padding) are inert;
* :class:`ShardedCSCLayout` holds each shard's buckets (built by
  :func:`repro_torch.core.graph.bucket_layout` over the shard's local
  node blocks) stacked on a leading shard axis, padded with inert edge
  blocks to one ``n_edge_blocks``;
* ``src`` ids are GLOBAL (they index the gathered frontier), ``dst`` ids
  are LOCAL shard rows; padding slots are ``src = n_nodes`` (the sink,
  never on a frontier) and ``dst = shard_rows`` (one row past the local
  tile).

:class:`PartitionedGraph` carries the shards and the replicated CSR
arrays (``indptr``/``indices``/``degree``) that the backward path walk
reads on the gathered state.  On a ``ShardMesh`` all shards lie on one
device: the mesh is an axis of the state (``repro_torch.core.shards``).
On a ``GroupShardMesh`` each process holds one shard: its partition is
*local* (``partition_graph(..., shard=rank)``), a stack of one row whose
``first_shard`` names it, the counterpart of the JAX layout's
``local()`` inside ``shard_map``.  The global metadata (``n_shards``,
``shard_rows``, ``v_pad``, the exchange chunks and budget) stays that of
the whole partition; only ``n_local_shards`` counts the rows held.

The frontier exchange of the sharded BFS comes in two protocols, dense
(the whole masked slice) and bitmap-scheduled sparse (only the source
chunks that hold frontier rows, at most ``exchange_budget`` a shard);
:class:`ExchangePlan` prices them.  The schedule's chunk is
``gcd(block_v, 128)`` rows.

Departure from the JAX package, as in ``core/graph.py``: blocking left
to the default comes from the card's :func:`choose_csc_blocks`, not the
TPU's VMEM heuristic.  At an explicit blocking every array equals the
JAX package's.

A weighted graph gives a weighted partition: each shard keeps its
weights in its bucketed order beside its edges (the layout's
``weight``, pad slots 0.0, from which :meth:`ShardedCSCLayout.relax_plan`
builds the weighted rounds' plan), and the partition keeps the
replicated CSR weights (``PartitionedGraph.weight``) for the backward
walks.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve_device
from .graph import CSCLayout, Graph, bucket_layout, build_graph, \
    choose_csc_blocks

__all__ = [
    "ExchangePlan", "PartitionedGraph", "ShardedCSCLayout",
    "auto_exchange_budget", "default_exchange_budget", "exchange_plan",
    "gather_graph", "global_row", "max_active_source_chunks",
    "partition_graph", "partitioned_from_numpy", "repartition",
    "shard_vertex_range", "vertex_owner",
]

@dataclasses.dataclass(frozen=True)
class ShardedCSCLayout:
    """Per-shard destination-bucketed edge arrays, leading shard axis."""

    src: torch.Tensor          # (S, n_edge_blocks * block_e) int32 GLOBAL
    dst: torch.Tensor          # (S, n_edge_blocks * block_e) int32 LOCAL
    block_nb: torch.Tensor     # (S, n_edge_blocks) int32 local node block
    block_sb: torch.Tensor     # (S, n_edge_blocks) int32 GLOBAL source block
    block_first: torch.Tensor  # (S, n_edge_blocks) int32
    block_v: int
    block_e: int
    blocks_per_shard: int
    n_edge_blocks: int
    n_shards: int              # of the whole partition
    n_nodes: int
    # the global shard of the stack's first row (a local layout's own)
    first_shard: int = 0
    # (S, n_edge_blocks * block_e) float32 weights in each shard's
    # bucketed order (pad slots 0.0); None on an unweighted graph
    weight: "torch.Tensor | None" = None
    _cache: dict = dataclasses.field(default_factory=dict, repr=False,
                                     compare=False)

    @property
    def shard_rows(self) -> int:
        return self.blocks_per_shard * self.block_v

    @property
    def v_pad(self) -> int:
        return self.n_shards * self.shard_rows

    @property
    def e_slots_per_shard(self) -> int:
        return self.n_edge_blocks * self.block_e

    @property
    def n_local_shards(self) -> int:
        """Shards held in the stack: ``n_shards``, or 1 in a local
        layout."""
        return self.src.shape[0]

    def shard(self, s: int) -> CSCLayout:
        """Row ``s`` of the stack as a :class:`CSCLayout` of views (no
        copy): its vertex space is the LOCAL row range (``v_pad ==
        shard_rows``), ``src`` stays global, ``n_nodes`` global (the sink
        the padding slots point at) and ``n_src_blocks`` tiles the global
        rows.  The operand of the dispatcher's ``shard=`` route; the
        counterpart of the JAX layout's ``shard(s)``."""
        return CSCLayout(
            src=self.src[s], dst=self.dst[s], block_nb=self.block_nb[s],
            block_sb=self.block_sb[s], block_first=self.block_first[s],
            block_v=self.block_v, block_e=self.block_e,
            n_node_blocks=self.blocks_per_shard,
            n_edge_blocks=self.n_edge_blocks, n_nodes=self.n_nodes,
            n_src_blocks=self.n_shards * self.blocks_per_shard,
            weight=None if self.weight is None else self.weight[s])

    def real_blocks(self) -> torch.Tensor:
        """(n_real,) int32, ascending: the flat indices ``s *
        n_edge_blocks + j`` of the edge blocks holding a slot whose source
        is not the sink.  Every other block (a shard's padding to
        ``n_edge_blocks``, a bucket's all-pad block) adds nothing, since
        sink slots also point their destination past the tile.  The grid
        of the sharded level launch.  Built on the layout's device on
        first use, then kept while ``src`` is this layout's (a
        ``dataclasses.replace`` copy shares the cache)."""
        hit = self._cache.get("real_blocks")
        if hit is None or hit[0] is not self.src:
            real = (self.src.view(-1, self.block_e) != self.n_nodes).any(
                dim=1)
            hit = (self.src, torch.nonzero(real)[:, 0].to(torch.int32))
            self._cache["real_blocks"] = hit
        return hit[1]

    def relax_plan(self):
        """The weighted rounds' plan of the held shards
        (``kernels.frontier.build_sharded_relax_plan``): built on first
        use, then kept while ``src`` and ``weight`` are this layout's."""
        hit = self._cache.get("relax")
        if hit is None or hit[0] is not self.src or hit[1] is not self.weight:
            from ..kernels.frontier import build_sharded_relax_plan
            hit = (self.src, self.weight, build_sharded_relax_plan(self))
            self._cache["relax"] = hit
        return hit[2]

    def to(self, device) -> "ShardedCSCLayout":
        dev = resolve_device(device)
        return dataclasses.replace(
            self, src=self.src.to(dev), dst=self.dst.to(dev),
            block_nb=self.block_nb.to(dev), block_sb=self.block_sb.to(dev),
            block_first=self.block_first.to(dev),
            weight=None if self.weight is None else self.weight.to(dev),
            _cache={})


@dataclasses.dataclass(frozen=True)
class PartitionedGraph:
    """A graph whose frontier lane is sharded.  Duck-types the ``Graph``
    attributes the path walk reads (``n_nodes``, ``indptr``, ``indices``,
    ``degree``, and on a weighted graph ``weight``, the replicated CSR
    weights)."""

    indptr: torch.Tensor   # (V+1,) int32, replicated CSR
    indices: torch.Tensor  # (E_pad,) int32
    degree: torch.Tensor   # (V,) int32
    shards: ShardedCSCLayout
    n_nodes: int
    n_edges: int
    max_degree: int
    # sparse-exchange chunk slots a shard (0: dense protocol only)
    exchange_budget: int = 0
    # built with exchange_budget="auto": the sharded lane derives the
    # budget from the diameter sweeps' chunk occupancy before calibration
    exchange_budget_auto: bool = False
    # (E_pad,) float32 replicated CSR weights; None on an unweighted graph
    weight: "torch.Tensor | None" = None

    @property
    def device(self) -> torch.device:
        return self.indptr.device

    @property
    def n_shards(self) -> int:
        return self.shards.n_shards

    @property
    def shard_rows(self) -> int:
        return self.shards.shard_rows

    @property
    def v_pad(self) -> int:
        return self.shards.v_pad

    @property
    def n_edges_undirected(self) -> int:
        return self.n_edges // 2

    @property
    def exchange_chunk_rows(self) -> int:
        """Rows of one exchange-schedule chunk: ``gcd(block_v, 128)``,
        which divides the node block."""
        return math.gcd(self.shards.block_v, 128)

    @property
    def exchange_chunks_per_shard(self) -> int:
        return self.shard_rows // self.exchange_chunk_rows

    def to(self, device) -> "PartitionedGraph":
        dev = resolve_device(device)
        return dataclasses.replace(
            self, indptr=self.indptr.to(dev), indices=self.indices.to(dev),
            degree=self.degree.to(dev), shards=self.shards.to(dev),
            weight=None if self.weight is None else self.weight.to(dev))


def vertex_owner(pg, v):
    """Shard owning vertex / global row ``v`` (an int, numpy or torch)."""
    return v // pg.shard_rows


def global_row(pg, shard, local_row):
    """(shard, local row) -> global row."""
    return shard * pg.shard_rows + local_row


def shard_vertex_range(pg, s: int):
    """Global rows [start, stop) owned by shard ``s``."""
    return s * pg.shard_rows, (s + 1) * pg.shard_rows


def _resolve_exchange_budget(shard_rows: int, block_v: int,
                             exchange_budget) -> int:
    """``None`` -> the default policy; any value clamped into [0,
    chunks_per_shard - 1].  The batch-width break-even lives in
    :attr:`ExchangePlan.sparse_available` and the sharded BFS."""
    cps = shard_rows // math.gcd(int(block_v), 128)
    if exchange_budget is None:
        exchange_budget = default_exchange_budget(cps)
    return max(0, min(int(exchange_budget), cps - 1))


def default_exchange_budget(chunks_per_shard: int) -> int:
    """ceil(chunks_per_shard / 4), clamped to [0, chunks_per_shard - 1]
    (a one-chunk shard is dense only)."""
    return max(0, min(chunks_per_shard - 1, -(-chunks_per_shard // 4)))


def auto_exchange_budget(pg: PartitionedGraph, level_occupancies,
                         quantile: float = 0.9) -> int:
    """The ``"auto"`` rule: the ``quantile``-th of the observed
    worst-shard chunk occupancies (one a level), clamped as an explicit
    budget; no observation gives the default policy."""
    occ = sorted(int(o) for o in level_occupancies)
    if not occ:
        return _resolve_exchange_budget(pg.shard_rows, pg.shards.block_v,
                                        None)
    q = min(max(float(quantile), 0.0), 1.0)
    pick = occ[min(len(occ) - 1, int(q * (len(occ) - 1) + 0.5))]
    return _resolve_exchange_budget(pg.shard_rows, pg.shards.block_v, pick)


@dataclasses.dataclass(frozen=True)
class ExchangePlan:
    """What one cooperative BFS level exchanges, in bytes summed over the
    shards (each shard's send counted once); both protocols include the
    occupancy bits, which always travel."""

    n_shards: int
    chunks_per_shard: int
    chunk_rows: int
    budget: int       # sparse chunk slots a shard; 0 = dense only
    batch: int        # B

    @property
    def bitmap_bytes(self) -> int:
        return 4 * self.n_shards * self.chunks_per_shard

    @property
    def dense_bytes(self) -> int:
        return (4 * self.n_shards * self.chunks_per_shard * self.chunk_rows
                * self.batch) + self.bitmap_bytes

    @property
    def sparse_bytes(self) -> int:
        return (self.n_shards * self.budget
                * (4 * self.chunk_rows * self.batch + 4)) + self.bitmap_bytes

    @property
    def sparse_available(self) -> bool:
        """A nonzero budget whose sparse send undercuts the dense one at
        this batch width."""
        return (self.budget > 0
                and self.budget * (self.chunk_rows * self.batch + 1)
                < self.chunks_per_shard * self.chunk_rows * self.batch)

    def sparse_taken(self, max_active_chunks: int) -> bool:
        return self.sparse_available and max_active_chunks <= self.budget

    def level_bytes(self, max_active_chunks: int) -> int:
        if self.sparse_taken(max_active_chunks):
            return self.sparse_bytes
        return self.dense_bytes

    def epoch_accounting(self, levels_total: int, levels_sparse: int) -> dict:
        """Price an exchange tally ``[levels, of which sparse]``: a dense
        level is a fallback when the sparse protocol was reachable at
        this width, else dense-only."""
        levels_total = int(levels_total)
        levels_sparse = int(levels_sparse)
        dense = levels_total - levels_sparse
        fallback = dense if self.sparse_available else 0
        return {
            "levels_total": levels_total,
            "levels_sparse": levels_sparse,
            "levels_dense_fallback": fallback,
            "levels_dense_only": dense - fallback,
            "bytes": (levels_sparse * self.sparse_bytes
                      + dense * self.dense_bytes),
        }


def exchange_plan(pg: PartitionedGraph, batch: int) -> ExchangePlan:
    return ExchangePlan(
        n_shards=pg.n_shards, chunks_per_shard=pg.exchange_chunks_per_shard,
        chunk_rows=pg.exchange_chunk_rows, budget=pg.exchange_budget,
        batch=int(batch))


def max_active_source_chunks(pg: PartitionedGraph, frontier_rows) -> int:
    """Worst-shard count of active source chunks of one level, from a
    host-side bool array over global rows (numpy)."""
    bits = np.zeros(pg.v_pad, bool)
    bits[: len(frontier_rows)] = np.asarray(frontier_rows, bool)
    per_chunk = bits.reshape(-1, pg.exchange_chunk_rows).any(axis=1)
    per_shard = per_chunk.reshape(pg.n_shards, pg.exchange_chunks_per_shard)
    return int(per_shard.sum(axis=1).max())


def partition_graph(graph: Graph, n_shards: int, *,
                    block_v: int | None = None, block_e: int | None = None,
                    exchange_budget: "int | str | None" = None,
                    shard: int | None = None) -> PartitionedGraph:
    """Split ``graph`` into ``n_shards`` destination-owned vertex shards,
    on the graph's device.

    One stable sort groups the edges by owner; each shard is bucketed by
    :func:`bucket_layout` over its local node blocks, with global source
    blocks, and padded to the largest shard's edge blocks.  Blocking left
    as ``None`` comes from :func:`choose_csc_blocks` (the JAX package's
    ``batch`` argument is dropped: the card's blocking does not depend on
    B).  ``exchange_budget``: ``None`` the default policy, ``0`` dense only,
    an int clamped to ``chunks_per_shard - 1``, ``"auto"`` the default
    now and flagged for the sharded lane to derive after the diameter
    sweeps.  ``shard=s`` builds shard ``s``'s buckets alone (a local
    partition, the one process ``s`` of a ``GroupShardMesh`` holds),
    padded to its own edge blocks: its arrays are row ``s`` of the whole
    partition's up to the inert padding.  A weighted graph's weights ride
    the same permutations into each shard's bucketed slots.
    """
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    if shard is not None and not 0 <= int(shard) < n_shards:
        raise ValueError(f"shard {shard} is not one of {n_shards} shards")
    budget_auto = isinstance(exchange_budget, str) and exchange_budget == "auto"
    if budget_auto:
        exchange_budget = None
    auto_v, auto_e = choose_csc_blocks(graph.n_nodes)
    block_v = auto_v if block_v is None else int(block_v)
    block_e = auto_e if block_e is None else int(block_e)
    dev = graph.device
    n = graph.n_nodes
    n_nb = -(-(n + 1) // block_v)
    bps = -(-n_nb // n_shards)
    shard_rows = bps * block_v
    src = graph.src[: graph.n_edges].long()
    dst = graph.dst[: graph.n_edges].long()
    owner = dst // shard_rows
    order = torch.sort(owner, stable=True).indices
    src_o, dst_o = src[order], dst[order]
    weighted = graph.weight is not None
    w_o = graph.weight[: graph.n_edges][order] if weighted else None
    bounds = torch.searchsorted(
        owner[order], torch.arange(n_shards + 1, device=dev)).tolist()
    sink_sb = n // block_v
    built = range(n_shards) if shard is None else (int(shard),)
    per_shard = []
    for s in built:
        lo, hi = bounds[s], bounds[s + 1]
        s_dst = dst_o[lo:hi] - s * shard_rows
        per_shard.append(bucket_layout(
            src_o[lo:hi], s_dst, s_dst // block_v, bps, block_e,
            sink_src=n, sink_dst=shard_rows, src_block=src_o[lo:hi] // block_v,
            sink_src_block=sink_sb,
            payload=w_o[lo:hi] if weighted else None))
    eb_max = max(p[2].shape[0] for p in per_shard)
    i32 = dict(dtype=torch.int32, device=dev)
    n_loc = len(per_shard)
    out = {"src": torch.full((n_loc, eb_max * block_e), n, **i32),
           "dst": torch.full((n_loc, eb_max * block_e), shard_rows, **i32),
           # inert padding blocks add zeros into the last local tile
           "block_nb": torch.full((n_loc, eb_max), bps - 1, **i32),
           "block_sb": torch.full((n_loc, eb_max), sink_sb, **i32),
           "block_first": torch.zeros((n_loc, eb_max), **i32)}
    if weighted:
        out["weight"] = torch.zeros((n_loc, eb_max * block_e),
                                    dtype=torch.float32, device=dev)
    for s, arrays in enumerate(per_shard):
        for name, a in zip(("src", "dst", "block_nb", "block_sb",
                            "block_first", "weight"), arrays):
            if a is not None:
                out[name][s, : a.shape[0]] = a
    shards = ShardedCSCLayout(
        **out, block_v=block_v, block_e=block_e, blocks_per_shard=int(bps),
        n_edge_blocks=int(eb_max), n_shards=int(n_shards), n_nodes=int(n),
        first_shard=built[0])
    return PartitionedGraph(
        indptr=graph.indptr, indices=graph.indices, degree=graph.degree,
        shards=shards, n_nodes=int(n), n_edges=int(graph.n_edges),
        max_degree=int(graph.max_degree),
        exchange_budget=_resolve_exchange_budget(shard_rows, block_v,
                                                 exchange_budget),
        exchange_budget_auto=budget_auto,
        weight=graph.weight if weighted else None)


def gather_graph(pg: PartitionedGraph) -> Graph:
    """The replicated :class:`Graph` a partition was built from, rebuilt
    from its CSR arrays and weights (bit-identical to the original)."""
    counts = torch.diff(pg.indptr.long())[: pg.n_nodes]
    src = torch.repeat_interleave(
        torch.arange(pg.n_nodes, device=pg.device), counts)
    dst = pg.indices[: pg.n_edges].long()
    return build_graph(src, dst, pg.n_nodes, device=pg.device,
                       weight=None if pg.weight is None
                       else pg.weight[: pg.n_edges])


def repartition(pg: PartitionedGraph, n_shards: int) -> PartitionedGraph:
    """Re-split onto ``n_shards`` shards at the default blocking; an
    ``"auto"`` budget stays auto."""
    return partition_graph(
        gather_graph(pg), n_shards,
        exchange_budget="auto" if pg.exchange_budget_auto else None)


_SHARD_ARRAYS = ("src", "dst", "block_nb", "block_sb", "block_first")
_SHARD_INTS = ("block_v", "block_e", "blocks_per_shard", "n_edge_blocks",
               "n_shards", "n_nodes")


def _tensor(a, dev) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.int32)).to(dev)


def _float_tensor(a, dev):
    if a is None:
        return None
    return torch.from_numpy(np.array(a, np.float32)).to(dev)


def partitioned_from_numpy(arrays: dict, shards: dict, n_nodes: int,
                           n_edges: int, max_degree: int, *,
                           exchange_budget: int = 0,
                           exchange_budget_auto: bool = False,
                           weight=None,
                           device=DEFAULT_DEVICE) -> PartitionedGraph:
    """A :class:`PartitionedGraph` from numpy arrays, e.g. the leaves of a
    JAX partition: ``arrays`` holds ``indptr``, ``indices`` and
    ``degree``; ``shards`` the layout's five (S, ...) arrays, its static
    ints and, on a weighted graph, its bucketed ``weight``; ``weight``
    the replicated CSR weights of a weighted graph."""
    dev = resolve_device(device)
    if (weight is None) != (shards.get("weight") is None):
        raise ValueError("a weighted partition needs both the replicated "
                         "weights and the layout's")
    layout = ShardedCSCLayout(
        **{k: _tensor(shards[k], dev) for k in _SHARD_ARRAYS},
        **{k: int(shards[k]) for k in _SHARD_INTS},
        weight=_float_tensor(shards.get("weight"), dev))
    return PartitionedGraph(
        **{k: _tensor(arrays[k], dev) for k in ("indptr", "indices",
                                                 "degree")},
        shards=layout, n_nodes=int(n_nodes), n_edges=int(n_edges),
        max_degree=int(max_degree), exchange_budget=int(exchange_budget),
        exchange_budget_auto=bool(exchange_budget_auto),
        weight=_float_tensor(weight, dev))
