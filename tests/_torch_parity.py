"""Helpers of the parity tests between the JAX package and the PyTorch
port: carry a JAX graph, partition or GraphBatch across as numpy arrays,
and pull tensors back."""
import numpy as np
import torch

from repro_torch.core import (bfs_sssp_batched, graph_from_numpy,
                              partitioned_from_numpy)
from repro_torch.models.gnn import GraphBatch

_GRAPH_ARRAYS = ("indptr", "indices", "src", "dst", "degree")
_CSC_ARRAYS = ("src", "dst", "block_nb", "block_sb", "block_first")
_CSC_INTS = ("block_v", "block_e", "n_node_blocks", "n_edge_blocks",
             "n_nodes", "n_src_blocks")


def _weight(obj):
    w = getattr(obj, "weight", None)
    return None if w is None else np.asarray(w)


def to_port(jgraph, device="cpu"):
    """The port's ``Graph`` over exactly the JAX graph's arrays, its
    weights and its layout's included."""
    arrays = {k: np.asarray(getattr(jgraph, k)) for k in _GRAPH_ARRAYS}
    arrays["weight"] = _weight(jgraph)
    csc = None
    if jgraph.csc is not None:
        csc = {k: np.asarray(getattr(jgraph.csc, k)) for k in _CSC_ARRAYS}
        csc.update({k: getattr(jgraph.csc, k) for k in _CSC_INTS})
        csc["weight"] = _weight(jgraph.csc)
    return graph_from_numpy(arrays, jgraph.n_nodes, jgraph.n_edges,
                            jgraph.max_degree, csc, device=device)


_SHARD_ARRAYS = ("src", "dst", "block_nb", "block_sb", "block_first")
_SHARD_INTS = ("block_v", "block_e", "blocks_per_shard", "n_edge_blocks",
               "n_shards", "n_nodes")


def partitioned_to_port(jpg, device="cpu"):
    """The port's ``PartitionedGraph`` over exactly the JAX partition's
    arrays, the replicated and the layout's weights included."""
    shards = {k: np.asarray(getattr(jpg.shards, k)) for k in _SHARD_ARRAYS}
    shards.update({k: getattr(jpg.shards, k) for k in _SHARD_INTS})
    shards["weight"] = _weight(jpg.shards)
    return partitioned_from_numpy(
        {k: np.asarray(getattr(jpg, k)) for k in ("indptr", "indices",
                                                  "degree")},
        shards, jpg.n_nodes, jpg.n_edges, jpg.max_degree,
        exchange_budget=jpg.exchange_budget,
        exchange_budget_auto=jpg.exchange_budget_auto,
        weight=_weight(jpg), device=device)


def np_(x):
    """A torch tensor or JAX array as numpy."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def batch_to_port(jbatch, device="cpu"):
    """The port's ``GraphBatch`` over exactly the JAX batch's leaves."""
    names = ("x", "z", "pos", "src", "dst", "edge_mask", "node_mask",
             "labels", "graph_id", "y")
    return GraphBatch(
        **{k: torch.from_numpy(np.array(getattr(jbatch, k))).to(device)
           for k in names}, n_graphs=jbatch.n_graphs)


def wide_inputs(tgraph, jpg, batch, seed, gaussian):
    """JAX's gathered frontier contract at one BFS level (the port's BFS,
    which gives JAX's bits): masked values over the global rows and their
    synthesized dist, numpy.  ``gaussian`` replaces sigma by |N(0, 1)|
    draws, which no summation order keeps exact."""
    rng = np.random.default_rng(seed)
    sources = rng.integers(0, tgraph.n_nodes, batch).astype(np.int32)
    res = bfs_sssp_batched(tgraph, sources)
    levels = np.maximum(np_(res.levels) // 2, 1).astype(np.int32)
    dist, sigma = np_(res.dist), np_(res.sigma)
    if gaussian:
        sigma = np.abs(rng.standard_normal(sigma.shape)).astype(np.float32)
    fvals = np.zeros((jpg.v_pad, batch), np.float32)
    fvals[: dist.shape[0]] = np.where(dist == levels, sigma, 0.0)
    fdist = np.where(fvals > 0, levels, -1).astype(np.int32)
    return fdist, fvals, levels
