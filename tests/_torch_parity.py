"""Helpers of the parity tests between the JAX package and the PyTorch
port: carry a JAX graph or GraphBatch across as numpy arrays, and pull
tensors back."""
import numpy as np
import torch

from repro_torch.core import graph_from_numpy
from repro_torch.models.gnn import GraphBatch

_GRAPH_ARRAYS = ("indptr", "indices", "src", "dst", "degree")
_CSC_ARRAYS = ("src", "dst", "block_nb", "block_sb", "block_first")
_CSC_INTS = ("block_v", "block_e", "n_node_blocks", "n_edge_blocks",
             "n_nodes", "n_src_blocks")


def to_port(jgraph, device="cpu"):
    """The port's ``Graph`` over exactly the JAX graph's arrays."""
    arrays = {k: np.asarray(getattr(jgraph, k)) for k in _GRAPH_ARRAYS}
    csc = None
    if jgraph.csc is not None:
        csc = {k: np.asarray(getattr(jgraph.csc, k)) for k in _CSC_ARRAYS}
        csc.update({k: getattr(jgraph.csc, k) for k in _CSC_INTS})
    return graph_from_numpy(arrays, jgraph.n_nodes, jgraph.n_edges,
                            jgraph.max_degree, csc, device=device)


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
