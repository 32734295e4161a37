"""Data pipeline of the port (``repro.data``)."""
from .pipeline import (NeighborSampler, PrefetchIterator, graph_to_batch,
                       lm_batch_fn, recsys_batch_fn)

__all__ = ["NeighborSampler", "PrefetchIterator", "graph_to_batch",
           "lm_batch_fn", "recsys_batch_fn"]
