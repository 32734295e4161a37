"""Data pipeline (``repro.data.pipeline``): the LM token stream
(``lm_batch_fn``), the full-batch GraphBatch of a graph, the layer-wise
neighbour sampler, MIND's session histories (``recsys_batch_fn``) and a
one-thread prefetcher.

Batches are host-side numpy, a pure function of (seed, step), so a
restart from step N reproduces the same sequence; the numpy draws are
the JAX package's in the same order, so every leaf is bitwise its
batch's.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Optional

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve_device
from ..models.gnn.message_passing import GraphBatch

__all__ = ["NeighborSampler", "PrefetchIterator", "graph_to_batch",
           "lm_batch_fn", "recsys_batch_fn"]


class PrefetchIterator:
    """Wrap a step -> batch function with a background thread that keeps
    up to ``depth`` batches ready.  ``close()`` stops the thread."""

    def __init__(self, make_batch: Callable[[int], object],
                 start_step: int = 0, depth: int = 2):
        self._make = make_batch
        self._step = start_step
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        step = self._step
        while not self._stop.is_set():
            try:
                self._q.put((step, self._make(step)), timeout=0.2)
                step += 1
            except queue.Full:
                continue

    def __iter__(self):
        return self

    def __next__(self):
        return self._q.get()

    def close(self):
        self._stop.set()


def lm_batch_fn(vocab: int, batch: int, seq: int, seed: int = 0):
    """step -> {"tokens", "targets"}, int32 numpy (batch, seq): a Zipf(1.3)
    stream mod ``vocab`` from ``default_rng((seed, step))``, the targets
    the tokens shifted by one (the reference's draws, so its bits)."""
    def make(step: int) -> dict:
        rng = np.random.default_rng((seed, step))
        z = rng.zipf(1.3, size=(batch, seq + 1)).astype(np.int64)
        tokens = (z % vocab).astype(np.int32)
        return {"tokens": tokens[:, :-1], "targets": tokens[:, 1:]}
    return make


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


class NeighborSampler:
    """Layer-wise (GraphSAGE-style) uniform neighbour sampler.

    Fixed-shape padded subgraph batches: seeds (B,), then per hop
    ``fanouts[i]`` neighbours drawn with replacement for every frontier
    node (a node of degree 0 gives masked edges).  Nodes are numbered in
    a local id space, seeds first; edges point from the sampled
    neighbour to its parent.  Deterministic in (seed, step).  The
    graph's CSR is copied to the host once.
    """

    def __init__(self, graph, fanouts, batch_nodes: int, seed: int = 0):
        self.indptr = graph.indptr.cpu().numpy()
        self.indices = graph.indices[: graph.n_edges].cpu().numpy()
        self.n_nodes = graph.n_nodes
        self.fanouts = tuple(fanouts)
        self.batch_nodes = batch_nodes
        self.seed = seed
        # fixed output sizes
        self.layer_sizes = [batch_nodes]
        for f in self.fanouts:
            self.layer_sizes.append(self.layer_sizes[-1] * f)
        self.total_nodes = sum(self.layer_sizes)
        self.total_edges = sum(self.layer_sizes[1:])

    def sample(self, step: int) -> dict:
        """``node_ids`` (global ids in local order), ``src``, ``dst``
        (local), ``edge_mask`` and ``n_seeds``, as numpy."""
        rng = np.random.default_rng((self.seed, step))
        seeds = rng.integers(0, self.n_nodes, self.batch_nodes)
        node_ids = [seeds.astype(np.int64)]
        srcs, dsts, emasks = [], [], []
        offset = 0
        frontier = node_ids[0]
        for f in self.fanouts:
            deg = self.indptr[frontier + 1] - self.indptr[frontier]
            pick = rng.integers(0, np.maximum(deg, 1)[:, None],
                                size=(len(frontier), f))
            nbr = self.indices[
                np.minimum(self.indptr[frontier][:, None] + pick,
                           len(self.indices) - 1)]
            valid = (deg > 0)[:, None] & np.ones_like(pick, bool)
            parent_local = offset + np.arange(len(frontier))
            child_local = offset + len(frontier) + \
                np.arange(len(frontier) * f)
            srcs.append(child_local)
            dsts.append(np.repeat(parent_local, f))
            emasks.append(valid.reshape(-1).astype(np.float32))
            node_ids.append(nbr.reshape(-1))
            offset += len(frontier)
            frontier = nbr.reshape(-1)
        nodes = np.concatenate(node_ids)
        return {
            "node_ids": nodes.astype(np.int64),
            "src": np.concatenate(srcs).astype(np.int32),
            "dst": np.concatenate(dsts).astype(np.int32),
            "edge_mask": np.concatenate(emasks),
            "n_seeds": self.batch_nodes,
        }

    def to_graph_batch(self, sub: dict, features, labels, *, n_classes: int,
                       pad_nodes: Optional[int] = None,
                       pad_edges: Optional[int] = None,
                       device=DEFAULT_DEVICE) -> GraphBatch:
        """The :class:`GraphBatch` of a sample on ``device``: the
        sampled nodes' rows of ``features`` (V, F) and ``labels`` (V,)
        (numpy), the loss on the seeds only, padded nodes and edges at 0
        with mask 0, seeded coordinates.  ``n_classes`` is kept for the
        JAX signature (the labels already hold the classes)."""
        dev = resolve_device(device)
        n = len(sub["node_ids"])
        e = len(sub["src"])
        pn = pad_nodes or n
        pe = pad_edges or e
        x = np.zeros((pn, features.shape[1]), np.float32)
        x[:n] = features[sub["node_ids"]]
        lab = np.zeros(pn, np.int32)
        lab[:n] = labels[sub["node_ids"]]
        src = np.zeros(pe, np.int32)
        dst = np.zeros(pe, np.int32)
        em = np.zeros(pe, np.float32)
        src[:e] = sub["src"]
        dst[:e] = sub["dst"]
        em[:e] = sub["edge_mask"]
        nm = np.zeros(pn, np.float32)
        nm[: sub["n_seeds"]] = 1.0     # loss only on the seed nodes
        z = (sub["node_ids"][:pn] % 16 if n == pn else
             np.pad(sub["node_ids"] % 16, (0, pn - n))).astype(np.int32)
        rng = np.random.default_rng(0)
        pos = rng.standard_normal((pn, 3)).astype(np.float32)

        def put(a):
            return torch.from_numpy(a).to(dev)

        return GraphBatch(
            x=put(x), z=put(z), pos=put(pos), src=put(src), dst=put(dst),
            edge_mask=put(em), node_mask=put(nm), labels=put(lab),
            graph_id=put(np.zeros(pn, np.int32)),
            y=put(np.zeros(1, np.float32)), n_graphs=1)


# ---------------------------------------------------------------------------
# recsys: session histories with latent-interest structure
# ---------------------------------------------------------------------------

def recsys_batch_fn(n_items: int, batch: int, hist_len: int, seed: int = 0,
                    n_latent: int = 64, *, device=DEFAULT_DEVICE):
    """``make(step)`` -> {hist (batch, hist_len) int32, hist_mask float32,
    target (batch,) int32} on ``device``.  Users draw items from three of
    ``n_latent`` clusters, which gives MIND's multi-interest routing
    something to learn; histories hold hist_len // 2 to hist_len items.
    The numpy draws are the reference's, bitwise."""
    dev = resolve_device(device)
    width = n_items // n_latent

    def make(step: int) -> dict:
        rng = np.random.default_rng((seed, step))
        cluster_of_user = rng.integers(0, n_latent, (batch, 3))
        which = rng.integers(0, 3, (batch, hist_len))
        cluster = np.take_along_axis(cluster_of_user, which, axis=1)
        items = (cluster * width
                 + rng.integers(0, width, (batch, hist_len))).astype(np.int32)
        lengths = rng.integers(hist_len // 2, hist_len + 1, batch)
        mask = (np.arange(hist_len)[None, :] < lengths[:, None]) \
            .astype(np.float32)
        tgt_cluster = cluster_of_user[np.arange(batch),
                                      rng.integers(0, 3, batch)]
        target = (tgt_cluster * width
                  + rng.integers(0, width, batch)).astype(np.int32)
        return {k: torch.from_numpy(v).to(dev) for k, v in
                (("hist", items), ("hist_mask", mask), ("target", target))}
    return make
