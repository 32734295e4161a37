"""The flat frontier route's pull (K1) on the CPU, against the JAX package.

The route reads an in-edge plan of the COO edges (``build_pull_plan``):
the sources in destination order, each row's offsets, and every row of
more than ``split`` in-edges cut into items.  Here the plan is replayed
in numpy, array for array; the pull's plain version (the wrapper's CPU
route) is held bit for bit against the JAX reference and the JAX Pallas
kernel in interpret mode on BFS-derived state (exact integer sums), and
against a numpy replay of the kernel's order of additions on
non-integer sigma.  The CUDA kernel itself is held against these on the
card (``tests/test_torch_kernels_gpu.py``, ``chip_smoke.py``).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jc
from repro.kernels.frontier import (frontier_expand_batched_pallas,
                                    frontier_expand_batched_ref as j_ref)
from repro_torch.core import bfs_sssp_batched
from repro_torch.kernels import frontier as tf
from repro_torch.kernels.segsum.kernel import build_plan
from _torch_parity import np_, to_port

STAR_LEAVES = 700     # the hub's in-degree, over the default split (512)


def _star():
    leaves = np.arange(1, STAR_LEAVES + 1)
    return jc.from_edge_list(np.stack([np.zeros_like(leaves), leaves], 1),
                             STAR_LEAVES + 1)


def _isolated():
    """ER(200) with vertices 200..203 on no edge."""
    rng = np.random.default_rng(4)
    return jc.from_edge_list(rng.integers(0, 200, (700, 2)), 204)


GRAPHS = {
    "er": lambda: jc.erdos_renyi_graph(257, 6.0, seed=3),
    "grid": lambda: jc.grid_graph(16, 12),
    "rmat": lambda: jc.rmat_graph(8, 8, seed=5),
    "star": _star,
    "isolated": _isolated,
}


def _state(graph, batch, seed, extra_rows=0):
    """BFS-derived (dist, sigma, levels) from seeded sources, each
    column's frontier at a seeded level below its eccentricity (so that
    it has out-edges where the source has any); ``extra_rows`` padding
    rows (dist -3) past the sink."""
    rng = np.random.default_rng(seed)
    sources = torch.from_numpy(rng.integers(0, graph.n_nodes, batch).astype(
        np.int32))
    res = bfs_sssp_batched(graph, sources)
    levels = torch.minimum(
        torch.from_numpy(rng.integers(0, 4, batch).astype(np.int32)),
        (res.levels - 1).clamp(min=0))
    dist, sigma = res.dist, res.sigma
    if extra_rows:
        dist = torch.cat([dist, dist.new_full((extra_rows, batch), -3)])
        sigma = torch.cat([sigma, sigma.new_zeros((extra_rows, batch))])
    return dist.contiguous(), sigma.contiguous(), levels


def _np_plan(src, dst, rows, split):
    """The plan in numpy: a stable sort by destination, the offsets, and
    each row of more than ``split`` in-edges cut into items of ``split``."""
    order = np.argsort(dst, kind="stable")
    counts = np.bincount(dst, minlength=rows)
    offsets = np.concatenate([[0], np.cumsum(counts)])
    heavy = np.flatnonzero(counts > split)
    begin, end, first = [], [], [0]
    for r in heavy:
        starts = np.arange(offsets[r], offsets[r + 1], split)
        begin += list(starts)
        end += list(np.minimum(starts + split, offsets[r + 1]))
        first.append(len(begin))
    return dict(ids_sorted=src[order], offsets=offsets,
                item_begin=np.asarray(begin, np.int64),
                item_end=np.asarray(end, np.int64),
                split_seg=heavy, split_first=np.asarray(first, np.int64))


def _np_pull(plan, dist, sigma, levels, split):
    """The kernel's order of additions in numpy (``np.add.at`` adds in
    index order): a light row sums its sources in plan order; a split row
    sums each item into a partial row, then the partials in item order."""
    rows, batch = dist.shape
    src = plan["ids_sorted"]
    vals = np.where(dist[src] == levels[None, :], sigma[src],
                    np.float32(0.0)).astype(np.float32)
    offsets = plan["offsets"]
    out = np.zeros((rows, batch), np.float32)
    for r in range(offsets.shape[0] - 1):
        if offsets[r + 1] - offsets[r] <= split:
            np.add.at(out, np.full(offsets[r + 1] - offsets[r], r),
                      vals[offsets[r]:offsets[r + 1]])
    for q, r in enumerate(plan["split_seg"]):
        for h in range(plan["split_first"][q], plan["split_first"][q + 1]):
            part = np.zeros(batch, np.float32)
            b, e = plan["item_begin"][h], plan["item_end"][h]
            np.add.at(part[None, :], np.zeros(e - b, np.int64), vals[b:e])
            out[r] += part
    return out


@pytest.mark.parametrize("name,batch", [
    ("er", 8), ("er", 33), ("grid", 1), ("grid", 96), ("rmat", 64),
    ("rmat", 33), ("star", 8), ("star", 64), ("isolated", 1),
    ("isolated", 96)])
def test_pull_matches_jax_ref_and_pallas(name, batch):
    """The flat wrapper's CPU route (the pull's plain version over the
    graph's plan) against the JAX reference and Pallas kernel, bit for
    bit; W = 1, 2, 3 frontier words a row, the sink row and padded edge
    slots included, the star's hub cut into items."""
    jgraph = GRAPHS[name]()
    g = to_port(jgraph)
    dist, sigma, levels = _state(g, batch, seed=batch)
    want = np_(j_ref(jgraph.src, jgraph.dst, jnp.asarray(np_(dist)),
                     jnp.asarray(np_(sigma)), jnp.asarray(np_(levels))))
    pallas = np_(frontier_expand_batched_pallas(
        jgraph.src, jgraph.dst, jnp.asarray(np_(dist)),
        jnp.asarray(np_(sigma)), jnp.asarray(np_(levels)), interpret=True))
    plan = g.pull_plan()
    assert g.e_pad > g.n_edges          # padded slots (sink to sink)
    if name == "star":
        assert plan.n_items == -(-STAR_LEAVES // tf.PULL_SPLIT)
    got = np_(tf.frontier_expand_flat(g.src, g.dst, dist, sigma, levels,
                                      plan))
    assert want.max() > 0
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(np_(tf.frontier_pull_ref(
        plan, dist, sigma, levels)), want)


@pytest.mark.parametrize("name,split", [
    ("rmat", tf.PULL_SPLIT), ("rmat", 7), ("star", tf.PULL_SPLIT),
    ("star", 64), ("grid", 1), ("isolated", 3)])
def test_plan_is_the_numpy_replay(name, split):
    """``build_pull_plan`` array for array against the numpy replay."""
    g = to_port(GRAPHS[name]())
    rows = g.n_nodes + 1
    plan = tf.build_pull_plan(g.src, g.dst, rows, split=split)
    want = _np_plan(np_(g.src), np_(g.dst), rows, split)
    assert plan.split == split and plan.n_segments == plan.n_rows == rows
    assert plan.transpose is None
    for key, arr in want.items():
        np.testing.assert_array_equal(np_(getattr(plan, key)), arr,
                                      err_msg=key)
    assert plan.n_items == want["item_begin"].shape[0]
    # the sink row's in-edges are exactly the padded slots
    counts = np.diff(want["offsets"])
    assert counts[g.n_nodes] == g.e_pad - g.n_edges
    if name == "isolated":
        assert (counts[200:204] == 0).all()


@pytest.mark.parametrize("name,batch,split,extra_rows", [
    ("rmat", 64, tf.PULL_SPLIT, 0), ("rmat", 33, 7, 5), ("star", 8, 64, 0),
    ("star", 96, tf.PULL_SPLIT, 3), ("isolated", 8, 3, 0), ("grid", 1, 1, 2)])
def test_pull_order_is_the_numpy_replay_on_any_sigma(name, batch, split,
                                                     extra_rows):
    """On non-integer sigma the sum depends on its order: the plain pull
    must add in the kernel's order (numpy replay), bit for bit.  Rows
    past the plan's (padding) come out zero."""
    g = to_port(GRAPHS[name]())
    dist, sigma, levels = _state(g, batch, seed=split, extra_rows=extra_rows)
    rng = np.random.default_rng(batch)
    sigma = sigma * torch.from_numpy(
        rng.uniform(0.5, 1.5, sigma.shape).astype(np.float32))
    plan = tf.build_pull_plan(g.src, g.dst, g.n_nodes + 1, split=split)
    want = _np_pull(_np_plan(np_(g.src), np_(g.dst), g.n_nodes + 1, split),
                    np_(dist), np_(sigma), np_(levels), split)
    got = np_(tf.frontier_expand_flat(g.src, g.dst, dist, sigma, levels,
                                      plan))
    assert got.shape == tuple(dist.shape)
    np.testing.assert_array_equal(got, want)
    assert not got[g.n_nodes:].any()
    assert not np.array_equal(want, np.round(want))    # not integer sums


def test_directed_coo_gets_its_own_plan():
    """A COO edge list that is not symmetric: without a plan the wrapper
    builds one from (src, dst) itself and returns the right sum; a plan
    of other edges, a plan wider than the state and ids outside the
    state's rows raise."""
    rng = np.random.default_rng(7)
    n, e = 90, 400
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    src = torch.from_numpy(np.concatenate([src, np.full(5, n, np.int32)]))
    dst = torch.from_numpy(np.concatenate([dst, np.full(5, n, np.int32)]))
    dist = torch.from_numpy(rng.integers(-1, 3, (n + 1, 8)).astype(np.int32))
    dist[n] = -3
    sigma = torch.from_numpy(rng.integers(0, 5, (n + 1, 8)).astype(
        np.float32))
    levels = torch.from_numpy(rng.integers(0, 3, 8).astype(np.int32))
    want = np_(j_ref(jnp.asarray(np_(src)), jnp.asarray(np_(dst)),
                     jnp.asarray(np_(dist)), jnp.asarray(np_(sigma)),
                     jnp.asarray(np_(levels))))
    got = tf.frontier_expand_flat(src, dst, dist, sigma, levels)
    np.testing.assert_array_equal(np_(got), want)
    # the transposed edges give another sum: no symmetry is assumed
    flipped = np_(tf.frontier_expand_flat(dst, src, dist, sigma, levels))
    assert not np.array_equal(flipped, want)
    with pytest.raises(ValueError, match="not built for these edges"):
        tf.frontier_expand_flat(src, dst, dist, sigma, levels,
                                tf.build_pull_plan(dst, src, n + 1))
    # a plan of these sources but other destinations (dst is checked too)
    with pytest.raises(ValueError, match="not built for these edges"):
        tf.frontier_expand_flat(src, dst.flip(0), dist, sigma, levels,
                                tf.build_pull_plan(src, dst, n + 1))
    with pytest.raises(ValueError, match="spans"):
        tf.frontier_expand_flat(src, dst, dist, sigma, levels,
                                tf.build_pull_plan(src, dst, n + 2))
    with pytest.raises(ValueError, match="outside"):
        tf.frontier_expand_flat(src, dst, dist[:n], sigma[:n], levels)


def test_pull_refuses_a_plan_that_marks_hot_sources():
    """A gather-segment-sum plan of the same edges marks its hottest
    sources in bit 31 of their ids, which the pull would read as
    negative rows: the wrapper raises.  The same plan built with no hot
    source (it keeps its ``order``, which the pull ignores) is taken and
    gives the JAX package's sum."""
    rng = np.random.default_rng(11)
    n, e = 60, 500
    src = torch.from_numpy(rng.integers(0, n, e).astype(np.int32))
    dst = torch.from_numpy(rng.integers(0, n, e).astype(np.int32))
    dist = torch.from_numpy(rng.integers(-1, 3, (n, 8)).astype(np.int32))
    sigma = torch.from_numpy(rng.integers(0, 5, (n, 8)).astype(np.float32))
    levels = torch.from_numpy(rng.integers(0, 3, 8).astype(np.int32))
    hot = build_plan(src, dst, n, n)
    assert hot.n_hot > 0 and bool((hot.ids_sorted < 0).any())
    with pytest.raises(ValueError, match="marks hot sources"):
        tf.frontier_expand_flat(src, dst, dist, sigma, levels, hot)
    cold = build_plan(src, dst, n, n, hot_rows=0)
    want = np_(j_ref(jnp.asarray(np_(src)), jnp.asarray(np_(dst)),
                     jnp.asarray(np_(dist)), jnp.asarray(np_(sigma)),
                     jnp.asarray(np_(levels))))
    np.testing.assert_array_equal(
        np_(tf.frontier_expand_flat(src, dst, dist, sigma, levels, cold)),
        want)


def test_graph_builds_its_plan_once():
    """``Graph.pull_plan`` is built on first use and kept (a BFS reuses
    it every level); a copy on another device, or one with other edges,
    gets its own.  The plan keeps no ``order`` (the pull gathers no
    per-edge weight)."""
    g = to_port(GRAPHS["er"]())
    plan = g.pull_plan()
    assert g.pull_plan() is plan and plan.ids.data_ptr() == g.src.data_ptr()
    assert plan.seg is g.dst and plan.order is None
    flipped = dataclasses.replace(g, dst=g.dst.flip(0))
    assert flipped.pull_plan().seg is flipped.dst
    assert g.pull_plan() is not plan        # rebuilt: the cache is shared
    plan = g.pull_plan()
    bfs_sssp_batched(g, torch.tensor([0, 5], dtype=torch.int32))
    assert g.pull_plan() is plan
    moved = g.to("cpu")
    assert moved.pull_plan() is not plan
    assert dataclasses.replace(g, csc=None).pull_plan() is plan
    np.testing.assert_array_equal(np_(moved.pull_plan().ids_sorted),
                                  np_(plan.ids_sorted))


def test_dispatcher_asks_for_the_plan_only_on_the_flat_route():
    """The dispatcher takes the plan lazily (``plan=graph.pull_plan``):
    the CPU route never asks for it, so a CPU BFS builds none, and its
    sum is the JAX reference's."""
    g = to_port(GRAPHS["rmat"]())
    dist, sigma, levels = _state(g, 8, seed=2)

    def no_plan():
        raise AssertionError("the CPU route asked for the pull plan")

    got = tf.frontier_expand(g.src, g.dst, dist, sigma, levels, plan=no_plan)
    want = j_ref(jnp.asarray(np_(g.src)), jnp.asarray(np_(g.dst)),
                 jnp.asarray(np_(dist)), jnp.asarray(np_(sigma)),
                 jnp.asarray(np_(levels)))
    np.testing.assert_array_equal(np_(got), np_(want))
    bfs_sssp_batched(g, torch.tensor([0, 3], dtype=torch.int32))
    assert "pull" not in g._cache
