"""The weighted lane's shortest-path-DAG count on the CPU: the rounds
that replace the reference's fixed point (fault R5), P3's floor carried
into them, and the plan-order plain versions of W1 and W2 replayed in
numpy.

R5: the JAX package iterates ``dag_sigma_batched_ref`` sweeps with the
sources pinned to 1 until nothing changes, rescaling a column by 1/max
once it passes 1e30.  The pin mixes scaled and unscaled counts, so a
rescaled column never reaches a fixed point: on the 64 x 64 unit grid
from a corner its ``levels`` comes back at the sweep cap (4,097) where
BFS gives 126, and sigma is left in an arbitrary state.  The port
finalizes a vertex once all its DAG in-neighbours are final, so the
rounds end after the DAG's hop depth and sigma is the exact count up to
the column's scale.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jc
import repro_torch.core as tc
from repro.core.bfs import delta_sssp_batched as jax_delta_sssp
from repro_torch.kernels import frontier as tf
from _torch_parity import np_, to_port
from test_torch_bfs_reach import _diamonds_and_path, _scipy_dist

CPU = "cpu"
TINY = np.finfo(np.float32).tiny


@pytest.fixture(autouse=True)
def _one_thread():
    """Small cases: one intra-op thread keeps them from contending for
    the cores with the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _unit(graph):
    return tc.with_weights(graph, torch.ones(graph.n_edges))


def test_r5_grid_levels_are_the_bfs_depth_and_sigma_the_counts():
    """64 x 64 grid, unit weights, delta = 1, from corner 0: levels 126
    (the BFS lane's), dist and buckets the BFS lane's, sigma the BFS
    lane's bits and C(i + j, i) up to one column scale (within 1e-5);
    the reference's levels is its sweep cap, 4,097 (R5)."""
    side = 64
    grid = tc.grid_graph(side, side, device=CPU)
    got = tc.delta_sssp_batched(_unit(grid), [0], delta=1.0)
    bfs = tc.bfs_sssp_batched(grid, [0])
    assert int(got.levels[0]) == int(bfs.levels[0]) == 2 * (side - 1)
    assert torch.equal(got.dist, bfs.dist.float())
    assert int(got.buckets[0]) == int(bfs.levels[0])
    assert torch.equal(got.sigma, bfs.sigma)
    sigma = np_(got.sigma)[: side * side, 0].astype(np.float64)
    exact = np.array([math.comb(i + j, i) for i in range(side)
                      for j in range(side)], np.float64)
    ratio = sigma / exact
    assert ratio.max() / ratio.min() - 1.0 < 1e-5
    assert float(sigma.max()) < 1e30 < float(exact.max())   # rescaled once
    jg = jc.with_weights(jc.grid_graph(side, side),
                         np.ones(grid.n_edges, np.float32))
    ref = jax_delta_sssp(jg, jnp.asarray([0], jnp.int32), delta=1.0)
    assert int(np_(ref.levels)[0]) == side * side + 1      # the fault


def test_p3_floor_on_the_diamond_chain_with_unit_weights():
    """Input A (260 diamonds beside a 520-edge path) with unit weights:
    the diamonds' counts are rescaled many times and the path's fall
    below float32's range; every reached vertex keeps sigma >= tiny,
    dist is scipy's and the rounds are the BFS lane's levels."""
    edges, n = _diamonds_and_path()
    graph = tc.from_edge_list(edges, n, device=CPU)
    got = tc.delta_sssp_batched(_unit(graph), [0], delta=1.0)
    dist = np_(got.dist)[:n, 0]
    np.testing.assert_array_equal(dist, _scipy_dist(edges, n, 0))
    bfs = tc.bfs_sssp_batched(graph, [0])
    assert int(got.levels[0]) == int(bfs.levels[0]) == 520
    assert torch.equal(got.sigma, bfs.sigma)
    sigma = np_(got.sigma)[:n, 0]
    assert (sigma[dist >= 0] >= TINY).all()


def _numpy_pull(rplan, tent, active, sigma, final):
    """W1 and W2 of one round replayed in numpy over the plan, in the
    kernels' order: each row's in-edges in plan order, a cut row's items
    into partial rows, then the partials in item order."""
    plan = rplan.plan
    offsets = np_(plan.offsets)
    ids = np_(plan.ids_sorted)
    w = np_(rplan.weight)
    rows, batch = tent.shape
    out_min = np.full((rows, batch), np.inf, np.float32)
    sums = np.zeros((rows, batch), np.float32)
    waiting = np.zeros((rows, batch), bool)

    def walk(lo, hi, v):
        m = np.full(batch, np.inf, np.float32)
        acc = np.zeros(batch, np.float32)
        wait = np.zeros(batch, bool)
        for e in range(lo, hi):
            u = ids[e]
            cand = np.where(active[u], tent[u] + w[e], np.inf).astype(
                np.float32)
            m = np.minimum(m, cand)
            on = np.isfinite(tent[u]) & (tent[u] + w[e] == tent[v])
            acc = np.where(on, acc + sigma[u], acc).astype(np.float32)
            wait |= on & ~final[u]
        return m, acc, wait

    item_begin, item_end = np_(plan.item_begin), np_(plan.item_end)
    split_first = np_(plan.split_first)
    for v in range(plan.n_segments):
        lo, hi = offsets[v], offsets[v + 1]
        if hi - lo <= plan.split:
            out_min[v], sums[v], waiting[v] = walk(lo, hi, v)
    for q, v in enumerate(np_(plan.split_seg)):
        parts = [walk(item_begin[h], item_end[h], v)
                 for h in range(split_first[q], split_first[q + 1])]
        m = np.full(batch, np.inf, np.float32)
        acc = np.zeros(batch, np.float32)
        wait = np.zeros(batch, bool)
        for pm, ps, pw in parts:
            m = np.minimum(m, pm)
            acc = (acc + ps).astype(np.float32)
            wait |= pw
        out_min[v], sums[v], waiting[v] = m, acc, wait
    return out_min, np.where(final, 0.0, sums), waiting & ~final


@pytest.mark.parametrize("split", [tf.PULL_SPLIT, 3])
def test_plan_order_versions_replayed_in_numpy(split):
    """The relax plan (a row's in-edges in source order, the weights in
    plan order, each item's row) and both plan-order plain versions,
    bitwise a numpy replay on non-integer sigma."""
    g = tc.rmat_graph(7, 8, seed=2, device=CPU)
    g = tc.with_weights(g, tc.symmetric_dyadic_weights(g, seed=1))
    rplan = tf.build_relax_plan(g.src, g.dst, g.weight, g.n_nodes + 1,
                                split=split)
    plan = rplan.plan
    assert split == tf.PULL_SPLIT or plan.n_items > plan.split_seg.shape[0]
    np.testing.assert_array_equal(
        np_(rplan.weight), np_(g.weight)[np_(plan.order)])
    np.testing.assert_array_equal(
        np_(rplan.item_row), np.repeat(np_(plan.split_seg),
                                       np.diff(np_(plan.split_first))))
    offsets, ids = np_(plan.offsets), np_(plan.ids_sorted)
    for v in range(g.n_nodes):
        assert (np.diff(ids[offsets[v]: offsets[v + 1]]) > 0).all()
    res = tc.delta_sssp_batched(g, np.arange(0, 128, 13, dtype=np.int32))
    gen = torch.Generator().manual_seed(split)
    tent = torch.where(res.dist >= 0, res.dist, float("inf"))
    active = torch.rand(tent.shape, generator=gen) < 0.5
    sigma = torch.rand(tent.shape, generator=gen) * 3.0
    final = (torch.rand(tent.shape, generator=gen) < 0.5) \
        | ~torch.isfinite(tent)
    want_min, want_sums, want_wait = _numpy_pull(
        rplan, np_(tent), np_(active), np_(sigma), np_(final))
    got_min = tf.frontier_relax_pull_ref(rplan, tent, active, tent.shape[0])
    got_sums, got_wait = tf.dag_sigma_pull_ref(rplan, tent, sigma, final,
                                               tent.shape[0])
    np.testing.assert_array_equal(np_(got_min), want_min)
    np.testing.assert_array_equal(np_(got_sums), want_sums)
    np.testing.assert_array_equal(np_(got_wait), want_wait)
    # the CPU wrappers run these plain versions, and the COO min agrees
    assert torch.equal(tf.frontier_relax_pull(rplan, tent, active), got_min)
    assert torch.equal(tf.frontier_relax_batched_ref(
        g.src, g.dst, g.weight, tent, active), got_min)
    got = tf.dag_sigma_pull(rplan, tent, sigma, final)
    assert torch.equal(got[0], got_sums) and torch.equal(got[1], got_wait)


@pytest.mark.parametrize("shard", [None, 1])
def test_sharded_relax_plan_stacks_the_held_shards(shard):
    """The sharded relax plan (whole, or one rank's local layout) over
    global sources: its plan-order versions give the per-shard plain
    versions' tiles, and a row's in-edges keep the replicated plan's
    order (ascending sources), so the DAG sums are the replicated ones'
    bits."""
    g = tc.rmat_graph(7, 8, seed=3, device=CPU)
    g = tc.with_weights(g, tc.symmetric_dyadic_weights(g, seed=2))
    pg = tc.partition_graph(g, 4, block_v=16, block_e=128, shard=shard)
    rplan = pg.shards.relax_plan()
    assert rplan is pg.shards.relax_plan()               # kept
    rows = pg.shard_rows
    assert rplan.dst_offset == (shard or 0) * rows
    assert rplan.out_rows == pg.shards.n_local_shards * rows
    res = tc.delta_sssp_batched(g, np.arange(0, 128, 9, dtype=np.int32))
    gen = torch.Generator().manual_seed(1)
    tent = torch.where(res.dist >= 0, res.dist, float("inf"))
    tent = torch.cat([tent, tent.new_full((pg.v_pad - tent.shape[0],
                                           tent.shape[1]), float("inf"))])
    active = torch.rand(tent.shape, generator=gen) < 0.5
    sigma = torch.rand(tent.shape, generator=gen) * 3.0
    final = (torch.rand(tent.shape, generator=gen) < 0.3) \
        | ~torch.isfinite(tent)
    shape = (pg.shards.n_local_shards, rows, tent.shape[1])
    got = tf.frontier_relax_pull_ref(rplan, tent, active, rplan.out_rows)
    want = tf.frontier_relax_sharded_level_ref(pg.shards, tent, active)
    assert torch.equal(got.view(shape), want)
    sums, waiting = tf.dag_sigma_pull_ref(rplan, tent, sigma, final,
                                          rplan.out_rows)
    ws, ww = tf.dag_round_sharded_level_ref(pg.shards, tent, sigma, final)
    assert torch.equal(sums.view(shape), ws)
    assert torch.equal(waiting.view(shape), ww)
    full = tf.dag_round_batched_ref(g.src, g.dst, g.weight,
                                    tent[: g.n_nodes + 1],
                                    sigma[: g.n_nodes + 1],
                                    final[: g.n_nodes + 1])
    first = rplan.dst_offset
    n_real = min(rplan.out_rows, g.n_nodes + 1 - first)
    assert torch.equal(sums[:n_real], full[0][first: first + n_real])
