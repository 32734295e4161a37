"""The port's sharded cooperative lane on a ``ShardMesh`` (all shards on
the CPU) against the JAX package.

JAX's own tests hold its sharded BFS, bidirectional BFS, diameter and
sampler bit for bit to its replicated ones (``tests/test_partition.py``),
so the port's sharded functions are held against JAX's replicated
functions, run here in this process: ``dist``, ``levels``, ``d`` and
``split`` bitwise, and ``sigma`` bitwise while it is an exact integer.
The plain wide expansion and the frontier bitmaps are held against JAX's
own sharded helpers; the sampler, whose generator differs from
``jax.random``, against the port's replicated sampler at the same seed.
"""
import dataclasses

import jax
import jax.numpy as jnp
import networkx as nx
import numpy as np
import pytest
import torch

import repro.core as jc
import repro.kernels.frontier as jf
import repro_torch.core as tc
import repro_torch.kernels.frontier as tf
from _torch_parity import np_, partitioned_to_port, to_port, wide_inputs
from repro_torch.core import AdaptiveConfig, ShardMesh
from repro_torch.runtime import InjectedFault

CPU = "cpu"


def _ws60():
    g = nx.connected_watts_strogatz_graph(60, 6, 0.3, seed=0)
    return jc.from_edge_list(np.array(g.edges()), 60)


def _gathered(mesh, x, v1):
    return np_(mesh.all_gather(x)[:v1])


# ---------------------------------------------------------------------------
# The plain wide expansion, the bitmaps and the dispatcher's routes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("gaussian", [False, True], ids=["int", "normal"])
@pytest.mark.parametrize("batch", [1, 5, 33, 64, 96])
def test_sharded_ref_matches_jax(batch, gaussian):
    jgraph = jc.erdos_renyi_graph(500, 6.0, seed=7)
    jpg = jc.partition_graph(jgraph, 4, block_v=64, block_e=128)
    tpg = partitioned_to_port(jpg)
    fdist, fvals, levels = wide_inputs(to_port(jgraph), jpg, batch, batch,
                                       gaussian)
    args = [torch.from_numpy(a) for a in (fdist, fvals, levels)]
    before = dict(tf.launch_counts)
    for s in range(jpg.n_shards):
        want = np_(jf.frontier_expand_sharded_ref(
            jpg.shards.shard(s), *map(jnp.asarray, (fdist, fvals, levels))))
        view = tpg.shards.shard(s)
        got = np_(tf.frontier_expand_sharded_ref(view, *args))
        routed = np_(tf.frontier_expand(view.src, view.dst, *args,
                                        shard=view))
        wide = np_(tf.frontier_expand_node_blocked(view, *args,
                                                   wide_state=True))
        assert got.shape == (jpg.shard_rows, batch)
        if gaussian:
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
        else:
            assert want.max() < 2 ** 24
            np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(routed, got)
        np.testing.assert_array_equal(wide, got)
    assert tf.launch_counts == before       # no kernel on the CPU


class _Layout:
    def __init__(self, block_e):
        self.block_e = block_e


@pytest.mark.parametrize("cuda,lane,route", [
    (False, None, "sharded_ref"), (False, "ref", "sharded_ref"),
    (True, None, "sharded_nb"), (True, "node_blocked", "sharded_nb")])
def test_select_route_sharded(cuda, lane, route):
    assert tf.select_route(cuda=cuda, shard=_Layout(1024), lane=lane) \
        == route


@pytest.mark.parametrize("cuda,csc,shard,lane,match", [
    (False, None, _Layout(1024), "node_blocked", "CPU"),
    (True, None, _Layout(1024), "ref", "CPU tensors"),
    (True, None, _Layout(1024), "flat", "flat kernel"),
    (False, None, _Layout(1024), "flat", "flat kernel"),
    (True, _Layout(1024), _Layout(1024), None, "not both"),
    (False, _Layout(1024), _Layout(1024), "ref", "not both"),
    (True, None, _Layout(29_057), None, "shared memory"),
    (True, None, _Layout(1024), "pallas", "unknown lane"),
])
def test_sharded_route_errors(cuda, csc, shard, lane, match):
    with pytest.raises(ValueError, match=match):
        tf.select_route(cuda=cuda, csc=csc, shard=shard, lane=lane)


def test_sharded_dispatcher_raises_on_cpu():
    tpg = tc.partition_graph(tc.grid_graph(16, 8, device=CPU), 2,
                             block_v=32, block_e=128)
    view = tpg.shards.shard(0)
    fdist = torch.full((tpg.v_pad, 2), -1, dtype=torch.int32)
    fvals = torch.zeros(fdist.shape)
    with pytest.raises(ValueError, match="CPU"):
        tf.frontier_expand(view.src, view.dst, fdist, fvals, [0, 0],
                           shard=view, lane="node_blocked")
    with pytest.raises(ValueError, match="not both"):
        tf.frontier_expand(view.src, view.dst, fdist, fvals, [0, 0],
                           shard=view, csc=view)
    with pytest.raises(ValueError, match="gathered rows"):
        tf.frontier_expand_node_blocked(view, fdist[:10], fvals[:10],
                                        [0, 0], wide_state=True)


def test_frontier_bitmaps_match_jax():
    jgraph = jc.grid_graph(32, 16)
    jpg = jc.partition_graph(jgraph, 4, block_v=64, block_e=128)
    tpg = partitioned_to_port(jpg)
    res = tc.bfs_sssp_batched(to_port(jgraph), [0, 100, 511])
    levels = jnp.asarray([2, 3, 5], jnp.int32)
    active = jnp.asarray([True, False, True])
    dist = np.full((jpg.v_pad, 3), -3, np.int32)
    dist[: jgraph.n_nodes + 1] = np_(res.dist)
    chunk = jpg.exchange_chunk_rows
    for act in (None, active):
        want = np_(jf.frontier_source_block_bitmap(
            jnp.asarray(dist), levels, chunk, act))
        got = np_(tf.frontier_source_block_bitmap(
            torch.from_numpy(dist), torch.from_numpy(np.array(levels)),
            chunk, None if act is None else torch.from_numpy(np.array(act))))
        np.testing.assert_array_equal(got, want)
        assert 0 < want.sum() < want.shape[0]
        for s in range(jpg.n_shards):
            np.testing.assert_array_equal(
                np_(tf.edge_bitmap_from_source_bits(
                    tpg.shards.shard(s), torch.from_numpy(want), chunk)),
                np_(jf.edge_bitmap_from_source_bits(
                    jpg.shards.shard(s), jnp.asarray(want), chunk)))


# ---------------------------------------------------------------------------
# The sharded BFS searches and the exchange
# ---------------------------------------------------------------------------

def test_bfs_sssp_sharded_matches_jax_replicated():
    """Grid 126 x 126 in 8 shards, B=64, against JAX's replicated BFS:
    dist and levels bitwise; rows past the graph stay -3 / 0.  Sigma
    passes 1e30 here and is rescaled, so it is no exact integer: it is
    bitwise JAX's wherever JAX's is a normal number (at least 2^-126),
    and at least float32's smallest normal where JAX's is 0 or
    subnormal, since the port floors a reached vertex's sigma there."""
    jgraph = jc.grid_graph(126, 126)
    tpg = tc.partition_graph(to_port(jgraph), 8, block_v=256, block_e=128)
    sources = np.random.default_rng(11).integers(
        0, jgraph.n_nodes, 64).astype(np.int32)
    mesh = ShardMesh(8, CPU)
    got = tc.bfs_sssp_batched_sharded(tpg, sources, mesh=mesh)
    want = jc.bfs_sssp_batched(jgraph, jnp.asarray(sources))
    v1 = jgraph.n_nodes + 1
    assert got.dist.shape == (8, tpg.shard_rows, 64)
    np.testing.assert_array_equal(_gathered(mesh, got.dist, v1),
                                  np_(want.dist))
    np.testing.assert_array_equal(np_(got.levels), np_(want.levels))
    sigma, jsigma = _gathered(mesh, got.sigma, v1), np_(want.sigma)
    tiny = np.finfo(np.float32).tiny
    reached = np_(want.dist) >= 0
    normal = reached & (jsigma >= tiny)
    np.testing.assert_array_equal(sigma[normal], jsigma[normal])
    assert (sigma[reached & ~normal] >= tiny).all()
    np.testing.assert_array_equal(sigma[~reached], jsigma[~reached])
    assert bool((mesh.all_gather(got.dist)[v1:] == -3).all())
    assert bool((mesh.all_gather(got.sigma)[v1:] == 0).all())
    assert got.n_iters == int(np_(want.levels).max()) + 1
    assert got.exchange.tolist()[0] == got.n_iters


def test_bfs_sharded_stop_nodes_match_jax():
    jgraph = jc.grid_graph(20, 12)
    tpg = tc.partition_graph(to_port(jgraph), 3, block_v=32, block_e=128)
    rng = np.random.default_rng(4)
    src, stop = (rng.integers(0, jgraph.n_nodes, 5).astype(np.int32)
                 for _ in range(2))
    mesh = ShardMesh(3, CPU)
    got = tc.bfs_sssp_batched_sharded(tpg, src, mesh=mesh, stop_nodes=stop)
    want = jc.bfs_sssp_batched(jgraph, jnp.asarray(src),
                               stop_nodes=jnp.asarray(stop))
    v1 = jgraph.n_nodes + 1
    np.testing.assert_array_equal(_gathered(mesh, got.dist, v1),
                                  np_(want.dist))
    np.testing.assert_array_equal(np_(got.levels), np_(want.levels))


_SS = np.array([0, 5, 1000, 2047], np.int32)
_TT = np.array([2047, 100, 9, 44], np.int32)


def _bidir(tpg, mesh):
    return tc.bidirectional_bfs_batched_sharded(tpg, _SS, _TT, mesh=mesh)


def test_bidirectional_sharded_matches_jax_replicated():
    jgraph = jc.grid_graph(64, 32)
    tpg = tc.partition_graph(to_port(jgraph), 8, block_v=128, block_e=256)
    mesh = ShardMesh(8, CPU)
    got = _bidir(tpg, mesh)
    want = jc.bidirectional_bfs_batched(jgraph, jnp.asarray(_SS),
                                        jnp.asarray(_TT))
    v1 = jgraph.n_nodes + 1
    for f in ("dist_s", "dist_t", "sigma_s", "sigma_t"):
        np.testing.assert_array_equal(_gathered(mesh, getattr(got, f), v1),
                                      np_(getattr(want, f)), err_msg=f)
    np.testing.assert_array_equal(np_(got.d), np_(want.d))
    np.testing.assert_array_equal(np_(got.split), np_(want.split))


def test_exchange_protocols_give_the_same_bits():
    """The default budget takes the sparse protocol on narrow levels and
    falls back on wide ones; a dense-only partition gives the same bits,
    padding included."""
    g = to_port(jc.grid_graph(64, 32))
    mesh = ShardMesh(8, CPU)
    tpg = tc.partition_graph(g, 8, block_v=128, block_e=256)
    dense = tc.partition_graph(g, 8, block_v=128, block_e=256,
                               exchange_budget=0)
    assert tpg.exchange_budget > 0 and dense.exchange_budget == 0
    got, ref = _bidir(tpg, mesh), _bidir(dense, mesh)
    for a, b in zip(got[:6], ref[:6]):
        assert torch.equal(a, b)
    levels, sparse = got.exchange.tolist()
    assert levels == got.n_iters and 0 < sparse < levels
    assert ref.exchange.tolist() == [ref.n_iters, 0]
    # the pricing of this run's tally
    plan = tc.exchange_plan(tpg, len(_SS))
    acct = plan.epoch_accounting(levels, sparse)
    assert acct["levels_dense_fallback"] == levels - sparse
    assert acct["bytes"] < levels * plan.dense_bytes


# ---------------------------------------------------------------------------
# Diameter, sampler, engine
# ---------------------------------------------------------------------------

def test_diameter_sharded_matches_jax_on_a_connected_graph():
    jgraph = jc.grid_graph(64, 32)
    tpg = tc.partition_graph(to_port(jgraph), 8, block_v=128, block_e=256)
    key = jax.random.PRNGKey(0)
    seeds = np_(jax.random.randint(key, (1,), 0, jgraph.n_nodes))
    want = jc.estimate_diameter(jgraph, key)
    got = tc.estimate_diameter_sharded(tpg, ShardMesh(8, CPU), seeds=seeds)
    assert (got.lower, got.upper, got.vertex_diameter) == (
        int(want.lower), int(want.upper), int(want.vertex_diameter))


def test_diameter_sharded_bounds_every_component():
    """With an isolated vertex the port's bound covers every component
    (departure R3): the sharded estimate equals the port's single lane,
    and return_dist gives the first chains' second sweep."""
    edges = np.array([[i, i + 1] for i in range(30)] + [[40, 41]])
    g = tc.from_edge_list(edges, 45, device=CPU)
    tpg = tc.partition_graph(g, 3, block_v=16, block_e=128)
    for seed in (0, 1, 2):
        want = tc.estimate_diameter(g, torch.Generator().manual_seed(seed))
        got, dist = tc.estimate_diameter_sharded(
            tpg, ShardMesh(3, CPU), torch.Generator().manual_seed(seed),
            return_dist=True)
        assert got == want and got.upper >= 30
        assert dist.shape == (tpg.v_pad, 1) and int(dist.min()) == -1


def test_sample_batch_sharded_matches_the_replicated_sampler():
    g = to_port(jc.grid_graph(32, 16))
    tpg = tc.partition_graph(g, 8, block_v=64, block_e=128)
    mesh = ShardMesh(8, CPU)
    got = tc.sample_batch(tpg, torch.Generator().manual_seed(5), 19,
                          batch_size=6, mesh=mesh)
    want = tc.sample_batch(g, torch.Generator().manual_seed(5), 19,
                           batch_size=6)
    assert torch.equal(got[0], want[0]) and got[1] == want[1] == 19
    got = tc.sample_path_forward_batched_sharded(
        tpg, torch.Generator().manual_seed(3), 7, mesh=mesh)
    want = tc.sample_path_forward_batched(
        g, torch.Generator().manual_seed(3), 7)
    for f in ("internal", "valid", "length", "sources"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    v1 = g.n_nodes + 1
    assert torch.equal(got.dist[:v1], want.dist)
    assert got.exchange.tolist()[0] == got.n_levels == want.n_levels


def test_run_kadabra_sharded_converges_within_eps():
    """Watts-Strogatz(60) in 8 shards: converged, within eps of exact
    Brandes; the "auto" budget gives the same bits; each epoch's stats
    price the exchange."""
    g = to_port(_ws60())
    eps = 0.05
    cfg = AdaptiveConfig(eps=eps, delta=0.1, n0_base=400)
    mesh = ShardMesh(8, CPU)
    pg = tc.partition_graph(g, 8, block_v=8, block_e=128)
    res = tc.run_kadabra(pg, mesh=mesh, config=cfg)
    err = np.abs(res.btilde - tc.brandes_numpy(g)).max()
    assert res.converged and res.tau > 0 and err < eps
    auto = tc.run_kadabra(tc.partition_graph(g, 8, block_v=8, block_e=128,
                                             exchange_budget="auto"),
                          mesh=mesh, config=cfg)
    np.testing.assert_array_equal(auto.btilde, res.btilde)
    assert auto.tau == res.tau and auto.converged
    assert all(s.exchange["levels_total"] > 0 for s in res.stats)
    assert sum(s.exchange["levels_total"] for s in res.stats) \
        < res.bfs_levels


def test_run_fixed_sharded_matches_the_replicated_lane():
    """Closeness sweeps the diameter on both lanes, so the generator's
    draws line up: the sharded run gives the replicated run's bits."""
    g = to_port(jc.grid_graph(20, 12))
    pg = tc.partition_graph(g, 4, block_v=32, block_e=128)
    kw = dict(metrics=("closeness", "betweenness"), seed=3, batch_size=8)
    got = tc.run_fixed(pg, 40, mesh=ShardMesh(4, CPU), **kw)
    want = tc.run_fixed(g, 40, device=CPU, **kw)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.scores, b.scores)
        assert a.tau == b.tau == 40


def _refuse(epoch, state):
    raise InjectedFault(f"refused epoch {epoch}")


def test_sharded_lane_raises():
    g = to_port(jc.grid_graph(8, 8))
    pg = tc.partition_graph(g, 2, block_v=16, block_e=128)
    mesh = ShardMesh(2, CPU)
    with pytest.raises(ValueError, match="mesh"):
        tc.run_kadabra(pg)
    with pytest.raises(ValueError, match="shards"):
        tc.run_kadabra(pg, mesh=ShardMesh(3, CPU))
    with pytest.raises(ValueError, match="lies on"):
        mesh.check(dataclasses.replace(pg).to("meta"))
    with pytest.raises(ValueError, match="differs"):
        tc.run_kadabra(pg, mesh=mesh, device="meta")
    # a replicated Graph takes a SamplerMesh (the SPMD lane), not a
    # ShardMesh
    with pytest.raises(TypeError, match="SamplerMesh"):
        tc.run_kadabra(g, mesh=mesh, device=CPU)
    with pytest.raises(TypeError, match="SamplerMesh"):
        tc.run_fixed(g, 8, mesh=mesh, device=CPU)
    # item 14 is ported: a hook's refusal and a telemetry argument of no
    # known form raise on the sharded lane too
    with pytest.raises(InjectedFault, match="refused epoch 1"):
        tc.run_adaptive(pg, mesh=mesh, on_epoch=_refuse)
    with pytest.raises(TypeError, match="telemetry must be"):
        tc.run_adaptive(pg, mesh=mesh, telemetry=3)
    # the weighted stream (item 13) needs a partition with weights
    with pytest.raises(ValueError, match="needs a graph with weights"):
        tc.run_adaptive(pg, mesh=mesh, stream="weighted")
    with pytest.raises(ValueError, match="n_shards"):
        ShardMesh(0, CPU)


def test_shard_mesh_on_cuda_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ShardMesh(8)
