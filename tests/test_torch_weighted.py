"""The port's weighted delta-stepping lane on the CPU, against scipy's
Dijkstra, a numpy shortest-path-count DP and the JAX package.

Instances are the JAX weighted suite's own (deduplicated ER, grid and
skewed-weight ER with dyadic weights, so that float32 min-plus is exact),
carried across with their weights.  Distances are held to scipy's float64
Dijkstra cast to float32, bitwise; sigma to JAX's sweep and the numpy DP
where JAX does not rescale; levels and buckets to JAX's.  R1's two inputs
(delta = 41/16, which stalls the reference's window ladder) are held to
scipy only.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jc
import repro_torch.core as tc
from repro.core.bfs import delta_sssp_batched as jax_delta_sssp
from repro.core.diameter import estimate_diameter_weighted as jax_wdiam
from repro_torch.core.bfs import _delta_stepping
from repro_torch.kernels import frontier as tf
from _torch_parity import np_, to_port
from test_weighted import (_INSTANCES, _oracle_dist_cols, _scipy_dists,
                           _sigma_numpy)
from test_weighted_props import _random_connected_weighted

CPU = "cpu"
NAMES = sorted(_INSTANCES)


@pytest.fixture(autouse=True)
def _one_thread():
    """Small cases: one intra-op thread keeps them from contending for
    the cores with the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sources(g, k=8, seed=17):
    return np.random.default_rng(seed).integers(0, g.n_nodes, k).astype(
        np.int32)


@pytest.mark.parametrize("name", NAMES)
def test_weights_cross_over_and_match_the_port_draw(name):
    """The converter carries the JAX graph's weights; the port's own
    build (build_graph with weights, symmetric_dyadic_weights,
    with_weights, the layout's bucketed weights) gives the same bits."""
    jg = _INSTANCES[name]()
    g = to_port(jg)
    np.testing.assert_array_equal(np_(g.weight), np_(jg.weight))
    n = jg.n_edges
    own = tc.build_graph(np_(jg.src)[:n], np_(jg.dst)[:n], jg.n_nodes,
                         weight=np_(jg.weight)[:n], device=CPU)
    np.testing.assert_array_equal(np_(own.weight), np_(jg.weight))
    plain = dataclasses.replace(g, weight=None)
    if name != "skew":
        seed = {"er": 3, "grid": 5}[name]
        w = tc.symmetric_dyadic_weights(plain, seed=seed)
        np.testing.assert_array_equal(np_(w), np_(jg.weight)[:n])
    jcsc = jc.with_csc_layout(jg, block_v=32, block_e=128)
    csc = tc.with_weights(tc.with_csc_layout(plain, block_v=32, block_e=128),
                          g.weight[:n])
    np.testing.assert_array_equal(np_(csc.csc.weight), np_(jcsc.csc.weight))
    np.testing.assert_array_equal(np_(to_port(jcsc).csc.weight),
                                  np_(jcsc.csc.weight))
    assert csc.to(CPU).weight is not None and csc.to(CPU).csc.weight \
        is not None
    with pytest.raises(ValueError, match="strictly positive"):
        tc.with_weights(plain, torch.zeros(n))
    with pytest.raises(ValueError, match="one entry per directed edge"):
        tc.with_weights(plain, torch.ones(n + 1))


@pytest.mark.parametrize("name", NAMES)
def test_dist_matches_dijkstra_and_sigma_the_dp(name):
    jg = _INSTANCES[name]()
    g = to_port(jg)
    sources = _sources(g)
    res = tc.delta_sssp_batched(g, sources)
    D = _scipy_dists(jg)
    np.testing.assert_array_equal(np_(res.dist),
                                  _oracle_dist_cols(D, sources, g.n_nodes))
    for j, s in enumerate(sources):
        np.testing.assert_array_equal(np_(res.sigma)[: g.n_nodes, j],
                                      _sigma_numpy(jg, D, s))
    # a layout rides along: its rows past V+1 stay -3, the rest the same
    gc = to_port(jc.with_csc_layout(jg, block_v=32, block_e=128))
    rc = tc.delta_sssp_batched(gc, sources)
    assert rc.dist.shape[0] == gc.csc.v_pad
    np.testing.assert_array_equal(np_(rc.dist)[: g.n_nodes + 1],
                                  np_(res.dist))
    assert (np_(rc.dist)[g.n_nodes:] == -3.0).all()
    np.testing.assert_array_equal(np_(rc.sigma)[: g.n_nodes + 1],
                                  np_(res.sigma))


@pytest.mark.parametrize("name", NAMES)
def test_sigma_levels_and_buckets_match_jax(name):
    """Where JAX's fixed point does not rescale (these sums are small
    integers) sigma is JAX's bit for bit, and so are the DAG hop depth
    and the window advances."""
    jg = _INSTANCES[name]()
    g = to_port(jg)
    sources = _sources(g, seed=5)
    want = jax_delta_sssp(jg, jnp.asarray(sources))
    got = tc.delta_sssp_batched(g, sources)
    assert float(np_(want.sigma).max()) < 1e30
    for f in ("dist", "sigma", "levels", "buckets"):
        np.testing.assert_array_equal(np_(getattr(got, f)),
                                      np_(getattr(want, f)), err_msg=f)
    assert got.n_iters > 0 and got.n_dag_rounds == int(np_(got.levels).max())


def test_delta_inf_is_bellman_ford():
    jg = _INSTANCES["er"]()
    g = to_port(jg)
    sources = _sources(g)
    bf = tc.delta_sssp_batched(g, sources, delta=float("inf"))
    ds = tc.delta_sssp_batched(g, sources)
    assert not bf.buckets.any()
    for f in ("dist", "sigma", "levels"):
        assert torch.equal(getattr(bf, f), getattr(ds, f)), f
    want = jax_delta_sssp(jg, jnp.asarray(sources), delta=jnp.inf)
    np.testing.assert_array_equal(np_(bf.dist), np_(want.dist))


@pytest.mark.parametrize("shape", [(12, 9), (7, 31)])
def test_unit_weights_delta_one_is_the_ports_bfs(shape):
    """Unit weights with delta = 1: dist, sigma and levels bitwise the
    port's BFS lane, one window a BFS level."""
    g = tc.grid_graph(*shape, device=CPU)
    w = tc.with_weights(g, torch.ones(g.n_edges))
    sources = _sources(g, k=6, seed=1)
    got = tc.delta_sssp_batched(w, sources, delta=1.0)
    bfs = tc.bfs_sssp_batched(g, sources)
    assert torch.equal(got.dist, bfs.dist.float())
    assert torch.equal(got.sigma, bfs.sigma)
    assert torch.equal(got.levels, bfs.levels)
    assert torch.equal(got.buckets, bfs.levels)
    assert got.n_dag_rounds == bfs.n_iters - 1


@pytest.mark.parametrize("n,m,seed", [(9, 5, 1), (8, 5, 2)])
def test_r1_window_inputs_match_dijkstra(n, m, seed):
    """R1: at delta = 41/16 the reference's jitted window index (a
    multiply by the reciprocal) stalls and leaves vertices unrelaxed; the
    port's corrected index reaches scipy's distances.  Not compared with
    JAX, whose result here is the fault."""
    jg = _random_connected_weighted(n, m, seed)
    g = to_port(jg)
    sources = np.arange(n, dtype=np.int32)
    res = tc.delta_sssp_batched(g, sources, delta=41.0 / 16.0)
    D = _scipy_dists(jg)
    np.testing.assert_array_equal(np_(res.dist),
                                  _oracle_dist_cols(D, sources, n))
    assert (np_(res.dist)[:n] >= 0).all()
    for j, s in enumerate(sources):
        np.testing.assert_array_equal(np_(res.sigma)[:n, j],
                                      _sigma_numpy(jg, D, s))


def test_window_start_holds_the_closest_fresh_distance():
    """k * delta <= m < k * delta + delta in float32, where a reciprocal
    multiply puts floor(2.5625 / 2.5625) at 0."""
    from repro_torch.core.bfs import _window_start
    delta = torch.tensor(41.0 / 16.0)
    m = torch.tensor([0.0, 2.5625, 5.125, 7.6875, 1e-3, 100.0])
    ws = _window_start(m, delta)
    assert bool(((ws <= m) & (m < ws + delta)).all())
    assert ws.tolist()[:4] == [0.0, 2.5625, 5.125, 7.6875]


def test_round_cap_raises():
    g = to_port(_INSTANCES["grid"]())
    tent = torch.full((g.n_nodes + 1, 1), float("inf"))
    tent[0] = 0.0
    fresh = torch.zeros(tent.shape, dtype=torch.bool)
    fresh[0] = True

    def relax(t, mask):
        return tf.frontier_relax(g.src, g.dst, g.weight, t, mask)

    with pytest.raises(RuntimeError, match="round cap"):
        _delta_stepping(tent, fresh, torch.tensor(0.0625), 3, relax,
                        lambda x: x.sum(dim=0, dtype=torch.int32),
                        lambda x: x.amin(dim=0))


@pytest.mark.parametrize("budget", [None, 0])
def test_sharded_search_ships_exact_distances(budget):
    """R6: on float weights that are not dyadic the sharded search is
    bitwise the replicated one (dist, sigma, levels, buckets) over both
    exchange protocols: a bucket travels as its distance's bits, where
    the reference's ``tent + 1`` wire rounds (0.1 + 1 - 1 is 0.10000002
    in float32)."""
    one = np.float32(1.0)
    assert (np.float32(0.1) + one) - one != np.float32(0.1)
    g = tc.grid_graph(32, 16, device=CPU)
    w = np.random.default_rng(4).uniform(0.05, 1.0, g.n_edges)
    g = tc.with_weights(g, torch.from_numpy(w.astype(np.float32)))
    pg = tc.partition_graph(g, 8, block_v=32, block_e=128,
                            exchange_budget=budget)
    mesh = tc.ShardMesh(8, CPU)
    sources = _sources(g, k=4, seed=3)
    rep = tc.delta_sssp_batched(g, sources)
    sh = tc.delta_sssp_batched_sharded(pg, sources, mesh=mesh)
    v1 = g.n_nodes + 1
    for f in ("dist", "sigma"):
        assert torch.equal(mesh.all_gather(getattr(sh, f))[:v1],
                           getattr(rep, f)), f
    assert torch.equal(sh.levels, rep.levels)
    assert torch.equal(sh.buckets, rep.buckets)
    assert (sh.n_iters, sh.n_dag_rounds) == (rep.n_iters, rep.n_dag_rounds)
    assert (int(sh.exchange[1]) > 0) == (budget is None)


@pytest.mark.parametrize("sharded", [False, True])
def test_a_dag_cycle_raises_at_its_first_stuck_round(sharded):
    """A weight absorbed by a float32 distance (2^24 + 1 == 2^24) puts
    the cycle 1 <-> 2 on the shortest-path DAG: the count raises in its
    first round, which finalizes no cell, not at a round cap."""
    big = float(2 ** 24)
    g = tc.build_graph(np.array([0, 1, 1, 2]), np.array([1, 0, 2, 1]), 3,
                       weight=np.array([big, big, 1.0, 1.0], np.float32),
                       device=CPU)
    with pytest.raises(RuntimeError, match="in round 1 .*cycle"):
        if sharded:
            pg = tc.partition_graph(g, 2, block_v=8, block_e=128)
            tc.delta_sssp_batched_sharded(pg, [0, 0],
                                          mesh=tc.ShardMesh(2, CPU))
        else:
            tc.delta_sssp_batched(g, [0, 0])


def test_a_graph_without_weights_raises():
    g = tc.grid_graph(4, 4, device=CPU)
    with pytest.raises(ValueError, match="weights"):
        tc.delta_sssp_batched(g, [0])
    with pytest.raises(ValueError, match="weights"):
        tc.sample_path_weighted_batched(g, torch.Generator(), 2)
    with pytest.raises(ValueError, match="relax plan"):
        g.relax_plan()
    pg = tc.partition_graph(g, 2, block_v=16, block_e=128)
    with pytest.raises(ValueError, match="weighted partition"):
        tc.delta_sssp_batched_sharded(pg, [0], mesh=tc.ShardMesh(2, CPU))
    with pytest.raises(ValueError, match="needs a graph with weights"):
        tc.run_fixed(g, 4, stream="weighted", device=CPU)


@pytest.mark.parametrize("cuda,shards,lane,want", [
    (False, None, None, "ref"),
    (True, None, None, "pull"),
    (False, "S", None, "sharded_level_ref"),
    (True, "S", None, "sharded_level"),
    (True, None, "pull", "pull"),
    (False, None, "ref", "ref"),
    (False, "S", "ref", "sharded_level_ref"),
    (True, "S", "pull", "sharded_level"),
])
def test_weighted_routes(cuda, shards, lane, want):
    assert tf.select_weighted_route(cuda=cuda, shards=shards,
                                    lane=lane) == want


@pytest.mark.parametrize("cuda,kw,match", [
    (False, dict(lane="pull"), "CUDA kernel"),
    (True, dict(lane="ref"), "plain version"),
    (True, dict(lane="flat"), "no weighted kernel"),
    (False, dict(lane="node_blocked"), "no weighted kernel"),
    (False, dict(lane="wide"), "unknown lane"),
    (True, dict(shards="S", lane="ref"), "plain version"),
])
def test_weighted_forced_lanes_raise(cuda, kw, match):
    with pytest.raises(ValueError, match=match):
        tf.select_weighted_route(cuda=cuda, **kw)


def test_the_dispatchers_run_the_plain_versions_on_the_cpu():
    """Every CPU route of both dispatchers against the JAX package's
    XLA references, bitwise (min is exact; the DAG sums add in source
    order on every route); a forced kernel raises."""
    from repro.kernels.frontier.ref import (dag_sigma_batched_ref,
                                            dag_sigma_sharded_ref,
                                            frontier_relax_batched_ref,
                                            frontier_relax_sharded_ref)
    jg = _INSTANCES["skew"]()
    g = to_port(jg)
    res = tc.delta_sssp_batched(g, _sources(g))
    tent = torch.where(res.dist >= 0, res.dist, float("inf"))
    gen = torch.Generator().manual_seed(0)
    active = torch.rand(tent.shape, generator=gen) < 0.5
    sigma = torch.rand(tent.shape, generator=gen)
    final = torch.zeros(tent.shape, dtype=torch.bool)
    args = (g.src, g.dst, g.weight, tent, active)
    got = tf.frontier_relax(*args)
    want = frontier_relax_batched_ref(jg.src, jg.dst, jg.weight,
                                      jnp.asarray(np_(tent)),
                                      jnp.asarray(np_(active)))
    np.testing.assert_array_equal(np_(got), np_(want))
    sums, _waiting = tf.dag_sigma(g.src, g.dst, g.weight, tent, sigma,
                                  final)
    jsum = dag_sigma_batched_ref(jg.src, jg.dst, jg.weight,
                                 jnp.asarray(np_(tent)),
                                 jnp.asarray(np_(sigma)))
    np.testing.assert_array_equal(np_(sums), np_(jsum))
    np.testing.assert_array_equal(
        np_(tf.dag_sigma_batched_ref(g.src, g.dst, g.weight, tent, sigma)),
        np_(jsum))
    # a random final set: final cells give 0 and False, the others wait
    # exactly on an on-DAG in-edge from an open source
    final = torch.rand(tent.shape, generator=gen) < 0.5
    sums, waiting = tf.dag_sigma(g.src, g.dst, g.weight, tent, sigma, final)
    n = jg.n_edges
    src, dst = np_(g.src)[:n], np_(g.dst)[:n]
    t_np, f_np = np_(tent), np_(final)
    on = np.isfinite(t_np[src]) & (t_np[src] + np_(g.weight)[:n, None]
                                   == t_np[dst])
    want_w = np.zeros(t_np.shape, bool)
    np.logical_or.at(want_w, dst, on & ~f_np[src])
    np.testing.assert_array_equal(np_(waiting), want_w & ~f_np)
    np.testing.assert_array_equal(np_(sums), np.where(f_np, 0.0, np_(jsum)))
    final = torch.zeros(tent.shape, dtype=torch.bool)
    with pytest.raises(ValueError, match="CUDA kernel"):
        tf.frontier_relax(*args, lane="pull")
    # the sharded route, every shard at once, and its per-shard helpers
    jpg = jc.partition_graph(jg, 2, block_v=32, block_e=128)
    pg = tc.partition_graph(g, 2, block_v=32, block_e=128)
    pad = pg.v_pad - tent.shape[0]
    tg = torch.cat([tent, tent.new_full((pad, tent.shape[1]),
                                        float("inf"))])
    ag = torch.cat([active, active.new_zeros((pad, tent.shape[1]))])
    sg = torch.cat([sigma, sigma.new_zeros((pad, tent.shape[1]))])
    stack = tf.frontier_relax(None, None, None, tg, ag, shards=pg.shards)
    dsum, _dw = tf.dag_sigma(None, None, None, tg, sg,
                             torch.zeros(tg.shape, dtype=torch.bool),
                             shards=pg.shards)
    for s in range(2):
        view = jpg.shards.shard(s)
        rows = slice(s * pg.shard_rows, (s + 1) * pg.shard_rows)
        jt = jnp.asarray(np_(tg))
        np.testing.assert_array_equal(
            np_(stack[s]), np_(frontier_relax_sharded_ref(
                view, jt, jnp.asarray(np_(ag)))))
        np.testing.assert_array_equal(
            np_(tf.frontier_relax_sharded_ref(pg.shards.shard(s), tg, ag)),
            np_(stack[s]))
        want = dag_sigma_sharded_ref(view, jt, jnp.asarray(np_(sg)),
                                     jt[rows])
        np.testing.assert_array_equal(np_(dsum[s]), np_(want))
        np.testing.assert_array_equal(
            np_(tf.dag_sigma_sharded_ref(pg.shards.shard(s), tg, sg,
                                         tg[rows])), np_(want))
        one = tf.dag_round_sharded_ref(
            pg.shards.shard(s), tg, sg,
            torch.zeros(tg.shape, dtype=torch.bool), rows.start)
        np.testing.assert_array_equal(np_(one[0]), np_(want))


def test_weighted_diameter_matches_jax_and_brackets_truth():
    """The same seeds as JAX's draw give JAX's bounds bit for bit on a
    connected graph, and they bracket scipy's weighted diameter."""
    jg = _INSTANCES["grid"]()
    g = to_port(jg)
    want = jax_wdiam(jg)
    seeds = jax.random.randint(jax.random.PRNGKey(0), (1,), 0, jg.n_nodes)
    got = tc.estimate_diameter_weighted(g, seeds=np_(seeds))
    assert np.float32(got.lower) == np.float32(want.lower)
    assert np.float32(got.upper) == np.float32(want.upper)
    assert got.vertex_diameter == int(want.vertex_diameter)
    D = _scipy_dists(jg)
    assert got.lower <= float(D.max()) <= got.upper
    assert got.n_levels > 0 and got.n_dag_rounds > 0


def test_weighted_diameter_covers_a_component_the_seed_misses():
    """R3 on the weighted lane: a seed on an isolated vertex cannot
    collapse the bound; the long component gets its own chain."""
    path = np.stack([np.arange(29), np.arange(1, 30)], axis=1)
    g = tc.from_edge_list(path, 31, device=CPU)        # vertex 30 isolated
    g = tc.with_weights(g, tc.symmetric_dyadic_weights(g, seed=2))
    est = tc.estimate_diameter_weighted(g, seeds=[30])
    D = _scipy_dists(dataclasses.replace(
        g, weight=g.weight.numpy(), src=g.src.numpy(), dst=g.dst.numpy()))
    true = float(D[np.isfinite(D)].max())
    assert est.lower <= true <= est.upper
    assert est.vertex_diameter >= 30


def test_weighted_walks_follow_shortest_paths_and_pairs_ignore_weights():
    """The pair draw reads no weight (the forward stream's pairs on the
    same generator); every walked path is a weighted shortest s-t path
    of ``length`` hops."""
    jg = _INSTANCES["er"]()
    g = to_port(jg)
    unweighted = dataclasses.replace(g, weight=None, _cache={})
    a = tc.sample_path_weighted_batched(g, torch.Generator().manual_seed(4),
                                        16)
    b = tc.sample_path_forward_batched(unweighted,
                                       torch.Generator().manual_seed(4), 16)
    s, t = tc.sample_pairs(torch.Generator().manual_seed(4), g.n_nodes, 16)
    assert torch.equal(a.sources, b.sources) and torch.equal(a.sources, s)
    D = _scipy_dists(jg)
    w = {(int(u), int(v)): float(x) for u, v, x in zip(
        np_(jg.src)[: jg.n_edges], np_(jg.dst)[: jg.n_edges],
        np_(jg.weight)[: jg.n_edges])}
    assert bool(a.valid.all())
    for j in range(16):
        # the walk runs from t down to s
        inner = [int(x) for x in np_(a.internal[j]) if x >= 0]
        hops = [int(s[j])] + inner[::-1] + [int(t[j])]
        total = sum(w[(hops[i], hops[i + 1])] for i in range(len(hops) - 1))
        assert total == D[int(s[j]), int(t[j])]
        assert int(a.length[j]) == len(hops) - 1
        assert np_(a.dist)[int(t[j]), j] == np.float32(total)
