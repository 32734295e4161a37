"""Batched BFS and the diameter sweep of the PyTorch port against the
JAX package, with and without a CSC layout: ``dist``, ``levels``, ``d``
and ``split`` bit for bit, and ``sigma`` bit for bit while it holds
exact small integers."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import repro.core as jc
import repro_torch.core as tc
from _torch_parity import np_, to_port
from repro_torch.core.diameter import connected_components

GRAPHS = {
    "er": lambda: jc.erdos_renyi_graph(300, 5.0, seed=4),
    "grid": lambda: jc.grid_graph(14, 11),
    "rmat": lambda: jc.rmat_graph(8, 6, seed=2),
}
CSC = {"er": (64, 128), "grid": (37, 128), "rmat": (100, 256)}


def _graphs(name, csc):
    jgraph = GRAPHS[name]()
    if csc:
        jgraph = jc.with_csc_layout(jgraph, block_v=CSC[name][0],
                                    block_e=CSC[name][1])
    return jgraph, to_port(jgraph)


def _ids(n, k, seed):
    return np.random.default_rng(seed).integers(0, n, k).astype(np.int32)


@pytest.mark.parametrize("csc", [False, True], ids=["coo", "csc"])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_bfs_sssp_batched_matches_jax(name, csc):
    jgraph, tgraph = _graphs(name, csc)
    sources = _ids(jgraph.n_nodes, 6, seed=len(name))
    want = jc.bfs_sssp_batched(jgraph, jnp.asarray(sources))
    got = tc.bfs_sssp_batched(tgraph, sources)
    rows = tgraph.csc.v_pad if csc else tgraph.n_nodes + 1
    assert got.dist.shape == (rows, 6)
    np.testing.assert_array_equal(np_(got.dist), np_(want.dist))
    np.testing.assert_array_equal(np_(got.levels), np_(want.levels))
    np.testing.assert_array_equal(np_(got.sigma), np_(want.sigma))
    # the loop expands until every frontier is empty: one level past the
    # deepest eccentricity
    assert got.n_iters == int(np_(got.levels).max()) + 1


@pytest.mark.parametrize("csc", [False, True], ids=["coo", "csc"])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_bidirectional_bfs_batched_matches_jax(name, csc):
    jgraph, tgraph = _graphs(name, csc)
    s = _ids(jgraph.n_nodes, 8, seed=1)
    t = _ids(jgraph.n_nodes, 8, seed=2)
    t = np.where(t == s, (t + 1) % jgraph.n_nodes, t).astype(np.int32)
    want = jc.bidirectional_bfs_batched(jgraph, jnp.asarray(s),
                                        jnp.asarray(t))
    got = tc.bidirectional_bfs_batched(tgraph, s, t)
    for f in ("dist_s", "dist_t", "d", "split", "sigma_s", "sigma_t"):
        np.testing.assert_array_equal(np_(getattr(got, f)),
                                      np_(getattr(want, f)), err_msg=f)
    assert got.n_iters >= 1


def test_bfs_stop_nodes_match_jax():
    jgraph, tgraph = _graphs("grid", False)
    sources, stops = _ids(jgraph.n_nodes, 4, 5), _ids(jgraph.n_nodes, 4, 6)
    want = jc.bfs_sssp_batched(jgraph, jnp.asarray(sources),
                               stop_nodes=jnp.asarray(stops))
    got = tc.bfs_sssp_batched(tgraph, sources, stop_nodes=stops)
    np.testing.assert_array_equal(np_(got.dist), np_(want.dist))
    np.testing.assert_array_equal(np_(got.levels), np_(want.levels))


def test_single_search_wrappers_match_jax():
    jgraph, tgraph = _graphs("rmat", True)
    want = jc.bfs_sssp(jgraph, 3)
    got = tc.bfs_sssp(tgraph, 3)
    assert got.dist.dim() == 1
    np.testing.assert_array_equal(np_(got.dist), np_(want.dist))
    np.testing.assert_array_equal(np_(got.sigma), np_(want.sigma))
    assert int(got.levels) == int(want.levels)
    bw = jc.bidirectional_bfs(jgraph, 3, 77)
    bg = tc.bidirectional_bfs(tgraph, 3, 77)
    assert (int(bg.d), int(bg.split)) == (int(bw.d), int(bw.split))
    np.testing.assert_array_equal(np_(bg.dist_t), np_(bw.dist_t))


def test_disconnected_pair_reports_minus_one():
    edges = np.array([[0, 1], [1, 2], [3, 4]])
    jgraph = jc.from_edge_list(edges, 5)
    tgraph = to_port(jgraph)
    got = tc.bidirectional_bfs_batched(tgraph, [0, 0], [2, 4])
    want = jc.bidirectional_bfs_batched(jgraph, jnp.asarray([0, 0]),
                                        jnp.asarray([2, 4]))
    assert np_(got.d).tolist() == np_(want.d).tolist() == [2, -1]
    assert np_(got.split).tolist() == np_(want.split).tolist()


def test_sigma_rescale_matches_jax():
    """Corner-to-corner path counts of a 54 x 54 grid pass 1e30, so the
    per-column rescale fires; the scale factor and the integer state
    agree exactly, sigma to float32 rounding."""
    jgraph = jc.grid_graph(54, 54)
    tgraph = to_port(jgraph)
    sources = np.array([0, 54 * 54 - 1], np.int32)
    want = jc.bfs_sssp_batched(jgraph, jnp.asarray(sources))
    got = tc.bfs_sssp_batched(tgraph, sources)
    np.testing.assert_array_equal(np_(got.dist), np_(want.dist))
    assert float(np_(want.sigma).max()) <= 1e30
    np.testing.assert_allclose(np_(got.sigma), np_(want.sigma), rtol=1e-6)


@pytest.mark.parametrize("csc", [False, True], ids=["coo", "csc"])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_diameter_matches_jax_given_seeds(name, csc):
    jgraph, tgraph = _graphs(name, csc)
    n_sweeps = 3                       # two chains
    key = jax.random.PRNGKey(len(name))
    # the seeds JAX's estimate_diameter draws from this key
    seeds = np.array(jax.random.randint(key, (max(1, n_sweeps - 1),), 0,
                                        jgraph.n_nodes))
    want = jc.estimate_diameter(jgraph, key, n_sweeps=n_sweeps)
    got = tc.estimate_diameter(tgraph, n_sweeps=n_sweeps, seeds=seeds)
    assert (got.lower, got.upper, got.vertex_diameter) == (
        int(want.lower), int(want.upper), int(want.vertex_diameter))
    assert got.n_levels >= got.lower + 1


def _exact_diameter(tgraph):
    every = np.arange(tgraph.n_nodes, dtype=np.int32)
    return int(np_(tc.bfs_sssp_batched(tgraph, every).levels).max())


def _two_components():
    """A 3-vertex path (diameter 2), a 7 x 5 grid (diameter 10) and two
    isolated vertices: 3 + 35 + 2 = 40 vertices."""
    grid = tc.grid_graph(7, 5, device="cpu")
    e = grid.n_edges
    grid_edges = np.stack([np_(grid.src)[:e], np_(grid.dst)[:e]], 1) + 3
    return tc.from_edge_list(np.concatenate([[[0, 1], [1, 2]], grid_edges]),
                             40, device="cpu")


@pytest.mark.parametrize("seeds,upper", [
    ([0], 20), ([1, 39], 20), ([38], 20), ([20], None)],
    ids=["path-end", "path+isolated", "isolated", "grid"])
def test_diameter_bound_holds_across_components(seeds, upper):
    """The bound covers every component, wherever the seeds land; the
    JAX package's double sweep bounds only the seeds' components.  A
    seed outside the grid adds a chain from the grid's lowest vertex, a
    corner, whose bound is 2 * 10."""
    graph = _two_components()
    labels = np_(connected_components(graph))
    assert sorted(np.bincount(labels)[np.unique(labels)]) == [1, 1, 3, 35]
    exact = _exact_diameter(graph)
    assert exact == 10
    got = tc.estimate_diameter(graph, seeds=np.array(seeds))
    assert got.lower <= exact <= got.upper
    assert got.vertex_diameter == got.upper + 1
    if upper is not None:
        assert (got.lower, got.upper) == (exact, upper)


@pytest.mark.parametrize("seed", range(4))
def test_diameter_bound_holds_on_rmat(seed):
    """R-MAT has isolated vertices and small components beside its giant
    one; drawn seeds give a valid bound on each graph."""
    graph = tc.rmat_graph(8, 4, seed=seed, device="cpu")
    gen = torch.Generator().manual_seed(seed)
    got = tc.estimate_diameter(graph, gen, n_sweeps=2)
    assert got.lower <= _exact_diameter(graph) <= got.upper
