"""Reach of the port's single-source BFS once sigma leaves float32's range.

A column's path counts are rescaled by 1/max once they pass 1e30, so the
small counts of one level can fall below float32's range.  The port
floors a reached vertex's sigma at float32's smallest normal number
(``torch.finfo(torch.float32).tiny``), so reach is decided by whether a
frontier in-neighbour exists: ``dist`` is scipy's on inputs where the
JAX package's BFS, which lets such counts become 0, leaves vertices
unreached or reaches them late.  ``sigma`` is bitwise JAX's wherever
JAX's is a normal number (at least 2^-126), and at least ``tiny`` where
JAX's is 0 or subnormal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch
from scipy.sparse.csgraph import shortest_path

import repro.core as jc
import repro_torch.core as tc
from _torch_parity import np_, to_port
from repro_torch.core import ShardMesh

CPU = "cpu"
TINY = np.finfo(np.float32).tiny


@pytest.fixture(autouse=True)
def _one_thread():
    """These cases are small: one intra-op thread keeps them from
    contending for the cores with the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _diamonds_and_path(k: int = 260, path_len: int = 520):
    """Input A: from vertex 0 a chain of ``k`` diamonds (sigma doubles at
    each junction, 2^k at the end) beside a plain path of ``path_len``
    edges (sigma 1 all along), each undirected edge listed once."""
    edges, junction, nxt = [], 0, 1
    for _ in range(k):
        a, b, j = nxt, nxt + 1, nxt + 2
        edges += [(junction, a), (junction, b), (a, j), (b, j)]
        junction, nxt = j, nxt + 3
    prev = 0
    for _ in range(path_len):
        edges.append((prev, nxt))
        prev, nxt = nxt, nxt + 1
    return np.array(edges, dtype=np.int64), nxt


def _scipy_dist(edges, n, source):
    a = sp.coo_matrix((np.ones(len(edges)), (edges[:, 0], edges[:, 1])),
                      shape=(n, n)).tocsr()
    d = shortest_path(a, directed=False, unweighted=True, indices=[source])[0]
    return np.where(np.isinf(d), -1, d).astype(np.int32)


def _grid_edges(width, height):
    nid = np.arange(width * height).reshape(height, width)
    right = np.stack([nid[:, :-1].ravel(), nid[:, 1:].ravel()], axis=1)
    down = np.stack([nid[:-1, :].ravel(), nid[1:, :].ravel()], axis=1)
    return np.concatenate([right, down])


def _port_bfs(graph, sources, route):
    """dist, sigma over the graph's V rows and the reached-row sigma of
    the port's BFS by ``route``: the flat kernel's route, the
    node-blocked one (a CSC layout), or 8 shards on the CPU."""
    n = graph.n_nodes
    if route == "sharded8":
        pg = tc.partition_graph(graph, 8, block_v=256, block_e=128)
        mesh = ShardMesh(8, CPU)
        res = tc.bfs_sssp_batched_sharded(pg, sources, mesh=mesh)
        return (np_(mesh.all_gather(res.dist))[:n],
                np_(mesh.all_gather(res.sigma))[:n])
    if route == "csc":
        graph = tc.with_csc_layout(graph, block_v=256, block_e=128)
    res = tc.bfs_sssp_batched(graph, sources)
    return np_(res.dist)[:n], np_(res.sigma)[:n]


@pytest.mark.parametrize("route", ["flat", "csc", "sharded8"])
def test_diamond_chain_beside_a_path_reaches_scipy_distances(route):
    """Input A: the diamonds' counts pass 1e30 and every rescale takes
    the path's sigma of 1 further down, to 0 without the floor; the
    path's end (520 edges out) must still be reached, and every
    distance be scipy's."""
    edges, n = _diamonds_and_path()
    assert n == 1301
    graph = tc.from_edge_list(edges, n, device=CPU)
    dist, sigma = _port_bfs(graph, np.array([0], np.int32), route)
    np.testing.assert_array_equal(dist[:, 0], _scipy_dist(edges, n, 0))
    assert dist[n - 1, 0] == 520
    reached = dist[:, 0] >= 0
    assert (sigma[reached, 0] >= TINY).all()
    assert (sigma[~reached, 0] == 0).all()


def test_grid_256_corner_reaches_scipy_distances():
    """The smoke's grid cell from corner 0: the counts along the
    diagonal pass 1e30 many times over, and without the floor the BFS
    got 1,090 distances wrong."""
    graph = tc.grid_graph(256, 256, device=CPU)
    res = tc.bfs_sssp(graph, 0)
    dist = np_(res.dist)[: graph.n_nodes]
    np.testing.assert_array_equal(
        dist, _scipy_dist(_grid_edges(256, 256), graph.n_nodes, 0))
    assert (np_(res.sigma)[: graph.n_nodes] >= TINY).all()


@pytest.mark.parametrize("side,sources", [
    (126, "random64+corner"),
    (54, "two corners"),
], ids=["grid126", "grid54"])
def test_sigma_is_jax_where_jax_is_normal(side, sources):
    """Against JAX's replicated BFS: ``dist`` bitwise (no distance is
    lost on these grids), ``sigma`` bitwise wherever JAX's is at least
    2^-126, and at least ``tiny`` where JAX's is 0 or subnormal."""
    jgraph = jc.grid_graph(side, side)
    n = jgraph.n_nodes
    if sources == "two corners":
        src = np.array([0, n - 1], np.int32)
    else:
        src = np.concatenate([
            np.random.default_rng(11).integers(0, n, 64), [0]]
        ).astype(np.int32)
    want = jc.bfs_sssp_batched(jgraph, jnp.asarray(src))
    got = tc.bfs_sssp_batched(to_port(jgraph), src)
    np.testing.assert_array_equal(np_(got.dist), np_(want.dist))
    reached = np_(want.dist)[:n] >= 0
    w, g = np_(want.sigma)[:n], np_(got.sigma)[:n]
    normal = reached & (w >= TINY)
    np.testing.assert_array_equal(g[normal], w[normal])
    assert (g[reached & ~normal] >= TINY).all()
    assert int(normal.sum()) > 0
