"""The sharded level route (every shard of a one-card mesh in one call)
against the JAX package, on the CPU.

On the card the route is one words pass over the gathered masked values
and one node-blocked launch over the layout's real edge blocks; here it
runs its plain version, which must stack exactly what JAX's per-shard
``frontier_expand_sharded_ref`` gives each device.  The real-block table
that sizes the card's grid is checked slot by slot.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jc
import repro.kernels.frontier as jf
import repro_torch.core as tc
import repro_torch.kernels.frontier as tf
from _torch_parity import np_, partitioned_to_port, to_port, wide_inputs
from repro_torch.kernels.frontier import ops as tf_ops

_GRAPHS = {
    # name: (JAX graph, shards, block_v, block_e)
    "er": (lambda: jc.erdos_renyi_graph(500, 6.0, seed=7), 4, 64, 128),
    # R-MAT's skew leaves the later shards mostly padding
    "rmat": (lambda: jc.rmat_graph(10, 16, seed=3), 4, 64, 128),
}


def _partition(name):
    make, n_shards, block_v, block_e = _GRAPHS[name]
    jgraph = make()
    jpg = jc.partition_graph(jgraph, n_shards, block_v=block_v,
                             block_e=block_e)
    return jgraph, jpg, partitioned_to_port(jpg)


# ---------------------------------------------------------------------------
# The real-block table
# ---------------------------------------------------------------------------

def _check_table(shards):
    table = shards.real_blocks()
    assert table.dtype == torch.int32
    blocks = np_(shards.src).reshape(-1, shards.block_e)
    listed = np.zeros(blocks.shape[0], bool)
    listed[np_(table)] = True
    assert np.all(np.diff(np_(table)) > 0)
    # every listed block has a non-sink source, every other only sinks
    assert (blocks[listed] != shards.n_nodes).any(axis=1).all()
    assert (blocks[~listed] == shards.n_nodes).all()
    # a left-out block's destinations are all past the tile: it adds
    # nothing on any frontier
    dst = np_(shards.dst).reshape(-1, shards.block_e)
    assert (dst[~listed] == shards.shard_rows).all()
    return table


@pytest.mark.parametrize("name", sorted(_GRAPHS))
def test_real_block_table_lists_exactly_the_real_blocks(name):
    _, jpg, tpg = _partition(name)
    table = _check_table(tpg.shards)
    n_all = tpg.n_shards * tpg.shards.n_edge_blocks
    assert 0 < table.shape[0] <= n_all
    if name == "rmat":
        assert table.shape[0] < n_all     # padding blocks are left out
    # the table is built once per layout, and a copy on another device
    # builds its own
    assert tpg.shards.real_blocks() is table
    moved = tpg.shards.to("cpu")
    assert torch.equal(moved.real_blocks(), table)


def test_real_block_table_at_the_cards_blocking():
    """The port's own partition of a skewed R-MAT (default blocking):
    the same property, and each shard's real blocks counted."""
    graph = tc.rmat_graph(10, 16, seed=3, device="cpu")
    pg = tc.partition_graph(graph, 4, block_e=128)
    table = _check_table(pg.shards)
    per_shard = np.bincount(np_(table) // pg.shards.n_edge_blocks,
                            minlength=pg.n_shards)
    src = np_(pg.shards.src).reshape(pg.n_shards, -1, pg.shards.block_e)
    want = (src != pg.n_nodes).any(axis=2).sum(axis=1)
    np.testing.assert_array_equal(per_shard, want)


# ---------------------------------------------------------------------------
# The plain level function against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("gaussian", [False, True], ids=["int", "normal"])
@pytest.mark.parametrize("name,batch", [("er", 1), ("er", 5), ("er", 33),
                                        ("er", 64), ("er", 96),
                                        ("rmat", 64)])
def test_sharded_level_matches_jax(name, batch, gaussian):
    """The stack of JAX's per-shard wide expansion: bitwise on integer
    sigma, rtol 1e-6 on |N(0, 1)| sigma (index_add_ and XLA's scatter
    add in other orders); the wrapper and the dispatcher's ``shards=``
    route give the plain version's bits, and nothing launches."""
    jgraph, jpg, tpg = _partition(name)
    fdist, fvals, levels = wide_inputs(to_port(jgraph), jpg, batch, batch,
                                       gaussian)
    want = np.stack([np_(jf.frontier_expand_sharded_ref(
        jpg.shards.shard(s), *map(jnp.asarray, (fdist, fvals, levels))))
        for s in range(jpg.n_shards)])
    t_fvals, t_levels = torch.from_numpy(fvals), torch.from_numpy(levels)
    before = dict(tf.launch_counts)
    got = np_(tf.frontier_expand_sharded_level_ref(tpg.shards, t_fvals,
                                                   t_levels))
    wrapped = np_(tf.frontier_expand_sharded_level(tpg.shards, t_fvals,
                                                   t_levels))
    routed = np_(tf.frontier_expand(None, None, None, t_fvals, t_levels,
                                    shards=tpg.shards))
    assert tf.launch_counts == before       # no kernel on the CPU
    assert got.shape == (jpg.n_shards, jpg.shard_rows, batch)
    if gaussian:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    else:
        assert want.max() < 2 ** 24
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(wrapped, got)
    np.testing.assert_array_equal(routed, got)


def test_sharded_level_unbatched_and_its_input_checks():
    """An unbatched (rows,) state gives the (S, shard_rows) stack; too
    few gathered rows or a non-float32 state raise."""
    jgraph, jpg, tpg = _partition("er")
    _, fvals, levels = wide_inputs(to_port(jgraph), jpg, 1, 3, False)
    t_fvals = torch.from_numpy(fvals)
    got = tf.frontier_expand(None, None, None, t_fvals[:, 0], int(levels[0]),
                             shards=tpg.shards)
    want = tf.frontier_expand_sharded_level_ref(
        tpg.shards, t_fvals, torch.from_numpy(levels))
    assert got.shape == (jpg.n_shards, jpg.shard_rows)
    assert torch.equal(got, want[..., 0])
    with pytest.raises(ValueError, match="gathered rows"):
        tf.frontier_expand_sharded_level(tpg.shards, t_fvals[:10], levels)
    with pytest.raises(TypeError, match="float32"):
        tf.frontier_expand_sharded_level(tpg.shards, t_fvals.double(),
                                         levels)


# ---------------------------------------------------------------------------
# The route
# ---------------------------------------------------------------------------

class _Layout:
    def __init__(self, block_e):
        self.block_e = block_e


@pytest.mark.parametrize("cuda,lane,route", [
    (False, None, "sharded_level_ref"), (False, "ref", "sharded_level_ref"),
    (True, None, "sharded_level"), (True, "node_blocked", "sharded_level")])
def test_select_route_sharded_level(cuda, lane, route):
    assert tf.select_route(cuda=cuda, shards=_Layout(1024), lane=lane) \
        == route


@pytest.mark.parametrize("cuda,csc,shard,block_e,lane,match", [
    (False, None, None, 1024, "node_blocked", "CPU"),
    (True, None, None, 1024, "ref", "CPU tensors"),
    (True, None, None, 1024, "flat", "flat kernel"),
    (False, None, None, 1024, "flat", "flat kernel"),
    (True, _Layout(1024), None, 1024, None, "not both"),
    (False, None, _Layout(1024), 1024, None, "not both"),
    (True, None, None, 29_057, None, "shared memory"),
    (True, None, None, 1024, "pallas", "unknown lane"),
])
def test_sharded_level_route_errors(cuda, csc, shard, block_e, lane, match):
    with pytest.raises(ValueError, match=match):
        tf.select_route(cuda=cuda, csc=csc, shard=shard,
                        shards=_Layout(block_e), lane=lane)


def test_sharded_level_dispatcher_raises_on_cpu():
    tpg = tc.partition_graph(tc.grid_graph(16, 8, device="cpu"), 2,
                             block_v=32, block_e=128)
    fvals = torch.zeros((tpg.v_pad, 2))
    with pytest.raises(ValueError, match="CPU"):
        tf.frontier_expand(None, None, None, fvals, [0, 0],
                           shards=tpg.shards, lane="node_blocked")
    with pytest.raises(ValueError, match="not both"):
        tf.frontier_expand(None, None, None, fvals, [0, 0],
                           shards=tpg.shards, shard=tpg.shards.shard(0))


# ---------------------------------------------------------------------------
# The sharded BFS: one level call a level
# ---------------------------------------------------------------------------

def test_sharded_bfs_makes_one_level_call_a_level(monkeypatch):
    """The sharded BFS on the CPU goes through the ``shards=`` route's
    plain version once a level (all shards at once) and launches
    nothing; it gives the replicated BFS's bits."""
    graph = tc.grid_graph(32, 16, device="cpu")
    pg = tc.partition_graph(graph, 4, block_v=64, block_e=128)
    mesh = tc.ShardMesh(4, "cpu")
    calls = []
    plain = tf_ops.frontier_expand_sharded_level_ref

    def counted(shards, fvals, levels):
        calls.append(fvals.shape)
        return plain(shards, fvals, levels)

    monkeypatch.setattr(tf_ops, "frontier_expand_sharded_level_ref", counted)
    before = dict(tf.launch_counts)
    res = tc.bfs_sssp_batched_sharded(pg, [0, 100, 511], mesh=mesh)
    assert tf.launch_counts == before
    assert len(calls) == res.n_iters > 0
    assert all(shape == (pg.v_pad, 3) for shape in calls)
    want = tc.bfs_sssp_batched(graph, [0, 100, 511])
    v1 = graph.n_nodes + 1
    assert torch.equal(mesh.all_gather(res.dist)[:v1], want.dist)
    assert torch.equal(mesh.all_gather(res.sigma)[:v1], want.sigma)
