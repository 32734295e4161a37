"""The port's vertex partition (``repro_torch.core.partition``) against
the JAX package's: at an explicit blocking every layout array and field
equals JAX's ``partition_graph``; the exchange budget, its plan and the
owner maps follow the same rules; ``gather_graph`` and ``repartition``
rebuild what JAX's do."""
import dataclasses

import networkx as nx
import numpy as np
import pytest
import torch

import repro.core as jc
import repro.core.partition as jp
import repro_torch.core as tc
import repro_torch.core.partition as tp
from _torch_parity import np_, partitioned_to_port, to_port

_LAYOUT_ARRAYS = ("src", "dst", "block_nb", "block_sb", "block_first")
_LAYOUT_INTS = ("block_v", "block_e", "blocks_per_shard", "n_edge_blocks",
                "n_shards", "n_nodes", "shard_rows", "v_pad",
                "e_slots_per_shard")
_GRAPH_FIELDS = ("n_nodes", "n_edges", "max_degree", "exchange_budget",
                 "exchange_budget_auto", "n_shards", "shard_rows", "v_pad",
                 "n_edges_undirected", "exchange_chunk_rows",
                 "exchange_chunks_per_shard")


def _ws60():
    g = nx.connected_watts_strogatz_graph(60, 6, 0.3, seed=0)
    return jc.from_edge_list(np.array(g.edges()), 60)


# name: (JAX graph, n_shards, block_v, block_e)
CASES = {
    "grid64x32": (lambda: jc.grid_graph(64, 32), 8, 128, 256),
    "ws60": (_ws60, 8, 8, 128),
    "rmat3": (lambda: jc.rmat_graph(9, 8, seed=3), 3, 64, 128),
    "rmat1": (lambda: jc.rmat_graph(9, 8, seed=3), 1, 64, 128),
}


def _assert_same_partition(got, want):
    for name in _LAYOUT_ARRAYS:
        np.testing.assert_array_equal(np_(getattr(got.shards, name)),
                                      np_(getattr(want.shards, name)),
                                      err_msg=name)
        assert getattr(got.shards, name).dtype == torch.int32
    for name in _LAYOUT_INTS:
        assert getattr(got.shards, name) == getattr(want.shards, name), name
    for name in ("indptr", "indices", "degree"):
        np.testing.assert_array_equal(np_(getattr(got, name)),
                                      np_(getattr(want, name)), err_msg=name)
    for name in _GRAPH_FIELDS:
        assert getattr(got, name) == getattr(want, name), name


@pytest.mark.parametrize("case", sorted(CASES))
def test_partition_matches_jax(case):
    make, n_shards, block_v, block_e = CASES[case]
    jgraph = make()
    want = jc.partition_graph(jgraph, n_shards, block_v=block_v,
                              block_e=block_e)
    got = tc.partition_graph(to_port(jgraph), n_shards, block_v=block_v,
                             block_e=block_e)
    _assert_same_partition(got, want)
    # every shard view is the JAX view, field for field
    for s in range(n_shards):
        jv, tv = want.shards.shard(s), got.shards.shard(s)
        for name in _LAYOUT_ARRAYS:
            np.testing.assert_array_equal(np_(getattr(tv, name)),
                                          np_(getattr(jv, name)))
        for name in ("block_v", "block_e", "n_node_blocks", "n_edge_blocks",
                     "n_nodes", "n_src_blocks", "v_pad"):
            assert getattr(tv, name) == getattr(jv, name), name
    # the JAX partition carried across is the port's own
    _assert_same_partition(partitioned_to_port(want), want)


@pytest.mark.parametrize("budget", [None, 0, "auto", 1, 3, 10 ** 6])
def test_exchange_budget_matches_jax(budget):
    jgraph = jc.grid_graph(128, 16)
    want = jc.partition_graph(jgraph, 4, block_v=64, block_e=128,
                              exchange_budget=budget)
    got = tc.partition_graph(to_port(jgraph), 4, block_v=64, block_e=128,
                             exchange_budget=budget)
    assert got.exchange_budget == want.exchange_budget
    assert got.exchange_budget_auto == want.exchange_budget_auto == (
        budget == "auto")
    for cps in (1, 2, 5, 33, 1152):
        assert tp.default_exchange_budget(cps) \
            == jp.default_exchange_budget(cps)


@pytest.mark.parametrize("occ,q", [(list(range(1, 11)), 0.9),
                                   ([3, 1, 2], 0.5), ([10 ** 6], 0.9),
                                   ([1, 10 ** 6], 0.0), ([], 0.9),
                                   ([5, 0, 2, 2, 9, 4], 0.7)])
def test_auto_exchange_budget_matches_jax(occ, q):
    jgraph = jc.grid_graph(128, 16)
    jpg = jc.partition_graph(jgraph, 4, block_v=64, block_e=128)
    tpg = partitioned_to_port(jpg)
    assert tp.auto_exchange_budget(tpg, occ, quantile=q) \
        == jp.auto_exchange_budget(jpg, occ, quantile=q)


@pytest.mark.parametrize("batch", [1, 4, 16, 64])
@pytest.mark.parametrize("budget", [None, 0, 10 ** 6])
def test_exchange_plan_matches_jax(batch, budget):
    jgraph = jc.grid_graph(512, 8)
    jpg = jc.partition_graph(jgraph, 4, block_v=64, block_e=128,
                             exchange_budget=budget)
    tpg = partitioned_to_port(jpg)
    want, got = jp.exchange_plan(jpg, batch), tp.exchange_plan(tpg, batch)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for name in ("bitmap_bytes", "dense_bytes", "sparse_bytes",
                 "sparse_available"):
        assert getattr(got, name) == getattr(want, name), name
    for active in range(0, tpg.exchange_chunks_per_shard + 1, 3):
        assert got.sparse_taken(active) == want.sparse_taken(active)
        assert got.level_bytes(active) == want.level_bytes(active)
    for total, sparse in ((0, 0), (7, 3), (40, 0), (12, 12)):
        assert got.epoch_accounting(total, sparse) \
            == want.epoch_accounting(total, sparse)


def test_active_chunks_and_owner_maps_match_jax():
    jgraph = jc.grid_graph(512, 8)
    jpg = jc.partition_graph(jgraph, 4, block_v=64, block_e=128)
    tpg = partitioned_to_port(jpg)
    rng = np.random.default_rng(3)
    for density in (0.0, 0.001, 0.05, 1.0):
        rows = rng.random(jgraph.n_nodes + 1) < density
        assert tp.max_active_source_chunks(tpg, rows) \
            == jp.max_active_source_chunks(jpg, rows)
    v = np.arange(tpg.v_pad)
    np.testing.assert_array_equal(tp.vertex_owner(tpg, v),
                                  jp.vertex_owner(jpg, v))
    np.testing.assert_array_equal(
        tp.global_row(tpg, tp.vertex_owner(tpg, v), v % tpg.shard_rows), v)
    for s in range(tpg.n_shards):
        assert tp.shard_vertex_range(tpg, s) == jp.shard_vertex_range(jpg, s)
    # torch indices take the same maps
    tv = torch.arange(tpg.v_pad)
    assert torch.equal(tp.vertex_owner(tpg, tv),
                       torch.from_numpy(jp.vertex_owner(jpg, v)))


@pytest.mark.parametrize("budget", [None, "auto"])
def test_gather_graph_and_repartition_match_jax(budget):
    jgraph = jc.rmat_graph(9, 8, seed=5)
    jpg = jc.partition_graph(jgraph, 4, block_v=64, block_e=128,
                             exchange_budget=budget)
    tpg = partitioned_to_port(jpg)
    want, got = jp.gather_graph(jpg), tp.gather_graph(tpg)
    for name in ("indptr", "indices", "src", "dst", "degree"):
        np.testing.assert_array_equal(np_(getattr(got, name)),
                                      np_(getattr(want, name)), err_msg=name)
    assert (got.n_nodes, got.n_edges, got.max_degree) \
        == (want.n_nodes, want.n_edges, want.max_degree)
    # repartition re-blocks at the card's default; JAX's partition of its
    # own gathered graph at that blocking is the same partition
    again = tp.repartition(tpg, 3)
    ref = jc.partition_graph(jp.gather_graph(jpg), 3,
                             block_v=again.shards.block_v,
                             block_e=again.shards.block_e,
                             exchange_budget=budget)
    _assert_same_partition(again, ref)
    assert (again.shards.block_v, again.shards.block_e) \
        == tc.choose_csc_blocks(jgraph.n_nodes)


def test_default_blocking_is_the_cards():
    g = tc.rmat_graph(10, 8, seed=1, device="cpu")
    pg = tc.partition_graph(g, 4)
    assert (pg.shards.block_v, pg.shards.block_e) \
        == tc.choose_csc_blocks(g.n_nodes)
    assert pg.device == torch.device("cpu")
    assert pg.to("cpu").shards.src.device == torch.device("cpu")
    # every real edge in exactly one shard, into the shard's own rows
    real = pg.shards.src != g.n_nodes
    assert int(real.sum()) == g.n_edges
    assert bool((pg.shards.dst[real] < pg.shard_rows).all())


def test_weighted_partition_raises():
    """A weighted partition crosses over with both its weights (the
    replicated CSR ones and the layout's bucketed ones) and equals the
    port's own; one without the other raises."""
    jgraph = jc.with_weights(jc.grid_graph(8, 8),
                             np.arange(1, jc.grid_graph(8, 8).n_edges + 1,
                                       dtype=np.float32) / 16)
    jpg = jc.partition_graph(jgraph, 2, block_v=16, block_e=128)
    pg = partitioned_to_port(jpg)
    own = tc.partition_graph(to_port(jgraph), 2, block_v=16, block_e=128)
    for a, b in ((pg.weight, jpg.weight), (pg.shards.weight,
                                           jpg.shards.weight),
                 (own.weight, jpg.weight),
                 (own.shards.weight, jpg.shards.weight)):
        np.testing.assert_array_equal(np_(a), np_(b))
    np.testing.assert_array_equal(np_(tc.gather_graph(own).weight),
                                  np_(jgraph.weight))
    np.testing.assert_array_equal(
        np_(tc.repartition(own, 4).shards.weight),
        np_(tc.partition_graph(to_port(jgraph), 4).shards.weight))
    arrays = {k: np_(getattr(jpg, k)) for k in ("indptr", "indices",
                                                "degree")}
    shards = {k: np_(getattr(jpg.shards, k))
              for k in ("src", "dst", "block_nb", "block_sb", "block_first",
                        "block_v", "block_e", "blocks_per_shard",
                        "n_edge_blocks", "n_shards", "n_nodes")}
    with pytest.raises(ValueError, match="both"):
        tc.partitioned_from_numpy(arrays, shards, jpg.n_nodes, jpg.n_edges,
                                  jpg.max_degree, weight=np_(jpg.weight),
                                  device="cpu")
    with pytest.raises(ValueError, match="n_shards"):
        tc.partition_graph(to_port(jc.grid_graph(4, 4)), 0)
