"""The sharded cooperative lane with one vertex shard a process
(``GroupShardMesh`` over a 4-rank gloo group on the CPU) against the
JAX package's replicated drivers and the port's one-process
``ShardMesh(4)`` lane.

One group runs every case (``_torch_sharded_ranks.sharded_suite``); the
tests read its ranks' results.  The searches are held against JAX's
replicated ones as ``tests/test_torch_sharded.py`` holds the one-card
lane: dist, levels, d and split bitwise, sigma bitwise wherever JAX's is
a normal number.  The engine's runs are held bitwise against the same
runs on ``ShardMesh(4, "cpu")``, made in this process (the plain
versions are deterministic on the CPU), and every rank against rank 0.
"""
import dataclasses

import jax.numpy as jnp
import networkx as nx
import numpy as np
import pytest
import torch

import repro.core as jc
import _torch_sharded_ranks as ranks
from _torch_parity import np_
from repro_torch.checkpoint import CheckpointSchemaError
from repro_torch.core import (AdaptiveConfig, GroupShardMesh, ShardMesh,
                              bidirectional_bfs_batched_sharded,
                              from_edge_list, gather_graph, partition_graph,
                              run_adaptive, run_fixed, run_kadabra)
from repro_torch.core.engine import _sharded_diameter
from repro_torch.launch import spawn_local

W = 4
N_RUN = 60
GRID = (32, 32)
SS = np.array([0, 5, 500, 1023], np.int32)
TT = np.array([1023, 100, 9, 44], np.int32)
CPU = "cpu"


def _edges(g: nx.Graph) -> np.ndarray:
    return np.array(g.edges(), dtype=np.int64)


@pytest.fixture(scope="module")
def run_edges():
    return _edges(nx.connected_watts_strogatz_graph(N_RUN, 6, 0.3, seed=0))


@pytest.fixture(scope="module")
def bfs_edges():
    return _edges(nx.convert_node_labels_to_integers(
        nx.grid_2d_graph(*GRID), ordering="sorted"))


@pytest.fixture(scope="module")
def sources():
    return np.random.default_rng(11).integers(
        0, GRID[0] * GRID[1], 16).astype(np.int32)


@pytest.fixture(scope="module")
def run_pg(run_edges):
    g = from_edge_list(run_edges, N_RUN, device=CPU)
    return partition_graph(g, W, **ranks.RUN_BLOCKS)


@pytest.fixture(scope="module")
def dirs(tmp_path_factory, run_pg):
    """The checkpoint roots; the ShardMesh steps the ranks read are
    written here, before the group starts."""
    root = tmp_path_factory.mktemp("sharded_group")
    d = {k: str(root / k) for k in ("own", "shard_mesh", "for_shard_mesh",
                                    "two")}
    d["store"] = str(root)
    part = AdaptiveConfig(**ranks.KADABRA, max_epochs=1)
    run_kadabra(run_pg, mesh=ShardMesh(W, CPU), config=part,
                checkpoint_dir=d["shard_mesh"])
    two = partition_graph(gather_graph(run_pg), 2, **ranks.RUN_BLOCKS)
    run_kadabra(two, mesh=ShardMesh(2, CPU), config=part,
                checkpoint_dir=d["two"])
    return d


@pytest.fixture(scope="module")
def suite(run_edges, bfs_edges, sources, dirs):
    return spawn_local(ranks.sharded_suite, W,
                       args=(run_edges, N_RUN, bfs_edges, GRID[0] * GRID[1],
                             sources, SS, TT, dirs),
                       timeout=300, store_dir=dirs["store"])


@pytest.fixture(scope="module")
def jgrid(bfs_edges):
    return jc.from_edge_list(bfs_edges, GRID[0] * GRID[1])


def _same_kadabra(a: dict, b, levels: bool = True) -> bool:
    """A rank's run (a dict) against another's, or a BetweennessResult;
    a resumed run counts only the levels it expanded (``levels=False``
    leaves them out)."""
    if not isinstance(b, dict):
        b = ranks.kadabra_dict(b)
    return (np.array_equal(a["btilde"], b["btilde"]) and a["tau"] == b["tau"]
            and a["n_epochs"] == b["n_epochs"]
            and a["converged"] == b["converged"]
            and (not levels or a["bfs_levels"] == b["bfs_levels"]))


# ---------------------------------------------------------------------------
# The mesh and the local partition
# ---------------------------------------------------------------------------

def test_every_rank_holds_its_own_shard(suite, bfs_edges):
    """Rank r's local partition is row r of the whole partition up to the
    inert padding, with the whole partition's global metadata."""
    whole = partition_graph(
        from_edge_list(bfs_edges, GRID[0] * GRID[1], device=CPU), W,
        **ranks.BFS_BLOCKS)
    for r in suite:
        lay = r["layout"]
        assert (r["size"], r["staged"], r["axis_index"]) == (W, False,
                                                             [r["rank"]])
        assert (lay["first_shard"], lay["n_local_shards"]) == (r["rank"], 1)
        assert lay["v_pad"] == whole.v_pad
        assert lay["budget"] == whole.exchange_budget
        src = lay["src"][0]
        want = np_(whole.shards.src[r["rank"]])
        assert lay["n_edge_blocks"] <= whole.shards.n_edge_blocks
        np.testing.assert_array_equal(src, want[: src.shape[0]])
        assert (want[src.shape[0]:] == whole.n_nodes).all()


def _local(run_pg, s: int, **kw):
    return partition_graph(gather_graph(run_pg), W, shard=s,
                           **ranks.RUN_BLOCKS, **kw)


def test_a_local_partition_is_a_row_of_the_whole_one(run_pg):
    """One shard's buckets and real blocks, the whole partition's
    metadata."""
    loc = _local(run_pg, 2)
    assert loc.shards.first_shard == 2 and loc.shards.n_local_shards == 1
    assert (loc.n_shards, loc.v_pad, loc.exchange_budget) == (
        run_pg.n_shards, run_pg.v_pad, run_pg.exchange_budget)
    n = loc.shards.src.shape[1]
    assert torch.equal(loc.shards.src[0], run_pg.shards.src[2, :n])
    whole, neb = run_pg.shards.real_blocks(), run_pg.shards.n_edge_blocks
    assert torch.equal(loc.shards.real_blocks(),
                       whole[whole // neb == 2] - 2 * neb)
    with pytest.raises(ValueError, match="not one of"):
        _local(run_pg, W)


def test_a_shard_mesh_refuses_a_local_partition(run_pg):
    with pytest.raises(ValueError, match="holds 1 of"):
        ShardMesh(W, CPU).check(_local(run_pg, 0))


def test_the_group_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="init_process_group"):
        GroupShardMesh(CPU)


# ---------------------------------------------------------------------------
# The searches against JAX's replicated drivers
# ---------------------------------------------------------------------------

def test_bfs_sssp_on_the_ranks_matches_jax_replicated(suite, jgrid,
                                                      sources):
    want = jc.bfs_sssp_batched(jgrid, jnp.asarray(sources))
    v1 = jgrid.n_nodes + 1
    jdist, jsigma = np_(want.dist), np_(want.sigma)
    tiny = np.finfo(np.float32).tiny
    reached = jdist >= 0
    normal = reached & (jsigma >= tiny)
    for r in suite:
        got = r["sssp"]
        assert got["local_shape"][0] == 1
        np.testing.assert_array_equal(got["dist"][:v1], jdist)
        np.testing.assert_array_equal(got["levels"], np_(want.levels))
        sigma = got["sigma"][:v1]
        np.testing.assert_array_equal(sigma[normal], jsigma[normal])
        assert (sigma[reached & ~normal] >= tiny).all()
        np.testing.assert_array_equal(sigma[~reached], jsigma[~reached])
        assert (got["dist"][v1:] == -3).all()
        assert (got["sigma"][v1:] == 0).all()
        assert got["n_iters"] == int(np_(want.levels).max()) + 1
        assert got["exchange"][0] == got["n_iters"]


def test_bfs_stop_nodes_on_the_ranks_match_jax(suite, jgrid):
    want = jc.bfs_sssp_batched(jgrid, jnp.asarray(SS),
                               stop_nodes=jnp.asarray(TT))
    for r in suite:
        np.testing.assert_array_equal(
            r["sssp_stop"]["dist"][: jgrid.n_nodes + 1], np_(want.dist))
        np.testing.assert_array_equal(r["sssp_stop"]["levels"],
                                      np_(want.levels))


@pytest.mark.parametrize("part", ["default", "dense", "wide"])
def test_bidirectional_on_the_ranks_matches_jax_replicated(suite, jgrid,
                                                           part):
    """Bitwise, sigma included (integers below 2^24 at the meeting), on
    every budget: the protocols rebuild the same gathered values."""
    want = jc.bidirectional_bfs_batched(jgrid, jnp.asarray(SS),
                                        jnp.asarray(TT))
    v1 = jgrid.n_nodes + 1
    for r in suite:
        got = r[("bidir", part)]
        for f in ("dist_s", "dist_t", "sigma_s", "sigma_t"):
            np.testing.assert_array_equal(got[f][:v1], np_(getattr(want, f)),
                                          err_msg=f)
        np.testing.assert_array_equal(got["d"], np_(want.d))
        np.testing.assert_array_equal(got["split"], np_(want.split))


def test_dense_and_sparse_protocols_give_the_same_bits(suite):
    """Budget 0 (dense only) and the largest budget (sparse on every
    level that fits) against each other, bitwise, and the tallies."""
    for r in suite:
        dense, wide = r[("bidir", "dense")], r[("bidir", "wide")]
        for f in ("dist_s", "dist_t", "sigma_s", "sigma_t", "d", "split"):
            np.testing.assert_array_equal(dense[f], wide[f], err_msg=f)
        assert dense["exchange"] == [dense["n_iters"], 0]
        levels, sparse = wide["exchange"]
        assert levels == wide["n_iters"] and sparse > 0
        assert wide["exchange"] == suite[0][("bidir", "wide")]["exchange"]


def test_the_group_matches_the_one_card_lane(suite, bfs_edges):
    """The ranks' searches give the bits of ShardMesh(4) on the whole
    partition."""
    g = from_edge_list(bfs_edges, GRID[0] * GRID[1], device=CPU)
    pg = partition_graph(g, W, **ranks.BFS_BLOCKS)
    mesh = ShardMesh(W, CPU)
    res = bidirectional_bfs_batched_sharded(pg, SS, TT, mesh=mesh)
    for r in suite:
        got = r[("bidir", "default")]
        for f in ("dist_s", "dist_t", "sigma_s", "sigma_t"):
            np.testing.assert_array_equal(
                got[f], np_(mesh.all_gather(getattr(res, f))), err_msg=f)
        assert got["exchange"] == res.exchange.tolist()
        assert got["n_iters"] == res.n_iters


# ---------------------------------------------------------------------------
# What crosses the wire
# ---------------------------------------------------------------------------

def _bytes(traffic: dict) -> dict:
    return {k: v["sent_bytes"] for k, v in traffic.items()}


def test_a_sparse_level_moves_only_the_sparse_pair(suite, bfs_edges):
    """One level from the four sources, every chunk within the budget:
    the occupancy bits, the pick, the sparse pair of gathers (values
    and int32 chunk ids) and the level's reductions; no dense gather."""
    g = from_edge_list(bfs_edges, GRID[0] * GRID[1], device=CPU)
    pg = partition_graph(g, W, **ranks.BFS_BLOCKS)
    cps, chunk, b = (pg.exchange_chunks_per_shard, pg.exchange_chunk_rows,
                     len(SS))
    budget = cps - 1
    for r in suite:
        took, traffic = r["level_sparse"]
        assert took == 1 and "dense" not in traffic
        sent = _bytes(traffic)
        assert sent["sparse"] == budget * (4 * chunk * b + 4)
        assert sent["bits"] == 4 * cps and sent["pick"] == 4
        assert traffic["sparse"]["calls"] == 2
        assert traffic["sparse"]["staged_bytes"] == 0


def test_a_dense_level_moves_only_the_dense_gather(suite, bfs_edges):
    g = from_edge_list(bfs_edges, GRID[0] * GRID[1], device=CPU)
    pg = partition_graph(g, W, **ranks.BFS_BLOCKS)
    for r in suite:
        took, traffic = r["level_dense"]
        assert took == 0 and set(traffic) == {"bits", "dense", "reduce"}
        assert _bytes(traffic)["dense"] == 4 * pg.shard_rows * len(SS)
        took, traffic = r["level_unfit"]
        # a budget the level overflows: the pick, then the dense gather
        assert took == 0 and "sparse" not in traffic
        assert {"bits", "pick", "dense"} <= set(traffic)


# ---------------------------------------------------------------------------
# The engine: run_fixed, run_adaptive, run_kadabra
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stream", ["bidir", "forward"])
def test_run_fixed_is_the_one_card_lane_on_every_rank(suite, run_pg,
                                                      stream):
    want = run_fixed(run_pg, ranks.FIXED_N,
                     metrics=ranks.FIXED_METRICS[stream],
                     seed=ranks.FIXED_SEED, batch_size=ranks.FIXED_BATCH,
                     mesh=ShardMesh(W, CPU))
    for r in suite:
        got = r[("fixed", stream)]
        assert len(got) == len(want)
        for (name, scores, tau), rep in zip(got, want):
            assert name == rep.name and tau == rep.tau == ranks.FIXED_N
            np.testing.assert_array_equal(scores, rep.scores)


@pytest.fixture(scope="module")
def one_card_kadabra(run_pg):
    return run_kadabra(run_pg, mesh=ShardMesh(W, CPU),
                       config=AdaptiveConfig(**ranks.KADABRA))


def test_run_kadabra_is_the_one_card_lane_on_every_rank(suite,
                                                        one_card_kadabra):
    for r in suite:
        assert _same_kadabra(r["kadabra"], one_card_kadabra)
        assert r["kadabra"]["exchange"] == [
            s.exchange for s in one_card_kadabra.stats]


def test_run_kadabra_on_the_ranks_is_within_eps_of_brandes(suite,
                                                           run_edges):
    exact = np.asarray(jc.brandes_numpy(jc.from_edge_list(run_edges,
                                                          N_RUN)))
    res = suite[0]["kadabra"]
    assert res["converged"]
    assert np.abs(res["btilde"] - exact).max() < ranks.KADABRA["eps"]


def test_forward_metrics_are_the_one_card_lane_on_every_rank(suite, run_pg):
    want = run_adaptive(run_pg, ("closeness", "harmonic"), seed=1,
                        mesh=ShardMesh(W, CPU),
                        config=AdaptiveConfig(**ranks.FORWARD))
    for r in suite:
        got = r["forward"]
        assert (got["tau"], got["n_epochs"]) == (want.tau, want.n_epochs)
        for (name, scores, tau, stop), rep in zip(got["reports"],
                                                  want.reports):
            assert (name, tau, stop) == (rep.name, rep.tau, rep.stop_epoch)
            np.testing.assert_array_equal(scores, rep.scores)


def test_every_rank_derives_the_same_auto_budget(suite, run_pg):
    """The ranks derive the "auto" budget from the same gathered sweep:
    the one-card lane's."""
    auto = dataclasses.replace(run_pg, exchange_budget_auto=True)
    gen = torch.Generator(device=CPU).manual_seed(0)
    want = _sharded_diameter(auto, ShardMesh(W, CPU), gen, 2)[1]
    assert [r["auto_budget"] for r in suite] == [want.exchange_budget] * W


# ---------------------------------------------------------------------------
# Checkpoints: resume, cross-resume, refusals
# ---------------------------------------------------------------------------

def test_resume_after_one_epoch_is_bitwise(suite):
    for r in suite:
        assert r["kadabra"]["n_epochs"] >= 2
        assert r["resume_part"]["n_epochs"] == 1
        assert not r["resume_part"]["converged"]
        assert _same_kadabra(r["resumed"], r["kadabra"], levels=False)
        assert r["resumed"]["epochs"] == list(
            range(2, r["kadabra"]["n_epochs"] + 1))


def test_a_shard_mesh_step_resumes_on_the_ranks(suite):
    for r in suite:
        assert _same_kadabra(r["from_shard_mesh"], r["kadabra"],
                             levels=False)
        assert r["from_shard_mesh"]["epochs"][0] == 2


def test_a_group_step_resumes_on_a_shard_mesh(suite, run_pg, dirs):
    res = run_kadabra(run_pg, mesh=ShardMesh(W, CPU),
                      config=AdaptiveConfig(**ranks.KADABRA),
                      checkpoint_dir=dirs["for_shard_mesh"])
    assert _same_kadabra(suite[0]["kadabra"], res, levels=False)
    assert res.stats[0].epoch == 2


def test_a_step_of_another_shard_count_raises(suite, run_pg, dirs):
    assert all(r["two_raised"] for r in suite)
    with pytest.raises(CheckpointSchemaError):
        run_kadabra(partition_graph(gather_graph(run_pg), 2,
                                    **ranks.RUN_BLOCKS),
                    mesh=ShardMesh(2, CPU),
                    config=AdaptiveConfig(**ranks.KADABRA),
                    checkpoint_dir=dirs["own"])


@pytest.mark.parametrize("case,match", [
    ("count", "shards but the mesh has"), ("other", "its own shard"),
    ("whole", "its own shard")])
def test_the_group_refuses_a_partition_it_cannot_hold(suite, case, match):
    for r in suite:
        assert match in r["refused"][case]


def test_a_rank_dependent_loop_bit_fails_within_the_timeout(run_edges):
    """Rank 1 leaves its search after one level: rank 0's next collective
    finds no partner, and spawn_local raises instead of hanging."""
    import time
    t0 = time.monotonic()
    with pytest.raises((RuntimeError, TimeoutError)):
        spawn_local(ranks.split_loop, 2, args=(run_edges, N_RUN),
                    timeout=10)
    assert time.monotonic() - t0 < 30


def test_scaling_example_partitioned_half_runs_on_the_cpu(capsys,
                                                         monkeypatch):
    """examples/betweenness_scaling_torch.py's partitioned half with
    --device cpu at a tiny size: 2 shard ranks, the grid's and R-MAT's
    exchange traced, run_kadabra within eps on both ranks."""
    import importlib
    from pathlib import Path
    examples = Path(__file__).resolve().parents[1] / "examples"
    # imported by its name, so that the ranks it spawns import it too
    monkeypatch.syspath_prepend(str(examples))
    scaling = importlib.import_module("betweenness_scaling_torch")
    results = scaling.main(["--device", "cpu", "--half", "sharded",
                            "--shards", "2", "--scale", "6",
                            "--edge-factor", "4", "--grid-length", "32",
                            "--eps", "0.1"])["sharded"]
    assert len(results) == 2
    for name in ("grid", "rmat"):
        tr = results[0][name]
        assert tr["levels"] > 0 and 0 <= tr["sparse"] <= tr["levels"]
        assert tr == {**results[1][name], "sent": tr["sent"]}
    out = capsys.readouterr().out
    assert out.rstrip().endswith("OK")
    assert "every rank the same bits: True" in out


def test_a_local_partition_keeps_its_shard_when_moved(run_pg):
    moved = dataclasses.replace(_local(run_pg, 1), exchange_budget=0).to(CPU)
    assert moved.shards.first_shard == 1
    assert moved.shards.n_local_shards == 1
