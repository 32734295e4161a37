"""Rank functions of ``tests/test_torch_sharded_group.py``, run by
``repro_torch.launch.spawn_local``: the sharded cooperative lane with one
vertex shard a process (``GroupShardMesh``).

They live apart from the test module so that a spawned rank imports
torch and the port only: no JAX, no pytest.  Each rank builds its own
local partition (``partition_graph(graph, S, shard=rank)``) and returns
numpy arrays and plain values, which the test process compares with the
JAX package and with the one-process ``ShardMesh`` run.
"""
import numpy as np
import torch

from repro_torch.checkpoint import CheckpointSchemaError
from repro_torch.core import (AdaptiveConfig, GroupShardMesh,
                              bfs_sssp_batched_sharded,
                              bidirectional_bfs_batched_sharded,
                              delta_sssp_batched_sharded, from_edge_list,
                              partition_graph, run_adaptive, run_fixed,
                              run_kadabra, symmetric_dyadic_weights,
                              with_weights)
from repro_torch.core.bfs import _expand_level_sharded, _init_state_sharded
from repro_torch.core.engine import _sharded_diameter

CPU = "cpu"
# the run graph's blocking (4 shards of 16 rows) and the search graph's
RUN_BLOCKS = dict(block_v=8, block_e=128)
BFS_BLOCKS = dict(block_v=128, block_e=256)
# three epochs of 128-sample batches (the resume runs stop after the
# first): few levels, since each level costs the group a few collectives
KADABRA = dict(eps=0.1, delta=0.1, n0_base=200, sample_batch_size=128)
FORWARD = dict(eps=0.1, delta=0.1, n0_base=200, sample_batch_size=128)
FIXED_N, FIXED_SEED, FIXED_BATCH = 40, 3, 8
FIXED_METRICS = {"bidir": ("betweenness",),
                 "forward": ("closeness", "betweenness")}
# the weighted lane's group runs (tests/test_torch_weighted_engine.py):
# 4 shards of 16 rows, a few 64-sample batches an epoch
WEIGHTED_BLOCKS = dict(block_v=8, block_e=128)
WEIGHTED = dict(eps=0.1, delta=0.1, n0_base=200, sample_batch_size=64)
WEIGHTED_METRICS = ("betweenness", "closeness")


def kadabra_dict(res) -> dict:
    return {"btilde": res.btilde, "tau": res.tau, "n_epochs": res.n_epochs,
            "converged": res.converged, "bfs_levels": res.bfs_levels,
            "epochs": [s.epoch for s in res.stats],
            "exchange": [s.exchange for s in res.stats]}


def adaptive_dict(res) -> dict:
    return {"tau": res.tau, "n_epochs": res.n_epochs,
            "reports": [(r.name, r.scores, r.tau, r.stop_epoch)
                        for r in res.reports]}


def fixed_list(reports) -> list:
    return [(r.name, r.scores, r.tau) for r in reports]


def _gathered(mesh, res, fields) -> dict:
    return {f: mesh.all_gather(getattr(res, f)).numpy() for f in fields}


def _one_level(pg, mesh, sources):
    """The traffic of the first level of a search from ``sources``."""
    dist, sigma = _init_state_sharded(pg, mesh, sources)
    b = sources.shape[0]
    level = torch.zeros(b, dtype=torch.int32)
    active = torch.ones(b, dtype=torch.bool)
    mesh.traffic(reset=True)
    _, _, _, took = _expand_level_sharded(pg, mesh, dist, sigma, level,
                                          active)
    return int(took), mesh.traffic(reset=True)


def _refused(fn) -> str:
    try:
        fn()
    except ValueError as e:
        return str(e)
    return ""


def sharded_suite(rank, run_edges, n_run, bfs_edges, n_bfs, sources, ss,
                  tt, dirs):
    """Every group run of tests/test_torch_sharded_group.py on this rank
    of a 4-rank gloo group.  ``dirs`` holds the checkpoint roots: "own"
    (written and resumed here), "shard_mesh" (a step written by
    ShardMesh(4)), "for_shard_mesh" (written here, resumed by the test
    process on ShardMesh(4)), "two" (a step of ShardMesh(2)), each a
    run of KADABRA's config stopped after one epoch."""
    mesh = GroupShardMesh(CPU)
    size = mesh.n_shards
    out = {"rank": rank, "size": size, "staged": mesh.staged,
           "axis_index": mesh.axis_index().tolist()}

    # the searches on the grid, against the JAX replicated drivers
    grid = from_edge_list(bfs_edges, n_bfs, device=CPU)
    pg = partition_graph(grid, size, shard=rank, **BFS_BLOCKS)
    dense = partition_graph(grid, size, shard=rank, exchange_budget=0,
                            **BFS_BLOCKS)
    wide = partition_graph(grid, size, shard=rank,
                           exchange_budget=pg.exchange_chunks_per_shard - 1,
                           **BFS_BLOCKS)
    out["layout"] = {"src": pg.shards.src.numpy(),
                     "first_shard": pg.shards.first_shard,
                     "n_local_shards": pg.shards.n_local_shards,
                     "n_edge_blocks": pg.shards.n_edge_blocks,
                     "v_pad": pg.v_pad, "budget": pg.exchange_budget,
                     "wide_budget": wide.exchange_budget}
    res = bfs_sssp_batched_sharded(pg, sources, mesh=mesh)
    out["sssp"] = {**_gathered(mesh, res, ("dist", "sigma")),
                   "levels": res.levels.numpy(), "n_iters": res.n_iters,
                   "exchange": res.exchange.tolist(),
                   "local_shape": tuple(res.dist.shape)}
    stops = np.asarray(tt, np.int32)
    res = bfs_sssp_batched_sharded(pg, ss, mesh=mesh, stop_nodes=stops)
    out["sssp_stop"] = {**_gathered(mesh, res, ("dist",)),
                        "levels": res.levels.numpy()}
    bidir = ("dist_s", "dist_t", "sigma_s", "sigma_t")
    for name, part in (("default", pg), ("dense", dense), ("wide", wide)):
        res = bidirectional_bfs_batched_sharded(part, ss, tt, mesh=mesh)
        out[("bidir", name)] = {**_gathered(mesh, res, bidir),
                                "d": res.d.numpy(), "split": res.split.numpy(),
                                "n_iters": res.n_iters,
                                "exchange": res.exchange.tolist()}
    src = torch.as_tensor(ss, dtype=torch.int32)
    out["level_sparse"] = _one_level(wide, mesh, src)
    out["level_dense"] = _one_level(dense, mesh, src)
    out["level_unfit"] = _one_level(
        partition_graph(grid, size, shard=rank, exchange_budget=1,
                        **BFS_BLOCKS),
        mesh, torch.arange(0, n_bfs, n_bfs // 64, dtype=torch.int32))

    # the engine on the run graph
    g = from_edge_list(run_edges, n_run, device=CPU)
    pg = partition_graph(g, size, shard=rank, **RUN_BLOCKS)
    for stream, metrics in FIXED_METRICS.items():
        out[("fixed", stream)] = fixed_list(run_fixed(
            pg, FIXED_N, metrics=metrics, seed=FIXED_SEED,
            batch_size=FIXED_BATCH, mesh=mesh))
    cfg = AdaptiveConfig(**KADABRA)
    out["kadabra"] = kadabra_dict(run_kadabra(pg, mesh=mesh, config=cfg))
    out["forward"] = adaptive_dict(run_adaptive(
        pg, ("closeness", "harmonic"), seed=1, mesh=mesh,
        config=AdaptiveConfig(**FORWARD)))
    auto = partition_graph(g, size, shard=rank, exchange_budget="auto",
                           **RUN_BLOCKS)
    gen = torch.Generator(device=CPU).manual_seed(0)
    out["auto_budget"] = _sharded_diameter(auto, mesh, gen, 2)[1]\
        .exchange_budget

    # resume after one epoch, and across the meshes
    part = AdaptiveConfig(**KADABRA, max_epochs=1)
    out["resume_part"] = kadabra_dict(run_kadabra(
        pg, mesh=mesh, config=part, checkpoint_dir=dirs["own"]))
    out["resumed"] = kadabra_dict(run_kadabra(pg, mesh=mesh, config=cfg,
                                              checkpoint_dir=dirs["own"]))
    out["from_shard_mesh"] = kadabra_dict(run_kadabra(
        pg, mesh=mesh, config=cfg, checkpoint_dir=dirs["shard_mesh"]))
    run_kadabra(pg, mesh=mesh, config=part,
                checkpoint_dir=dirs["for_shard_mesh"])
    try:
        run_kadabra(pg, mesh=mesh, config=cfg, checkpoint_dir=dirs["two"])
        out["two_raised"] = False
    except CheckpointSchemaError:
        out["two_raised"] = True

    # refusals: another shard count, another rank's shard, every shard
    out["refused"] = {
        "count": _refused(lambda: run_kadabra(
            partition_graph(g, size - 1, shard=0, **RUN_BLOCKS), mesh=mesh)),
        "other": _refused(lambda: run_kadabra(
            partition_graph(g, size, shard=(rank + 1) % size, **RUN_BLOCKS),
            mesh=mesh)),
        "whole": _refused(lambda: mesh.check(
            partition_graph(g, size, **RUN_BLOCKS)))}
    return out


def split_loop(rank, edges, n_nodes):
    """Rank 1 caps its search at one level, a rank-dependent loop bit:
    it leaves the loop while rank 0 waits in the next level's
    collectives."""
    mesh = GroupShardMesh(CPU)
    g = from_edge_list(edges, n_nodes, device=CPU)
    pg = partition_graph(g, mesh.n_shards, shard=rank, **RUN_BLOCKS)
    res = bidirectional_bfs_batched_sharded(
        pg, [0, 1], [n_nodes - 1, n_nodes // 2], mesh=mesh,
        max_levels=1 if rank == 1 else None)
    return res.n_iters


def weighted_graph(edges, n_nodes, wseed):
    """The weighted lane's test graph: the edges with
    ``symmetric_dyadic_weights(seed=wseed)``, the same on every rank."""
    g = from_edge_list(edges, n_nodes, device=CPU)
    return with_weights(g, symmetric_dyadic_weights(g, seed=wseed))


def weighted_suite(rank, edges, n_nodes, wseed, sources):
    """tests/test_torch_weighted_engine.py's group runs on this rank of a
    4-rank gloo group, each rank holding its own shard: one weighted
    search, an adaptive run and a fixed run on the weighted stream (one
    intra-op thread: the cases are small)."""
    torch.set_num_threads(1)
    mesh = GroupShardMesh(CPU)
    g = weighted_graph(edges, n_nodes, wseed)
    pg = partition_graph(g, mesh.n_shards, shard=rank, **WEIGHTED_BLOCKS)
    res = delta_sssp_batched_sharded(pg, sources, mesh=mesh)
    out = {"sssp": {**_gathered(mesh, res, ("dist", "sigma")),
                    "levels": res.levels.numpy(),
                    "buckets": res.buckets.numpy(), "n_iters": res.n_iters,
                    "n_dag_rounds": res.n_dag_rounds,
                    "exchange": res.exchange.tolist()}}
    run = run_adaptive(pg, WEIGHTED_METRICS, stream="weighted", seed=2,
                       mesh=mesh, config=AdaptiveConfig(**WEIGHTED))
    out["adaptive"] = {**adaptive_dict(run), "bfs_levels": run.bfs_levels,
                       "dag_rounds": run.dag_rounds,
                       "distance_cap": run.distance_cap}
    out["fixed"] = fixed_list(run_fixed(
        pg, FIXED_N, metrics=WEIGHTED_METRICS, stream="weighted",
        seed=FIXED_SEED, batch_size=FIXED_BATCH, mesh=mesh))
    return out
