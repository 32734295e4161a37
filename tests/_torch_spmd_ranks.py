"""Rank functions of the SPMD tests (``tests/test_torch_distributed.py``,
``tests/test_torch_spmd.py``), run by ``repro_torch.launch.spawn_local``.

They live apart from the test modules so that a spawned rank imports
torch and the port only: no JAX, no pytest.  Each returns numpy arrays
and plain values, which the test process compares with the JAX package.
"""
import os
import time

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointSchemaError, latest_step
from repro_torch.core import (AdaptiveConfig, SamplerMesh, from_edge_list,
                              run_adaptive, run_fixed, run_kadabra,
                              symmetric_dyadic_weights, with_weights)
from repro_torch.core.distributed import (AGGREGATIONS, allreduce_ints,
                                          assert_replicated)

CPU = "cpu"
MODES = tuple(AGGREGATIONS)


def aggregate_frames(rank, meshes, frames):
    """The three aggregations of ``frames[rank]`` on every mesh: {(mesh
    index, kind, mode): the sum}, the tiers' sizes, and the flat sum of
    the ranks' indices (the tau path)."""
    out, tiers = {}, []
    for m, (axes, shape) in enumerate(meshes):
        mesh = SamplerMesh(shape, axes, CPU)
        tiers.append((mesh.local_size, mesh.global_size))
        for kind, stack in frames.items():
            x = torch.from_numpy(stack[rank])
            for mode, fn in AGGREGATIONS.items():
                handle = fn(x, mesh)
                got = handle.wait()
                assert got.shape == x.shape and handle.staged_bytes == 0
                out[(m, kind, mode)] = got.numpy().copy()
                # the input frame is left as it was
                assert np.array_equal(x.numpy(), stack[rank])
    tau = int(allreduce_ints([rank], mesh).wait()[0])
    return out, tiers, tau


def fail_on_rank_one(rank):
    if rank == 1:
        raise ValueError("rank one fails")
    return rank


def hang_on_rank_one(rank):
    """Rank 1 never joins the collective that rank 0 waits in."""
    if rank == 1:
        time.sleep(3600)
    t = torch.ones(1)
    torch.distributed.all_reduce(t)
    return float(t[0])


def _kadabra(res):
    return {"btilde": res.btilde, "tau": res.tau, "n_epochs": res.n_epochs,
            "converged": res.converged, "bfs_levels": res.bfs_levels,
            "aggregation": [s.aggregation for s in res.stats]}


def spmd_suite(rank, edges, n_nodes, ckpt_root, eps, resume_eps):
    """Every run of tests/test_torch_spmd.py on this rank of a 4-rank
    gloo group, on the (2, 2) ("pod", "data") mesh."""
    g = from_edge_list(edges, n_nodes, device=CPU)
    mesh = SamplerMesh((2, 2), ("pod", "data"), CPU)
    out = {"rank": rank, "size": mesh.size, "staged": mesh.staged}
    for mode in MODES:
        cfg = AdaptiveConfig(eps=eps, delta=0.1, aggregation=mode)
        out[("kadabra", mode)] = _kadabra(run_kadabra(g, mesh=mesh,
                                                      config=cfg))

    # resume after one epoch: bitwise the uninterrupted run
    cfg = AdaptiveConfig(eps=resume_eps, delta=0.1)
    out["resume_full"] = _kadabra(run_kadabra(g, mesh=mesh, config=cfg))
    part = run_kadabra(g, mesh=mesh, config=AdaptiveConfig(
        eps=resume_eps, delta=0.1, max_epochs=1), checkpoint_dir=ckpt_root)
    out["resume_part"] = _kadabra(part)
    out["resumed"] = _kadabra(run_kadabra(g, mesh=mesh, config=cfg,
                                          checkpoint_dir=ckpt_root))
    # the newest step damaged: rank 0 quarantines it and every rank
    # resumes from the step before (the barrier: rank 0's last publish
    # has landed)
    torch.distributed.barrier()
    newest = latest_step(ckpt_root)
    if rank == 0:
        leaf = os.path.join(ckpt_root, f"step_{newest:08d}", "arr_000000.npy")
        with open(leaf, "r+b") as f:
            f.seek(-1, os.SEEK_END)
            last = f.read(1)
            f.seek(-1, os.SEEK_END)
            f.write(bytes([last[0] ^ 0xFF]))
    torch.distributed.barrier()
    res = run_kadabra(g, mesh=mesh, config=cfg, checkpoint_dir=ckpt_root)
    out["fallback"] = _kadabra(res)
    out["fallback_epochs"] = [s.epoch for s in res.stats]
    out["newest"] = newest
    out["quarantined"] = os.path.isdir(os.path.join(
        ckpt_root, f"step_{newest:08d}.quarantined-0"))

    # the same step read at W = 2, on the subgroup of ranks 0 and 1 (every
    # rank makes the subgroup; only its ranks build the mesh)
    pair = torch.distributed.new_group([0, 1])
    out["w2_schema_error"] = None
    if rank < 2:
        try:
            run_kadabra(g, mesh=SamplerMesh((2,), ("data",), CPU, group=pair),
                        config=cfg, checkpoint_dir=ckpt_root)
            out["w2_schema_error"] = False
        except CheckpointSchemaError:
            out["w2_schema_error"] = True

    # a mesh of one rank is the single lane
    solo = torch.distributed.new_group([rank], use_local_synchronization=True)
    one = SamplerMesh((1, 1), ("pod", "data"), CPU, group=solo)
    cfg = AdaptiveConfig(eps=eps, delta=0.1)
    out["size1"] = _kadabra(run_kadabra(g, mesh=one, config=cfg, seed=3))
    out["single"] = _kadabra(run_kadabra(g, config=cfg, seed=3, device=CPU))

    # run_fixed: ceil(n / W) draws a rank, one all_reduce
    out["fixed"] = {n: [(r.tau, r.scores) for r in run_fixed(
        g, n, seed=5, batch_size=16, mesh=mesh)] for n in (150, 64)}

    # closeness and harmonic on the forward stream, in every mode
    for mode in MODES:
        res = run_adaptive(g, ("closeness", "harmonic"), seed=1, mesh=mesh,
                           config=AdaptiveConfig(eps=0.1, delta=0.1,
                                                 n0_base=200,
                                                 aggregation=mode))
        out[("forward", mode)] = {
            "tau": res.tau, "n_epochs": res.n_epochs,
            "reports": [(r.name, r.scores, r.tau, r.stop_epoch)
                        for r in res.reports]}

    # refusals: another device than the mesh's, a rank-dependent bit
    try:
        run_kadabra(g, mesh=mesh, device="meta")
        out["device_refused"] = False
    except ValueError as e:
        out["device_refused"] = "differs" in str(e)
    try:
        assert_replicated(mesh, {"same": 7, "rank": rank})
        out["split_refused"] = None
    except RuntimeError as e:
        out["split_refused"] = str(e)
    return out


def weighted_spmd(rank, edges, n_nodes, wseed):
    """tests/test_torch_weighted_engine.py's SPMD run on this rank of a
    2-rank gloo group: the weighted stream in the hierarchical mode (one
    intra-op thread: the case is small)."""
    torch.set_num_threads(1)
    g = from_edge_list(edges, n_nodes, device=CPU)
    g = with_weights(g, symmetric_dyadic_weights(g, seed=wseed))
    mesh = SamplerMesh((2,), ("data",), CPU)
    res = run_adaptive(g, ("betweenness", "harmonic"), stream="weighted",
                       seed=1, mesh=mesh,
                       config=AdaptiveConfig(eps=0.1, delta=0.1,
                                             n0_base=200))
    return {"tau": res.tau, "n_epochs": res.n_epochs,
            "vertex_diameter": res.vertex_diameter,
            "distance_cap": res.distance_cap,
            "reports": [(r.name, r.scores, r.tau, r.stop_epoch)
                        for r in res.reports]}
