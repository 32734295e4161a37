"""Rank functions of ``tests/test_torch_supervisor.py``, run by
``repro_torch.launch.spawn_local`` on a gloo group: the runtime on the
lanes of many processes.

They live apart from the test module so that a spawned rank imports
torch and the port only (no JAX, no pytest).  Each returns plain values
and numpy arrays for the test process to compare.
"""
import os

import numpy as np
import torch

from repro_torch.checkpoint import latest_step
from repro_torch.core import (AdaptiveConfig, GroupShardMesh, SamplerMesh,
                              hyperbolic_graph, partition_graph,
                              run_adaptive)
from repro_torch.runtime import (DeviceLoss, EpochTimeoutError,
                                 FaultSchedule, FaultSpec, JSONLSink,
                                 ResilientRunner, RetryPolicy, RingSink,
                                 Telemetry, read_jsonl)

CPU = "cpu"
# hyperbolic(N_HYPER) in 4 shards of 64 rows, 64-sample batches; the
# clean run lasts past the ladder's last fault (epoch 6)
N_HYPER, BLOCK_V = 200, 64
RUN = dict(eps=0.05, delta=0.1, n0_base=128, sample_batch_size=64)
# the ladder: GroupShardMesh(4) shrinks to 2 ranks at epoch 2; two kills
# exhaust that rung (max_retries 1), two more the SamplerMesh(2) rung
LADDER = (FaultSpec("shrink", 2, survivors=2), FaultSpec("kill", 3),
          FaultSpec("kill", 4), FaultSpec("kill", 5), FaultSpec("kill", 6))


class HookBug(Exception):
    """A hook's failure that the runtime does not know."""


def _outcome(fn) -> tuple:
    """(exception class name, message) of ``fn()``, or (None, None)."""
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the test reads which
        return type(e).__name__, str(e)
    return None, None


def runtime_suite(rank: int, root: str) -> dict:
    """One 4-rank group: the hook agreement on a GroupShardMesh and a
    SamplerMesh (one rank's hook raises; every rank must raise), the bus
    on against off on both, then the ResilientRunner's ladder
    GroupShardMesh(4) -> GroupShardMesh(2) -> SamplerMesh(2) -> single,
    with telemetry to one JSONL a rank."""
    torch.set_num_threads(1)
    g = hyperbolic_graph(N_HYPER, seed=0, device=CPU)
    cfg = AdaptiveConfig(**RUN)
    out = {"rank": rank}

    # (a) GroupShardMesh(4): rank 2's hook times out at epoch 2
    mesh = GroupShardMesh(CPU)
    pg = partition_graph(g, 4, block_v=BLOCK_V, shard=rank)
    group_dir = os.path.join(root, "group_hook")

    def group_hook(epoch, state):
        if rank == 2 and epoch == 2:
            raise EpochTimeoutError("rank 2's own clock")

    out["group_hook"] = _outcome(lambda: run_adaptive(
        pg, config=cfg, seed=3, mesh=mesh, checkpoint_dir=group_dir,
        on_epoch=group_hook))
    out["group_hook_step"] = latest_step(group_dir)

    # (b) SamplerMesh((4,)): rank 1's hook raises a class of its own at
    # epoch 1, rank 3's at epoch 2 (never reached)
    smesh = SamplerMesh((4,), ("data",), CPU)

    def spmd_hook(epoch, state):
        if (rank, epoch) in ((1, 1), (3, 2)):
            raise HookBug(f"rank {rank}")

    out["spmd_hook"] = _outcome(lambda: run_adaptive(
        g, config=cfg, seed=3, mesh=smesh, on_epoch=spmd_hook))

    # (c) telemetry on is bitwise off on both process lanes
    two = AdaptiveConfig(**RUN, max_epochs=2)
    out["telemetry_bitwise"] = {}
    for name, graph, m in (("group", pg, mesh), ("spmd", g, smesh)):
        off = run_adaptive(graph, config=two, seed=3, mesh=m)
        ring = RingSink(0)
        on = run_adaptive(graph, config=two, seed=3, mesh=m,
                          telemetry=Telemetry([ring], validate=True))
        out["telemetry_bitwise"][name] = (
            bool(np.array_equal(on.reports[0].scores,
                                off.reports[0].scores))
            and (on.tau, on.bfs_levels) == (off.tau, off.bfs_levels),
            sum(e.kind == "epoch.stats" for e in ring.events),
            sum(e.kind == "exchange.epoch" for e in ring.events),
            ring.events[0].fields["lane"])

    # (d) the ladder
    trace = os.path.join(root, f"ladder-rank{rank}.jsonl")
    sink = JSONLSink(trace)
    sched = FaultSchedule(LADDER)
    runner = ResilientRunner(
        pg, mesh=mesh, checkpoint_dir=os.path.join(root, "ladder"),
        config=cfg, seed=3, schedule=sched,
        policy=RetryPolicy(max_retries=1, backoff_base=1e-3,
                           backoff_cap=1e-3),
        telemetry=Telemetry([sink], validate=True))
    try:
        res = runner.run()
    except DeviceLoss as e:
        out["ladder"] = {"device_loss": str(e)}
    else:
        out["ladder"] = {
            "scores": res.result.reports[0].scores, "tau": res.result.tau,
            "n_epochs": res.result.n_epochs, "lane": res.lane,
            "n_devices": res.n_devices, "attempts": res.attempts,
            "exhausted": sched.exhausted,
            "taus": [s.tau for s in res.result.stats],
            "events": [(e.kind, e.detail) for e in res.events]}
    sink.close()
    out["trace_kinds"] = sorted({e.kind for e in read_jsonl(
        trace, validate=True)})
    return out

