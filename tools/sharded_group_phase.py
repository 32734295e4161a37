"""``chip_smoke.py``'s phase [17] alone, on the card: [1] the device, [2]
the kernel builds, [14]'s partition of the production graph in 8 shards
and its one-card level at the mid-BFS state (the yardstick of [17]'s
level), then [17] (4 ranks spawned on the card in a gloo group, one
vertex shard each: a batch each way against ``ShardMesh(4)``, where a
level's time goes, ``run_kadabra`` at 2 epochs, hyperbolic(1000)
stopped and resumed) and the one-rank NCCL group.

    PYTHONPATH=src python tools/sharded_group_phase.py
"""
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
import chip_smoke as cs  # noqa: E402


def main() -> None:
    import torch
    from repro_torch.core import ShardMesh, partition_graph, rmat_graph
    from repro_torch.kernels.frontier import frontier_expand_flat
    cs.load_main_config()
    t0 = time.perf_counter()
    cs.phase_device()
    cs.phase_build()
    rmat = rmat_graph(cs.RMAT_SCALE, cs.EDGE_FACTOR, seed=cs.SEED,
                      device="cuda")
    pg = partition_graph(rmat, cs.SHARDS)
    dist, sigma, levels = cs.mid_bfs_state(rmat, cs.BATCH)
    flat_ms = cs.cuda_time_ms(lambda: frontier_expand_flat(
        rmat.src, rmat.dst, dist, sigma, levels, rmat.pull_plan()), 10)
    cs.log(f"[14] the one-card sharded level, {cs.SHARDS} shards of "
           f"{pg.shard_rows} rows")
    one_card = cs.level_breakdown(pg, ShardMesh(cs.SHARDS, "cuda"), dist,
                                  sigma, levels, flat_ms)
    del rmat, pg, dist, sigma
    torch.cuda.empty_cache()
    cs.log(f"[17] sharded lane over torch.distributed, {cs.GROUP_SHARDS} "
           "ranks on the one card")
    print(cs.phase_sharded_group(one_card), flush=True)
    print(f"sharded_group_phase total {time.perf_counter() - t0:.1f} s",
          flush=True)


if __name__ == "__main__":
    main()
