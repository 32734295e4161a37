"""The paper's experiment at laptop scale on the PyTorch port, in the two
halves of ``examples/betweenness_scaling.py``:

1. epoch-based adaptive sampling on a mesh of independent samplers, one
   process each, comparing the three aggregations of each epoch's frame
   (Alg. 1's flat all-reduce, the reduce-to-root + broadcast, and the
   hierarchical local/global scheme of §IV-E) on a (2, 2, 2) ("pod",
   "data", "model") mesh of 8 local ranks in one gloo group;
2. the partitioned lane, where the mesh is ONE cooperative sampler: each
   of 8 ranks holds one vertex shard's edge buckets
   (``partition_graph(graph, 8, shard=rank)`` on a ``GroupShardMesh``),
   and every BFS level exchanges the frontier through the
   bitmap-scheduled protocol: the active source chunks when they fit
   the budget, the dense all-gather otherwise.  The ranks count the
   bytes each protocol moved on one BFS trace of a narrow grid (a road
   network's shape) and of the R-MAT graph, then run ``run_kadabra`` on
   the R-MAT shards to its stop rule.

    # on the CPU
    PYTHONPATH=src python examples/betweenness_scaling_torch.py --device cpu
    # 8 ranks sharing one card (gloo stages each frame through the host)
    PYTHONPATH=src python examples/betweenness_scaling_torch.py
"""
import argparse
import time

import numpy as np

from repro_torch.core import (AdaptiveConfig, GroupShardMesh, SamplerMesh,
                              bfs_sssp_batched_sharded, brandes_numpy,
                              exchange_plan, grid_graph, partition_graph,
                              rmat_graph, run_kadabra)
from repro_torch.device import resolve_device
from repro_torch.launch import spawn_local

SHAPE, AXES = (2, 2, 2), ("pod", "data", "model")
MODES = ("hierarchical", "flat", "root")
TRACE_BATCH = 8


def rank_main(rank, device, scale, edge_factor, eps):
    """One sampler: the same graph and seed on every rank, its own
    draws; -> {mode: (seconds, BetweennessResult)}."""
    graph = rmat_graph(scale, edge_factor, seed=1, device=device)
    mesh = SamplerMesh(SHAPE, AXES, device=device)
    out = {}
    for agg in MODES:
        cfg = AdaptiveConfig(eps=eps, delta=0.1, aggregation=agg,
                             n0_base=400)
        t0 = time.perf_counter()
        res = run_kadabra(graph, mesh=mesh, config=cfg, seed=0)
        out[agg] = (time.perf_counter() - t0, res)
    return out


def spmd_half(args) -> list:
    graph = rmat_graph(args.scale, args.edge_factor, seed=1, device="cpu")
    print(f"R-MAT graph: |V|={graph.n_nodes} |E|={graph.n_edges // 2}; "
          f"mesh {SHAPE} {AXES}, one process a sampler, on {args.device}")
    exact = brandes_numpy(graph)
    results = spawn_local(rank_main, int(np.prod(SHAPE)),
                          args=(args.device, args.scale, args.edge_factor,
                                args.eps))
    for agg in MODES:
        seconds, res = results[0][agg]
        same = all(np.array_equal(r[agg][1].btilde, res.btilde)
                   and r[agg][1].tau == res.tau for r in results)
        err = float(np.abs(res.btilde - exact).max())
        wait = sum(s.aggregation["wait_s"] for s in res.stats)
        print(f"{agg:>13}: {seconds:6.2f}s  epochs={res.n_epochs:<4} "
              f"tau={res.tau:<7} max_err={err:.4f} (eps={args.eps}); rank "
              f"0 blocked {wait:.3f}s in wait(); every rank the same bits: "
              f"{same}")
        if not (err < args.eps and same and res.converged):
            raise SystemExit(f"{agg}: error {err}, ranks agree {same}, "
                             f"converged {res.converged}")
    print("all aggregation modes converged within eps")
    return results


def block_rows(n_nodes: int, n_shards: int) -> int:
    """Node blocks of a power of two rows, about four a shard, so that
    every shard holds rows at laptop scale (the card's default blocking
    puts a small graph in one block)."""
    rows = max(1, (n_nodes + 1) // (4 * n_shards))
    return max(8, 1 << (rows.bit_length() - 1))


def trace(pg, mesh, seed: int) -> dict:
    """One BFS of TRACE_BATCH sources: its levels, those taken sparse,
    and the bytes this rank sent by protocol (the mesh's count)."""
    rng = np.random.default_rng(seed)
    sources = rng.integers(0, pg.n_nodes, TRACE_BATCH).astype(np.int32)
    mesh.traffic(reset=True)
    res = bfs_sssp_batched_sharded(pg, sources, mesh=mesh)
    sent = {k: v["sent_bytes"] for k, v in mesh.traffic(reset=True).items()}
    levels, sparse = res.exchange.tolist()
    return {"levels": levels, "sparse": sparse, "sent": sent}


def shard_main(rank, device, scale, edge_factor, grid_length, eps):
    """One vertex shard: the rank's own partitions of the grid and of the
    R-MAT graph, a BFS trace of each, then the cooperative run."""
    mesh = GroupShardMesh(device)
    out = {}
    graphs = (("grid", grid_graph(grid_length, 8, device=device)),
              ("rmat", rmat_graph(scale, edge_factor, seed=1,
                                  device=device)))
    for name, g in graphs:
        pg = partition_graph(g, mesh.n_shards, shard=rank,
                             block_v=block_rows(g.n_nodes, mesh.n_shards))
        out[name] = trace(pg, mesh, seed=0)
    cfg = AdaptiveConfig(eps=eps, delta=0.1, n0_base=400)
    t0 = time.perf_counter()
    res = run_kadabra(pg, mesh=mesh, config=cfg, seed=0)
    out["kadabra"] = (time.perf_counter() - t0, res)
    return out


def sharded_half(args) -> list:
    s = args.shards
    print(f"\npartitioned lane ({s} shards, one a process, on {args.device}; "
          "bitmap-scheduled frontier exchange):")
    results = spawn_local(shard_main, s,
                          args=(args.device, args.scale, args.edge_factor,
                                args.grid_length, args.eps))
    graphs = (("grid", grid_graph(args.grid_length, 8, device="cpu")),
              ("rmat", rmat_graph(args.scale, args.edge_factor, seed=1,
                                  device="cpu")))
    for name, g in graphs:
        pg = partition_graph(g, s, block_v=block_rows(g.n_nodes, s))
        plan = exchange_plan(pg, TRACE_BATCH)
        tr = results[0][name]
        moved = sum(sum(r[name]["sent"].get(k, 0)
                        for k in ("bits", "dense", "sparse"))
                    for r in results)
        ratio = moved / (tr["levels"] * plan.dense_bytes)
        print(f"  {name} |V|={g.n_nodes}: {tr['levels']} BFS levels, sparse "
              f"taken on {tr['sparse']} (budget {plan.budget} x "
              f"{plan.chunk_rows}-row chunks a shard); the ranks sent "
              f"{moved / 1024:.1f} KiB, {ratio:.2f}x the dense protocol's "
              f"{plan.dense_bytes / 1024:.1f} KiB a level")
    seconds, res = results[0]["kadabra"]
    graph = graphs[1][1]
    err = float(np.abs(res.btilde - brandes_numpy(graph)).max())
    same = all(np.array_equal(r["kadabra"][1].btilde, res.btilde)
               and r["kadabra"][1].tau == res.tau for r in results)
    print(f"  cooperative run_kadabra on the R-MAT shards: {seconds:6.2f}s  "
          f"epochs={res.n_epochs} tau={res.tau} max_err={err:.4f} "
          f"(eps={args.eps}); every rank the same bits: {same}")
    if not (err < args.eps and same and res.converged):
        raise SystemExit(f"partitioned: error {err}, ranks agree {same}, "
                         f"converged {res.converged}")
    print("partitioned lane converged within eps")
    return results


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--scale", type=int, default=10,
                    help="R-MAT scale (2^scale vertices)")
    ap.add_argument("--edge-factor", type=int, default=8)
    ap.add_argument("--eps", type=float, default=0.05)
    ap.add_argument("--half", choices=("both", "spmd", "sharded"),
                    default="both")
    ap.add_argument("--shards", type=int, default=8,
                    help="ranks of the partitioned lane")
    ap.add_argument("--grid-length", type=int, default=2048,
                    help="the narrow grid is grid-length x 8")
    args = ap.parse_args(argv)
    resolve_device(args.device)     # no card: raise before any rank starts
    out = {}
    if args.half in ("both", "spmd"):
        out["spmd"] = spmd_half(args)
    if args.half in ("both", "sharded"):
        out["sharded"] = sharded_half(args)
    print("OK")
    return out


if __name__ == "__main__":
    main()
