"""The paper's experiment at laptop scale on the PyTorch port: epoch-based
adaptive sampling on a mesh of independent samplers, one process each,
comparing the three aggregations of each epoch's frame (Alg. 1's flat
all-reduce, the reduce-to-root + broadcast, and the hierarchical
local/global scheme of §IV-E) on a (2, 2, 2) ("pod", "data", "model")
mesh of 8 local ranks in one gloo group.  It is the first half of
``examples/betweenness_scaling.py``; the vertex-partitioned half waits
for the sharded lane's transport over ``torch.distributed``.

    # on the CPU
    PYTHONPATH=src python examples/betweenness_scaling_torch.py --device cpu
    # 8 ranks sharing one card (gloo stages each frame through the host)
    PYTHONPATH=src python examples/betweenness_scaling_torch.py
"""
import argparse
import time

import numpy as np

from repro_torch.core import (AdaptiveConfig, SamplerMesh, brandes_numpy,
                              rmat_graph, run_kadabra)
from repro_torch.device import resolve_device
from repro_torch.launch import spawn_local

SHAPE, AXES = (2, 2, 2), ("pod", "data", "model")
MODES = ("hierarchical", "flat", "root")


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


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--scale", type=int, default=10,
                    help="R-MAT scale (2^scale vertices)")
    ap.add_argument("--edge-factor", type=int, default=8)
    ap.add_argument("--eps", type=float, default=0.05)
    args = ap.parse_args(argv)
    resolve_device(args.device)     # no card: raise before any rank starts

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
    print("OK")
    return results


if __name__ == "__main__":
    main()
