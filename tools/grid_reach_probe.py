"""BFS reach once sigma leaves float32's range, and the smoke's grid run,
on the card: what the reach repair of single-source BFS changes there.

    PYTHONPATH=src python tools/grid_reach_probe.py

Run it with ``PYTHONPATH`` naming another tree's ``src`` to measure that
tree (the parent commit's, say) in the same call.  It prints:

1. from corner 0 of the 256 x 256 grid with a CSC layout (the
   node-blocked route of ``chip_smoke.py`` [5]): the distances that
   differ from the exact ones (a grid's distance from a corner is
   ``row + column``), and the reached vertices whose sigma is 0;
2. the same on input A (a chain of 260 diamonds beside a 520-edge path,
   both from vertex 0; the flat route): wrong distances, and the path's
   end's distance (520 exactly);
3. ``chip_smoke.py`` [5]'s ``run_kadabra`` on that grid (eps 0.05, delta
   0.1, seed 0): vertex diameter, samples, epochs, BFS levels, seconds.
"""
import json
import subprocess
import time

import numpy as np
import torch

from repro_torch.core import (AdaptiveConfig, bfs_sssp, from_edge_list,
                              grid_graph, run_kadabra, with_csc_layout)

SIDE, EPS, DELTA, SEED = 256, 0.05, 0.1, 0


def diamonds_and_path(k: int = 260, path_len: int = 520):
    edges, junction, nxt = [], 0, 1
    for _ in range(k):
        a, b, j = nxt, nxt + 1, nxt + 2
        edges += [(junction, a), (junction, b), (a, j), (b, j)]
        junction, nxt = j, nxt + 3
    prev = 0
    for _ in range(path_len):
        edges.append((prev, nxt))
        prev, nxt = nxt, nxt + 1
    return np.array(edges, dtype=np.int64), nxt, junction


def reach(graph, want) -> dict:
    res = bfs_sssp(graph, 0)
    n = graph.n_nodes
    dist = res.dist[:n].cpu().numpy()
    sigma = res.sigma[:n].cpu().numpy()
    return {"wrong": int((dist != want).sum()),
            "unreached": int((dist < 0).sum()),
            "reached_sigma_0": int(((dist >= 0) & (sigma == 0)).sum()),
            "levels": int(res.n_iters), "dist_last": int(dist[-1])}


def main() -> None:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)
    grid = with_csc_layout(grid_graph(SIDE, SIDE, device="cuda"))
    rows, cols = np.divmod(np.arange(SIDE * SIDE), SIDE)
    out = {"grid_corner": reach(grid, rows + cols)}
    edges, n, end = diamonds_and_path()
    chain = from_edge_list(edges, n, device="cuda")
    want = np.full(n, -1)
    want[0] = 0
    # the diamonds: a junction j of diamond i is at 2(i+1), its middles at
    # 2i+1; the path's vertices follow at 1..520
    for i in range(260):
        base = 1 + 3 * i
        want[base: base + 2] = 2 * i + 1
        want[base + 2] = 2 * i + 2
    want[end + 1:] = np.arange(1, n - end)
    out["input_a"] = reach(chain, want)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run_kadabra(grid, config=AdaptiveConfig(eps=EPS, delta=DELTA),
                      seed=SEED, device="cuda")
    torch.cuda.synchronize()
    out["grid_run"] = {
        "seconds": time.perf_counter() - t0,
        "phase_seconds": res.phase_seconds,
        "vertex_diameter": res.vertex_diameter, "tau": res.tau,
        "n_epochs": res.n_epochs, "converged": res.converged,
        "bfs_levels": res.bfs_levels,
        "btilde_sum": float(res.btilde.sum())}
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
