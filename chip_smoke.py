#!/usr/bin/env python3
"""On-card smoke of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card and ``nvcc``; exits non-zero without them, and on
any failed phase.  Phases:

1. the device: name, count, and ``nvidia-smi`` name and power limit;
2. build the frontier kernels from ``csrc/`` (nvcc, sm_90a) and print the
   build seconds and the ``ptxas`` register/shared-memory lines;
3. hold each kernel against its plain PyTorch version at main-path
   shapes (one mid-BFS level of R-MAT 2^20 x 30, B=64): the flat kernel
   on the COO edges, the node-blocked kernel on a CSC layout at the
   card's blocking.  Bitwise while the sums are exact integers below
   2^24, else rtol 1e-6 (atomics add in a varying order).  Times each
   with CUDA events after warm-up, beside its plain version, the byte
   bound and ``torch.sparse.mm`` (the library yardstick, called only
   here);
4. the main path: ``run_kadabra`` on R-MAT 2^20 x 30, B=64, eps=0.01,
   delta=0.1 (``repro.configs.betweenness``), no CSC layout, so every
   level goes through the flat kernel;
   then four of its sampling rounds under ``torch.profiler`` (device
   time by kernel, device idle share);
5. a second path through the node-blocked kernel: a 256 x 256 grid with
   a CSC layout.  The kernel is first held against its plain version and
   timed at the grid's own shapes (one mid-BFS level, B=8: these are the
   node-blocked row's numbers, the R-MAT ones stay beside them), then
   ``run_kadabra`` runs at eps=0.05, then two of its rounds under the
   profiler;
6. accuracy: ``run_kadabra`` on a 1000-vertex hyperbolic graph within
   eps=0.05 of the exact ``brandes_numpy``.

Then it prints the ``{"kernels": [...]}`` line, the card's name and
power limit, and as the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
FP32_OPS_PER_S = 67e12        # H100 SXM float32 outside the tensor cores
EXACT_LIMIT = float(1 << 24)  # float32 sums of integers are exact below
RTOL = 1e-6
SEED = 0
RMAT_SCALE, EDGE_FACTOR, BATCH = 20, 30, 64
MAIN_EPS, MAIN_DELTA = 0.01, 0.1
# epochs of the main path: caps the run inside the smoke's time limit;
# a run that hits it reports converged=False
MAIN_MAX_EPOCHS = 100
GRID_SIDE, GRID_EPS = 256, 0.05
GRID_BATCH = 8        # what resolve_sample_batch_size picks for the grid
HYPER_N, HYPER_EPS = 1000, 0.05
DEVICE = "cuda"


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_time_ms(fn, iters: int) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def bound(n_bytes: float, n_ops: float) -> tuple:
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = n_ops / FP32_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def compare(name: str, got, want) -> float:
    """Bitwise when the plain sums are exact small integers, else rtol."""
    import torch
    exact = bool(want.max() < EXACT_LIMIT) and bool(
        torch.equal(want, torch.round(want)))
    err = float((got - want).abs().max())
    if exact:
        if not torch.equal(got, want):
            raise AssertionError(f"{name}: not bitwise equal to its plain "
                                 f"version (max |diff| {err})")
        log(f"  {name}: bitwise equal to its plain version")
    else:
        if not torch.allclose(got, want, rtol=RTOL, atol=0.0):
            raise AssertionError(f"{name}: max |diff| {err} beyond rtol "
                                 f"{RTOL}")
        log(f"  {name}: within rtol {RTOL} (max |diff| {err})")
    return err


def phase_device():
    import torch
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"[1] device: {name}, count {count}; nvidia-smi: {smi}")
    return name, count, smi


def phase_build():
    from repro_torch.kernels import _build
    from repro_torch.kernels.frontier import kernel
    t0 = time.perf_counter()
    kernel.library()
    report = _build.build_report("frontier")
    log(f"[2] built frontier.cu in {report['seconds']:.2f} s "
        f"(phase {time.perf_counter() - t0:.2f} s)")
    for line in report["ptxas"].splitlines():
        if "registers" in line or "Compiling entry" in line:
            log(f"  ptxas: {line.strip()}")


def mid_bfs_state(graph, batch: int):
    """Full BFS from ``batch`` seeded sources; each column's frontier is
    put at half its eccentricity (the widest levels of R-MAT)."""
    import torch
    from repro_torch.core import bfs_sssp_batched
    gen = torch.Generator(device=graph.device).manual_seed(SEED)
    sources = torch.randint(0, graph.n_nodes, (batch,), generator=gen,
                            device=graph.device, dtype=torch.int32)
    res = bfs_sssp_batched(graph, sources)
    levels = (res.levels // 2).to(torch.int32)
    return res.dist.contiguous(), res.sigma.contiguous(), levels


def library_ms(graph, dist, sigma, levels) -> float:
    """The library yardstick: contrib = A^T @ fvals as one CSR sparse
    product over the state's rows (the frontier mask is not timed)."""
    import torch
    from repro_torch.kernels.frontier import frontier_expand_batched_ref
    rows, e_real = dist.shape[0], graph.n_edges
    at = torch.sparse_coo_tensor(
        torch.stack([graph.dst[:e_real].long(), graph.src[:e_real].long()]),
        torch.ones(e_real, device=dist.device), (rows, rows)).coalesce()
    at = at.to_sparse_csr()
    fvals = torch.where(dist == levels[None, :], sigma, 0.0)
    lib = torch.sparse.mm(at, fvals)
    torch.cuda.synchronize()
    lib_err = float((lib - frontier_expand_batched_ref(
        graph.src, graph.dst, dist, sigma, levels)).abs().max())
    ms = cuda_time_ms(lambda: torch.sparse.mm(at, fvals), 10)
    log(f"  torch.sparse.mm yardstick: {ms:.3f} ms (max |diff| vs plain "
        f"{lib_err})")
    return ms


def check_flat(graph, dist, sigma, levels) -> dict:
    """The flat kernel against its plain version on the COO edges."""
    import torch
    from repro_torch.kernels.frontier import (frontier_expand_batched_ref,
                                              frontier_expand_flat)
    v1, batch = graph.n_nodes + 1, dist.shape[1]
    got = frontier_expand_flat(graph.src, graph.dst, dist, sigma, levels)
    want = frontier_expand_batched_ref(graph.src, graph.dst, dist, sigma,
                                       levels)
    torch.cuda.synchronize()
    err = compare("frontier_flat", got, want)
    del got, want
    ms = cuda_time_ms(lambda: frontier_expand_flat(
        graph.src, graph.dst, dist, sigma, levels), 20)
    plain = cuda_time_ms(lambda: frontier_expand_batched_ref(
        graph.src, graph.dst, dist, sigma, levels), 3)
    b_ms, b_by = bound(graph.e_pad * 8 + v1 * batch * 12,
                       2.0 * graph.e_pad * batch)
    log(f"  frontier_flat: {ms:.3f} ms, plain {plain:.3f} ms, bound "
        f"{b_ms:.3f} ms ({b_by})")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": library_ms(graph, dist, sigma, levels)}


def check_node_blocked(graph, csc, dist, sigma, levels) -> dict:
    """The node-blocked kernel against its plain version on ``csc``, with
    the state at csc.v_pad rows.  The wrapper is timed as the path calls
    it, its block bitmap included; the bitmap is also timed alone."""
    import torch
    from repro_torch.kernels.frontier import (
        frontier_block_bitmap, frontier_expand_node_blocked,
        frontier_expand_node_blocked_ref)
    batch = dist.shape[1]
    n_active = int(frontier_block_bitmap(csc, dist, levels).sum())
    got = frontier_expand_node_blocked(csc, dist, sigma, levels)
    want = frontier_expand_node_blocked_ref(csc, dist, sigma, levels)
    torch.cuda.synchronize()
    err = compare("frontier_node_blocked", got, want)
    del got, want
    ms = cuda_time_ms(lambda: frontier_expand_node_blocked(
        csc, dist, sigma, levels), 20)
    bitmap = cuda_time_ms(lambda: frontier_block_bitmap(csc, dist, levels),
                          20)
    plain = cuda_time_ms(lambda: frontier_expand_node_blocked_ref(
        csc, dist, sigma, levels), 3)
    b_ms, b_by = bound(n_active * csc.block_e * 8 + csc.n_edge_blocks * 4
                       + csc.v_pad * batch * 12,
                       2.0 * n_active * csc.block_e * batch)
    log(f"  frontier_node_blocked: {ms:.3f} ms with its bitmap ({bitmap:.3f}"
        f" ms alone; {n_active}/{csc.n_edge_blocks} blocks active), plain "
        f"{plain:.3f} ms, bound {b_ms:.3f} ms ({b_by})")
    return {"max_abs_err": err, "ms": ms, "bitmap_ms": bitmap,
            "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": library_ms(graph, dist, sigma, levels)}


def phase_kernels(graph):
    """Both kernels at one mid-BFS level of the R-MAT graph, B=64."""
    import torch
    from repro_torch.core import build_csc_layout
    dist, sigma, levels = mid_bfs_state(graph, BATCH)
    log(f"[3] kernels at R-MAT 2^{RMAT_SCALE} x {EDGE_FACTOR}: "
        f"V={graph.n_nodes} E={graph.n_edges} B={BATCH}, levels "
        f"{levels.tolist()[:8]}...")
    flat = check_flat(graph, dist, sigma, levels)

    # the node-blocked kernel on the card's CSC blocking
    t0 = time.perf_counter()
    csc = build_csc_layout(graph)
    log(f"  CSC layout block_v={csc.block_v} block_e={csc.block_e}: "
        f"{csc.n_edge_blocks} edge blocks, e_slots/n_edges = "
        f"{csc.e_slots / graph.n_edges:.4f} "
        f"({time.perf_counter() - t0:.1f} s)")
    pad = csc.v_pad - dist.shape[0]
    dist = torch.cat([dist, dist.new_full((pad, BATCH), -3)]).contiguous()
    sigma = torch.cat([sigma, sigma.new_zeros((pad, BATCH))]).contiguous()
    nb = check_node_blocked(graph, csc, dist, sigma, levels)
    source = "src/repro_torch/kernels/frontier/csrc/frontier.cu"
    shape = f"R-MAT 2^{RMAT_SCALE} x {EDGE_FACTOR}, B={BATCH}"
    return [
        {"name": "frontier_flat", "route": "cuda", "source": source,
         "replaces": "src/repro/kernels/frontier/kernel.py:172",
         "launches": 0, **flat, "shape": shape},
        # the row's own numbers are set at the grid's shape in phase [5],
        # the path that launches this kernel; these stay beside them
        {"name": "frontier_node_blocked", "route": "cuda", "source": source,
         "replaces": "src/repro/kernels/frontier/kernel.py:405",
         "launches": 0, **{f"rmat_{k}": v for k, v in nb.items()},
         "rmat_shape": f"{shape}, block_v={csc.block_v} "
                       f"block_e={csc.block_e}"},
    ]


def phase_grid_kernel(grid) -> dict:
    """The node-blocked kernel at the grid run's own shapes: one mid-BFS
    level of GRID_BATCH searches on the grid's CSC layout."""
    dist, sigma, levels = mid_bfs_state(grid, GRID_BATCH)
    csc = grid.csc
    log(f"  kernel at the grid's shapes: V={grid.n_nodes} B={GRID_BATCH} "
        f"rows={dist.shape[0]} block_v={csc.block_v} block_e={csc.block_e}"
        f", levels {levels.tolist()}")
    nb = check_node_blocked(grid, csc, dist, sigma, levels)
    return {**nb, "shape": f"grid {GRID_SIDE} x {GRID_SIDE}, B={GRID_BATCH},"
                           f" block_v={csc.block_v} block_e={csc.block_e}"}


def phase_profile(label: str, graph, rounds: int, batch: int):
    """``rounds`` sampling rounds of ``batch`` under ``torch.profiler``:
    device time by kernel (the profiler's device-side entries only, so no
    kernel is counted twice), and the device's idle share of the wall
    time (the profiler's host overhead inflates the wall time a little)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.engine import draw_fold, resolve_estimators
    from repro_torch.core.estimators.base import RunContext
    gen = torch.Generator(device=graph.device).manual_seed(SEED + 1)
    ests = resolve_estimators("betweenness")
    ctx = RunContext(graph.n_nodes, 0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fold = draw_fold(graph, gen, rounds * batch, estimators=ests,
                         ctx=ctx, batch_size=batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [(evt.self_device_time_total / 1e3, evt.count, evt.key)
            for evt in prof.key_averages()
            if evt.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(r[0] for r in rows)
    log(f"  profile {label}: {rounds} rounds of {batch} samples, "
        f"{fold.n_levels} levels, wall {wall_ms:.1f} ms, device busy "
        f"{busy:.1f} ms, idle share {1 - busy / wall_ms:.3f}")
    for ms, calls, key in sorted(rows, reverse=True)[:6]:
        log(f"  {ms:9.2f} ms {ms / max(busy, 1e-9):6.1%} x{calls:<6d} "
            f"{key[:80]}")


def drive(label: str, graph, kernel_name: str, eps: float, delta: float,
          **cfg):
    """Run ``run_kadabra`` with the launch counts set to 0 just before
    and read just after; the named kernel must carry every level."""
    import numpy as np
    from repro_torch.core import AdaptiveConfig, run_kadabra
    from repro_torch.kernels.frontier import launch_counts, reset_launch_counts
    config = AdaptiveConfig(eps=eps, delta=delta, **cfg)
    reset_launch_counts()
    t0 = time.perf_counter()
    res = run_kadabra(graph, config=config, seed=SEED, device=DEVICE)
    seconds = time.perf_counter() - t0
    counts = dict(launch_counts)
    b = res.btilde
    log(f"  {label}: {seconds:.1f} s, phases "
        + ", ".join(f"{k} {v:.2f} s" for k, v in res.phase_seconds.items())
        + f"; tau {res.tau}, epochs {res.n_epochs}, converged "
        f"{res.converged}, vertex diameter {res.vertex_diameter}, BFS "
        f"levels {res.bfs_levels}, launches {counts}")
    if b.shape != (graph.n_nodes,) or not np.isfinite(b).all() \
            or (b < 0).any() or (b > 1).any():
        raise AssertionError(f"{label}: scores not finite in [0, 1] of "
                             f"shape ({graph.n_nodes},)")
    if counts[kernel_name] == 0 or counts[kernel_name] != res.bfs_levels \
            or sum(counts.values()) != counts[kernel_name]:
        raise AssertionError(f"{label}: expected all {res.bfs_levels} "
                             f"levels through {kernel_name}, got {counts}")
    return res, counts[kernel_name]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import numpy as np
    from repro_torch.core import (brandes_numpy, grid_graph,
                                  hyperbolic_graph, rmat_graph,
                                  with_csc_layout)
    from repro_torch.kernels.frontier import FLAT, NODE_BLOCKED
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    name, count, smi = phase_device()
    phase_build()

    t0 = time.perf_counter()
    rmat = rmat_graph(RMAT_SCALE, EDGE_FACTOR, seed=SEED, device=DEVICE)
    log(f"  R-MAT 2^{RMAT_SCALE} x {EDGE_FACTOR} built in "
        f"{time.perf_counter() - t0:.1f} s: V={rmat.n_nodes} "
        f"E={rmat.n_edges} max degree {rmat.max_degree}")
    rows = phase_kernels(rmat)
    torch.cuda.empty_cache()

    log(f"[4] main path: run_kadabra R-MAT 2^{RMAT_SCALE} x {EDGE_FACTOR}, "
        f"B={BATCH}, eps={MAIN_EPS}, delta={MAIN_DELTA}, max_epochs "
        f"{MAIN_MAX_EPOCHS}")
    res, rows[0]["launches"] = drive(
        "rmat", rmat, FLAT, MAIN_EPS, MAIN_DELTA, sample_batch_size=BATCH,
        max_epochs=MAIN_MAX_EPOCHS)
    if not res.converged:
        log(f"  the epoch cap {MAIN_MAX_EPOCHS} was hit: converged=False")
    phase_profile("rmat", rmat, 4, BATCH)
    del rmat
    torch.cuda.empty_cache()

    log(f"[5] node-blocked path: run_kadabra on a {GRID_SIDE} x {GRID_SIDE} "
        f"grid with a CSC layout, eps={GRID_EPS}")
    grid = with_csc_layout(grid_graph(GRID_SIDE, GRID_SIDE, device=DEVICE))
    rows[1].update(phase_grid_kernel(grid))
    _res, rows[1]["launches"] = drive("grid", grid, NODE_BLOCKED, GRID_EPS,
                                      0.1)
    phase_profile("grid", grid, 2, GRID_BATCH)

    log(f"[6] accuracy: run_kadabra on hyperbolic({HYPER_N}) vs exact "
        f"Brandes, eps={HYPER_EPS}")
    hyper = hyperbolic_graph(HYPER_N, seed=SEED, device=DEVICE)
    res, _ = drive("hyperbolic", hyper, FLAT, HYPER_EPS, 0.1)
    exact = brandes_numpy(hyper)
    err = float(np.abs(res.btilde - exact).max())
    log(f"  max |b~ - b| = {err:.5f} (eps {HYPER_EPS})")
    if not err < HYPER_EPS:
        raise AssertionError(f"hyperbolic: max error {err} >= {HYPER_EPS}")

    log(f"[7] total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
