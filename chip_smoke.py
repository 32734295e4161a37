#!/usr/bin/env python3
"""On-card smoke of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card and ``nvcc``; exits non-zero without them, and on
any failed phase.  Phases:

1. the device: name, count, and ``nvidia-smi`` name and power limit;
2. build the frontier, stop-check and gather-segment-sum kernels from
   their ``csrc/`` sources (one nvcc each, started together; sm_90a) and
   print the build seconds and the ``ptxas`` register/shared-memory
   lines;
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
   level goes through the flat kernel and every epoch's stop check
   through the stop-check kernel;
   then four of its sampling rounds under ``torch.profiler`` (device
   time by kernel, device idle share);
   then the stop-check kernel against its plain version at V = 2^20
   with the budgets of this graph's own calibration (bitwise, a NaN case
   and V = 1, 5000, 40000 included), timed beside the plain version and
   the byte bound;
5. a second path through the node-blocked kernel: a 256 x 256 grid with
   a CSC layout.  The kernel is first held against its plain version and
   timed at the grid's own shapes (one mid-BFS level, B=8: these are the
   node-blocked row's numbers, the R-MAT ones stay beside them), then
   ``run_kadabra`` runs at eps=0.05, then two of its rounds under the
   profiler;
6. accuracy: ``run_kadabra`` on a 1000-vertex hyperbolic graph within
   eps=0.05 of the exact ``brandes_numpy``;
7. the forward path: ``run_adaptive`` with betweenness, closeness and
   harmonic on one forward stream over the same R-MAT graph, B=64,
   eps=0.01, no CSC layout: every level through the flat kernel, three
   stop checks per epoch through the stop-check kernel; then two of its
   rounds under the profiler;
8. accuracy of closeness and harmonic on a connected Erdos-Renyi graph
   against scipy's exact distances, with the bounds of
   ``tests/test_estimators.py``;
9. the gather-segment-sum kernel against its plain version at the
   GraphSAGE path's shapes (R-MAT 2^21 x 15, ~6e7 edges, 128 columns):
   the layer's forward call and its transposed (backward) call.  Bitwise
   on integer-valued inputs; on N(0, 1) float32 and bfloat16 tables
   within the summation-order bound stated in the output.  Timed beside
   its plain version, the byte bound and ``torch.sparse.mm`` on the
   plan's (S, V1) CSR matrix (the library yardstick, called only here);
10. GraphSAGE (graphsage-reddit at full width, adapted to the
   ogb_products cell: d_feat 100, 47 classes) on that graph: one
   full-graph inference forward (after a warm-up one), then 3 AdamW
   steps, every neighbour mean through the kernel (2 launches a
   forward, 4 a step); then a step under the profiler (after a warm-up
   step); then the same forward and first step on the dispatcher's
   plain route held against the kernel route's.

Every run resets the launch counts just before it and reads them just
after: each kernel of the run must have carried all of its work.

Then it prints the ``{"kernels": [...]}`` line, the card's name and
power limit, and as the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
FP32_OPS_PER_S = 67e12        # H100 SXM float32 outside the tensor cores
EXACT_LIMIT = float(1 << 24)  # float32 sums of integers are exact below
RTOL = 1e-6
U32 = 2.0 ** -24      # float32 unit roundoff
U_BF16 = 2.0 ** -8    # bfloat16 unit roundoff
SEED = 0
RMAT_SCALE, EDGE_FACTOR, BATCH = 20, 30, 64
MAIN_EPS, MAIN_DELTA = 0.01, 0.1
# epochs of the main path: caps the run inside the smoke's time limit;
# a run that hits it reports converged=False
MAIN_MAX_EPOCHS = 100
GRID_SIDE, GRID_EPS = 256, 0.05
GRID_BATCH = 8        # what resolve_sample_batch_size picks for the grid
HYPER_N, HYPER_EPS = 1000, 0.05
# the forward path: ~85 epochs to closeness's Hoeffding omega at eps 0.01
FWD_METRICS = ("betweenness", "closeness", "harmonic")
FWD_EPS, FWD_MAX_EPOCHS = 0.01, 200
ER_N, ER_DEGREE, ER_EPS = 1500, 8.0, 0.05
STOPCHECK_SHAPES = (1, 5000, 40000)   # besides the full V
STOPCHECK_OPS = 20                    # float operations per vertex
# GraphSAGE: R-MAT at the scale of ogbn-products (2,449,029 nodes,
# 61,859,140 edges): 2^21 nodes, ~6e7 directed edges
GNN_SCALE, GNN_EDGE_FACTOR, GNN_CELL, GNN_STEPS = 21, 15, "ogb_products", 3
# kernel route against the plain route end to end: the neighbour sums
# differ by summation order only (~1e-7 relative), carried through two
# layers' matmuls and row normalisation.  The first step's gradients are
# sums over 2M nodes that cancel, which amplifies a relative gap of their
# small entries: each leaf is held at 1e-3 of its largest entry.  Adam's
# first update g / (|g| + eps) moves by up to |dg| / eps where |g| is
# near eps, so the parameters after it are held to that bound.
GNN_LOGIT_RTOL, GNN_LOGIT_ATOL, GNN_LOSS_RTOL, GNN_GRAD_RTOL = \
    1e-4, 1e-5, 1e-5, 1e-3
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
    """Every kernel source, one nvcc each, all started together."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.frontier import kernel as frontier
    from repro_torch.kernels.segsum import kernel as segsum
    from repro_torch.kernels.stopcheck import kernel as stopcheck
    t0 = time.perf_counter()
    libs = {"frontier": frontier.library, "stopcheck": stopcheck.library,
            "segsum": segsum.library}
    with ThreadPoolExecutor(len(libs)) as pool:
        for fut in [pool.submit(build) for build in libs.values()]:
            fut.result()
    log(f"[2] built {len(libs)} sources in "
        f"{time.perf_counter() - t0:.2f} s")
    for name in libs:
        report = _build.build_report(name)
        log(f"  {name}.cu: nvcc {report['seconds']:.2f} s")
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


def phase_profile(label: str, graph, rounds: int, batch: int,
                  metrics=("betweenness",), stream="bidir",
                  vertex_diameter: int = 0):
    """``rounds`` sampling rounds of ``batch`` under ``torch.profiler``:
    device time by kernel (the profiler's device-side entries only, so no
    kernel is counted twice), and the device's idle share of the wall
    time (the profiler's host overhead inflates the wall time a little)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.engine import draw_fold, resolve_estimators
    from repro_torch.core.estimators.base import RunContext
    gen = torch.Generator(device=graph.device).manual_seed(SEED + 1)
    ests = resolve_estimators(metrics)
    ctx = RunContext(graph.n_nodes, vertex_diameter)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fold = draw_fold(graph, gen, rounds * batch, estimators=ests,
                         ctx=ctx, stream=stream, batch_size=batch)
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


def reset_counts() -> None:
    from repro_torch.kernels import frontier, segsum, stopcheck
    frontier.reset_launch_counts()
    stopcheck.reset_launch_counts()
    segsum.reset_launch_counts()


def all_counts() -> dict:
    from repro_torch.kernels import frontier, segsum, stopcheck
    return {**frontier.launch_counts, **stopcheck.launch_counts,
            **segsum.launch_counts}


def read_counts(label: str, kernel_name: str, bfs_levels: int,
                stop_checks: int) -> dict:
    """The launch counts of the run just made: the named frontier kernel
    carried every level and the stop-check kernel every stop check; the
    gather-segment-sum kernel has no part in a centrality run."""
    from repro_torch.kernels import frontier, segsum, stopcheck
    counts = all_counts()
    if counts[segsum.SEGSUM] != 0:
        raise AssertionError(f"{label}: the gather-segment-sum kernel ran "
                             f"in a centrality run: {counts}")
    fr = dict(frontier.launch_counts)
    if fr[kernel_name] == 0 or fr[kernel_name] != bfs_levels \
            or sum(fr.values()) != fr[kernel_name]:
        raise AssertionError(f"{label}: expected all {bfs_levels} levels "
                             f"through {kernel_name}, got {counts}")
    got = counts[stopcheck.STOPCHECK]
    if got == 0 or got != stop_checks:
        raise AssertionError(f"{label}: expected {stop_checks} stop checks "
                             f"through the stop-check kernel, got {counts}")
    return counts


def drive(label: str, graph, kernel_name: str, eps: float, delta: float,
          **cfg):
    """Run ``run_kadabra`` with the launch counts set to 0 just before
    and read just after; the named kernel must carry every level and the
    stop-check kernel the one stop check of every epoch."""
    import numpy as np
    from repro_torch.core import AdaptiveConfig, run_kadabra
    config = AdaptiveConfig(eps=eps, delta=delta, **cfg)
    reset_counts()
    t0 = time.perf_counter()
    res = run_kadabra(graph, config=config, seed=SEED, device=DEVICE)
    seconds = time.perf_counter() - t0
    counts = read_counts(label, kernel_name, res.bfs_levels, res.n_epochs)
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
    return res, counts


def same_bits(name: str, got, want) -> float:
    """Bitwise equality, with NaN exactly where the plain version has it;
    on a mismatch the error names the largest gap in float32 ulps."""
    import torch
    nan = torch.isnan(want)
    ok = torch.equal(torch.isnan(got), nan) and torch.equal(got[~nan],
                                                            want[~nan])
    if not ok:
        ulps = int((got.view(torch.int32).long()
                    - want.view(torch.int32).long()).abs().max())
        raise AssertionError(f"{name}: {got.tolist()} is not its plain "
                             f"version {want.tolist()} ({ulps} ulps)")
    log(f"  {name}: bitwise equal to its plain version {got.tolist()}")
    return float((got[~nan] - want[~nan]).abs().max()) if bool(
        (~nan).any()) else 0.0


def phase_stopcheck(rmat, vertex_diameter: int, tau: int) -> dict:
    """The stop-check kernel at V = 2^20 with the budgets of the R-MAT
    run's own calibration (a fresh 32-sample frame through the
    betweenness estimator's make_params at the run's vertex diameter)."""
    import numpy as np
    import torch
    from repro_torch.core.engine import draw_fold, resolve_estimators
    from repro_torch.core.estimators.base import RunContext
    from repro_torch.kernels.stopcheck import stopcheck_fused, stopcheck_ref
    v = rmat.n_nodes
    est = resolve_estimators("betweenness")
    ctx = RunContext(v, vertex_diameter)
    gen = torch.Generator(device=rmat.device).manual_seed(SEED + 2)
    cal = draw_fold(rmat, gen, 32, estimators=est, ctx=ctx,
                    batch_size=BATCH)
    p = est[0].make_params(rmat, ctx, MAIN_EPS, MAIN_DELTA, cal.counts,
                           cal.tau)
    lil, liu, omega = p.log_inv_delta_l, p.log_inv_delta_u, p.omega
    counts = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, 400, v).astype(np.float32)).to(rmat.device)
    log(f"  stop check at V={v}: omega {float(omega):.1f}, tau {tau}")
    nan_lil = lil.clone()
    nan_lil[v // 3] = float("nan")
    cases = [("calibration frame", cal.counts[0][:v], cal.tau, lil, liu),
             ("seeded counts", counts, tau, lil, liu),
             ("NaN in ln(1/delta_L)", counts, tau, nan_lil, liu)]
    cases += [(f"V={n}", counts[:n], tau, lil[:n], liu[:n])
              for n in STOPCHECK_SHAPES]
    err = 0.0
    for name, c, t, lo, up in cases:
        args = (c.contiguous(), t, lo.contiguous(), up.contiguous(), omega)
        got, want = stopcheck_fused(*args), stopcheck_ref(*args)
        torch.cuda.synchronize()
        err = max(err, same_bits(f"stopcheck {name}", got, want))
    args = (counts, tau, lil, liu, omega)
    ms = cuda_time_ms(lambda: stopcheck_fused(*args), 200)
    plain = cuda_time_ms(lambda: stopcheck_ref(*args), 50)
    b_ms, b_by = bound(3 * 4 * v + 2 * 4, STOPCHECK_OPS * v)
    # the two kernels' own device time, without the host's enqueue
    from torch.profiler import ProfilerActivity, profile
    calls = 50
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            stopcheck_fused(*args)
        torch.cuda.synchronize()
    device_ms = sum(
        evt.self_device_time_total for evt in prof.key_averages()
        if evt.device_type == torch.autograd.DeviceType.CUDA
        and "stopcheck" in evt.key) / 1e3 / calls
    log(f"  stopcheck: {ms * 1e3:.2f} us per call ({device_ms * 1e3:.2f} us "
        f"of it in its two kernels), plain {plain * 1e3:.2f} us, bound "
        f"{b_ms * 1e3:.2f} us ({b_by}); no single PyTorch call computes "
        "[max f, max g]")
    return {"max_abs_err": err, "ms": ms, "device_ms": device_ms,
            "plain_ms": plain,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "shape": f"V={v} float32 x 3 (R-MAT 2^{RMAT_SCALE} budgets)"}


def phase_forward(rmat) -> tuple:
    """Betweenness, closeness and harmonic on one forward stream over the
    R-MAT graph; returns the result and the run's launch counts."""
    import numpy as np
    from repro_torch.core import AdaptiveConfig, run_adaptive
    from repro_torch.kernels.frontier import FLAT
    config = AdaptiveConfig(eps=FWD_EPS, delta=MAIN_DELTA,
                            sample_batch_size=BATCH,
                            max_epochs=FWD_MAX_EPOCHS)
    reset_counts()
    t0 = time.perf_counter()
    res = run_adaptive(rmat, FWD_METRICS, config=config, seed=SEED,
                       stream="forward", device=DEVICE)
    seconds = time.perf_counter() - t0
    counts = read_counts("forward", FLAT, res.bfs_levels,
                         len(FWD_METRICS) * res.n_epochs)
    t_samp = res.phase_seconds["sampling"]
    log(f"  forward: {seconds:.1f} s, phases "
        + ", ".join(f"{k} {v:.2f} s" for k, v in res.phase_seconds.items())
        + f"; epochs {res.n_epochs}, samples {res.tau} "
        f"({res.tau / t_samp:.1f}/s), vertex diameter "
        f"{res.vertex_diameter}, BFS levels {res.bfs_levels}, launches "
        f"{counts}")
    for rep in res.reports:
        log(f"  {rep.name}: tau {rep.tau}, omega {rep.omega:.1f}, converged "
            f"{rep.converged}, stop_epoch {rep.stop_epoch}")
        if rep.scores.shape != (rmat.n_nodes,) \
                or not np.isfinite(rep.scores).all():
            raise AssertionError(f"forward {rep.name}: scores not finite of "
                                 f"shape ({rmat.n_nodes},)")
        if not (rep.converged or rep.tau >= rep.omega):
            raise AssertionError(f"forward {rep.name}: neither converged "
                                 f"nor at omega (max_epochs {FWD_MAX_EPOCHS})")
    bet = res.reports[0].scores
    if (bet < 0).any() or (bet > 1).any():
        raise AssertionError("forward betweenness: scores outside [0, 1]")
    return res, counts


def dense_distances(graph):
    """All-pairs hop distances on the host (scipy), inf when unreached."""
    import numpy as np
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import shortest_path
    n = graph.n_nodes
    indptr = graph.indptr.cpu().numpy()
    indices = graph.indices.cpu().numpy()[: indptr[-1]]
    adj = csr_matrix((np.ones(indices.size, np.int8), indices, indptr),
                     shape=(n, n))
    return shortest_path(adj, method="D", unweighted=True)


def phase_distance_accuracy() -> dict:
    """Closeness and harmonic on a connected Erdos-Renyi graph against
    scipy's exact distances (the bounds of tests/test_estimators.py)."""
    import numpy as np
    from repro_torch.core import erdos_renyi_graph, run_adaptive
    from repro_torch.kernels.frontier import FLAT
    for seed in range(SEED, SEED + 20):
        graph = erdos_renyi_graph(ER_N, ER_DEGREE, seed=seed, device=DEVICE)
        d = dense_distances(graph)
        if np.isfinite(d).all():
            break
    else:
        raise AssertionError("no connected Erdos-Renyi instance in 20 seeds")
    n = graph.n_nodes
    reset_counts()
    res = run_adaptive(graph, ("closeness", "harmonic"), eps=ER_EPS,
                       delta=0.1, seed=SEED, device=DEVICE)
    counts = read_counts("er", FLAT, res.bfs_levels, 2 * res.n_epochs)
    clo, har = res.reports
    exact_clo = (n - 1) / d.sum(axis=0)
    rel = float((np.abs(clo.scores - exact_clo) / exact_clo).max())
    corr_clo = float(np.corrcoef(clo.scores, exact_clo)[0, 1])
    dh = d.copy()
    np.fill_diagonal(dh, np.inf)
    exact_har = (1.0 / dh).sum(axis=0) / (n - 1)
    err_har = float(np.abs(har.scores - exact_har).max())
    corr_har = float(np.corrcoef(har.scores, exact_har)[0, 1])
    log(f"  ER({n}, seed {seed}): tau {clo.tau}/{har.tau}, epochs "
        f"{res.n_epochs}; closeness max rel err {rel:.4f} corr "
        f"{corr_clo:.5f}; harmonic max err {err_har:.5f} corr "
        f"{corr_har:.5f}; launches {counts}")
    if not (clo.converged and har.converged and rel < 0.15
            and corr_clo > 0.99 and err_har < 2 * ER_EPS
            and corr_har > 0.99):
        raise AssertionError("closeness/harmonic outside the oracle bounds")
    return counts


def order_bound(ids, seg, w, table, n_segments: int):
    """Per-element bound on the gap between two float32 sums of the same
    terms in different orders: each lies within (n_s - 1) u sum|terms|
    of the exact sum (recursive summation, any order or tree), so two lie
    within 2 n_s u sum|terms| of each other, n_s the segment's entries."""
    import torch
    from repro_torch.kernels.segsum import gather_segment_sum_ref
    deg = torch.bincount(seg.long(), minlength=n_segments).float()[:, None]
    return 2.0 * deg * U32 * gather_segment_sum_ref(
        ids, seg, w.abs(), table.float().abs(), n_segments)


def check_segsum_call(label: str, ids, seg, w, n_segments: int, n_rows: int,
                      d: int, plan) -> float:
    """One call shape of the gather-segment-sum kernel against its plain
    version: integer-valued table and weights (bitwise), an N(0, 1)
    float32 table and a bfloat16 one (within the order bound; for
    bfloat16 plus one rounding of each side, 2^-8 relative).  Returns the
    largest float32 gap."""
    import torch
    from repro_torch.kernels.segsum import (gather_segment_sum_cuda,
                                            gather_segment_sum_ref)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 3)
    table = torch.randint(-8, 9, (n_rows, d), generator=gen, device=DEVICE,
                          dtype=torch.float32)
    w_int = torch.randint(0, 4, w.shape, generator=gen, device=DEVICE,
                          dtype=torch.float32)
    got = gather_segment_sum_cuda(ids, seg, w_int, table, n_segments, plan)
    want = gather_segment_sum_ref(ids, seg, w_int, table, n_segments)
    torch.cuda.synchronize()
    if not bool(want.abs().max() < EXACT_LIMIT):
        raise AssertionError(f"segsum {label}: integer sums not exact")
    if not torch.equal(got, want):
        raise AssertionError(f"segsum {label} integer-valued: not bitwise "
                             f"(max |diff| {float((got - want).abs().max())})")
    log(f"  segsum {label}, integer-valued float32: bitwise equal to its "
        "plain version")
    err32 = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        table = torch.randn((n_rows, d), generator=gen, device=DEVICE,
                            dtype=torch.float32).to(dtype)
        got = gather_segment_sum_cuda(ids, seg, w, table, n_segments,
                                      plan).float()
        want = gather_segment_sum_ref(ids, seg, w, table, n_segments).float()
        tol = order_bound(ids, seg, w, table, n_segments)
        if dtype == torch.bfloat16:
            tol = tol + U_BF16 * (2.0 * want.abs() + tol)
        gap = (got - want).abs()
        ratio = float((gap / tol.clamp(min=1e-30)).max())
        err = float(gap.max())
        if not bool((gap <= tol).all()):
            raise AssertionError(f"segsum {label} {dtype}: max |diff| {err} "
                                 f"beyond its bound (ratio {ratio:.3g})")
        log(f"  segsum {label}, N(0,1) {str(dtype)[6:]}: max |diff| {err:.3g}"
            f", within the order bound (largest bound {float(tol.max()):.3g},"
            f" largest gap/bound {ratio:.3g})")
        if dtype == torch.float32:
            err32 = err
        del got, want, tol, gap, table
    return err32


def phase_segsum(batch, d: int) -> dict:
    """The gather-segment-sum kernel at the GraphSAGE layer's shapes: the
    forward call (ids=src, seg=dst, w=edge mask, an (N, d) table) and its
    transposed backward call, each checked; the forward one timed."""
    import torch
    from repro_torch.kernels.segsum import (gather_segment_sum_cuda,
                                            gather_segment_sum_ref)
    n, v = batch.n_edges, batch.n_nodes
    t0 = time.perf_counter()
    plan = batch.segment_plan()
    torch.cuda.synchronize()
    log(f"  segment plans (src->dst and its transpose) built in "
        f"{time.perf_counter() - t0:.2f} s: {plan.split_seg.shape[0]} of {v} "
        f"segments above {plan.split} entries, cut into {plan.n_items} items;"
        f" largest segment {int(torch.diff(plan.offsets).max())} entries")
    err = max(
        check_segsum_call("forward", batch.src, batch.dst, batch.edge_mask,
                          v, v, d, plan),
        check_segsum_call("backward", batch.dst, batch.src, batch.edge_mask,
                          v, v, d, plan.transpose))
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 4)
    table = torch.randn((v, d), generator=gen, device=DEVICE)
    args = (batch.src, batch.dst, batch.edge_mask, table, v)
    ms = cuda_time_ms(lambda: gather_segment_sum_cuda(*args, plan), 20)
    back_ms = cuda_time_ms(lambda: gather_segment_sum_cuda(
        batch.dst, batch.src, batch.edge_mask, table, v, plan.transpose), 20)
    plain = cuda_time_ms(lambda: gather_segment_sum_ref(*args), 3)
    # the library yardstick: the plan's (S, V1) CSR matrix of weights
    csr = torch.sparse_csr_tensor(plan.offsets, plan.ids_sorted.long(),
                                  batch.edge_mask[plan.order], (v, v),
                                  check_invariants=True)
    lib = torch.sparse.mm(csr, table)
    want = gather_segment_sum_ref(*args)
    torch.cuda.synchronize()
    lib_err = float((lib - want).abs().max())
    del lib, want
    lib_ms = cuda_time_ms(lambda: torch.sparse.mm(csr, table), 10)
    b_ms, b_by = bound(12.0 * n + 2.0 * v * d * 4, 2.0 * n * d)
    gather_ms = n * d * 4 / HBM_BYTES_PER_S * 1e3
    log(f"  segsum: {ms:.3f} ms forward call ({back_ms:.3f} ms transposed), "
        f"plain {plain:.3f} ms, torch.sparse.mm {lib_ms:.3f} ms (max |diff| "
        f"vs plain {lib_err:.3g}), bound {b_ms:.3f} ms ({b_by}); one table "
        f"row read per entry would take {gather_ms:.3f} ms at the HBM rate")
    return {"max_abs_err": err, "ms": ms, "transposed_ms": back_ms,
            "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib_ms,
            "shape": f"R-MAT 2^{GNN_SCALE} x {GNN_EDGE_FACTOR}: N={n} "
                     f"entries, V1=S={v}, D={d} float32"}


def clone_tree(tree):
    from repro_torch.tree import tree_map
    return tree_map(lambda t: t.detach().clone(), tree)


def segsum_only(label: str, want: int) -> dict:
    """The launch counts of a GraphSAGE run: ``want`` gather-segment-sum
    launches and no other kernel."""
    from repro_torch.kernels.segsum import SEGSUM
    counts = all_counts()
    others = sum(v for k, v in counts.items() if k != SEGSUM)
    if counts[SEGSUM] != want or others:
        raise AssertionError(f"{label}: expected {want} gather-segment-sum "
                             f"launches and no other kernel, got {counts}")
    return counts


def check_first_step(logits, plain_logits, loss, plain_loss, params,
                     plain_params, m, plain_m, opt) -> None:
    """The kernel route's forward and first step against the plain
    route's: logits, loss, each leaf's gradient (m = (1 - b1) g after one
    step) at GNN_GRAD_RTOL of its largest entry, and each parameter within
    lr |dg| / eps of the other (plus float32 rounding)."""
    import torch
    from repro_torch.tree import tree_leaves
    logit_gap = float((logits - plain_logits).abs().max())
    grad_ratio, param_excess, param_gap = 0.0, 0.0, 0.0
    for p, pp, g, gp in zip(tree_leaves(params), tree_leaves(plain_params),
                            tree_leaves(m), tree_leaves(plain_m)):
        g, gp = g / (1.0 - opt.b1), gp / (1.0 - opt.b1)
        grad_ratio = max(grad_ratio, float((g - gp).abs().max())
                         / max(float(gp.abs().max()), 1e-30))
        # plus the float32 rounding of both routes' update, ~6 u each
        allowed = opt.lr * (g - gp).abs() / opt.eps \
            + 16 * U32 * (pp.abs() + opt.lr)
        gap = (p - pp).abs()
        param_gap = max(param_gap, float(gap.max()))
        param_excess = max(param_excess, float((gap / allowed).max()))
    log(f"  kernel route vs plain route: logits max |diff| {logit_gap:.3g} "
        f"(rtol {GNN_LOGIT_RTOL}, atol {GNN_LOGIT_ATOL}); first-step loss "
        f"{loss:.7f} vs {plain_loss:.7f} (rtol {GNN_LOSS_RTOL}); gradients: "
        f"largest gap {grad_ratio:.3g} of its leaf's largest entry (limit "
        f"{GNN_GRAD_RTOL}); params after the step: max |diff| "
        f"{param_gap:.3g}, at most {param_excess:.3g} of the lr |dg| / eps "
        "bound")
    if not (torch.allclose(logits, plain_logits, rtol=GNN_LOGIT_RTOL,
                           atol=GNN_LOGIT_ATOL)
            and abs(loss - plain_loss) <= GNN_LOSS_RTOL * abs(plain_loss)
            and grad_ratio <= GNN_GRAD_RTOL and param_excess <= 1.0):
        raise AssertionError("graphsage: kernel route and plain route "
                             "disagree beyond the stated tolerances")


def phase_graphsage(cfg, batch) -> dict:
    """graphsage-reddit at full width on the R-MAT batch: inference
    forward, then GNN_STEPS AdamW steps, counts read around each run; the
    plain route's forward and first step held against the kernel's; one
    step profiled.  Returns the path's launch counts."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    from repro_torch.models.gnn import sage_forward, sage_init, sage_loss
    from repro_torch.optim import AdamWConfig, init_state
    from repro_torch.train import make_train_step
    params0 = sage_init(torch.Generator().manual_seed(SEED), cfg,
                        device=DEVICE)
    opt = AdamWConfig()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # a first forward pays the process's one-time library set-up
    t0 = time.perf_counter()
    with torch.no_grad():
        sage_forward(params0, batch, cfg)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    reset_counts()
    t0 = time.perf_counter()
    with torch.no_grad():
        logits = sage_forward(params0, batch, cfg)
    torch.cuda.synchronize()
    fwd_s = time.perf_counter() - t0
    fwd = segsum_only("graphsage forward", cfg.n_layers)
    if logits.shape != (batch.n_nodes, cfg.n_classes) \
            or not bool(torch.isfinite(logits).all()):
        raise AssertionError("graphsage: logits not finite of shape "
                             f"({batch.n_nodes}, {cfg.n_classes})")
    log(f"  inference forward: {fwd_s:.3f} s (the first one {first_s:.3f} s),"
        f" logits {tuple(logits.shape)}, launches {fwd}")

    step = make_train_step(lambda p, b: sage_loss(p, b, cfg), opt)
    params, state = params0, init_state(params0)
    reset_counts()
    losses, step_s = [], []
    for i in range(GNN_STEPS):
        t0 = time.perf_counter()
        params, state, metrics = step(params, state, batch)
        losses.append(float(metrics["loss"]))
        step_s.append(time.perf_counter() - t0)
        if i == 0:
            params1, state1 = clone_tree(params), clone_tree(state)
    # each step: one launch per layer forward and one per layer backward
    train = segsum_only("graphsage train", 2 * cfg.n_layers * GNN_STEPS)
    peak = torch.cuda.max_memory_allocated()
    if not np.isfinite(losses).all():
        raise AssertionError(f"graphsage: loss not finite: {losses}")
    log(f"  {GNN_STEPS} AdamW steps: "
        + ", ".join(f"{s:.3f} s" for s in step_s) + "; loss "
        + ", ".join(f"{x:.6f}" for x in losses)
        + f"; launches {train}; peak memory {peak / 2**30:.2f} GiB "
        f"(torch.cuda.max_memory_allocated)")

    # two more steps under the profiler, the first as its warm-up (the
    # trace can miss kernels launched as it starts): device time by
    # kernel and idle share of the second
    torch.cuda.synchronize()
    traced = []    # the active step's events, handed over as it ends
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                 on_trace_ready=lambda p: traced.append(p.key_averages())
                 ) as prof:
        for _ in range(2):
            t0 = time.perf_counter()
            step(params, state, batch)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
            prof.step()
    # (the step marker's device-side range spans the others: left out)
    rows = [(evt.self_device_time_total / 1e3, evt.count, evt.key)
            for evt in traced[-1]
            if evt.device_type == torch.autograd.DeviceType.CUDA
            and not evt.key.startswith("ProfilerStep")]
    busy = sum(r[0] for r in rows)
    k4 = sum(r[0] for r in rows if "segsum" in r[2])
    k4_calls = sum(r[1] for r in rows if "segsum_kernel<" in r[2])
    log(f"  profile of one step: wall {wall_ms:.1f} ms, device busy "
        f"{busy:.1f} ms, idle share {1 - busy / wall_ms:.3f}; the "
        f"gather-segment-sum kernels {k4:.1f} ms, {k4 / max(busy, 1e-9):.1%} "
        f"of device time ({k4_calls} segsum_kernel launches traced)")
    for ms, calls, key in sorted(rows, reverse=True)[:8]:
        log(f"  {ms:9.2f} ms {ms / max(busy, 1e-9):6.1%} x{calls:<6d} "
            f"{key[:80]}")
    del params, state

    # the same forward and first step on the plain route, on the card
    reset_counts()
    with torch.no_grad():
        plain_logits = sage_forward(params0, batch, cfg, use_kernel=False)
    plain_step = make_train_step(
        lambda p, b: sage_loss(p, b, cfg, use_kernel=False), opt)
    plain_params1, plain_state1, plain_m = plain_step(
        params0, init_state(params0), batch)
    torch.cuda.synchronize()
    segsum_only("graphsage plain route", 0)
    check_first_step(logits, plain_logits, losses[0],
                     float(plain_m["loss"]), params1, plain_params1,
                     state1["m"], plain_state1["m"], opt)
    return {k: fwd[k] + train[k] for k in fwd}


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
    from repro_torch.configs._families import GNN_SHAPES
    from repro_torch.configs.graphsage_reddit import (cfg_for_shape,
                                                      make_config)
    from repro_torch.data import graph_to_batch
    from repro_torch.kernels.frontier import FLAT, NODE_BLOCKED
    from repro_torch.kernels.segsum import SEGSUM
    from repro_torch.kernels.stopcheck import STOPCHECK
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
    paths = {}   # path -> its run's launch counts

    log(f"[4] main path: run_kadabra R-MAT 2^{RMAT_SCALE} x {EDGE_FACTOR}, "
        f"B={BATCH}, eps={MAIN_EPS}, delta={MAIN_DELTA}, max_epochs "
        f"{MAIN_MAX_EPOCHS}")
    res, paths["rmat_bidir"] = drive(
        "rmat", rmat, FLAT, MAIN_EPS, MAIN_DELTA, sample_batch_size=BATCH,
        max_epochs=MAIN_MAX_EPOCHS)
    if not res.converged:
        log(f"  the epoch cap {MAIN_MAX_EPOCHS} was hit: converged=False")
    phase_profile("rmat", rmat, 4, BATCH)
    rows.append({"name": STOPCHECK, "route": "cuda",
                 "source": "src/repro_torch/kernels/stopcheck/csrc/"
                           "stopcheck.cu",
                 "replaces": "src/repro/kernels/stopcheck/kernel.py:45",
                 "launches": 0,
                 **phase_stopcheck(rmat, res.vertex_diameter, res.tau)})
    torch.cuda.empty_cache()

    log(f"[5] node-blocked path: run_kadabra on a {GRID_SIDE} x {GRID_SIDE} "
        f"grid with a CSC layout, eps={GRID_EPS}")
    grid = with_csc_layout(grid_graph(GRID_SIDE, GRID_SIDE, device=DEVICE))
    rows[1].update(phase_grid_kernel(grid))
    _res, paths["grid"] = drive("grid", grid, NODE_BLOCKED, GRID_EPS, 0.1)
    phase_profile("grid", grid, 2, GRID_BATCH)
    del grid

    log(f"[6] accuracy: run_kadabra on hyperbolic({HYPER_N}) vs exact "
        f"Brandes, eps={HYPER_EPS}")
    hyper = hyperbolic_graph(HYPER_N, seed=SEED, device=DEVICE)
    res, paths["hyperbolic"] = drive("hyperbolic", hyper, FLAT, HYPER_EPS,
                                     0.1)
    exact = brandes_numpy(hyper)
    err = float(np.abs(res.btilde - exact).max())
    log(f"  max |b~ - b| = {err:.5f} (eps {HYPER_EPS})")
    if not err < HYPER_EPS:
        raise AssertionError(f"hyperbolic: max error {err} >= {HYPER_EPS}")

    log(f"[7] forward path: run_adaptive {FWD_METRICS} on R-MAT "
        f"2^{RMAT_SCALE} x {EDGE_FACTOR}, stream='forward', B={BATCH}, "
        f"eps={FWD_EPS}, delta={MAIN_DELTA}, max_epochs {FWD_MAX_EPOCHS}")
    res, paths["forward"] = phase_forward(rmat)
    phase_profile("forward", rmat, 2, BATCH, metrics=FWD_METRICS,
                  stream="forward", vertex_diameter=res.vertex_diameter)
    del rmat
    torch.cuda.empty_cache()

    log(f"[8] accuracy: closeness and harmonic on a connected ER({ER_N}) "
        f"vs scipy's exact distances, eps={ER_EPS}")
    paths["er"] = phase_distance_accuracy()

    t0 = time.perf_counter()
    gnn = rmat_graph(GNN_SCALE, GNN_EDGE_FACTOR, seed=SEED, device=DEVICE)
    cfg = cfg_for_shape(make_config(), GNN_SHAPES[GNN_CELL])
    batch = graph_to_batch(gnn, d_feat=cfg.d_in, n_classes=cfg.n_classes,
                           seed=SEED, device=DEVICE)
    torch.cuda.synchronize()
    log(f"[9] gather-segment-sum kernel at the GraphSAGE path's shapes: "
        f"R-MAT 2^{GNN_SCALE} x {GNN_EDGE_FACTOR}, V={batch.n_nodes} "
        f"E={batch.n_edges} (graph and batch built in "
        f"{time.perf_counter() - t0:.1f} s), D={cfg.d_hidden}")
    del gnn
    rows.append({"name": SEGSUM, "route": "cuda",
                 "source": "src/repro_torch/kernels/segsum/csrc/segsum.cu",
                 "replaces": "src/repro/kernels/segsum/kernel.py:54",
                 "launches": 0, **phase_segsum(batch, cfg.d_hidden)})
    torch.cuda.empty_cache()

    log(f"[10] GraphSAGE: graphsage-reddit (n_layers {cfg.n_layers}, "
        f"d_hidden {cfg.d_hidden}, {cfg.aggregator}) on the {GNN_CELL} cell's "
        f"d_feat {cfg.d_in} and {cfg.n_classes} classes: one inference "
        f"forward, {GNN_STEPS} AdamW steps")
    paths["graphsage"] = phase_graphsage(cfg, batch)
    del batch
    torch.cuda.empty_cache()

    # each row's launches: the run of the path that row's kernel carries
    for row, main_path in zip(rows, ("rmat_bidir", "grid", "forward",
                                     "graphsage")):
        row["launches"] = paths[main_path][row["name"]]
        row["launches_by_path"] = {k: c[row["name"]]
                                   for k, c in paths.items()}
    log(f"[11] total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
