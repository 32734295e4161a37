#!/usr/bin/env python3
"""On-card smoke of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card and ``nvcc``; exits non-zero without them, and on
any failed phase.  Phases:

1. the device: name, count, and ``nvidia-smi`` name and power limit;
2. build the frontier, stop-check, gather-segment-sum and
   flash-attention kernels from their ``csrc/`` sources (one nvcc each,
   started together; sm_90a) and print the build seconds and the
   ``ptxas`` register, spill, shared-memory and warning lines;
3. hold each kernel against its plain PyTorch version at main-path
   shapes (one mid-BFS level of R-MAT 2^20 x 30, B=64): the flat route
   (the words pass, then the pull over the graph's in-edge plan, its hub
   rows cut into items and combined), bitwise, and twice on non-integer
   sigma, which must give the same bits (the pull's order is fixed);
   ``cuobjdump -sass`` must show no atomic in ``frontier_pull_kernel``
   (and some in ``frontier_nb_kernel``, the check's control); then on a
   CSC layout at the card's blocking the node-blocked route's
   frontier-words kernel and its whole level (the words pass, then the
   node-blocked kernel).  Bitwise while the sums are exact integers
   below 2^24, else rtol 1e-6 (atomics add in a varying order).  Times
   each wrapper a call with CUDA events after warm-up, as the path calls
   it, and beside it each of its kernels' device time from the profiler,
   its plain version, the byte bound and ``torch.sparse.mm`` (the
   library yardstick, called only here);
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
5. a second path through the node-blocked route: a 256 x 256 grid with
   a CSC layout.  Its two kernels were held against their plain versions
   and timed at the grid's own shapes at the start of [3] (one mid-BFS
   level, B=8, before any profiler session, which leaves overhead on
   later launches: these are the node-blocked row's numbers, the R-MAT
   ones stay beside them); here ``run_kadabra`` runs at eps=0.05 (every
   level one words launch and one node-blocked launch), then two of its
   rounds under the profiler;
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
   plain route held against the kernel route's;
11. the flash-attention kernel (K5): the ptxas lines of its bfloat16
   (wgmma + TMA) kernels and their HGMMA and UTMALDG counts from
   ``cuobjdump -sass``; then K5 against its plain version at the serving
   path's shape: q (2, 32768, 24, 128), k and v (2, 32768, 8, 128),
   bfloat16, causal, within 2e-2 (P is rounded to bfloat16 before P V)
   and per row, with a stale-ring-slot control; then float32 at (1,
   4096, 24/8, 128) within 3e-5 and a ragged non-causal (1, 1000, 6/2,
   64).  Each timed (and its TFLOP/s) beside its plain version, its
   bound and ``scaled_dot_product_attention`` (the library yardstick,
   called only here, on KV heads repeated beforehand);
12. llama3.2-3b serving at full width and depth in bfloat16 (3.61e9
   parameters drawn on the card): a prefill of 2 prompts of 32768
   tokens (the prefill_32k cell's length; its batch of 32 is cut to 2,
   since 32 caches of 3.76 GB exceed the card), every layer's attention
   through K5 (28 launches), cold and warm; the cache grown by 32 and
   32 greedy decode steps (no K5); a decode step and a warm prefill
   under the profiler;
   then the kernel route against the plain route end to end in float32
   on one 2048-token prompt; then the smoke config (float32, head dim
   16) prefilled through K5 against the CPU's plain route.

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
BF16_OPS_PER_S = 989e12       # H100 SXM bf16 tensor cores, dense
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
# flash attention: (B, S, H, KV, dh) of the serving path, a float32 case
# and a ragged non-causal one; tolerances of the JAX sweep
# (tests/test_flashattn_kernel.py): 2e-2 in bfloat16 (P rounded to
# bfloat16 before P V, both outputs rounded), 3e-5 in float32
FLASH_SHAPE = (2, 32768, 24, 8, 128)
FLASH_F32_SHAPE = (1, 4096, 24, 8, 128)
FLASH_RAGGED_SHAPE = (1, 1000, 6, 2, 64)
FLASH_TOL = {"bfloat16": 2e-2, "float32": 3e-5}
# bfloat16 is also held per output row: for every (b, s, h), ||got -
# want|| / ||want|| over dh at most FLASH_ROW_REL.  A causal row over n
# keys has |out| ~ 1/sqrt(n), so the absolute 2e-2 only binds the first
# rows.  Sound, the gap is P's and the outputs' rounding to bfloat16 (u
# = 2^-8): at most 4.1e-3 in a CPU emulation of the kernel's rounding
# at S = 4096 and 32768 (tools/flash_bf16_emulation.py).  The kernel's
# K/V tiles hold FLASH_KV_TILE keys in a ring of FLASH_KV_STAGES slots,
# so a consumer that reads a slot before its refill lands sees the tile
# FLASH_KV_STAGES before: keys 256-383 read as keys 0-127, which moves
# every row past them by 4.5e-2 or more at S = 32768 in the same
# emulation.  Each run reads both (the control through the plain
# version on the altered K and V) and checks that the limit lies
# between them.
FLASH_ROW_REL = 1e-2
FLASH_KV_TILE, FLASH_KV_STAGES = 128, 2
# llama3.2-3b serving: prefill_32k's length, its batch cut from 32 to 2
# (32 caches of 3.76 GB exceed the card's 80 GB), 32 decode steps
LLAMA_BATCH, LLAMA_PROMPT, LLAMA_GEN = 2, 32768, 32
# the kernel route against the plain route, float32 weights, one prompt:
# the two attentions differ by summation order (~1e-6 relative a layer,
# 3e-5 at most, the float32 tolerance of the kernel), carried through 28
# layers' residual stream, norms and the head.  Held at 1e-3 of the
# largest plain logit: ~100x the gap such order differences leave on
# the CPU parity tests' two layers, and far below the O(1) gaps of a
# wrong mask, head mapping or tile
LLAMA_F32_PROMPT, LLAMA_F32_RTOL = 2048, 1e-3
# the same in bfloat16, with the float32 weights rounded to bfloat16
# values so that the float32 plain route computes the bfloat16 model
# without rounding: every matmul, norm and attention output rounds on
# both routes, and the kernel also rounds P.  The kernel route's logits
# must lie within LLAMA_BF16_RATIO times the plain route's relative L2
# distance from the float32 logits.  In a CPU emulation of the kernel's
# rounding (narrow llama, 4 and 8 layers; tools/flash_bf16_emulation.py)
# the ratio was 0.95 and 1.10; a stale KV tile in every layer made it
# 40-55
LLAMA_BF16_RATIO = 1.5
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


def bound(n_bytes: float, n_ops: float,
          ops_per_s: float = FP32_OPS_PER_S) -> tuple:
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = n_ops / ops_per_s * 1e3
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
        same = "; bitwise equal" if torch.equal(got, want) else ""
        log(f"  {name}: within rtol {RTOL} (max |diff| {err}{same})")
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
    from repro_torch.kernels.flashattn import kernel as flashattn
    from repro_torch.kernels.frontier import kernel as frontier
    from repro_torch.kernels.segsum import kernel as segsum
    from repro_torch.kernels.stopcheck import kernel as stopcheck
    t0 = time.perf_counter()
    libs = {"frontier": frontier.library, "stopcheck": stopcheck.library,
            "segsum": segsum.library, "flashattn": flashattn.library}
    with ThreadPoolExecutor(len(libs)) as pool:
        for fut in [pool.submit(build) for build in libs.values()]:
            fut.result()
    log(f"[2] built {len(libs)} sources in "
        f"{time.perf_counter() - t0:.2f} s")
    for name in libs:
        report = _build.build_report(name)
        log(f"  {name}.cu: nvcc {report['seconds']:.2f} s")
        for line in report["ptxas"].splitlines():
            if any(w in line for w in ("registers", "Compiling entry",
                                       "spill", "arning")):
                log(f"  ptxas: {line.strip()}")


def cuobjdump_path() -> str:
    """The toolkit's ``cuobjdump``, else the copy in Triton's package."""
    import shutil
    found = shutil.which("cuobjdump")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/cuobjdump")
    if cand.exists():
        return str(cand)
    import triton
    return str(Path(triton.__file__).parent / "backends/nvidia/bin/cuobjdump")


def sass_ops(name: str, ops=("HGMMA", "UTMALDG")) -> dict:
    """Per kernel of the built library ``name``: how many SASS
    instructions have each of ``ops`` as their opcode (the part before
    the first dot; ``cuobjdump -sass``)."""
    import re
    from repro_torch.kernels import _build
    sass = subprocess.run(
        [cuobjdump_path(), "-sass", _build.build_report(name)["path"]],
        capture_output=True, text=True, check=True, timeout=300).stdout
    insn = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                      r"([A-Z][A-Z0-9_]*)")
    found, func = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            func = line.split("Function :")[1].strip()
            found[func] = dict.fromkeys(ops, 0)
        elif func is not None:
            m = insn.search(line)
            if m and m.group(1) in found[func]:
                found[func][m.group(1)] += 1
    return found


# opcodes of global and shared-memory atomics and reductions on sm_90
ATOMIC_OPS = ("RED", "REDG", "REDAS", "ATOM", "ATOMG", "ATOMS")


def atomics_in(kernel: str) -> int:
    """SASS atomic and reduction instructions in every instantiation of
    the frontier library's ``kernel``."""
    return sum(sum(n.values()) for f, n in sass_ops(
        "frontier", ATOMIC_OPS).items() if kernel in f)


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
    """The flat route (words pass, pull, combine) against its plain
    version on the COO edges, over the graph's in-edge plan: bitwise, the
    same bits twice on non-integer sigma, no atomic in the pull's SASS;
    the wrapper timed a call, each kernel's device time from the
    profiler."""
    import torch
    from repro_torch.kernels.frontier import (frontier_expand_batched_ref,
                                              frontier_expand_flat)
    v1, batch = graph.n_nodes + 1, dist.shape[1]
    t0 = time.perf_counter()
    plan = graph.pull_plan()
    torch.cuda.synchronize()
    counts = torch.diff(plan.offsets)
    log(f"  pull plan built in {time.perf_counter() - t0:.2f} s: "
        f"{plan.split_seg.shape[0]} of {v1} rows above {plan.split} in-edges,"
        f" cut into {plan.n_items} items; largest row "
        f"{int(counts.max())} in-edges")
    args = (graph.src, graph.dst, dist, sigma, levels, plan)
    got = frontier_expand_flat(*args)
    want = frontier_expand_batched_ref(graph.src, graph.dst, dist, sigma,
                                       levels)
    torch.cuda.synchronize()
    err = compare("frontier_flat", got, want)
    del got, want
    gen = torch.Generator(device=dist.device).manual_seed(SEED + 8)
    noisy = (sigma * (0.5 + torch.rand(sigma.shape, generator=gen,
                                       device=dist.device))).contiguous()
    first = frontier_expand_flat(graph.src, graph.dst, dist, noisy, levels,
                                 plan)
    again = frontier_expand_flat(graph.src, graph.dst, dist, noisy, levels,
                                 plan)
    want = frontier_expand_batched_ref(graph.src, graph.dst, dist, noisy,
                                       levels)
    torch.cuda.synchronize()
    if not torch.equal(first, again):
        raise AssertionError("frontier_flat: two launches on non-integer "
                             "sigma gave different bits")
    # two float32 sums of a row's n non-negative terms in different orders
    # lie within 2 n u of their sum of each other (order_bound); the hub
    # rows' n ~ 1e5 put that far beyond RTOL
    tol = 2.0 * counts[:, None].float() * U32 * want
    gap = (first - want).abs()
    noisy_err = float(gap.max())
    if not bool((gap <= tol).all()):
        raise AssertionError(f"frontier_flat, non-integer sigma: max |diff| "
                             f"{noisy_err} beyond the order bound")
    log(f"  frontier_flat: two launches on non-integer sigma, the same "
        f"bits; max |diff| {noisy_err:.3g} from the plain version, largest "
        f"gap/bound {float((gap / tol.clamp(min=1e-30)).max()):.3g}")
    del noisy, first, again, want, tol, gap
    atomics = {k: atomics_in(k) for k in ("frontier_pull_kernel",
                                          "frontier_pull_combine_kernel",
                                          "frontier_nb_kernel")}
    log(f"  cuobjdump -sass atomic and reduction instructions "
        f"({'/'.join(ATOMIC_OPS)}): {atomics}")
    pull_atomics = atomics["frontier_pull_kernel"] \
        + atomics["frontier_pull_combine_kernel"]
    if pull_atomics or not atomics["frontier_nb_kernel"]:
        raise AssertionError("the pull's SASS holds an atomic, or the "
                             "node-blocked kernel's none (the control)")
    ms = cuda_time_ms(lambda: frontier_expand_flat(*args), 20)
    names = ("frontier_words_kernel", "frontier_pull_kernel",
             "frontier_pull_combine_kernel")
    device = kernel_device_ms(lambda: frontier_expand_flat(*args), 20, names)
    plain = cuda_time_ms(lambda: frontier_expand_batched_ref(
        graph.src, graph.dst, dist, sigma, levels), 3)
    # the bytes of the route's own inputs: the plan (sources in
    # destination order, row offsets, the split rows' item tables; the
    # COO src/dst are not read during a level), dist and sigma read once,
    # out written once
    plan_bytes = sum(t.numel() * t.element_size() for t in (
        plan.ids_sorted, plan.offsets, plan.item_begin, plan.item_end,
        plan.split_seg, plan.split_first))
    b_ms, b_by = bound(plan_bytes + v1 * batch * 12,
                       2.0 * graph.e_pad * batch)
    log(f"  frontier_flat: plan {plan_bytes} bytes, state {v1 * batch * 12}"
        f" bytes")
    log(f"  frontier_flat: {ms:.3f} ms a call; device time "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in device.items())
        + f"; plain {plain:.3f} ms, bound {b_ms:.3f} ms ({b_by})")
    return {"max_abs_err": err, "noisy_max_abs_err": noisy_err, "ms": ms,
            "words_device_ms": device["frontier_words_kernel"],
            "pull_device_ms": device["frontier_pull_kernel"],
            "combine_device_ms": device["frontier_pull_combine_kernel"],
            "sass_atomics": atomics["frontier_pull_kernel"],
            "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": library_ms(graph, dist, sigma, levels)}


def kernel_device_ms(fn, calls: int, names) -> dict:
    """Device time a call of each kernel whose name holds one of
    ``names``, from ``calls`` calls of ``fn`` under the profiler (after
    one untraced call)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    found = dict.fromkeys(names, 0.0)
    for evt in prof.key_averages():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            for name in names:
                if name in evt.key:
                    found[name] += evt.self_device_time_total / 1e3 / calls
    return found


def check_node_blocked(graph, csc, dist, sigma, levels) -> dict:
    """The node-blocked route against its plain versions on ``csc``,
    with the state at csc.v_pad rows: the words kernel and the level
    (words pass + ``frontier_nb_kernel``), bitwise.  The wrapper is
    timed a call as the path calls it (two launches, allocations
    included); beside it each kernel's device time from the profiler."""
    import torch
    from repro_torch.kernels.frontier import (
        WORDS, frontier_block_bitmap, frontier_expand_node_blocked,
        frontier_expand_node_blocked_ref, frontier_words,
        frontier_words_ref, launch_counts)
    batch = dist.shape[1]
    n_active = int(frontier_block_bitmap(csc, dist, levels).sum())
    before = launch_counts[WORDS]
    words, zeros = frontier_words(dist, levels)
    torch.cuda.synchronize()
    if launch_counts[WORDS] != before + 1 or not torch.equal(
            words, frontier_words_ref(dist, levels)) or bool(zeros.any()):
        raise AssertionError("frontier_words: not bitwise equal to its "
                             "plain version")
    log(f"  frontier_words: bitwise equal to its plain version "
        f"({words.shape[1]} word(s) a row, "
        f"{int((words != 0).any(dim=1).sum())} frontier rows)")
    del words, zeros
    got = frontier_expand_node_blocked(csc, dist, sigma, levels)
    want = frontier_expand_node_blocked_ref(csc, dist, sigma, levels)
    torch.cuda.synchronize()
    err = compare("frontier_node_blocked", got, want)
    del got, want
    ms = cuda_time_ms(lambda: frontier_expand_node_blocked(
        csc, dist, sigma, levels), 20)
    device = kernel_device_ms(lambda: frontier_expand_node_blocked(
        csc, dist, sigma, levels), 20, ("frontier_words_kernel",
                                        "frontier_nb_kernel"))
    plain = cuda_time_ms(lambda: frontier_expand_node_blocked_ref(
        csc, dist, sigma, levels), 3)
    b_ms, b_by = bound(n_active * csc.block_e * 8 + csc.v_pad * batch * 12,
                       2.0 * n_active * csc.block_e * batch)
    log(f"  frontier_node_blocked: {ms:.3f} ms a call ({n_active}/"
        f"{csc.n_edge_blocks} edge blocks active); device time "
        f"frontier_words_kernel {device['frontier_words_kernel']:.4f} ms, "
        f"frontier_nb_kernel {device['frontier_nb_kernel']:.4f} ms; plain "
        f"{plain:.3f} ms, bound {b_ms:.4f} ms ({b_by})")
    return {"max_abs_err": err, "ms": ms,
            "words_device_ms": device["frontier_words_kernel"],
            "nb_device_ms": device["frontier_nb_kernel"],
            "active_blocks": n_active, "plain_ms": plain, "bound_ms": b_ms,
            "bound_by": b_by,
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
    log(f"[3] node-blocked route at the grid's shapes (before any profiler "
        f"run): {GRID_SIDE} x {GRID_SIDE} grid, V={grid.n_nodes} "
        f"B={GRID_BATCH} rows={dist.shape[0]} block_v={csc.block_v} "
        f"block_e={csc.block_e}, levels {levels.tolist()}")
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
    from repro_torch.kernels import flashattn, frontier, segsum, stopcheck
    frontier.reset_launch_counts()
    stopcheck.reset_launch_counts()
    segsum.reset_launch_counts()
    flashattn.reset_launch_counts()


def all_counts() -> dict:
    from repro_torch.kernels import flashattn, frontier, segsum, stopcheck
    return {**frontier.launch_counts, **stopcheck.launch_counts,
            **segsum.launch_counts, **flashattn.launch_counts}


def read_counts(label: str, kernel_name: str, bfs_levels: int,
                stop_checks: int) -> dict:
    """The launch counts of the run just made: the named frontier kernel
    carried every level, each with its words pass, and
    the stop-check kernel every stop check; the
    gather-segment-sum and flash-attention kernels have no part in a
    centrality run."""
    from repro_torch.kernels import flashattn, frontier, segsum, stopcheck
    counts = all_counts()
    if counts[segsum.SEGSUM] != 0 or counts[flashattn.FLASHATTN] != 0:
        raise AssertionError(f"{label}: the gather-segment-sum or "
                             "flash-attention kernel ran in a centrality "
                             f"run: {counts}")
    fr = dict(frontier.launch_counts)
    # a level of either route is two launches: its words pass and the
    # route's kernel
    if fr[kernel_name] == 0 or fr[kernel_name] != bfs_levels \
            or fr[frontier.WORDS] != bfs_levels \
            or sum(fr.values()) != 2 * bfs_levels:
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


def profile_twice(fn) -> tuple:
    """``fn`` twice under the profiler, the first as its warm-up (a trace
    can miss kernels launched as it starts): the second run's device-side
    (ms, count, name) rows and its wall ms.  The step marker's device
    range spans the others and is left out."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    traced = []    # the active run's events, handed over as it ends
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                 on_trace_ready=lambda p: traced.append(p.key_averages())
                 ) as prof:
        for _ in range(2):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
            prof.step()
    rows = [(evt.self_device_time_total / 1e3, evt.count, evt.key)
            for evt in traced[-1]
            if evt.device_type == torch.autograd.DeviceType.CUDA
            and not evt.key.startswith("ProfilerStep")]
    return rows, wall_ms


def clone_tree(tree):
    from repro_torch.tree import tree_map
    return tree_map(lambda t: t.detach().clone(), tree)


def kernel_only(label: str, name: str, want: int) -> dict:
    """The launch counts of a model run: ``want`` launches of the kernel
    ``name`` and no other kernel."""
    counts = all_counts()
    others = sum(v for k, v in counts.items() if k != name)
    if counts[name] != want or others:
        raise AssertionError(f"{label}: expected {want} {name} launches and "
                             f"no other kernel, got {counts}")
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
    from repro_torch.kernels.segsum import SEGSUM
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
    fwd = kernel_only("graphsage forward", SEGSUM, cfg.n_layers)
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
    train = kernel_only("graphsage train", SEGSUM,
                        2 * cfg.n_layers * GNN_STEPS)
    peak = torch.cuda.max_memory_allocated()
    if not np.isfinite(losses).all():
        raise AssertionError(f"graphsage: loss not finite: {losses}")
    log(f"  {GNN_STEPS} AdamW steps: "
        + ", ".join(f"{s:.3f} s" for s in step_s) + "; loss "
        + ", ".join(f"{x:.6f}" for x in losses)
        + f"; launches {train}; peak memory {peak / 2**30:.2f} GiB "
        f"(torch.cuda.max_memory_allocated)")

    # two more steps under the profiler: device time by kernel and idle
    # share of the second
    rows, wall_ms = profile_twice(lambda: step(params, state, batch))
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
    kernel_only("graphsage plain route", SEGSUM, 0)
    check_first_step(logits, plain_logits, losses[0],
                     float(plain_m["loss"]), params1, plain_params1,
                     state1["m"], plain_state1["m"], opt)
    return {k: fwd[k] + train[k] for k in fwd}


def flash_cost(shape, causal: bool, elem: int) -> tuple:
    """(bytes, operations) of one attention call: q, k, v read once and
    the output written once; 4 dh operations for every (query, key)
    pair the mask keeps (q . k and p v), the causal triangle
    S (S + 1) / 2 a head."""
    b, s, h, kv, dh = shape
    pairs = s * (s + 1) / 2 if causal else s * s
    return (2 * b * s * (h + kv) * dh * elem, 4.0 * b * h * pairs * dh)


def flash_inputs(shape, dtype, seed: int):
    import torch
    b, s, h, kv, dh = shape
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    return [torch.randn((b, s, n, dh), generator=gen, device=DEVICE,
                        dtype=torch.float32).to(dtype) for n in (h, kv, kv)]


def row_rel_err(got, want):
    """||got - want|| / ||want|| over the last axis, in float32."""
    g, w = got.float(), want.float()
    return (g - w).norm(dim=-1) / w.norm(dim=-1).clamp_min(1e-30)


def check_flash_rows(label: str, q, k, v, got, want, causal: bool) -> dict:
    """The bfloat16 output held per row within FLASH_ROW_REL, and a
    control: the plain version with KV tile FLASH_KV_STAGES read as tile
    0 (a consumer reading a ring slot before its refill), which must lie
    beyond it in every row that sees the whole stale tile."""
    import torch
    from repro_torch.kernels.flashattn import flash_attention_gqa_ref
    sound = float(row_rel_err(got, want).max())
    lo = FLASH_KV_STAGES * FLASH_KV_TILE
    past = lo + FLASH_KV_TILE
    k2, v2 = k.clone(), v.clone()
    k2[:, lo:past], v2[:, lo:past] = k[:, :FLASH_KV_TILE], v[:, :FLASH_KV_TILE]
    bad = flash_attention_gqa_ref(q, k2, v2, causal=causal)[:, past:]
    del k2, v2
    control = float(row_rel_err(bad, want[:, past:]).min())
    tol = FLASH_TOL["bfloat16"]
    passes_abs = ["passes" if torch.allclose(
        bad[:, r:].float(), want[:, past + r:].float(), rtol=tol, atol=tol)
        else "fails" for r in (0, 4096 - past)]
    del bad
    log(f"  flash {label}: per-row ||diff|| / ||plain|| at most {sound:.4g} "
        f"(limit {FLASH_ROW_REL}); control with a stale ring slot (keys "
        f"{lo}-{past - 1} read as 0-{FLASH_KV_TILE - 1}): at least "
        f"{control:.4g} in every row from {past} on; it {passes_abs[0]} the "
        f"absolute check, and {passes_abs[1]} it on rows 4096 and on")
    if not sound <= FLASH_ROW_REL < control:
        raise AssertionError(f"flash {label}: per-row gap {sound} or the "
                             f"stale-slot control {control} on the wrong "
                             f"side of {FLASH_ROW_REL}")
    return {"row_rel_err": sound, "stale_tile_row_rel_err_min": control}


def check_flash_case(label: str, shape, dtype, causal: bool, seed: int,
                     iters: int) -> dict:
    """K5 against its plain version on N(0, 1) inputs within the dtype's
    tolerance (and bfloat16 per row too, with its control); then timed
    beside the plain version, the bound and
    ``scaled_dot_product_attention`` on KV heads repeated beforehand."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flashattn import (flash_attention_cuda,
                                               flash_attention_gqa_ref)
    b, s, h, kv, dh = shape
    q, k, v = flash_inputs(shape, dtype, seed)
    got = flash_attention_cuda(q, k, v, causal=causal)
    want = flash_attention_gqa_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()
    tol = FLASH_TOL[str(dtype)[6:]]
    gap = (got.float() - want.float()).abs()
    err = float(gap.max())
    excess = float((gap / (tol + tol * want.float().abs())).max())
    del gap
    if not torch.allclose(got.float(), want.float(), rtol=tol, atol=tol):
        raise AssertionError(f"flash {label}: max |diff| {err} beyond atol "
                             f"= rtol = {tol}")
    rows = (check_flash_rows(label, q, k, v, got, want, causal)
            if dtype == torch.bfloat16 else {})
    ms = cuda_time_ms(lambda: flash_attention_cuda(q, k, v, causal=causal),
                      iters)
    plain = cuda_time_ms(lambda: flash_attention_gqa_ref(q, k, v,
                                                         causal=causal), 1)
    qt = q.transpose(1, 2)
    kt = k.repeat_interleave(h // kv, dim=2).transpose(1, 2)
    vt = v.repeat_interleave(h // kv, dim=2).transpose(1, 2)
    lib = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
    torch.cuda.synchronize()
    lib_err = float((lib.transpose(1, 2).float() - want.float()).abs().max())
    del got, want, lib
    lib_ms = cuda_time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=causal), iters)
    n_bytes, n_ops = flash_cost(shape, causal, q.element_size())
    b_ms, b_by = bound(n_bytes, n_ops, BF16_OPS_PER_S
                       if dtype == torch.bfloat16 else FP32_OPS_PER_S)
    tflops = n_ops / ms / 1e9
    log(f"  flash {label} {str(dtype)[6:]} {'causal' if causal else 'full'}"
        f" (B, S, H/KV, dh) = ({b}, {s}, {h}/{kv}, {dh}): max |diff| "
        f"{err:.3g} (atol = rtol = {tol}; largest gap / allowed "
        f"{excess:.3g}); {ms:.3f} ms ({tflops:.1f} TFLOP/s), plain "
        f"{plain:.3f} ms, scaled_dot_product_attention {lib_ms:.3f} ms (max "
        f"|diff| vs plain {lib_err:.3g}), bound {b_ms:.3f} ms ({b_by})")
    return {"max_abs_err": err, "ms": ms, "tflops": tflops,
            "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib_ms, **rows,
            "shape": f"(B, S, H/KV, dh) = ({b}, {s}, {h}/{kv}, {dh}) "
                     f"{str(dtype)[6:]}, {'causal' if causal else 'full'}"}


def phase_flash() -> dict:
    """K5 at the serving path's shape (bfloat16, causal), then float32
    and a ragged non-causal case."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.flashattn.kernel import SOURCE
    dh = FLASH_SHAPE[4]
    tiles = (1 + 2 * FLASH_KV_STAGES) * FLASH_KV_TILE * dh * 2
    log(f"  dynamic shared memory a block: bfloat16 {tiles} bytes of tiles "
        f"(+ barriers and 1024-byte alignment), float32 "
        f"{(64 * (dh + 1) * 2 + 64 * dh + 64 * 65) * 4} bytes at dh={dh} "
        f"({SOURCE.name})")
    ptxas = _build.build_report("flashattn")["ptxas"].splitlines()
    for i, line in enumerate(ptxas):
        if "Compiling entry" in line and "flash_bf16_kernel" in line:
            log(f"  ptxas: {line.strip()}")
            log(f"  ptxas: {' | '.join(x.strip() for x in ptxas[i + 1:i + 4])}")
    ops = {f: n for f, n in sass_ops("flashattn").items()
           if "flash_bf16_kernel" in f}
    for func, counts in ops.items():
        log(f"  cuobjdump -sass: {func}: {counts}")
    if len(ops) != 2 or not all(n["HGMMA"] and n["UTMALDG"]
                                for n in ops.values()):
        raise AssertionError(f"flash_bf16_kernel lacks HGMMA or UTMALDG: {ops}")
    row = check_flash_case("serving", FLASH_SHAPE, torch.bfloat16, True,
                           SEED + 5, 5)
    torch.cuda.empty_cache()
    f32 = check_flash_case("float32", FLASH_F32_SHAPE, torch.float32, True,
                           SEED + 6, 3)
    ragged = check_flash_case("ragged", FLASH_RAGGED_SHAPE, torch.float32,
                              False, SEED + 7, 20)
    torch.cuda.empty_cache()
    return {**row, **{f"float32_{k}": v for k, v in f32.items()},
            **{f"ragged_{k}": v for k, v in ragged.items()}}


def finite_logits(label: str, logits, batch: int, cfg) -> None:
    import torch
    if logits.shape != (batch, cfg.vocab_pad) \
            or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{label}: logits not finite of shape "
                             f"({batch}, {cfg.vocab_pad})")


def profile_serving(label: str, fn) -> None:
    """Device time by kernel of ``fn``'s second run under the profiler
    (K5, the GEMMs, the rest) and its idle share."""
    rows, wall_ms = profile_twice(fn)
    busy = sum(r[0] for r in rows)
    k5 = sum(r[0] for r in rows if "flash_bf16_kernel" in r[2])
    k5_calls = sum(r[1] for r in rows if "flash_bf16_kernel" in r[2])
    gemm = sum(r[0] for r in rows if any(
        w in r[2].lower() for w in ("gemm", "xmma", "cutlass", "nvjet")))
    share = 1.0 / max(busy, 1e-9)
    log(f"  profile of one {label}: wall {wall_ms:.1f} ms, device busy "
        f"{busy:.1f} ms, idle share {1 - busy / wall_ms:.3f}; K5 {k5:.1f} ms "
        f"({k5 * share:.1%}, {k5_calls} launches traced), GEMMs {gemm:.1f} ms"
        f" ({gemm * share:.1%}), the rest {busy - k5 - gemm:.1f} ms "
        f"({(busy - k5 - gemm) * share:.1%})")
    for ms, calls, key in sorted(rows, reverse=True)[:10]:
        log(f"  {ms:9.2f} ms {ms * share:6.1%} x{calls:<6d} {key[:80]}")


def rel_l2(got, want) -> float:
    return float((got.float() - want.float()).norm() / want.float().norm())


def check_routes(cfg) -> None:
    """Full width and depth, one prompt prefilled through K5 and through
    the dispatcher's plain route, on weights drawn in float32 and
    rounded to bfloat16 values.  Float32: last-token logits within
    LLAMA_F32_RTOL of the largest plain logit.  Bfloat16: the kernel
    route within LLAMA_BF16_RATIO of the plain route's relative L2
    distance from the float32 plain logits.  In both, the argmax equal
    unless the plain route's top-2 gap could be closed by the gap
    allowed (float32) or seen (bfloat16)."""
    import dataclasses
    import torch
    from repro_torch.kernels.flashattn import FLASHATTN
    from repro_torch.models.transformer import init_params, prefill_step
    from repro_torch.tree import tree_leaves, tree_map
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 8)
    params = init_params(gen, cfg32, device=DEVICE)
    for leaf in tree_leaves(params):
        leaf.copy_(leaf.to(torch.bfloat16))
    prompt = torch.randint(0, cfg.vocab, (1, LLAMA_F32_PROMPT), generator=gen,
                           device=DEVICE)

    def both_routes(params, c, label):
        reset_counts()
        got, _ = prefill_step(params, prompt, c)
        torch.cuda.synchronize()
        kernel_only(f"{label} kernel route", FLASHATTN, cfg.n_layers)
        reset_counts()
        want, _ = prefill_step(params, prompt, c, use_kernel=False)
        torch.cuda.synchronize()
        kernel_only(f"{label} plain route", FLASHATTN, 0)
        finite_logits(f"{label} kernel route", got, 1, cfg)
        top2 = torch.topk(want[0].float(), 2).values
        return got, want, float(top2[0] - top2[1])

    with torch.no_grad():
        got, want, top_gap = both_routes(params, cfg32, "float32")
        tol = LLAMA_F32_RTOL * float(want.abs().max())
        gap = float((got - want).abs().max())
        same_argmax = int(got.argmax()) == int(want.argmax())
        log(f"  kernel route vs plain route, float32, 1 x {LLAMA_F32_PROMPT}: "
            f"last-token logits max |diff| {gap:.3g} (tolerance {tol:.3g} = "
            f"{LLAMA_F32_RTOL} of the largest |logit| "
            f"{float(want.abs().max()):.3g}"
            f"); argmax {int(got.argmax())} vs {int(want.argmax())} (plain "
            f"top-2 gap {top_gap:.3g})")
        if gap > tol or not (same_argmax or top_gap < tol):
            raise AssertionError("llama float32: kernel route and plain "
                                 "route disagree beyond the stated "
                                 "tolerance")
        exact = want
        params = tree_map(lambda x: x.to(torch.bfloat16), params)
        got, want, top_gap = both_routes(params, cfg, "bfloat16")
    e_kernel, e_plain = rel_l2(got, exact), rel_l2(want, exact)
    gap = float((got.float() - want.float()).abs().max())
    same_argmax = int(got.argmax()) == int(want.argmax())
    log(f"  kernel route vs plain route, bfloat16, 1 x {LLAMA_F32_PROMPT}: "
        f"last-token logits' relative L2 distance from the float32 plain "
        f"route {e_kernel:.4g} (kernel) vs {e_plain:.4g} (plain), ratio "
        f"{e_kernel / e_plain:.3g} (limit {LLAMA_BF16_RATIO}); kernel vs "
        f"plain {rel_l2(got, want):.4g}, max |diff| {gap:.3g}; argmax "
        f"{int(got.argmax())} vs {int(want.argmax())} (plain top-2 gap "
        f"{top_gap:.3g})")
    if e_kernel > LLAMA_BF16_RATIO * e_plain \
            or not (same_argmax or top_gap < 2 * gap):
        raise AssertionError("llama bfloat16: kernel route and plain route "
                             "disagree beyond the stated tolerance")


def check_smoke_config() -> None:
    """``make_smoke_config()`` (float32, head dim 16): a prefill on the
    card through K5, one launch a layer, against the CPU's plain route
    within the float32 tolerance of the LM tests (1e-4)."""
    import torch
    from repro_torch.configs.llama3_2_3b import make_smoke_config
    from repro_torch.kernels.flashattn import FLASHATTN
    from repro_torch.models.transformer import init_params, prefill_step
    from repro_torch.tree import tree_map
    cfg = make_smoke_config()
    params = init_params(torch.Generator().manual_seed(SEED), cfg,
                         device="cpu")
    tokens = torch.randint(0, cfg.vocab, (4, 96),
                           generator=torch.Generator().manual_seed(SEED))
    with torch.no_grad():
        want, _ = prefill_step(params, tokens, cfg)
        reset_counts()
        got, _ = prefill_step(tree_map(lambda x: x.to(DEVICE), params),
                              tokens.to(DEVICE), cfg)
        torch.cuda.synchronize()
    counts = kernel_only("smoke config prefill", FLASHATTN, cfg.n_layers)
    gap = float((got.cpu() - want).abs().max())
    log(f"  smoke config ({cfg.n_layers} layers, head dim {cfg.hd}, "
        f"{str(cfg.dtype)[6:]}) prefill 4 x 96 on the card: logits max "
        f"|diff| {gap:.3g} from the CPU's plain route; launches {counts}")
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)


def phase_llama() -> dict:
    """llama3.2-3b serving at full width and depth; returns the launch
    counts of the counted run (a warm prefill, then the decode)."""
    import torch
    from repro_torch.configs.llama3_2_3b import make_config
    from repro_torch.kernels.flashattn import FLASHATTN
    from repro_torch.models.transformer import (decode_step, grow_cache,
                                                init_params, prefill_step)
    from repro_torch.tree import tree_leaves
    cfg = make_config()
    b, s = LLAMA_BATCH, LLAMA_PROMPT
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    t0 = time.perf_counter()
    params = init_params(gen, cfg, device=DEVICE)
    prompt = torch.randint(0, cfg.vocab, (b, s), generator=gen, device=DEVICE)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(params))
    log(f"  {cfg.name}: {n_params} parameters ({cfg.dtype}) drawn on the card"
        f" in {time.perf_counter() - t0:.2f} s; prompt {b} x {s}")
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        # the process's first prefill pays cuBLAS set-up: reported as cold
        times = []
        for run in ("cold", "warm"):
            reset_counts()
            t0 = time.perf_counter()
            logits, cache = prefill_step(params, prompt, cfg)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            prefill = kernel_only(f"{run} prefill", FLASHATTN, cfg.n_layers)
            if run == "cold":
                del cache
        finite_logits("prefill", logits, b, cfg)
        log(f"  prefill {b} x {s}: cold {times[0]:.3f} s "
            f"({b * s / times[0]:.0f} tokens/s), warm {times[1]:.3f} s "
            f"({b * s / times[1]:.0f} tokens/s); launches {prefill}")

        cache = grow_cache(cache, LLAMA_GEN)
        tokens = torch.argmax(logits, -1)[:, None]
        ids = [tokens]
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(LLAMA_GEN):
            logits, cache = decode_step(params, cache, tokens, cfg)
            tokens = torch.argmax(logits, -1)[:, None]
            ids.append(tokens)
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
        decode = kernel_only("decode", FLASHATTN, 0)
        finite_logits("decode", logits, b, cfg)
        peak = torch.cuda.max_memory_allocated()
        gen_ids = torch.cat(ids, dim=1)
        log(f"  decode: {LLAMA_GEN} steps of {b} tokens from a cache of "
            f"{cache['k'].shape[2]} slots, "
            f"{decode_s / LLAMA_GEN * 1e3:.2f} ms "
            f"a step ({b * LLAMA_GEN / decode_s:.1f} tokens/s); launches "
            f"{decode}; cache at len {cache['len']}; peak memory "
            f"{peak / 2**30:.2f} GiB (torch.cuda.max_memory_allocated); "
            f"first ids {gen_ids[0, :8].tolist()} / {gen_ids[1, :8].tolist()}")
        # profiled steps rewrite the last two slots: the counted run is over
        profile_serving("decode step", lambda: decode_step(
            params, {**cache, "len": cache["len"] - 2}, tokens, cfg))
        del cache, logits
        torch.cuda.empty_cache()
        profile_serving("warm prefill", lambda: prefill_step(params, prompt,
                                                             cfg))
    del params
    torch.cuda.empty_cache()
    check_routes(cfg)
    torch.cuda.empty_cache()
    check_smoke_config()
    return {k: prefill[k] + decode[k] for k in prefill}


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
    from repro_torch.kernels.flashattn import FLASHATTN
    from repro_torch.kernels.frontier import FLAT, NODE_BLOCKED, WORDS
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
    # the grid's node-blocked level is timed first: a torch.profiler
    # session leaves overhead on every later launch in the process, and
    # this level is bound by its host time
    grid = with_csc_layout(grid_graph(GRID_SIDE, GRID_SIDE, device=DEVICE))
    grid_row = phase_grid_kernel(grid)
    rows = phase_kernels(rmat)
    rows[1].update(grid_row)
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

    log(f"[11] flash-attention kernel at the serving path's shapes: "
        f"(B, S, H, KV, dh) = {FLASH_SHAPE} bfloat16 causal, "
        f"{FLASH_F32_SHAPE} float32, {FLASH_RAGGED_SHAPE} non-causal")
    rows.append({"name": FLASHATTN, "route": "cuda",
                 "source": "src/repro_torch/kernels/flashattn/csrc/"
                           "flashattn.cu",
                 "replaces": "src/repro/kernels/flashattn/kernel.py:70",
                 "launches": 0, **phase_flash()})

    log(f"[12] llama3.2-3b serving: prefill {LLAMA_BATCH} x {LLAMA_PROMPT} "
        f"(prefill_32k's length, batch cut from 32), {LLAMA_GEN} decode "
        f"steps, bfloat16 at full width and depth")
    paths["llama_serve"] = phase_llama()

    # each row's launches: the run of the path that row's kernel carries;
    # the node-blocked row's words pass beside it
    for row, main_path in zip(rows, ("rmat_bidir", "grid", "forward",
                                     "graphsage", "llama_serve")):
        row["launches"] = paths[main_path][row["name"]]
        row["launches_by_path"] = {k: c[row["name"]]
                                   for k, c in paths.items()}
    # beside the launches of each frontier route, its words passes
    for row, main_path in zip(rows[:2], ("rmat_bidir", "grid")):
        row["words_launches"] = paths[main_path][WORDS]
        row["words_launches_by_path"] = {k: c[WORDS]
                                         for k, c in paths.items()}
    log(f"[13] total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
