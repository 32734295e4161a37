#!/usr/bin/env python3
"""On-card smoke of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card and ``nvcc``; exits non-zero without them, and on
any failed phase.  Phases:

1. the device: name, count, and ``nvidia-smi`` name and power limit;
2. build the frontier, weighted-lane (``relax.cu``), stop-check,
   gather-segment-sum and flash-attention kernels and the latter's
   backward (``flashattn_bwd.cu``) from their ``csrc/`` sources (one
   nvcc each,
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
   library yardstick, called only here).  The stop-check kernel is
   timed a call first, before the grid's level and any profiler
   session (1,000 calls back to back at V = 2^20);
4. the main path: ``run_kadabra`` on R-MAT 2^20 x 30, B=64, eps=0.01,
   delta=0.1 (``repro_torch.configs.betweenness``), no CSC layout, so
   every level goes through the flat kernel and every epoch's stop check
   through the stop-check kernel; then [15a] (below);
   then four of its sampling rounds under ``torch.profiler`` (device
   time by kernel, device idle share);
   then the stop-check kernel against its plain version at V = 2^20
   with the budgets of this graph's own calibration (bitwise, a NaN case
   and V = 1, 5000, 40000 included), and its device time a check and
   its launches a check (one) from the profiler (one trace of up to
   TRACE_TRIES with all 50, none with more), beside the byte bound;
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
   the layer's forward call and its transposed (backward) call, and the
   share of entries on the plans' hot sources.  Bitwise on
   integer-valued inputs; on N(0, 1) float32 and bfloat16 tables two
   calls give the same bits, within the summation-order bound stated in
   the output.  Timed beside its plain version, the byte bound (the
   plan's ids and offsets, the weights in plan order, the table and the
   output once) and ``torch.sparse.mm`` on the plan's (S, V1) CSR matrix
   (the library yardstick, called only here);
10. GraphSAGE (graphsage-reddit at full width, adapted to the
   ogb_products cell: d_feat 100, 47 classes) on that graph: one
   full-graph inference forward (after a warm-up one), then 3 AdamW
   steps, every neighbour mean through the kernel (2 launches a
   forward, 4 a step); then a step under the profiler (after a warm-up
   step); then the same forward and first step on the dispatcher's
   plain route held against the kernel route's;
11. the flash-attention kernel (K5): the ptxas lines of its kernels
   and, from ``cuobjdump -sass``, the HGMMA and UTMALDG counts of the
   bfloat16 ones (wgmma + TMA) and the HMMA counts of the float32 ones
   (split TF32 on ``mma.sync``), which must not spill; K5 bwd's
   (``flashattn_bwd``): every bfloat16 dK/dV and dQ kernel with HGMMA
   and UTMALDG and no spill, no atomic or reduction opcode in the
   library; then K5 against
   its plain version at the serving path's shape: q (2, 32768, 24, 128),
   k and v (2, 32768, 8, 128), bfloat16, causal, within 2e-2 (P is
   rounded to bfloat16 before P V) and per row, with a stale-ring-slot
   control (beyond the row limit in every 64-row slab); the same at granite-moe's prefill shape, head dim 64 (q (2,
   32768, 24, 64), k and v (2, 32768, 8, 64)); then float32 at (1, 4096, 24/8, 128) within 3e-5, with a
   control (the plain version on q, k, v rounded to TF32) that must lie
   beyond it, and a ragged non-causal (1, 1000, 6/2, 64).  Each timed
   (and its TFLOP/s) beside its plain version, its bound (float32: three
   TF32 products, and the float32 pipe's figure) and
   ``scaled_dot_product_attention`` (the library yardstick, called only
   here, on KV heads repeated beforehand);
12. llama3.2-3b serving at full width and depth in bfloat16 (3.61e9
   parameters drawn on the card): a prefill of 2 prompts of 32768
   tokens (the prefill_32k cell's length; its batch of 32 is cut to 2,
   since 32 caches of 3.76 GB exceed the card), every layer's attention
   through K5 (28 launches), cold and warm; the cache grown by 32 and
   32 greedy decode steps (no K5); a decode step and a warm prefill
   under the profiler;
   then the kernel route against the plain route end to end in float32
   on one 2048-token prompt; then the smoke config (float32, head dim
   16) prefilled through K5 against the CPU's plain route;
13. the whole run's seconds (printed last);
14. the sharded cooperative lane: R-MAT 2^20 x 30 partitioned into 8
   shards (the reference's mesh) at the card's blocking, all on the card
   (``ShardMesh``).  At one mid-BFS level: the node-blocked kernel in
   wide_state mode against its plain version on every shard (the
   per-shard route), and the sharded level call (one words pass over
   the gathered values, one node-blocked launch over the layout's real
   edge blocks, all 8 shards) against the stacked plain version
   (bitwise where the sums are exact integers, else rtol 1e-6); the
   level call timed beside its two kernels' device time and launches
   from the profiler (one each a level), the plain version, the
   whole-level byte bound, ``torch.sparse.mm`` on the stacked matrix and
   on each shard's, the per-shard route's 8 calls and the replicated
   node-blocked level, and the real blocks launched against 8 x
   n_edge_blocks; where a sharded level's time goes (exchange, the level
   call, the rest) beside the replicated flat level; one bidirectional
   batch against the replicated flat route (dist, d and split bitwise);
   ``run_kadabra`` on the partition (every level one level launch and
   one words pass, no flat or replicated node-blocked launch), then
   [15b] (below), two of its rounds under the profiler;
   hyperbolic(1000) in 8 shards within eps 0.05 of exact Brandes;
15. checkpointed resume at full size, in a temporary directory removed
   after: (a) right after [4], [4]'s run with ``checkpoint_dir`` stopped
   after 8 epochs, resumed with [4]'s config (btilde, tau and epochs
   bitwise [4]'s) and resumed again (no epoch drawn, the same result);
   (b) right after [14]'s run, the same stopped after 7 epochs, one byte
   of the newest step's first leaf flipped, resumed: the step is
   quarantined, the run falls back to step 6, whose leaves and
   generator state come back bitwise, and its result is [14]'s bits, or
   within 2 eps of them where a second uninterrupted run also differs.
   Each prints the bytes a step, the seconds a save blocks the loop, the
   background publish's and a restore's seconds; (a) also the replayed
   phases 1-2 and the checkpointed run's sampling seconds against [4]'s;
16. the SPMD lane, after [14] has freed its graphs: SPMD_RANKS ranks
   spawned (``repro_torch.launch.spawn_local``) on the one card in a gloo
   group over a ``FileStore`` (NCCL refuses two ranks on one card; gloo
   aggregates each frame in pinned host memory), a (2, 2) ("pod",
   "data") ``SamplerMesh``.  The ranks load the kernels this process
   built.  Each rank builds R-MAT 2^20 x 30 (its checksum the same on
   every rank) and runs (a) ``run_kadabra`` on the production cell in
   each of the hierarchical, flat and root aggregations: every rank's
   btilde, tau and epochs bitwise rank 0's, the three modes bitwise one
   another's, each converged; (b) on every rank its flat and words
   launches equal its BFS levels and its stop checks its epochs;
   (c) rank 0's seconds drawing, blocked in ``wait()`` and bytes staged,
   each epoch, and the run's seconds and max |b - b_[4]| beside [4]'s;
   (d) the hierarchical run stopped after RESUME_AT epochs and resumed,
   bitwise (a)'s; (e) hyperbolic(1000) within eps 0.05 of exact Brandes,
   then the same graph with dyadic weights on the weighted stream in the
   hierarchical mode: bitwise on every rank (and one distance cap),
   within eps 0.05 of exact weighted Brandes, every round one W1 launch
   and every DAG round one W2 launch.
   A rank that raises, or a group that outlasts SPMD_TIMEOUT, fails the
   smoke.  (f) In this process, a one-rank NCCL group runs the three
   aggregations on a (1, v_pad) frame on the card: bitwise its input,
   each timed;
17. the sharded cooperative lane over ``torch.distributed``, after [16]:
   R-MAT 2^20 x 30 cut into GROUP_SHARDS = 4 shards at the card's
   blocking, and 4 ranks spawned on the one card in a gloo group, each
   holding one shard (``partition_graph(graph, 4, shard=rank)`` on a
   ``GroupShardMesh``; CRC32 of its layout against the parent's whole
   partition's row) and loading the parent's kernel builds.  (a) One
   bidirectional and one forward batch of B pairs: every rank's
   gathered dist, d, split and levels bitwise the parent's
   ``ShardMesh(4)`` batches on the same sources (saved for the ranks
   in a temporary directory), sigma bitwise where an exact integer
   below 2^24, else within rtol 1e-6; every rank bitwise rank 0 (CRC32
   of the gathered state).  (b) Each rank's launches: one words pass
   and one node-blocked launch a level, no flat or replicated
   node-blocked launch, one K3 an epoch.  (c) Rank 0's level split into
   the exchange (occupancy bits, the pick, the chosen protocol's gathers,
   staged through pinned host memory), the level call (the card
   synchronized on both sides), the reductions and the rest; the levels
   taken dense and sparse, the bytes sent and staged a level by
   protocol, and the state's gather once a batch; the parent's
   ``ShardMesh(4)`` level on the same batch beside it.  (d)
   ``run_kadabra`` on the production cell stopped at GROUP_MAX_EPOCHS =
   1 epoch (calibration's 128 samples, then an epoch of n0 = 1,000):
   every rank bitwise rank 0, and bitwise the parent's ``ShardMesh(4)``
   run of the same config where two such runs are bitwise alike, else
   within 2 eps; each collective's calls, bytes and seconds.  The run to
   eps 0.01's stop rule is left out on purpose: at ~224 batches the
   once-a-batch gather of the state alone (4 tensors of v_pad x B x 4
   bytes, v_pad 1,114,112) is ~1.1 GB received a rank a batch, ~255 GB a
   rank a run through loopback TCP, minutes beyond the smoke's limit for
   no check that (d) does not make.  (e) hyperbolic(1000) in 4 ranks to
   its stop rule within eps 0.05 of exact Brandes; the same run stopped
   after one epoch and resumed, and resumed from a step written by the
   parent's ``ShardMesh(4)`` run, both bitwise, and bitwise that run;
   then one weighted batch of B on the same graph with dyadic weights,
   a shard a rank: dist, sigma, levels and buckets bitwise the parent's
   ``ShardMesh(4)`` batch, one W1 launch a round and one W2 a DAG round.
   A rank that raises, or a group that outlasts GROUP_TIMEOUT, fails
   the smoke.  (f) In this process, a one-rank NCCL group (the
   collectives on the card, nothing staged) runs one bidirectional
   batch on ``partition_graph(graph, 1, shard=0)``: dist, d and split
   bitwise the ``ShardMesh(1)`` batch, sigma as in (a);
18. the weighted delta-stepping lane, after [17]: R-MAT 2^20 x 30 with
   the JAX package's dyadic weights (``symmetric_dyadic_weights``, seed
   0), B=64.  (a) One batch from 64 seeded sources with a neighbour,
   its state captured half way through the relaxation rounds and half
   way through the DAG rounds: W1 (``relax_pull_kernel``, the min-plus
   round) bitwise its plain version there (min is exact), W2
   (``dag_sigma_pull_kernel``, one round of the DAG count) bitwise its
   plain version on the path's counts (exact integers) and, on
   non-integer sigma, the same bits twice within the summation-order
   bound; each timed a call beside its kernels' device time, its plain
   version and its bound (the plan, the weights and the state once at
   3.35 TB/s; no single PyTorch call computes either, so library
   null); the batch's distances from two sources bitwise scipy's
   Dijkstra; one batch under the profiler (W1 and W2 a round against
   the rest of the host loop).  (b) ``run_adaptive(...,
   stream="weighted")`` betweenness on it, single lane, eps
   WEIGHTED_EPS = 0.03 (cut from the cell's 0.01 to fit the phase; the
   log projects 0.01 from the measured seconds a sample), delta 0.1:
   every relaxation round one W1 launch, every DAG round one W2
   launch, one K3 a check, nothing else.  (e) One batch on
   ``ShardMesh(8)`` of the same graph: dist, levels and buckets bitwise
   the replicated batch, sigma bitwise where exact; one W1 launch a
   round over the 8 shards.  (c) A connected weighted ER(1500) at eps
   0.05 within eps of exact weighted Brandes (scipy Dijkstra and the
   distance-ordered DP, normalized by n(n-1), ``weighted_brandes``).
   (d) R5: the 64 x 64 grid with unit weights, delta 1, from corner 0:
   levels 126, the BFS lane's (through K1), dist and buckets equal, and
   sigma within 1e-5 relative of the BFS lane's;
19. the runtime (``repro_torch.runtime``), after [18]: (a) [4]'s run again
   with the telemetry bus on (a ring and a JSONL sink, every event
   validated): btilde, tau and epochs bitwise [4]'s, its launch counts
   [4]'s; the JSONL re-read and validated, its ``run.end`` tau and its
   ``epoch.stats`` count the result's; a Chrome trace written and
   parsed; its seconds beside [4]'s.  (b) ``ResilientRunner`` on the
   same run, ``checkpoint_every=1``, through kill at epoch 2, nan at 3,
   hang at 4 (RUNTIME_HANG s against an epoch timeout of
   RUNTIME_EPOCH_TIMEOUT s), corrupt at 5 and truncate at 6: every fault
   fired, btilde and tau bitwise [4]'s, the two damaged steps
   quarantined on disk, the event log naming InvariantViolation and
   EpochTimeoutError; each attempt's replayed phases 1-2 and re-run
   epochs, and the seconds a failure costs, logged.  (c) The ladder on
   one card: [14]'s R-MAT in 8 shards on ``ShardMesh(8)`` shrinks to 4
   shards at epoch 3, kills at 4 and 5 exhaust that rung (one retry) and
   it degrades to the single lane: within 2 eps of [4]'s btilde, the
   final run's tau never falling; hyperbolic(1000) in 8 shards the same
   way within HYPER_EPS of exact Brandes.  (d) The ladder across
   processes: RUNTIME_RANKS ranks spawned on the card in a gloo group,
   hyperbolic(1000) on ``GroupShardMesh(4)`` shrinks to 2 ranks at epoch
   2, kills degrade it to ``SamplerMesh(2)`` and then to the single
   lane: ranks 2-3 end in ``DeviceLoss``, ranks 0-1 bitwise alike and
   within HYPER_EPS of exact Brandes (a rank that raises anything else,
   or a group that outlasts GROUP_TIMEOUT, fails the smoke).  (e) Last,
   ``torch_profiler_trace`` around one hyperbolic(1000) run: its trace
   file parses, and its record count is logged;
20. the GNN cells, after [19]: (a) the molecule cell (128 molecules of
   30 atoms, each molecule's 32 closest atom pairs as edges both ways:
   8,192 edges, padded to 4,096 nodes; seeded positions, types and a
   pair-potential target).  K4 over the batch's edge plan (ids =
   arange(E), seg = dst) and its transpose at D = 3, 64, 288 and 1,152
   as in [9] (bitwise on integer inputs, N(0, 1) float32 and bfloat16
   within the order bound), timed at MACE's D = 1,152 beside its plain
   version, its bound and ``torch.sparse.mm``.  Then EGNN, NequIP and
   MACE at ``make_config()`` width and depth: a forward and MOL_STEPS =
   3 AdamW steps through K4 (launches a forward and a step asserted:
   EGNN 8 and 15, NequIP 5 and 10, MACE 2 and 4), the plain route's
   forward (every output within MOL_FWD_REL of its largest entry) and
   first step (loss, gradients, parameters as [10]) held against them,
   the energy of the batch rotated by ``random_rotation(7)`` within
   MOL_ROT_REL = 5e-4 of the largest; forward and step milliseconds and
   peak memory.  EGNN once more with ``agg_dtype="bf16"`` (K4 on a
   bfloat16 table): a forward and a step, its distance from the float32
   forward within MOL_BF16_REL.  (b) GraphSAGE (graphsage-reddit) on the
   minibatch_lg cell: ``NeighborSampler`` with 1,024 seeds and fanouts
   15-10 on R-MAT 2^18 x 16 with (2^18, 602) float32 features, which
   fills the cell's 169,984 nodes and 168,960 edges exactly; a forward
   and one AdamW step through K4 (2 and 4 launches), held against the
   plain route as [10];
21. MoE serving, qwen2 and MIND, after [20], each model freed before the
   next is drawn: (a) granite-moe-3b-a800m at full width and depth in
   bfloat16 (weights drawn on the card): a prefill of GRANITE_BATCH x
   GRANITE_PROMPT (prefill_32k's length, its batch cut to 2 as in [12]),
   cold and warm, every layer's attention through K5 (32 launches a
   prefill); the cache grown by GRANITE_GEN and as many greedy decode
   steps (no K5); one more prefill with every layer's routing recomputed
   beside it: the share of (token, slot) choices dropped by capacity, a
   layer; layer 0's float32 router probabilities routed on the card and
   on the CPU (expert ids, kept choices and slots bitwise, as drawn and
   rounded to multiples of 2^-6, where most tokens tie); then the kernel
   route against the plain route on one prompt of LLAMA_F32_PROMPT
   tokens, in float32 (logits within LLAMA_F32_RTOL) and in bfloat16
   (within LLAMA_BF16_RATIO), as [12].
   (b) moonshot-v1-16b-a3b at full width (56 GB of bfloat16 weights):
   1 x MOONSHOT_PROMPT and MOONSHOT_GEN decode steps, 48 K5 launches a
   prefill.  (c) qwen2-7b at full width: 1 x QWEN_PROMPT and QWEN_GEN
   decode steps, 28 K5 launches a prefill.  Each prints its prefill
   seconds and tokens/s, decode ms a step and peak memory.  (d) MIND at
   ``make_config()`` width (a 2^21 x 64 float32 table) with batches from
   ``recsys_batch_fn``: serve_p99 (512 users) and serve_bulk (262,144)
   through ``serve_interests`` and retrieval_cand (1 user x 1,000,448
   candidates) through ``retrieval_scores``, each timed with CUDA events
   after a warm-up; serve_p99 on the card within MIND_SERVE_REL of the
   CPU's on the same weights and batch; train_batch: MIND_STEPS AdamW
   steps at 65,536 through ``train/step.py``, the losses finite.  No kernel runs in (d);
22. gemma3-27b, after [21]: (a) K5's sliding-window mode (each query
   tile's KV loop from the first tile of its window, the tiles where a
   window begins masked) at gemma3's local layers' prefill shape, q (1,
   32768, 32, 128), k and v (1, 32768, 16, 128), bfloat16, window 1,024,
   against its windowed plain version within 2e-2 and per row within
   1e-2, with the stale-ring-slot control counted from each query tile's
   first KV tile (beyond the row limit in every 64-row slab); float32 at
   (1, 4096, 32/16, 128) within 3e-5 with its TF32 control; the ragged
   (1, 1000, 6/2, 64) in both types at windows 1, 100, 128 and 1,000.
   Each timed beside its plain version, its bound, the causal kernel on
   the same inputs and ``scaled_dot_product_attention`` with the band as
   a boolean mask (memory-efficient backend).  (b) gemma3-27b at full
   width and depth in bfloat16 (2.84e10 parameters, 52.9 GiB, drawn on
   the card): a prefill of 1 x 16,384 (62 K5 launches, 52 windowed), the
   cache grown by 8 and 8 greedy decode steps (no K5), then 1 x 32,768
   prefilled twice (first and warm) where its projected peak fits the
   card, else 16,384 with the reason printed; each prefill's seconds,
   tokens/s and peak memory.  (c) The kernel route against the plain
   route at full width on one period of 6 layers (5 local, 1 global),
   one prompt of 4,096 tokens: the plain route's local layers through
   ``masked_chunk_attention`` and, with ``attn_trapezoid``, through
   ``trapezoid_attention``; float32 within LLAMA_F32_RTOL and bfloat16
   within LLAMA_BF16_RATIO, as [12];
23. LM training, after [22]: (a) K5's backward kernel
   (``csrc/flashattn_bwd.cu``, built in [2] beside the others) against
   its plain backward in float32 on the same inputs (the kernel forward's
   output and logsumexp) at llama's train_4k layer (1, 4096, 24/8, 128)
   bfloat16 causal, gemma3's local layer (1, 4096, 32/16, 128) bfloat16
   window 1,024, float32 (1, 2048, 24/8, 128) causal and windowed, head
   dim 16 and the ragged (1, 1000, 6/2, 64) in both types at windows 1,
   100 and 1,000: dq, dk, dv within TRAIN_BWD_REL in relative L2, two
   calls the same bits, a control (the logsumexp shifted; a float32
   window off by one) beyond the limit; each timed beside the plain
   backward, its bound (five products over the kept pairs) and the
   backward of ``scaled_dot_product_attention``; K5's forward with its
   logsumexp output beside the serving call at [11]'s shape.  (c) The
   kernel route against the plain route at full width on 2 layers, one
   4,096-token batch: the loss and every leaf's gradient, float32 within
   LLAMA_F32_RTOL, bfloat16 within LLAMA_BF16_RATIO of the plain route's
   distance from float32.  (b) llama3.2-3b at full width and depth in
   bfloat16 through ``launch/train.py``'s path (3.61e9 parameters drawn
   on the card, the donating AdamW step, remat "full", 4,096 tokens):
   two sizing steps at batch 1 and 2 project the batch (train_4k's 256
   cut to what fits), then TRAIN_STEPS steps (56 K5 and 28 K5 bwd
   launches each, asserted), their losses, seconds, tokens/s and peak
   memory; a profiled step (device time by kernel, idle share); one step
   with loss_chunk 1,024 on the last step's weights and batch.  (d)
   ``examples/train_lm_torch.py``'s default run on the card (its loss
   must fall by more than 1.0), and 3 steps of the llama, gemma3 and
   granite smoke configs against the CPU's losses.

Every run resets the launch counts just before it and reads them just
after: each kernel of the run must have carried all of its work.

Then it prints the ``{"kernels": [...]}`` line, the card's name and
power limit, and as the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
FP32_OPS_PER_S = 67e12        # H100 SXM float32 outside the tensor cores
TF32_OPS_PER_S = 495e12       # H100 SXM TF32 tensor cores, dense
BF16_OPS_PER_S = 989e12       # H100 SXM bf16 tensor cores, dense
EXACT_LIMIT = float(1 << 24)  # float32 sums of integers are exact below
RTOL = 1e-6
U32 = 2.0 ** -24      # float32 unit roundoff
U_BF16 = 2.0 ** -8    # bfloat16 unit roundoff
SEED = 0
# the production cell, R-MAT 2^20 x 30 at eps 0.01, delta 0.1 and B = 64:
# set by load_main_config() from repro_torch.configs.betweenness
RMAT_SCALE = EDGE_FACTOR = BATCH = MAIN_EPS = MAIN_DELTA = None
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
STOPCHECK_CALLS = 1000                # back-to-back calls timed a call
TRACE_TRIES = 20      # traces taken at most for a launch count to show
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
# granite-moe's prefill ([21a]): the bfloat16 kernel at head dim 64
FLASH_DH64_SHAPE = (2, 32768, 24, 8, 64)
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
# the rows past them by 4.5e-2 or more at S = 32768 in the same
# emulation (its last 512 rows).  Such a read corrupts the
# FLASH_SLAB_ROWS query rows of one head that the reading consumer
# warpgroup owns, so the control must exceed the limit in at least one
# row of every such slab past the stale tile; the smallest gap over
# single rows is printed beside it (at head dim 64, a few of the 1.5e6
# rows of S = 32768 fall below 1e-2).  Each run reads both (the control
# through the plain version on the altered K and V) and checks that the
# limit lies between them.
FLASH_ROW_REL = 1e-2
FLASH_KV_TILE, FLASH_KV_STAGES, FLASH_SLAB_ROWS = 128, 2, 64
# the float32 route (flash_f32_kernel): q K^T and P V as three TF32
# products on the tensor cores (a = a_hi + a_lo; a_lo b_hi + a_hi b_lo +
# a_hi b_hi), so its least time is 3 x the operations over the TF32 rate;
# the float32 pipe's figure is logged beside it.  Its control: the plain
# version on q, k, v rounded to TF32, what one TF32 pass would see,
# which must lie beyond 3e-5 where the kernel lies within it (7-26x
# beyond at S 320 and 512 in tools/flash_f32_emulation.py).  A
# block owns FLASH_F32_ROWS query rows (Q tile in shared memory) and
# walks KV tiles of FLASH_F32_TILE keys in a ring of FLASH_F32_STAGES
FLASH_F32_PRODUCTS = 3
FLASH_F32_ROWS, FLASH_F32_TILE, FLASH_F32_STAGES = 128, 64, 2
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
# the sharded cooperative lane: the production graph in the reference's
# own mesh of 8 shards at the card's blocking (block_v 2^14: shard_rows
# 147,456, v_pad 1,179,648); hyperbolic(1000) in 8 shards of 128 rows
SHARDS = 8
HYPER_BLOCK_V = 128
# checkpointed resume: the replicated run stopped after 8 of [4]'s
# epochs, the sharded one after 7 of [14]'s, whose newest step then has
# one byte of its first leaf flipped
RESUME_AT, SHARDED_RESUME_AT = 8, 7
# the SPMD lane: 4 ranks sharing the one card in a gloo group (NCCL
# refuses two ranks on one card), on a (2, 2) ("pod", "data") mesh; a
# rank that raises, or a group that outlasts SPMD_TIMEOUT seconds, fails
# the smoke
SPMD_RANKS, SPMD_SHAPE, SPMD_AXES = 4, (2, 2), ("pod", "data")
SPMD_MODES = ("hierarchical", "flat", "root")
SPMD_TIMEOUT = 600
DEVICE = "cuda"
# the settings a spawned rank takes from the parent (it imports this
# script afresh)
SPMD_SETTINGS = ("DEVICE", "SEED", "RMAT_SCALE", "EDGE_FACTOR", "BATCH",
                 "MAIN_EPS", "MAIN_DELTA", "MAIN_MAX_EPOCHS", "RESUME_AT",
                 "HYPER_N", "HYPER_EPS", "SPMD_SHAPE", "SPMD_AXES",
                 "SPMD_MODES")
# the sharded lane over torch.distributed: the production graph in 4
# shards at the card's blocking, one a rank, the ranks spawned on the one
# card in a gloo group; (d) runs calibration and GROUP_MAX_EPOCHS epochs
# (phase [17]'s docstring says why not to the stop rule; one epoch, cut
# from two when [23] joined the smoke: the second took ~47 s of the
# smoke's 1,014 s on an NVIDIA H100 80GB HBM3 at 700.00 W, and (e) runs
# 3 epochs in the ranks); a rank that raises, or a group that outlasts
# GROUP_TIMEOUT seconds, fails the smoke
GROUP_SHARDS, GROUP_MAX_EPOCHS, GROUP_TIMEOUT = 4, 1, 400
# the weighted lane: the production graph with the JAX package's dyadic
# weights; its run at eps WEIGHTED_EPS, cut from the cell's 0.01 to fit
# the phase (the log projects the cell's eps from the measured rate); a
# weighted ER(ER_N) at WER_EPS against exact weighted Brandes; R5's unit
# grid of WGRID_SIDE^2
WEIGHTED_EPS, WER_EPS, WGRID_SIDE = 0.03, 0.05, 64
# the equivariant GNNs ([20]) on the molecule cell: MOL_GRAPHS molecules
# of MOL_ATOMS atoms, each with the MOL_EDGES // 2 closest atom pairs as
# edges both ways (a radius graph's edges, 8,192 in all), padded to the
# cell's 4,096 nodes; MOL_STEPS AdamW steps a model.  The kernel route
# is held against the plain route: the sums differ by order only, in
# segments of ~2 entries, carried through 2-5 layers (MACE's cubic B3
# included), so every output within MOL_FWD_REL of its tensor's largest
# entry, the first step's loss within MOL_LOSS_RTOL and its gradients as
# GraphSAGE's (GNN_GRAD_RTOL of each leaf's largest entry).  The energy
# of the batch rotated by random_rotation(7) within MOL_ROT_REL of the
# unrotated one's largest entry (the JAX test's 5e-4).  bf16 EGNN: its
# distance from the float32 forward within MOL_BF16_REL of each output's
# largest entry, the bound of its CPU test (there 3x the largest
# distance of 4 seeds at the smoke width; the CPU's plain route was
# 0.010 from float32 at this width and depth)
MOL_GRAPHS, MOL_ATOMS, MOL_EDGES, MOL_STEPS = 128, 30, 64, 3
MOL_FWD_REL, MOL_LOSS_RTOL, MOL_ROT_REL, MOL_BF16_REL = \
    1e-4, 1e-4, 5e-4, 0.05
# GraphSAGE on the minibatch_lg cell ([20b]): NeighborSampler's 1,024
# seeds at fanouts 15-10 on a seeded R-MAT of 2^SAMPLER_SCALE nodes x
# SAMPLER_EDGE_FACTOR, with (V, 602) float32 features on the host
SAMPLER_SCALE, SAMPLER_EDGE_FACTOR = 18, 16
SAMPLER_SEEDS, SAMPLER_FANOUTS = 1024, (15, 10)
# [21] MoE serving: granite at prefill_32k's length, its batch cut to 2
# (as [12]), 32 decode steps, the float32 route check on one prompt of
# LLAMA_F32_PROMPT; moonshot at batch 1 and a prompt of 4,096 (its 56 GB
# of weights and a 2 x 32k cache exceed the card); qwen2 at 1 x 32,768
GRANITE_BATCH, GRANITE_PROMPT, GRANITE_GEN = 2, 32768, 32
MOONSHOT_PROMPT, MOONSHOT_GEN = 4096, 8
QWEN_PROMPT, QWEN_GEN = 32768, 8
# MIND: AdamW steps at the train_batch cell, and serve_p99's interests
# on the card against the CPU within MIND_SERVE_REL of the largest entry
# (the same float32 expressions, summed in other orders)
MIND_STEPS, MIND_SERVE_REL = 3, 1e-5
# [22] gemma3-27b.  (a) K5's sliding-window mode at the shape of
# gemma3's local layers in a 32k prefill (B, S, H, KV, dh) =
# FLASH_WINDOW_SHAPE, bfloat16, window GEMMA_WINDOW, held as [11] holds
# the causal kernel (2e-2, each row within FLASH_ROW_REL, a stale-slot
# control per 64-row slab); float32 at FLASH_WINDOW_F32_SHAPE; the ragged
# FLASH_RAGGED_SHAPE in both types at the windows FLASH_WINDOW_RAGGED.
# (b) The model at full width and depth (52.9 GiB of bfloat16 weights):
# prefills of 1 x GEMMA_PROMPT (prefill_32k's length, its batch of 32
# cut to 1: one 32k cache is 15.5 GiB), first and again, and of 1 x
# GEMMA_DECODE_PROMPT before GEMMA_GEN greedy decode steps (cut from 32k:
# grow_cache holds two caches at once, 52.9 + 2 x 15.5 GiB).  (c) The
# kernel route against the plain route at full width on one period of
# the pattern (6 layers: depth cut from 62), GEMMA_ROUTE_PROMPT tokens,
# so that the plain route's local layers run 4 chunks of attn_chunk,
# through masked_chunk_attention and trapezoid_attention
GEMMA_WINDOW = 1024
FLASH_WINDOW_SHAPE = (1, 32768, 32, 16, 128)
FLASH_WINDOW_F32_SHAPE = (1, 4096, 32, 16, 128)
FLASH_WINDOW_RAGGED = (1, 100, 128, 1000)
GEMMA_PROMPT, GEMMA_DECODE_PROMPT, GEMMA_GEN = 32768, 16384, 8
GEMMA_ROUTE_PROMPT = 4096
# the 32k prefill runs if its projected peak (allocated) leaves this much
# of the card for the allocator's fragmentation: 2.72 GiB were reserved
# but unallocated when a 32k prefill with a larger FFN peak ran out of
# memory on an NVIDIA H100 80GB HBM3 at 700.00 W
GEMMA_MARGIN_GIB = 3.0
# [23] LM training.  (a) K5's backward kernel against its plain backward
# in float32 on the same inputs: each of dq, dk, dv within TRAIN_BWD_REL
# in relative L2 (float32: sums in another order, ~1e-7; bfloat16: the
# kernel rounds each gradient once, 2^-9 relative, and reads the same
# bfloat16 inputs), where a gradient is not 0 by construction (a window
# of 1 leaves dq = dk = 0: there the largest entry is held to the same
# number); its control, the logsumexp shifted by TRAIN_LSE_SHIFT (P
# scaled by e^-0.05) and in a float32 window case narrower than S the
# window off by one, must land beyond.  Shapes: llama's train_4k layer,
# gemma3's local layer (window 1,024), float32 causal and windowed, head
# dim 16, and the ragged FLASH_RAGGED_SHAPE in both types at
# TRAIN_BWD_RAGGED_WINDOWS
TRAIN_BWD_REL = {"bfloat16": 1e-2, "float32": 1e-5}
TRAIN_LSE_SHIFT = 0.05
# the forward that training runs (K5 with its logsumexp output) in each
# case: its output bitwise the serving call's and within FLASH_TOL of
# the plain forward in float32, its logsumexp within TRAIN_LSE_ATOL of
# the plain one (float32: split TF32 products, 3e-5 on the output;
# bfloat16: exact float32 scores of bfloat16 inputs, ex2.approx); the
# control, the logsumexp moved down one row, must land beyond
TRAIN_LSE_ATOL = {"bfloat16": 1e-4, "float32": 3e-5}
# llama's layer at the batch (b) trains at on an NVIDIA H100 80GB HBM3
# at 700.00 W; (b) checks the kernel again at its own batch if that
# differs
TRAIN_BWD_LLAMA = (3, 4096, 24, 8, 128)
TRAIN_BWD_GEMMA = (1, 4096, 32, 16, 128)
TRAIN_BWD_F32 = (1, 2048, 24, 8, 128)
TRAIN_BWD_DH16 = (2, 512, 4, 2, 16)
TRAIN_BWD_RAGGED_WINDOWS = (1, 100, 1000)
# (b) llama3.2-3b trained at full width and depth: train_4k's sequence,
# its batch of TRAIN_CELL_BATCH cut to what two sizing steps project to
# fit the card with TRAIN_MARGIN_GIB to spare (the projection is linear
# in the batch and fell short: 73.07 GiB projected at 4, 75.89 measured;
# and late in the whole smoke 9.35 GiB sat reserved but unallocated when
# the loss asked for 7.83 GiB, on an NVIDIA H100 80GB HBM3 at 700.00 W);
# TRAIN_STEPS AdamW steps;
# then one step with loss_chunk TRAIN_LOSS_CHUNK on the last step's
# weights and batch, its loss within TRAIN_CHUNK_RTOL of the unchunked
# one (the head's bfloat16 matmul over 1,024-row chunks may round its
# logits otherwise than over the whole sequence, and the float32 sums
# run in another order)
TRAIN_SEQ, TRAIN_CELL_BATCH, TRAIN_STEPS = 4096, 256, 4
TRAIN_MARGIN_GIB = 8.0
TRAIN_LOSS_CHUNK, TRAIN_CHUNK_RTOL = 1024, 1e-3
# (c) the kernel route against the plain route at full width on
# TRAIN_ROUTE_LAYERS layers: float32 within LLAMA_F32_RTOL (the loss, and
# each leaf's gradient in relative L2); bfloat16 each leaf within
# LLAMA_BF16_RATIO of the plain route's distance from the float32 one,
# the loss within TRAIN_BF16_LOSS_RTOL of the plain bfloat16 route's (a
# few bfloat16 roundings, 2^-8 each)
TRAIN_ROUTE_LAYERS, TRAIN_BF16_LOSS_RTOL = 2, 2.0 ** -6
# (d) TRAIN_SMOKE_STEPS steps of three smoke configs on the card against
# the CPU: each loss within TRAIN_SMOKE_RTOL (the float32 tolerance of
# check_smoke_config)
TRAIN_SMOKE_STEPS, TRAIN_SMOKE_RTOL = 3, 1e-4
GROUP_SETTINGS = ("DEVICE", "SEED", "RMAT_SCALE", "EDGE_FACTOR", "BATCH",
                  "MAIN_EPS", "MAIN_DELTA", "HYPER_N", "HYPER_EPS",
                  "HYPER_BLOCK_V", "GROUP_SHARDS", "GROUP_MAX_EPOCHS")
# the runtime ([19]): (b)'s hang sleeps RUNTIME_HANG s against an epoch
# timeout of RUNTIME_EPOCH_TIMEOUT s (an epoch of [4] takes ~0.7 s); the
# ladders' hyperbolic runs draw RUNTIME_HYPER_N0 samples an epoch (n0_base
# cut from 1000, so that they last past their last fault, the fifth or
# sixth epoch); (d) spawns RUNTIME_RANKS ranks on the one card
RUNTIME_HANG, RUNTIME_EPOCH_TIMEOUT = 4.0, 2.5
RUNTIME_HYPER_N0, RUNTIME_RANKS = 250, 4
RUNTIME_SETTINGS = ("DEVICE", "SEED", "HYPER_N", "HYPER_EPS",
                    "HYPER_BLOCK_V", "RUNTIME_HYPER_N0", "RUNTIME_RANKS")


def load_main_config() -> None:
    """The production cell's R-MAT scale and edge factor, eps, delta and
    B, from the port's betweenness config."""
    global RMAT_SCALE, EDGE_FACTOR, BATCH, MAIN_EPS, MAIN_DELTA
    from repro_torch.configs.betweenness import make_config
    cfg = make_config()
    RMAT_SCALE, EDGE_FACTOR = cfg.rmat_scale, cfg.edge_factor
    MAIN_EPS, MAIN_DELTA = cfg.eps, cfg.delta
    BATCH = cfg.adaptive.sample_batch_size


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
    libs = {"frontier": frontier.library, "relax": frontier.relax_library,
            "stopcheck": stopcheck.library, "segsum": segsum.library,
            "flashattn": flashattn.library,
            "flashattn_bwd": flashattn.bwd_library}
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


def atomics_in(kernel: str, library: str = "frontier") -> int:
    """SASS atomic and reduction instructions in every instantiation of
    the built ``library``'s ``kernel`` (every kernel of it when ``kernel``
    is empty)."""
    return sum(sum(n.values()) for f, n in sass_ops(
        library, ATOMIC_OPS).items() if kernel in f)


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
                  vertex_diameter: int = 0, mesh=None):
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
                         ctx=ctx, stream=stream, batch_size=batch, mesh=mesh)
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
    frontier.reset_launch_counts()      # the weighted lane's counts too
    stopcheck.reset_launch_counts()
    segsum.reset_launch_counts()
    flashattn.reset_launch_counts()


def all_counts() -> dict:
    from repro_torch.kernels import flashattn, frontier, segsum, stopcheck
    return {**frontier.launch_counts, **frontier.weighted_launch_counts,
            **stopcheck.launch_counts, **segsum.launch_counts,
            **flashattn.launch_counts}


def read_counts(label: str, kernel_name: str, bfs_levels: int,
                stop_checks: int) -> dict:
    """The launch counts of the run just made: the named frontier kernel
    carried every level, each with its words pass, and
    the stop-check kernel every stop check; the
    gather-segment-sum and flash-attention kernels have no part in a
    centrality run."""
    from repro_torch.kernels import flashattn, frontier, segsum, stopcheck
    counts = all_counts()
    if counts[segsum.SEGSUM] != 0 or counts[flashattn.FLASHATTN] != 0 \
            or counts[flashattn.FLASHATTN_WINDOW] != 0:
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
          checkpoint_dir=None, **cfg):
    """Run ``run_kadabra`` with the launch counts set to 0 just before
    and read just after; the named kernel must carry every level and the
    stop-check kernel the one stop check of every epoch drawn (a resumed
    run draws only the epochs after its checkpoint)."""
    import numpy as np
    from repro_torch.core import AdaptiveConfig, run_kadabra
    config = AdaptiveConfig(eps=eps, delta=delta, **cfg)
    reset_counts()
    t0 = time.perf_counter()
    res = run_kadabra(graph, config=config, seed=SEED, device=DEVICE,
                      checkpoint_dir=checkpoint_dir)
    seconds = time.perf_counter() - t0
    counts = read_counts(label, kernel_name, res.bfs_levels, len(res.stats))
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


def stop_inputs(v: int):
    """Seeded counts (0..399) and budgets in [1e-3, 20) at V = ``v`` on
    the card."""
    import numpy as np
    import torch
    rng = np.random.default_rng(SEED)
    counts = rng.integers(0, 400, v).astype(np.float32)
    lil, liu = (rng.random((2, v)) * 20 + 1e-3).astype(np.float32)
    return tuple(torch.from_numpy(a).to(DEVICE) for a in (counts, lil, liu))


def time_stopcheck(v: int) -> dict:
    """The stop-check kernel a call at V = ``v``, CUDA events over
    STOPCHECK_CALLS back-to-back calls (host and device time), before any
    profiler session: one leaves overhead on every later launch."""
    import torch
    from repro_torch.kernels.stopcheck import stopcheck_fused, stopcheck_ref
    counts, lil, liu = stop_inputs(v)
    omega = torch.tensor(29978.7, device=DEVICE)
    args = (counts, 17_408, lil, liu, omega)
    ms = cuda_time_ms(lambda: stopcheck_fused(*args), STOPCHECK_CALLS)
    plain = cuda_time_ms(lambda: stopcheck_ref(*args), 50)
    log(f"[3] stop-check kernel at V={v} (before any profiler session): "
        f"{ms * 1e3:.2f} us a call over {STOPCHECK_CALLS} calls, plain "
        f"{plain * 1e3:.2f} us")
    return {"ms": ms, "plain_ms": plain}


def phase_stopcheck(rmat, vertex_diameter: int, tau: int) -> dict:
    """The stop-check kernel at V = 2^20 with the budgets of the R-MAT
    run's own calibration (a fresh 32-sample frame through the
    betweenness estimator's make_params at the run's vertex diameter),
    bitwise in every case; then its device time a launch and its
    launches a check from the profiler."""
    import torch
    from repro_torch.core.engine import draw_fold, resolve_estimators
    from repro_torch.core.estimators.base import RunContext
    from repro_torch.kernels import stopcheck
    from repro_torch.kernels.stopcheck import (STOPCHECK, stopcheck_fused,
                                               stopcheck_ref)
    v = rmat.n_nodes
    est = resolve_estimators("betweenness")
    ctx = RunContext(v, vertex_diameter)
    gen = torch.Generator(device=rmat.device).manual_seed(SEED + 2)
    cal = draw_fold(rmat, gen, 32, estimators=est, ctx=ctx,
                    batch_size=BATCH)
    p = est[0].make_params(rmat, ctx, MAIN_EPS, MAIN_DELTA, cal.counts,
                           cal.tau)
    lil, liu, omega = p.log_inv_delta_l, p.log_inv_delta_u, p.omega
    counts = stop_inputs(v)[0]
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
    b_ms, b_by = bound(3 * 4 * v + 2 * 4, STOPCHECK_OPS * v)
    # the kernel's own device time, without the host's enqueue, and the
    # launches a check: a trace that saw all 50 checks' launches, and
    # only the stop-check kernel's, in any trace no more than 50; the
    # wrapper counts 50 in every traced run
    calls = 50
    counted = []

    def checks():
        stopcheck.reset_launch_counts()
        for _ in range(calls):
            stopcheck_fused(*args)
        counted.append(stopcheck.launch_counts[STOPCHECK])

    traces = padded_traces(checks,
                           lambda rows: sum(r[1] for r in rows) == calls)
    rows = traces[-1]
    launches = sum(r[1] for r in rows)
    device_ms = sum(r[0] for r in rows) / max(launches, 1)
    if (launches != calls or set(counted) != {calls}
            or any(sum(r[1] for r in t) > calls
                   or not all("stopcheck_kernel" in r[2] for r in t)
                   for t in traces)):
        raise AssertionError(
            f"stopcheck: device launches in {calls} checks, trace by "
            f"trace: {[[(r[2], r[1]) for r in t] for t in traces]}; "
            f"counted {counted}")
    log(f"  stopcheck: {device_ms * 1e3:.2f} us of device time a check, "
        f"one launch a check ({launches} in {calls} checks, trace "
        f"{len(traces)} of at most {TRACE_TRIES}; launches traced "
        f"{[sum(r[1] for r in t) for t in traces]}), bound "
        f"{b_ms * 1e3:.2f} us ({b_by}); no single PyTorch call computes "
        "[max f, max g]")
    return {"max_abs_err": err, "device_ms": device_ms,
            "launches_a_check": launches / calls,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "shape": f"V={v} float32 x 3 (bitwise on R-MAT 2^{RMAT_SCALE} "
                     "budgets; timed a call on seeded ones)"}


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
        got = gather_segment_sum_cuda(ids, seg, w, table, n_segments, plan)
        again = gather_segment_sum_cuda(ids, seg, w, table, n_segments, plan)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError(f"segsum {label} {dtype}: two calls gave "
                                 "different bits")
        del again
        got = got.float()
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
        log(f"  segsum {label}, N(0,1) {str(dtype)[6:]}: two calls bitwise "
            f"equal; max |diff| {err:.3g} from the plain version, within "
            f"the order bound (largest bound {float(tol.max()):.3g}, "
            f"largest gap/bound {ratio:.3g})")
        if dtype == torch.float32:
            err32 = err
        del got, want, tol, gap, table
    return err32


def segsum_bytes(plan, d: int, elem: int) -> float:
    """The bytes K4's route must move for one call over ``plan``: the
    plan's ids (4 an entry) and offsets (8 a segment), the weights in plan
    order (4 an entry), the table once and the output once."""
    return (8.0 * plan.n_entries + 8.0 * (plan.n_segments + 1)
            + elem * d * (plan.n_rows + plan.n_segments))


def phase_segsum(batch, d: int) -> dict:
    """The gather-segment-sum kernel at the GraphSAGE layer's shapes: the
    forward call (ids=src, seg=dst, w=edge mask, an (N, d) table) and its
    transposed backward call, each checked and timed."""
    import torch
    from repro_torch.kernels.segsum import (gather_segment_sum_cuda,
                                            gather_segment_sum_ref)
    n, v = batch.n_edges, batch.n_nodes
    t0 = time.perf_counter()
    plan = batch.segment_plan()
    torch.cuda.synchronize()
    hot_share = [float((p.ids_sorted < 0).sum()) / max(p.n_entries, 1)
                 for p in (plan, plan.transpose)]
    log(f"  segment plans (src->dst and its transpose) built in "
        f"{time.perf_counter() - t0:.2f} s: {plan.split_seg.shape[0]} of {v} "
        f"segments above {plan.split} entries, cut into {plan.n_items} items;"
        f" largest segment {int(torch.diff(plan.offsets).max())} entries; "
        f"the {plan.n_hot} hot sources carry {hot_share[0]:.3f} of the "
        f"entries ({hot_share[1]:.3f} in the transpose)")
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
    csr = torch.sparse_csr_tensor(plan.offsets, plan.sorted_ids().long(),
                                  plan.weights_in_order(batch.edge_mask),
                                  (v, v), check_invariants=True)
    lib = torch.sparse.mm(csr, table)
    want = gather_segment_sum_ref(*args)
    torch.cuda.synchronize()
    lib_err = float((lib - want).abs().max())
    del lib, want
    lib_ms = cuda_time_ms(lambda: torch.sparse.mm(csr, table), 10)
    b_ms, b_by = bound(segsum_bytes(plan, d, 4), 2.0 * n * d)
    gather_ms = n * d * 4 / HBM_BYTES_PER_S * 1e3
    log(f"  segsum: {ms:.3f} ms forward call ({back_ms:.3f} ms transposed), "
        f"plain {plain:.3f} ms, torch.sparse.mm {lib_ms:.3f} ms (max |diff| "
        f"vs plain {lib_err:.3g}), bound {b_ms:.3f} ms ({b_by}: the plan's "
        f"ids and offsets, w in plan order, the table and the output once); "
        f"one table row read per entry would take {gather_ms:.3f} ms at the "
        f"HBM rate")
    return {"max_abs_err": err, "ms": ms, "transposed_ms": back_ms,
            "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib_ms, "hot_sources": plan.n_hot,
            "hot_share": hot_share[0], "transposed_hot_share": hot_share[1],
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


def padded_traces(fn, done) -> list:
    """The device-side rows of the second of two traced runs of ``fn``,
    the run sitting 0.25 s inside its traced step at both ends, away
    from the edges of the trace's window; traced again until ``done``
    holds of a trace's rows, at most TRACE_TRIES times.  The rows of
    every trace, in order.  Late in a long process a trace loses the
    records of launches that ran, up to a whole session's (none of 50
    stop checks, once), and never adds one: so a caller asks for its
    exact count in one trace and for no more than it in any."""
    import torch

    def padded():
        time.sleep(0.25)
        fn()
        torch.cuda.synchronize()
        time.sleep(0.25)

    traces = []
    while len(traces) < TRACE_TRIES:
        traces.append(profile_twice(padded)[0])
        if done(traces[-1]):
            break
    return traces


def clone_tree(tree):
    from repro_torch.tree import tree_map
    return tree_map(lambda t: t.detach().clone(), tree)


def kernel_only(label: str, name: str, want: int) -> dict:
    """The launch counts of a model run: ``want`` launches of the kernel
    ``name`` and no other kernel."""
    return kernels_only(label, {name: want})


def kernels_only(label: str, want: dict) -> dict:
    """The launch counts of a model run: each kernel named in ``want`` as
    many launches as it says, every other kernel none."""
    counts = all_counts()
    if any(v != want.get(k, 0) for k, v in counts.items()):
        raise AssertionError(f"{label}: expected the launches {want} and no "
                             f"other kernel, got {counts}")
    return counts


def k5_launches(cfg) -> dict:
    """K5's launches in one prefill of ``cfg``: a causal launch a global
    layer, a window launch a local (sliding-window) layer."""
    from repro_torch.kernels.flashattn import FLASHATTN, FLASHATTN_WINDOW
    period = cfg.layer_pattern
    local = sum(period[i % len(period)] == "local"
                for i in range(cfg.n_layers))
    return {FLASHATTN: cfg.n_layers - local, FLASHATTN_WINDOW: local}


def step_gaps(params, plain_params, m, plain_m, opt) -> tuple:
    """The kernel route's first AdamW step against the plain route's:
    the largest gradient gap (m = (1 - b1) g after one step) as a share
    of its leaf's largest entry, the largest parameter gap, and the
    largest parameter gap as a share of the lr |dg| / eps bound (plus
    float32 rounding): Adam's first update g / (|g| + eps) moves by up to
    |dg| / eps where |g| is near eps."""
    from repro_torch.tree import tree_leaves
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
    return grad_ratio, param_gap, param_excess


def check_first_step(logits, plain_logits, loss, plain_loss, params,
                     plain_params, m, plain_m, opt) -> None:
    """The kernel route's forward and first step against the plain
    route's: logits, loss, each leaf's gradient at GNN_GRAD_RTOL of its
    largest entry, and each parameter within lr |dg| / eps of the other
    (plus float32 rounding)."""
    import torch
    logit_gap = float((logits - plain_logits).abs().max())
    grad_ratio, param_gap, param_excess = step_gaps(
        params, plain_params, m, plain_m, opt)
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


def flash_pairs(s: int, causal: bool, window=None) -> float:
    """The (query, key) pairs a head the mask keeps: the causal triangle
    S (S + 1) / 2, or with a window w the triangle's first w rows and w
    keys each after them."""
    if window is not None and s > window:
        return window * (window + 1) / 2 + (s - window) * window
    return s * (s + 1) / 2 if causal else s * s


def flash_cost(shape, causal: bool, elem: int, window=None) -> tuple:
    """(bytes, operations) of one attention call: q, k, v read once and
    the output written once; 4 dh operations for every (query, key)
    pair the mask keeps (q . k and p v)."""
    b, s, h, kv, dh = shape
    return (2 * b * s * (h + kv) * dh * elem,
            4.0 * b * h * flash_pairs(s, causal, window) * dh)


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
    beyond it in at least one row of every slab of FLASH_SLAB_ROWS rows
    (one consumer warpgroup's, of one head) that sees the whole stale
    tile."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flashattn import flash_attention_gqa_ref
    sound = float(row_rel_err(got, want).max())
    lo = FLASH_KV_STAGES * FLASH_KV_TILE
    past = lo + FLASH_KV_TILE
    k2, v2 = k.clone(), v.clone()
    k2[:, lo:past], v2[:, lo:past] = k[:, :FLASH_KV_TILE], v[:, :FLASH_KV_TILE]
    bad = flash_attention_gqa_ref(q, k2, v2, causal=causal)[:, past:]
    del k2, v2
    gaps = row_rel_err(bad, want[:, past:])            # (B, S - past, H)
    control = float(gaps.min())
    below = int((gaps <= FLASH_ROW_REL).sum())
    pad = -gaps.shape[1] % FLASH_SLAB_ROWS             # gaps are >= 0
    slabs = F.pad(gaps.transpose(1, 2), (0, pad)).unflatten(
        2, (-1, FLASH_SLAB_ROWS)).amax(-1)
    slab_control = float(slabs.min())
    del gaps, slabs
    tol = FLASH_TOL["bfloat16"]
    passes_abs = ["passes" if torch.allclose(
        bad[:, r:].float(), want[:, past + r:].float(), rtol=tol, atol=tol)
        else "fails" for r in (0, 4096 - past)]
    del bad
    log(f"  flash {label}: per-row ||diff|| / ||plain|| at most {sound:.4g} "
        f"(limit {FLASH_ROW_REL}); control with a stale ring slot (keys "
        f"{lo}-{past - 1} read as 0-{FLASH_KV_TILE - 1}), rows from {past} "
        f"on: at least {slab_control:.4g} in the worst row of every "
        f"{FLASH_SLAB_ROWS}-row slab, at least {control:.4g} in every row "
        f"({below} rows at or below the limit); it {passes_abs[0]} the "
        f"absolute check, and {passes_abs[1]} it on rows 4096 and on")
    if not sound <= FLASH_ROW_REL < slab_control:
        raise AssertionError(f"flash {label}: per-row gap {sound} or the "
                             f"stale-slot control {slab_control} on the "
                             f"wrong side of {FLASH_ROW_REL}")
    return {"row_rel_err": sound, "stale_tile_row_rel_err_min": control,
            "stale_tile_slab_rel_err_min": slab_control,
            "stale_tile_rows_at_or_below_limit": below}


def stale_window_ref(q, k, v, window: int) -> dict:
    """The windowed plain version with a stale ring slot: for each query
    tile of FLASH_KV_TILE rows whose KV loop (from its first window tile
    j0 to its diagonal) visits more than FLASH_KV_STAGES tiles, tile j0 +
    FLASH_KV_STAGES read as tile j0, what a consumer reading the slot
    before its refill would see.  Float32 scores, softmax and P V, as the
    plain version.  {query tile: its rows' output (B, rows, H, dh)}."""
    import torch
    _, s, h, dh = q.shape
    g = h // k.shape[2]
    tile = FLASH_KV_TILE
    out = {}
    for qt in range(-(-s // tile)):
        j0 = max(0, qt * tile - window + 1) // tile
        if qt - j0 + 1 <= FLASH_KV_STAGES:
            continue
        lo, hi = j0 * tile, min(s, (qt + 1) * tile)
        kk, vv = (x[:, lo:hi].to(torch.float32, copy=True) for x in (k, v))
        st = FLASH_KV_STAGES * tile
        n = min(hi - lo, st + tile) - st
        kk[:, st:st + n], vv[:, st:st + n] = kk[:, :n], vv[:, :n]
        kk = kk.repeat_interleave(g, dim=2)
        vv = vv.repeat_interleave(g, dim=2)
        rows = q[:, qt * tile:hi].float()
        scores = torch.einsum("bqhd,bkhd->bhqk", rows, kk) / dh ** 0.5
        qpos = torch.arange(qt * tile, hi, device=q.device)[:, None]
        kpos = torch.arange(lo, hi, device=q.device)[None, :]
        scores = scores.masked_fill((kpos > qpos) | (qpos - kpos >= window),
                                    -1e30)
        out[qt] = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(scores, -1),
                               vv)
    return out


def check_flash_window_rows(label: str, q, k, v, got, want,
                            window: int) -> dict:
    """The windowed bfloat16 output held per row within FLASH_ROW_REL, and
    its stale-slot control (``stale_window_ref``), which must lie beyond
    that in at least one row of every FLASH_SLAB_ROWS-row slab (one
    consumer warpgroup's, of one head) of each query tile whose loop
    reaches a third tile.  Where no loop does (a window of at most
    FLASH_KV_STAGES tiles), the ring never wraps and there is no
    control."""
    sound = float(row_rel_err(got, want).max())
    tile = FLASH_KV_TILE
    bad = stale_window_ref(q, k, v, window)
    if not bad:
        log(f"  flash {label} window {window}: per-row ||diff|| / ||plain|| "
            f"at most {sound:.4g} (limit {FLASH_ROW_REL}); no query tile "
            f"visits more than {FLASH_KV_STAGES} KV tiles, so the ring never "
            "wraps: no stale-slot control")
        if not sound <= FLASH_ROW_REL:
            raise AssertionError(f"flash {label}: per-row gap {sound} beyond "
                                 f"{FLASH_ROW_REL}")
        return {"row_rel_err": sound}
    slab_min, row_min, below = float("inf"), float("inf"), 0
    for qt, rows in bad.items():
        w = want[:, qt * tile:qt * tile + rows.shape[1]]
        gaps = row_rel_err(rows, w)                       # (B, rows, H)
        row_min = min(row_min, float(gaps.min()))
        below += int((gaps <= FLASH_ROW_REL).sum())
        for r in range(0, gaps.shape[1], FLASH_SLAB_ROWS):
            slab = gaps[:, r:r + FLASH_SLAB_ROWS].amax(dim=1)  # (B, H)
            slab_min = min(slab_min, float(slab.min()))
    log(f"  flash {label} window {window}: per-row ||diff|| / ||plain|| at "
        f"most {sound:.4g} (limit {FLASH_ROW_REL}); control with a stale "
        f"ring slot (each query tile's KV tile j0 + {FLASH_KV_STAGES} read "
        f"as its first, j0), {len(bad)} query tiles: at least "
        f"{slab_min:.4g} in the worst row of every {FLASH_SLAB_ROWS}-row "
        f"slab, at least {row_min:.4g} in every row ({below} rows at or "
        "below the limit)")
    if not sound <= FLASH_ROW_REL < slab_min:
        raise AssertionError(f"flash {label}: per-row gap {sound} or the "
                             f"stale-slot control {slab_min} on the wrong "
                             f"side of {FLASH_ROW_REL}")
    return {"row_rel_err": sound, "stale_tile_row_rel_err_min": row_min,
            "stale_tile_slab_rel_err_min": slab_min,
            "stale_tile_rows_at_or_below_limit": below}


def tf32_round(x):
    """float32 rounded to TF32 (10 mantissa bits), to nearest, ties away
    from zero (``cvt.rna.tf32.f32``)."""
    import torch
    return ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def check_flash_tf32_control(label: str, q, k, v, want, causal: bool,
                             excess: float, window=None) -> dict:
    """The float32 route's control: the plain version on q, k, v rounded
    to TF32 must lie beyond the 3e-5 that the kernel meets (``excess``,
    its largest gap over the allowed one, at most 1)."""
    from repro_torch.kernels.flashattn import flash_attention_gqa_ref
    tol = FLASH_TOL["float32"]
    bad = flash_attention_gqa_ref(tf32_round(q), tf32_round(k),
                                  tf32_round(v), causal=causal, window=window)
    gap = (bad - want).abs()
    control = float((gap / (tol + tol * want.abs())).max())
    log(f"  flash {label}: control, the plain version on q, k, v rounded "
        f"to TF32: max |diff| {float(gap.max()):.3g}, largest gap / allowed "
        f"{control:.3g}; the kernel's {excess:.3g}")
    if not excess <= 1.0 < control:
        raise AssertionError(f"flash {label}: the kernel's gap ({excess}) or "
                             f"the TF32-rounded control's ({control}) on the "
                             f"wrong side of {tol}")
    return {"tf32_inputs_excess": control, "excess": excess}


def check_flash_case(label: str, shape, dtype, causal: bool, seed: int,
                     iters: int, tf32_control: bool = False,
                     window=None) -> dict:
    """K5 against its plain version on N(0, 1) inputs within the dtype's
    tolerance (and bfloat16 per row too, with its control; float32 with
    the TF32 control where asked); then timed beside the plain version,
    the bound and ``scaled_dot_product_attention`` on KV heads repeated
    beforehand.  A float32 bound is three TF32 products' (the float32
    pipe's figure beside it).  With a ``window``: the window mode against
    the windowed plain version, its stale-slot control counted from each
    query tile's first KV tile, also timed beside the causal kernel on
    the same inputs, and SDPA given the band as a boolean mask."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flashattn import (flash_attention_cuda,
                                               flash_attention_gqa_ref)
    b, s, h, kv, dh = shape
    q, k, v = flash_inputs(shape, dtype, seed)
    got = flash_attention_cuda(q, k, v, causal=causal, window=window)
    want = flash_attention_gqa_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    tol = FLASH_TOL[str(dtype)[6:]]
    gap = (got.float() - want.float()).abs()
    err = float(gap.max())
    excess = float((gap / (tol + tol * want.float().abs())).max())
    del gap
    if not torch.allclose(got.float(), want.float(), rtol=tol, atol=tol):
        raise AssertionError(f"flash {label}: max |diff| {err} beyond atol "
                             f"= rtol = {tol}")
    if dtype != torch.bfloat16:
        rows = {}
    elif window is None:
        rows = check_flash_rows(label, q, k, v, got, want, causal)
    else:
        rows = check_flash_window_rows(label, q, k, v, got, want, window)
    if tf32_control:
        rows = check_flash_tf32_control(label, q, k, v, want, causal, excess,
                                        window)
    ms = cuda_time_ms(lambda: flash_attention_cuda(q, k, v, causal=causal,
                                                   window=window), iters)
    plain = cuda_time_ms(lambda: flash_attention_gqa_ref(
        q, k, v, causal=causal, window=window), 1)
    qt = q.transpose(1, 2)
    kt = k.repeat_interleave(h // kv, dim=2).transpose(1, 2)
    vt = v.repeat_interleave(h // kv, dim=2).transpose(1, 2)
    if window is None:
        def sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt,
                                                  is_causal=causal)
        also_causal = {}
    else:
        # the band as a boolean mask (True: attend), on the memory-
        # efficient backend: the math backend would hold (B, H, S, S)
        # float32 scores, 137 GB at 32 heads of 32,768
        from torch.nn.attention import SDPBackend, sdpa_kernel
        pos = torch.arange(s, device=q.device)
        band = (pos[:, None] >= pos[None, :]) \
            & (pos[:, None] - pos[None, :] < window)

        def sdpa():
            with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
                return F.scaled_dot_product_attention(qt, kt, vt,
                                                      attn_mask=band)
        causal_ms = cuda_time_ms(lambda: flash_attention_cuda(q, k, v),
                                 iters)
        also_causal = {"causal_kernel_ms": causal_ms}
    lib = sdpa()
    torch.cuda.synchronize()
    lib_err = float((lib.transpose(1, 2).float() - want.float()).abs().max())
    del got, want, lib
    lib_ms = cuda_time_ms(sdpa, iters)
    n_bytes, n_ops = flash_cost(shape, causal, q.element_size(), window)
    if dtype == torch.bfloat16:
        b_ms, b_by = bound(n_bytes, n_ops, BF16_OPS_PER_S)
        bounds = {}
        also = ""
    else:
        b_ms, b_by = bound(n_bytes, FLASH_F32_PRODUCTS * n_ops,
                           TF32_OPS_PER_S)
        fp32_ms, _ = bound(n_bytes, n_ops, FP32_OPS_PER_S)
        bounds = {"fp32_pipe_bound_ms": fp32_ms}
        also = (f"; the operations as {FLASH_F32_PRODUCTS} TF32 products "
                f"at {TF32_OPS_PER_S / 1e12:.0f} TFLOP/s; the float32 "
                f"pipe's bound {fp32_ms:.3f} ms at "
                f"{FP32_OPS_PER_S / 1e12:.0f} TFLOP/s")
    tflops = n_ops / ms / 1e9
    mode = "causal" if causal else "full"
    if window is not None:
        mode = f"window {window}"
        also += (f"; the causal kernel on the same inputs "
                 f"{also_causal['causal_kernel_ms']:.3f} ms; kept pairs a "
                 f"head {flash_pairs(s, causal, window):.4g} against "
                 f"{flash_pairs(s, causal):.4g} causal")
    log(f"  flash {label} {str(dtype)[6:]} {mode}"
        f" (B, S, H/KV, dh) = ({b}, {s}, {h}/{kv}, {dh}): max |diff| "
        f"{err:.3g} (atol = rtol = {tol}; largest gap / allowed "
        f"{excess:.3g}); {ms:.3f} ms ({tflops:.1f} TFLOP/s), plain "
        f"{plain:.3f} ms, scaled_dot_product_attention {lib_ms:.3f} ms (max "
        f"|diff| vs plain {lib_err:.3g}), bound {b_ms:.3f} ms ({b_by}{also})")
    return {"max_abs_err": err, "ms": ms, "tflops": tflops,
            "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
            **bounds, "library_ms": lib_ms, **also_causal, **rows,
            "shape": f"(B, S, H/KV, dh) = ({b}, {s}, {h}/{kv}, {dh}) "
                     f"{str(dtype)[6:]}, {mode}"}


def flash_f32_smem(dh: int) -> int:
    """Dynamic shared memory of one float32 block (``f32_smem_bytes``):
    the Q tile and the K/V ring, Q and K rows padded to 16 banks mod 32
    (dh 16 needs none), V rows by 4 floats."""
    ld_qk = dh if dh % 32 == 16 else dh + 16
    return 4 * (FLASH_F32_ROWS * ld_qk
                + FLASH_F32_STAGES * FLASH_F32_TILE * (ld_qk + dh + 4))


def check_flash_bwd_build() -> None:
    """K5 bwd's build: every bfloat16 dK/dV and dQ instantiation (dh 64
    and 128, with and without the window mode) has HGMMA and UTMALDG in
    its SASS, every float32 one (dh 16, 64 and 128, with and without the
    window mode) HMMA, none of them spills (ptxas), and no kernel of the
    library has an atomic or reduction opcode (its determinism)."""
    from repro_torch.kernels import _build
    ptxas = _build.build_report("flashattn_bwd")["ptxas"].splitlines()
    routes = {"bf16": ("bwd_dkdv_wgmma_kernel", "bwd_dq_wgmma_kernel"),
              "f32": ("bwd_dkdv_tf32_kernel", "bwd_dq_tf32_kernel")}
    spills = {}
    for i, line in enumerate(ptxas):
        if "Compiling entry" in line and any(
                k in line for names in routes.values() for k in names):
            props = [x.strip() for x in ptxas[i + 1:i + 4]]
            if any(k in line for k in routes["f32"]):
                log(f"  ptxas: {line.strip()}")
                log(f"  ptxas: {' | '.join(props)}")
            spills[line.split("'")[1]] = next(
                (x for x in props if "spill" in x), "")
    ops = sass_ops("flashattn_bwd", ("HGMMA", "UTMALDG", "HMMA"))
    kernels = {route: {f: n for f, n in ops.items()
                       if any(k in f for k in names)}
               for route, names in routes.items()}
    atomics = atomics_in("", "flashattn_bwd")
    bf16 = sorted((n["HGMMA"], n["UTMALDG"]) for n in kernels["bf16"].values())
    log(f"  flashattn_bwd.cu: {len(kernels['bf16'])} bf16 dK/dV and dQ "
        f"kernels, HGMMA and UTMALDG counts {bf16}; "
        f"{len(kernels['f32'])} float32 ones, HMMA counts "
        f"{sorted(n['HMMA'] for n in kernels['f32'].values())}; spills "
        f"{sorted(set(spills.values()))}; atomic and reduction opcodes "
        f"({'/'.join(ATOMIC_OPS)}) in the library: {atomics}")
    if len(kernels["bf16"]) != 8 or not all(
            n["HGMMA"] and n["UTMALDG"] for n in kernels["bf16"].values()):
        raise AssertionError(f"K5 bwd's bf16 kernels lack HGMMA or UTMALDG: "
                             f"{kernels['bf16']}")
    if len(kernels["f32"]) != 12 or not all(
            n["HMMA"] for n in kernels["f32"].values()):
        raise AssertionError(f"K5 bwd's float32 kernels lack HMMA: "
                             f"{kernels['f32']}")
    if len(spills) != 20 or not all(
            "0 bytes spill stores, 0 bytes spill loads" in x
            for x in spills.values()):
        raise AssertionError(f"K5 bwd's kernels spill: {spills}")
    if atomics:
        raise AssertionError(f"flashattn_bwd has {atomics} atomic or "
                             "reduction instructions")


def phase_flash() -> dict:
    """K5 at the serving path's shape (bfloat16, causal) and at
    granite-moe's (head dim 64), then float32 and a ragged non-causal
    case."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.flashattn.kernel import SOURCE
    dh = FLASH_SHAPE[4]
    tiles = (1 + 2 * FLASH_KV_STAGES) * FLASH_KV_TILE * dh * 2
    log(f"  dynamic shared memory a block: bfloat16 {tiles} bytes of tiles "
        f"(+ barriers and 1024-byte alignment), float32 "
        f"{flash_f32_smem(dh)} bytes at dh={dh} (the Q tile and "
        f"{FLASH_F32_STAGES} stages of K and V, rows padded) ({SOURCE.name})")
    ptxas = _build.build_report("flashattn")["ptxas"].splitlines()
    spills = {}
    for i, line in enumerate(ptxas):
        if "Compiling entry" in line and "flash_" in line:
            props = [x.strip() for x in ptxas[i + 1:i + 4]]
            log(f"  ptxas: {line.strip()}")
            log(f"  ptxas: {' | '.join(props)}")
            if "flash_f32_kernel" in line:
                spills[line.split("'")[1]] = next(
                    (x for x in props if "spill" in x), "")
    ops = sass_ops("flashattn", ("HGMMA", "UTMALDG", "HMMA"))
    for func, counts in ops.items():
        log(f"  cuobjdump -sass: {func}: {counts}")
    bf16 = [n for f, n in ops.items() if "flash_bf16_kernel" in f]
    f32 = [n for f, n in ops.items() if "flash_f32_kernel" in f]
    # each kernel with and without the window mode, each with and
    # without the logsumexp output: bf16 at dh 64 and 128, float32 at dh
    # 16, 64 and 128
    if len(bf16) != 8 or not all(n["HGMMA"] and n["UTMALDG"] for n in bf16):
        raise AssertionError(f"flash_bf16_kernel lacks HGMMA or UTMALDG: {ops}")
    if len(f32) != 12 or not all(n["HMMA"] for n in f32):
        raise AssertionError(f"flash_f32_kernel lacks HMMA: {ops}")
    if len(spills) != 12 or not all(
            "0 bytes spill stores, 0 bytes spill loads" in x
            for x in spills.values()):
        raise AssertionError(f"flash_f32_kernel spills: {spills}")
    check_flash_bwd_build()
    row = check_flash_case("serving", FLASH_SHAPE, torch.bfloat16, True,
                           SEED + 5, 5)
    torch.cuda.empty_cache()
    dh64 = check_flash_case("granite", FLASH_DH64_SHAPE, torch.bfloat16,
                            True, SEED + 9, 5)
    torch.cuda.empty_cache()
    f32 = check_flash_case("float32", FLASH_F32_SHAPE, torch.float32, True,
                           SEED + 6, 10, tf32_control=True)
    ragged = check_flash_case("ragged", FLASH_RAGGED_SHAPE, torch.float32,
                              False, SEED + 7, 20)
    torch.cuda.empty_cache()
    return {**row, **{f"dh64_{k}": v for k, v in dh64.items()},
            **{f"float32_{k}": v for k, v in f32.items()},
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


def check_routes(cfg, prompt_len: int = LLAMA_F32_PROMPT,
                 variants=(("", {}),)) -> None:
    """Full width and depth, one prompt prefilled through K5 and through
    the plain route, on weights drawn in float32 and rounded to bfloat16
    values.  Float32: last-token logits within LLAMA_F32_RTOL of the
    largest plain logit.  Bfloat16: the kernel route within
    LLAMA_BF16_RATIO of the plain route's relative L2 distance from the
    float32 plain logits.
    In both, the argmax equal unless the plain route's top-2 gap could
    be closed by the gap allowed (float32) or seen (bfloat16).
    ``variants`` are (name, config fields) of the plain route, each held
    against the one kernel route (``attn_trapezoid`` picks a local
    layer's plain schedule; the kernel route ignores it)."""
    import dataclasses
    import torch
    from repro_torch.models.transformer import init_params, prefill_step
    from repro_torch.tree import tree_leaves
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 8)
    params = init_params(gen, cfg32, device=DEVICE)
    for leaf in tree_leaves(params):
        leaf.copy_(leaf.to(torch.bfloat16))
    prompt = torch.randint(0, cfg.vocab, (1, prompt_len), generator=gen,
                           device=DEVICE)

    def both_routes(params, c, label):
        reset_counts()
        got, _ = prefill_step(params, prompt, c)
        torch.cuda.synchronize()
        kernels_only(f"{label} kernel route", k5_launches(cfg))
        finite_logits(f"{label} kernel route", got, 1, cfg)
        wants = {}
        for name, fields in variants:
            reset_counts()
            want, _ = prefill_step(params, prompt,
                                   dataclasses.replace(c, **fields),
                                   use_kernel=False)
            torch.cuda.synchronize()
            kernels_only(f"{label} plain route{name}", {})
            top2 = torch.topk(want[0].float(), 2).values
            wants[name] = want, float(top2[0] - top2[1])
        return got, wants

    with torch.no_grad():
        got, wants = both_routes(params, cfg32, "float32")
        for name, (want, top_gap) in wants.items():
            tol = LLAMA_F32_RTOL * float(want.abs().max())
            gap = float((got - want).abs().max())
            same_argmax = int(got.argmax()) == int(want.argmax())
            log(f"  kernel route vs plain route{name}, float32, 1 x "
                f"{prompt_len}: last-token logits max |diff| {gap:.3g} "
                f"(tolerance {tol:.3g} = {LLAMA_F32_RTOL} of the largest "
                f"|logit| {float(want.abs().max()):.3g}"
                f"); argmax {int(got.argmax())} vs {int(want.argmax())} "
                f"(plain top-2 gap {top_gap:.3g})")
            if gap > tol or not (same_argmax or top_gap < tol):
                raise AssertionError(f"{cfg.name} float32: kernel route and "
                                     f"plain route{name} disagree beyond the "
                                     "stated tolerance")
        exact = {name: want for name, (want, _) in wants.items()}
        # the same values in the bfloat16 model's types (an MoE router
        # stays float32)
        p16 = init_params(gen, cfg, device=DEVICE)
        for dst, src in zip(tree_leaves(p16), tree_leaves(params)):
            dst.copy_(src)
        del params
        got, wants = both_routes(p16, cfg, "bfloat16")
    for name, (want, top_gap) in wants.items():
        e_kernel, e_plain = rel_l2(got, exact[name]), rel_l2(want,
                                                             exact[name])
        gap = float((got.float() - want.float()).abs().max())
        same_argmax = int(got.argmax()) == int(want.argmax())
        log(f"  kernel route vs plain route{name}, bfloat16, 1 x "
            f"{prompt_len}: last-token logits' relative L2 distance from the "
            f"float32 plain route {e_kernel:.4g} (kernel) vs {e_plain:.4g} "
            f"(plain), ratio {e_kernel / e_plain:.3g} (limit "
            f"{LLAMA_BF16_RATIO}); kernel vs plain {rel_l2(got, want):.4g}, "
            f"max |diff| {gap:.3g}; argmax {int(got.argmax())} vs "
            f"{int(want.argmax())} (plain top-2 gap {top_gap:.3g})")
        if e_kernel > LLAMA_BF16_RATIO * e_plain \
                or not (same_argmax or top_gap < 2 * gap):
            raise AssertionError(f"{cfg.name} bfloat16: kernel route and "
                                 f"plain route{name} disagree beyond the "
                                 "stated tolerance")


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


def serve_cell(cfg, batch: int, prompt_len: int, gen_len: int,
               seed: int) -> tuple:
    """``cfg`` at full width and depth, weights drawn on the card: a cold
    and a warm prefill of batch x prompt_len (one K5 launch a layer
    each; the process's first prefill pays cuBLAS set-up), the cache
    grown by gen_len and gen_len greedy decode steps (no K5).  Returns
    (params, prompt, the cache, the last tokens, the warm prefill's and
    the decode's launch counts summed)."""
    import torch
    from repro_torch.kernels.flashattn import FLASHATTN
    from repro_torch.models.transformer import (decode_step, grow_cache,
                                                init_params, prefill_step)
    from repro_torch.tree import tree_leaves
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    t0 = time.perf_counter()
    params = init_params(gen, cfg, device=DEVICE)
    prompt = torch.randint(0, cfg.vocab, (batch, prompt_len), generator=gen,
                           device=DEVICE)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(params))
    log(f"  {cfg.name}: {n_params} parameters ({cfg.dtype}, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card) drawn"
        f" in {time.perf_counter() - t0:.2f} s; prompt {batch} x "
        f"{prompt_len}")
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        times = []
        for run in ("cold", "warm"):
            reset_counts()
            t0 = time.perf_counter()
            logits, cache = prefill_step(params, prompt, cfg)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            prefill = kernels_only(f"{cfg.name} {run} prefill",
                                   k5_launches(cfg))
            if run == "cold":
                del cache
        finite_logits(f"{cfg.name} prefill", logits, batch, cfg)
        log(f"  prefill {batch} x {prompt_len}: cold {times[0]:.3f} s "
            f"({batch * prompt_len / times[0]:.0f} tokens/s), warm "
            f"{times[1]:.3f} s ({batch * prompt_len / times[1]:.0f} "
            f"tokens/s); K5 launches {k5_summary(prefill)} a prefill")
        cache = grow_cache(cache, gen_len)
        tokens = torch.argmax(logits, -1)[:, None]
        ids = [tokens]
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(gen_len):
            logits, cache = decode_step(params, cache, tokens, cfg)
            tokens = torch.argmax(logits, -1)[:, None]
            ids.append(tokens)
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
        decode = kernel_only(f"{cfg.name} decode", FLASHATTN, 0)
        finite_logits(f"{cfg.name} decode", logits, batch, cfg)
    log(f"  decode: {gen_len} steps of {batch} tokens from a cache of "
        f"{cache['k'].shape[2]} slots, {decode_s / gen_len * 1e3:.2f} ms a "
        f"step ({batch * gen_len / decode_s:.1f} tokens/s); K5 launches "
        f"{decode[FLASHATTN]}; cache at len {cache['len']}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
        f"(torch.cuda.max_memory_allocated); first ids "
        f"{torch.cat(ids, dim=1)[:, :8].tolist()}")
    return params, prompt, cache, tokens, {k: prefill[k] + decode[k]
                                           for k in prefill}


def k5_summary(counts: dict) -> str:
    """K5's launches in ``counts``: their number, and how many of them
    ran the window mode where any did."""
    from repro_torch.kernels.flashattn import FLASHATTN, FLASHATTN_WINDOW
    n = counts[FLASHATTN] + counts[FLASHATTN_WINDOW]
    if counts[FLASHATTN_WINDOW]:
        return f"{n} ({counts[FLASHATTN_WINDOW]} windowed)"
    return str(n)


def phase_llama() -> dict:
    """llama3.2-3b serving at full width and depth; returns the launch
    counts of the counted run (a warm prefill, then the decode)."""
    import torch
    from repro_torch.configs.llama3_2_3b import make_config
    from repro_torch.models.transformer import decode_step, prefill_step
    cfg = make_config()
    params, prompt, cache, tokens, counts = serve_cell(
        cfg, LLAMA_BATCH, LLAMA_PROMPT, LLAMA_GEN, SEED)
    with torch.no_grad():
        # profiled steps rewrite the last two slots: the counted run is over
        profile_serving("decode step", lambda: decode_step(
            params, {**cache, "len": cache["len"] - 2}, tokens, cfg))
        del cache
        torch.cuda.empty_cache()
        profile_serving("warm prefill", lambda: prefill_step(params, prompt,
                                                             cfg))
    del params
    torch.cuda.empty_cache()
    check_routes(cfg)
    torch.cuda.empty_cache()
    check_smoke_config()
    return counts


# ---------------------------------------------------------------------------
# [14] the sharded cooperative lane
# ---------------------------------------------------------------------------

def check_cells(name: str, got, want) -> tuple:
    """Bitwise where the plain value is an exact integer below 2^24,
    within rtol elsewhere (atomics add in a varying order); raises, else
    -> (exact cells, other cells, max |diff|)."""
    import torch
    exact = (want < EXACT_LIMIT) & (want == torch.round(want))
    err = float((got - want).abs().max()) if want.numel() else 0.0
    if not torch.equal(got[exact], want[exact]):
        raise AssertionError(f"{name}: not bitwise equal where the sums are "
                             "exact integers")
    rest = ~exact
    gap = (got[rest] - want[rest]).abs()
    if bool((gap > RTOL * want[rest].abs()).any()):
        raise AssertionError(f"{name}: max |diff| {err} beyond rtol {RTOL} "
                             "where the sums are not exact")
    return int(exact.sum()), int(rest.sum()), err


def compare_cells(name: str, got, want) -> float:
    """:func:`check_cells`, logged."""
    n_exact, n_rest, err = check_cells(name, got, want)
    log(f"  {name}: bitwise on {n_exact} exact cells, within rtol "
        f"{RTOL} on {n_rest} others (max |diff| {err})")
    return err


def shard_matrix(view, v_pad: int):
    """The shard's local matrix (shard_rows x v_pad, ones at its real
    edges) in CSR, for the library yardstick."""
    import torch
    real = view.src != view.n_nodes
    at = torch.sparse_coo_tensor(
        torch.stack([view.dst[real].long(), view.src[real].long()]),
        torch.ones(int(real.sum()), device=view.src.device),
        (view.v_pad, v_pad)).coalesce()
    return at.to_sparse_csr()


def stacked_matrix(pg):
    """Every shard's edges in one v_pad x v_pad CSR matrix, shard s's
    destinations at rows s * shard_rows + dst: one torch.sparse.mm with
    it computes the whole sharded level."""
    import torch
    parts = []
    for s in range(pg.n_shards):
        view = pg.shards.shard(s)
        real = view.src != view.n_nodes
        parts.append(torch.stack([view.dst[real].long() + s * pg.shard_rows,
                                  view.src[real].long()]))
    idx = torch.cat(parts, dim=1)
    at = torch.sparse_coo_tensor(
        idx, torch.ones(idx.shape[1], device=idx.device),
        (pg.v_pad, pg.v_pad)).coalesce()
    return at.to_sparse_csr()


def traced_kernels(fn, names, done=None) -> list:
    """Device ms and launches of each kernel whose name holds one of
    ``names``, a dict for each trace of ``padded_traces(fn, ...)``,
    traced until ``done`` holds of the launches (a tuple in the order of
    ``names``); one trace without ``done``."""
    def sums(rows):
        found = {name: [0.0, 0] for name in names}
        for ms, count, key in rows:
            for name in names:
                if name in key:
                    found[name][0] += ms
                    found[name][1] += count
        return found

    want = done or (lambda launches: True)
    return [sums(rows) for rows in padded_traces(
        fn, lambda rows: want(tuple(n for _, n in sums(rows).values())))]


def check_wide(pg, rmat, dist, sigma, levels, replicated_ms: float) -> dict:
    """K2 wide_state at one mid-BFS level: the gathered masked frontier
    as the lane hands it over.  Every shard's per-shard call against its
    plain version, and the level call (every shard at once: one words
    pass, one node-blocked launch over the layout's real blocks) against
    the stacked plain version.  The level call timed with CUDA events,
    its two kernels' device time and launches from the profiler, beside
    the plain version, the whole-level byte bound, torch.sparse.mm on
    each shard's matrix and on the stacked matrix, and the per-shard
    calls it replaces."""
    import torch
    from repro_torch.kernels.frontier import (
        frontier_expand_node_blocked, frontier_expand_sharded_level,
        frontier_expand_sharded_level_ref, frontier_expand_sharded_ref)
    batch = dist.shape[1]
    v1 = rmat.n_nodes + 1
    fvals = torch.zeros((pg.v_pad, batch), device=dist.device)
    fvals[:v1] = torch.where(dist == levels, sigma, 0.0)
    fdist = torch.where(fvals > 0, levels, -1).to(torch.int32)
    shards = pg.shards
    views = [shards.shard(s) for s in range(pg.n_shards)]
    err = 0.0
    for s, view in enumerate(views):
        got = frontier_expand_node_blocked(view, fdist, fvals, levels,
                                           wide_state=True)
        want = frontier_expand_sharded_ref(view, fdist, fvals, levels)
        torch.cuda.synchronize()
        err = max(err, compare_cells(f"frontier_node_blocked_wide shard {s}",
                                     got, want))
        del got, want
    got = frontier_expand_sharded_level(shards, fvals, levels)
    want = frontier_expand_sharded_level_ref(shards, fvals, levels)
    torch.cuda.synchronize()
    err = max(err, compare_cells("frontier_nb_sharded_level (8 shards)",
                                 got, want))
    del got, want
    # what the level reads: the real blocks, the active ones among them
    hit_rows = (fvals > 0).any(dim=1)
    blocks = shards.src.view(-1, shards.block_e)
    real = shards.real_blocks()
    n_blocks = blocks.shape[0]
    active = int(hit_rows[blocks[real.long()].long()].any(dim=1).sum())
    srcs = torch.unique(shards.src[(shards.src != rmat.n_nodes)
                                   & hit_rows[shards.src.long()]])
    per_shard_real = torch.bincount(real.long() // shards.n_edge_blocks,
                                    minlength=pg.n_shards).tolist()
    log(f"  real edge blocks launched: {real.shape[0]} of {pg.n_shards} x "
        f"{shards.n_edge_blocks} = {n_blocks} ({per_shard_real} a shard); "
        f"{active} of them active, {srcs.numel()} frontier source rows")
    ids_bytes = active * shards.block_e * 8
    cells = pg.v_pad * batch * 4
    words_bytes = pg.v_pad * (-(-batch // 32)) * 4
    # the bound: the active blocks' ids, fvals read once (the level's
    # state), the stack written once
    b_ms, b_by = bound(ids_bytes + 2 * cells,
                       2.0 * active * shards.block_e * batch)
    # the same with the words in place of fvals and only the frontier
    # sources' rows read
    w_ms, _ = bound(ids_bytes + words_bytes + srcs.numel() * batch * 4
                    + cells, 0.0)
    def level():
        return frontier_expand_sharded_level(shards, fvals, levels)

    def per_shard():
        return [frontier_expand_node_blocked(v, fdist, fvals, levels,
                                             wide_state=True) for v in views]

    ms = cuda_time_ms(level, 20)
    shard_ms = cuda_time_ms(per_shard, 10)
    # The profiler's launches a level: single levels, each traced alone,
    # until one trace holds one launch of each kernel.  Late in a long
    # process a trace loses the records of launches that ran, whole
    # levels at a time, padded or not (of 10 level calls it saw 6 words
    # passes and 7 node-blocked launches; single levels (0, 0), (1, 1),
    # (0, 0)); it never adds one, so no trace may show more than one
    # launch of either.
    names = ("frontier_words_kernel", "frontier_nb_kernel")
    seen = [tuple(n for _, n in d.values()) for d in traced_kernels(
        level, names, lambda launches: launches == (1, 1))]
    if (1, 1) not in seen or max(max(t) for t in seen) > 1:
        raise AssertionError(f"sharded level: the profiler saw {seen} "
                             "(words, node-blocked) launches in single "
                             "traced levels, not one of each")
    # device time a launch, from 10 traced calls of each route: traced
    # until a trace holds launches of both kernels, none more than ran
    calls = 10
    device = traced_kernels(lambda: [level() for _ in range(calls)], names,
                            all)
    shard_dev = traced_kernels(lambda: [per_shard() for _ in range(calls)],
                               names, all)
    if any(n > k for traces, k in ((device, calls),
                                   (shard_dev, calls * pg.n_shards))
           for dev in traces for _, n in dev.values()) or not all(
               n for dev in (device[-1], shard_dev[-1])
               for _, n in dev.values()):
        raise AssertionError(f"sharded level: traced launches {device} in "
                             f"{calls} level calls, {shard_dev} in "
                             f"{calls} x {pg.n_shards} per-shard calls")
    device, shard_dev = device[-1], shard_dev[-1]
    words_dev, nb_dev = (device[k][0] / device[k][1] for k in names)
    # the per-shard route's kernels a level (8 launches each)
    shard_words, shard_nb = (shard_dev[k][0] / shard_dev[k][1] * pg.n_shards
                             for k in names)
    plain = cuda_time_ms(lambda: frontier_expand_sharded_level_ref(
        shards, fvals, levels), 2)
    mats = [shard_matrix(v, pg.v_pad) for v in views]
    stacked = stacked_matrix(pg)
    torch.cuda.synchronize()
    lib_err = float((torch.sparse.mm(stacked, fvals).view(
        pg.n_shards, pg.shard_rows, batch) - level()).abs().max())
    lib_shards = cuda_time_ms(lambda: [torch.sparse.mm(a, fvals)
                                       for a in mats], 10)
    lib = cuda_time_ms(lambda: torch.sparse.mm(stacked, fvals), 10)
    del mats, stacked
    log(f"  frontier_nb_sharded_level: {ms:.3f} ms a call (one level, all "
        f"{pg.n_shards} shards); device time frontier_words_kernel "
        f"{words_dev:.4f} ms, frontier_nb_kernel {nb_dev:.4f} ms a launch "
        f"({device['frontier_words_kernel'][1]} and "
        f"{device['frontier_nb_kernel'][1]} launches traced in {calls} "
        f"calls); launches in single traced levels {seen}; "
        f"plain {plain:.3f} ms; bound {b_ms:.4f} ms ({b_by}: active ids, "
        f"fvals read once, the stack written once; with the words and the "
        f"frontier source rows in place of fvals {w_ms:.4f} ms); "
        f"torch.sparse.mm on the stacked v_pad x v_pad matrix {lib:.3f} ms "
        f"(max |diff| {lib_err}), on the {pg.n_shards} shards' matrices "
        f"{lib_shards:.3f} ms; the per-shard route's {pg.n_shards} calls "
        f"{shard_ms:.3f} ms (device a level: frontier_words_kernel "
        f"{shard_words:.4f} ms, frontier_nb_kernel {shard_nb:.4f} ms); the "
        f"replicated K2 level on the same state {replicated_ms:.3f} ms")
    return {"max_abs_err": err, "ms": ms, "words_device_ms": words_dev,
            "nb_device_ms": nb_dev, "plain_ms": plain, "bound_ms": b_ms,
            "bound_by": b_by, "bound_words_ms": w_ms, "library_ms": lib,
            "library_shards_ms": lib_shards, "per_shard_calls_ms": shard_ms,
            "per_shard_words_device_ms": shard_words,
            "per_shard_nb_device_ms": shard_nb,
            "real_blocks": int(real.shape[0]), "edge_blocks": n_blocks,
            "active_blocks": active, "replicated_level_ms": replicated_ms}


def level_breakdown(pg, mesh, dist, sigma, levels, flat_ms: float) -> dict:
    """Where a sharded level's time goes, CUDA events at the mid-BFS
    state: the exchange, the level call (words pass included), and the
    rest of the level (the update and its cross-shard reductions)."""
    import torch
    from repro_torch.core.bfs import (_expand_level_sharded,
                                      _gather_frontier_sharded)
    from repro_torch.kernels.frontier import frontier_expand
    v1, batch = dist.shape
    sd = torch.full((pg.v_pad, batch), -3, dtype=torch.int32,
                    device=dist.device)
    ss = torch.zeros((pg.v_pad, batch), device=dist.device)
    sd[:v1], ss[:v1] = dist, sigma
    sd = sd.view(pg.n_shards, pg.shard_rows, batch)
    ss = ss.view(pg.n_shards, pg.shard_rows, batch)
    active = torch.ones(batch, dtype=torch.bool, device=dist.device)
    xch = cuda_time_ms(lambda: _gather_frontier_sharded(
        pg, mesh, sd, ss, levels, active), 10)
    fvals, _, took = _gather_frontier_sharded(pg, mesh, sd, ss, levels,
                                              active)
    wide = cuda_time_ms(lambda: frontier_expand(
        None, None, None, fvals, levels, shards=pg.shards), 10)
    whole = cuda_time_ms(lambda: _expand_level_sharded(
        pg, mesh, sd, ss, levels, active), 10)
    log(f"  a sharded level at the mid-BFS state: {whole:.3f} ms = "
        f"exchange {xch:.3f} ms (sparse taken: {int(took)}) + wide "
        f"(the level call) {wide:.3f} ms + the rest "
        f"{whole - xch - wide:.3f} ms; the replicated flat level (K1) on "
        f"the same state {flat_ms:.3f} ms")
    return {"sharded_level_ms": whole, "exchange_ms": xch, "wide_ms": wide}


def read_sharded_counts(label: str, bfs_levels: int,
                        stop_checks: int) -> dict:
    """Every level one sharded level launch and one words pass for all
    shards; no flat or replicated node-blocked launch; one stop check an
    epoch."""
    from repro_torch.kernels import flashattn, frontier, segsum, stopcheck
    counts = all_counts()
    if counts[frontier.NODE_BLOCKED_WIDE] != bfs_levels or bfs_levels == 0 \
            or counts[frontier.WORDS] != bfs_levels \
            or counts[frontier.FLAT] or counts[frontier.NODE_BLOCKED] \
            or counts[segsum.SEGSUM] or counts[flashattn.FLASHATTN] \
            or counts[flashattn.FLASHATTN_WINDOW]:
        raise AssertionError(f"{label}: expected {bfs_levels} level "
                             f"launches and words passes and no other "
                             f"frontier kernel, got {counts}")
    if counts[stopcheck.STOPCHECK] != stop_checks or stop_checks == 0:
        raise AssertionError(f"{label}: expected {stop_checks} stop checks, "
                             f"got {counts}")
    return counts


def drive_sharded(label: str, pg, mesh, eps: float, delta: float,
                  checkpoint_dir=None, **cfg):
    """run_kadabra on the partitioned graph, counts reset just before and
    read just after."""
    import numpy as np
    from repro_torch.core import AdaptiveConfig, run_kadabra
    config = AdaptiveConfig(eps=eps, delta=delta, **cfg)
    reset_counts()
    t0 = time.perf_counter()
    res = run_kadabra(pg, config=config, seed=SEED, mesh=mesh,
                      checkpoint_dir=checkpoint_dir)
    seconds = time.perf_counter() - t0
    counts = read_sharded_counts(label, res.bfs_levels, len(res.stats))
    total = sum(s.exchange["levels_total"] for s in res.stats)
    sparse = sum(s.exchange["levels_sparse"] for s in res.stats)
    moved = sum(s.exchange["bytes"] for s in res.stats)
    t_samp = res.phase_seconds["sampling"]
    log(f"  {label}: {seconds:.1f} s, phases "
        + ", ".join(f"{k} {v:.2f} s" for k, v in res.phase_seconds.items())
        + f"; samples {res.tau} ({res.tau / max(t_samp, 1e-9):.1f}/s), "
        f"epochs {res.n_epochs}, converged {res.converged}, vertex "
        f"diameter {res.vertex_diameter}, BFS levels {res.bfs_levels}; "
        f"epochs' exchange: {total} levels, {sparse} sparse, "
        f"{total - sparse} dense, {moved / 1e9:.3f} GB priced; launches "
        f"{counts}")
    b = res.btilde
    if b.shape != (pg.n_nodes,) or not np.isfinite(b).all() \
            or (b < 0).any() or (b > 1).any():
        raise AssertionError(f"{label}: scores not finite in [0, 1]")
    return res, counts


def phase_sharded() -> tuple:
    """[14]: the sharded cooperative lane on R-MAT 2^20 x 30 in SHARDS
    shards (ShardMesh on the card), then hyperbolic(1000) in SHARDS
    shards against exact Brandes.  Returns the kernel row's numbers and
    the paths' launch counts."""
    import numpy as np
    import torch
    from repro_torch.core import (ShardMesh, bidirectional_bfs_batched,
                                  bidirectional_bfs_batched_sharded,
                                  brandes_numpy, build_csc_layout,
                                  hyperbolic_graph, partition_graph,
                                  rmat_graph, sample_pairs)
    from repro_torch.kernels.frontier import (frontier_expand_flat,
                                              frontier_expand_node_blocked)
    paths = {}
    rmat = rmat_graph(RMAT_SCALE, EDGE_FACTOR, seed=SEED, device=DEVICE)
    t0 = time.perf_counter()
    pg = partition_graph(rmat, SHARDS)
    torch.cuda.synchronize()
    log(f"  partitioned in {time.perf_counter() - t0:.2f} s: block_v "
        f"{pg.shards.block_v}, block_e {pg.shards.block_e}, shard_rows "
        f"{pg.shard_rows}, v_pad {pg.v_pad}, {pg.shards.n_edge_blocks} edge "
        f"blocks a shard, exchange chunks of {pg.exchange_chunk_rows} rows, "
        f"budget {pg.exchange_budget} of {pg.exchange_chunks_per_shard}")
    mesh = ShardMesh(SHARDS, DEVICE)
    dist, sigma, levels = mid_bfs_state(rmat, BATCH)
    args = (rmat.src, rmat.dst, dist, sigma, levels, rmat.pull_plan())
    flat_ms = cuda_time_ms(lambda: frontier_expand_flat(*args), 10)
    csc = build_csc_layout(rmat)
    pad = csc.v_pad - dist.shape[0]
    d_pad = torch.cat([dist, dist.new_full((pad, BATCH), -3)]).contiguous()
    s_pad = torch.cat([sigma, sigma.new_zeros((pad, BATCH))]).contiguous()
    rep_ms = cuda_time_ms(lambda: frontier_expand_node_blocked(
        csc, d_pad, s_pad, levels), 10)
    del csc, d_pad, s_pad
    row = check_wide(pg, rmat, dist, sigma, levels, rep_ms)
    row["shape"] = (f"R-MAT 2^{RMAT_SCALE} x {EDGE_FACTOR}, B={BATCH}, "
                    f"{SHARDS} shards of {pg.shard_rows} rows, block_v="
                    f"{pg.shards.block_v} block_e={pg.shards.block_e}, a call "
                    f"is one level of all {SHARDS} shards")
    row.update(level_breakdown(pg, mesh, dist, sigma, levels, flat_ms))
    del dist, sigma
    torch.cuda.empty_cache()

    gen = torch.Generator(device=rmat.device).manual_seed(SEED + 3)
    s, t = sample_pairs(gen, rmat.n_nodes, BATCH)
    reset_counts()
    got = bidirectional_bfs_batched_sharded(pg, s, t, mesh=mesh)
    counts = all_counts()
    want = bidirectional_bfs_batched(rmat, s, t)
    torch.cuda.synchronize()
    v1 = rmat.n_nodes + 1
    for f in ("dist_s", "dist_t"):
        if not torch.equal(mesh.all_gather(getattr(got, f))[:v1],
                           getattr(want, f)):
            raise AssertionError(f"sharded bidirectional {f} is not the "
                                 "replicated flat route's")
    if not (torch.equal(got.d, want.d) and torch.equal(got.split,
                                                       want.split)):
        raise AssertionError("sharded bidirectional d / split differ")
    for f in ("sigma_s", "sigma_t"):
        compare_cells(f"sharded bidirectional {f}",
                      mesh.all_gather(getattr(got, f))[:v1],
                      getattr(want, f))
    log(f"  one bidirectional batch of {BATCH}: {got.n_iters} levels "
        f"(replicated {want.n_iters}), exchange tally "
        f"{got.exchange.tolist()}; dist, d and split bitwise; launches "
        f"{counts}")
    del got, want
    torch.cuda.empty_cache()

    res, paths["rmat_sharded"] = drive_sharded(
        "rmat_sharded", pg, mesh, MAIN_EPS, MAIN_DELTA,
        sample_batch_size=BATCH, max_epochs=MAIN_MAX_EPOCHS)
    if not res.converged:
        log(f"  the epoch cap {MAIN_MAX_EPOCHS} was hit: converged=False")
    log(f"[15b] checkpointed resume of [14]: stopped after "
        f"{SHARDED_RESUME_AT} epochs, newest step damaged, resumed")
    paths["rmat_sharded_resumed"] = phase_resume_sharded(pg, mesh, res)
    phase_profile("rmat_sharded", pg, 2, BATCH, mesh=mesh)
    del rmat, pg
    torch.cuda.empty_cache()

    hyper = hyperbolic_graph(HYPER_N, seed=SEED, device=DEVICE)
    hpg = partition_graph(hyper, SHARDS, block_v=HYPER_BLOCK_V)
    res, paths["hyperbolic_sharded"] = drive_sharded(
        "hyperbolic_sharded", hpg, mesh, HYPER_EPS, 0.1)
    err = float(np.abs(res.btilde - brandes_numpy(hyper)).max())
    log(f"  hyperbolic({HYPER_N}) in {SHARDS} shards: max |b~ - b| = "
        f"{err:.5f} (eps {HYPER_EPS})")
    if not err < HYPER_EPS:
        raise AssertionError(f"hyperbolic sharded: max error {err} >= "
                             f"{HYPER_EPS}")
    return row, paths


def host_copies(leaves) -> list:
    """Each leaf of an engine checkpoint as its own numpy array."""
    import numpy as np
    import torch
    return [x.detach().cpu().numpy().copy() if isinstance(x, torch.Tensor)
            else np.array(x) for x in leaves]


class CheckpointProbe:
    """Times the store's saves (the loop's thread is blocked for the copy
    to host), their background publishes (CRC32, ``np.save``, fsync,
    rename) and the restores of the runs made inside it.  With
    ``stash`` it also keeps a host copy of every leaf list the engine
    saved and of the leaves and generator state each restore set, by
    epoch, for the round-trip check; the copies cost the loop time, so
    a timed run goes without."""

    def __init__(self, stash: bool = False):
        self.stash = stash
        self.blocked, self.threads, self.restores = [], [], []
        self.saved, self.restored = {}, {}

    def __enter__(self):
        from repro_torch.checkpoint import store
        from repro_torch.core.engine import _EngineCheckpointer as ckpt
        self._orig = (store.save, store.restore, ckpt.save_state,
                      ckpt.restore_state)
        orig_save, orig_restore, orig_save_state, orig_restore_state = \
            self._orig

        def save(*args, **kwargs):
            t0 = time.perf_counter()
            thread = orig_save(*args, **kwargs)
            self.blocked.append(time.perf_counter() - t0)
            self.threads.append(thread)
            return thread

        def restore(*args, **kwargs):
            t0 = time.perf_counter()
            out = orig_restore(*args, **kwargs)
            self.restores.append(time.perf_counter() - t0)
            return out

        def save_state(ck, epoch, state, frozen_c, frozen_tau, stop_epoch,
                       gen, **kwargs):
            self.saved[epoch] = host_copies(ck.leaves(
                state, frozen_c, frozen_tau, stop_epoch, gen))
            return orig_save_state(ck, epoch, state, frozen_c, frozen_tau,
                                   stop_epoch, gen, **kwargs)

        def restore_state(ck, state, frozen_c, frozen_tau, stop_epoch, gen):
            out = orig_restore_state(ck, state, frozen_c, frozen_tau,
                                     stop_epoch, gen)
            if out[4]:          # a step was restored (epoch 0: none)
                # the generator's state read back after set_state
                self.restored[out[4]] = host_copies(ck.leaves(*out[:4],
                                                              gen))
            return out

        store.save, store.restore = save, restore
        if self.stash:
            ckpt.save_state, ckpt.restore_state = save_state, restore_state
        return self

    def __exit__(self, *exc):
        from repro_torch.checkpoint import store
        from repro_torch.core.engine import _EngineCheckpointer as ckpt
        store.save, store.restore = self._orig[:2]
        ckpt.save_state, ckpt.restore_state = self._orig[2:]
        return False

    def summary(self) -> str:
        def ms(xs):
            return (f"{len(xs)} x, mean {1e3 * sum(xs) / max(len(xs), 1):.2f}"
                    f" ms, max {1e3 * max(xs, default=0):.2f} ms")
        publish = [t.seconds for t in self.threads]
        return (f"saves blocked the loop {ms(self.blocked)}; background "
                f"publishes {ms(publish)}; restores {ms(self.restores)}")


def step_bytes(root: str, step: int) -> int:
    d = Path(root) / f"step_{step:08d}"
    return sum(f.stat().st_size for f in d.iterdir())


def flip_byte(root: str, step: int) -> str:
    """One byte in the middle of a step's first leaf, inverted."""
    path = Path(root) / f"step_{step:08d}" / "arr_000000.npy"
    with open(path, "r+b") as f:
        f.seek(path.stat().st_size // 2)
        b = f.read(1)
        f.seek(-1, 1)
        f.write(bytes([b[0] ^ 0xFF]))
    return str(path)


def same_run(a, b) -> bool:
    import numpy as np
    return (np.array_equal(a.btilde, b.btilde) and a.tau == b.tau
            and a.n_epochs == b.n_epochs and a.converged == b.converged)


def phase_resume(rmat, base) -> dict:
    """[15a]: [4]'s run with checkpoint_dir, stopped after RESUME_AT
    epochs, resumed with [4]'s config (bitwise [4]'s result: K1 and K3
    add in a fixed order), and resumed once more (nothing drawn).  Every
    level through K1, every check through K3.  Returns the launch counts
    of the resumed run."""
    import shutil
    import tempfile
    from repro_torch.checkpoint import latest_step
    from repro_torch.core import AdaptiveConfig, run_kadabra
    from repro_torch.kernels.frontier import FLAT, WORDS
    from repro_torch.kernels.stopcheck import STOPCHECK
    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    cfg = dict(sample_batch_size=BATCH)
    try:
        with CheckpointProbe() as probe:
            part, _ = drive("rmat_ckpt_part", rmat, FLAT, MAIN_EPS,
                            MAIN_DELTA, checkpoint_dir=root,
                            max_epochs=RESUME_AT, **cfg)
            if part.n_epochs != RESUME_AT or latest_step(root) != RESUME_AT:
                raise AssertionError(f"checkpointed run: {part.n_epochs} "
                                     f"epochs, latest step "
                                     f"{latest_step(root)}")
            n_bytes = step_bytes(root, RESUME_AT)
            res, counts = drive("rmat_resumed", rmat, FLAT, MAIN_EPS,
                                MAIN_DELTA, checkpoint_dir=root,
                                max_epochs=MAIN_MAX_EPOCHS, **cfg)
            if not same_run(res, base):
                raise AssertionError(
                    f"resumed run is not [4]'s: tau {res.tau} vs {base.tau}, "
                    f"epochs {res.n_epochs} vs {base.n_epochs}, btilde "
                    f"equal {bool((res.btilde == base.btilde).all())}")
            if [s.epoch for s in res.stats] != list(
                    range(RESUME_AT + 1, base.n_epochs + 1)):
                raise AssertionError("the resumed run drew other epochs")
            reset_counts()
            again = run_kadabra(rmat, config=AdaptiveConfig(
                eps=MAIN_EPS, delta=MAIN_DELTA, max_epochs=MAIN_MAX_EPOCHS,
                **cfg), seed=SEED, device=DEVICE, checkpoint_dir=root)
            c2 = all_counts()
        if not same_run(again, base) or again.stats \
                or c2[STOPCHECK] != 0 or c2[FLAT] != again.bfs_levels \
                or c2[WORDS] != again.bfs_levels:
            raise AssertionError(f"resuming the completed run drew epochs "
                                 f"or changed the result: {again.stats}, "
                                 f"launches {c2}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    samp = part.phase_seconds["sampling"] + res.phase_seconds["sampling"]
    draw = sum(s.seconds for s in part.stats + res.stats)
    base_samp = base.phase_seconds["sampling"]
    base_draw = sum(s.seconds for s in base.stats)
    replay = (res.phase_seconds["diameter"]
              + res.phase_seconds["calibration"])
    log(f"  checkpointed: {n_bytes} bytes a step; {probe.summary()}")
    log(f"  resumed at epoch {RESUME_AT}: btilde, tau {res.tau} and "
        f"{res.n_epochs} epochs bitwise [4]'s; phases 1-2 replayed in "
        f"{replay:.3f} s; resumed again: 0 epochs, {again.bfs_levels} "
        f"replayed levels, the same result")
    log(f"  sampling with checkpoint_every=1: {samp:.3f} s over "
        f"{base.n_epochs} epochs against [4]'s {base_samp:.3f} s "
        f"({samp / base_samp - 1:+.2%}); the epochs' draws alone "
        f"{draw:.3f} s against {base_draw:.3f} s")
    return counts


def phase_resume_sharded(pg, mesh, base) -> dict:
    """[15b]: [14]'s sharded run with checkpoint_dir, stopped after
    SHARDED_RESUME_AT epochs; one byte of the newest step's first leaf
    flipped; resumed with [14]'s config.  The damaged step must be
    quarantined and the run fall back to the step before, whose leaves
    and generator state must come back bitwise; the result must be
    [14]'s bits, or, only where a second uninterrupted run also differs
    from [14]'s (K2's atomics add in a varying order), within 2 eps of
    it.  Returns the launch counts of the resumed run."""
    import os
    import shutil
    import tempfile
    import numpy as np
    from repro_torch.checkpoint import latest_step
    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    cfg = dict(sample_batch_size=BATCH)
    try:
        with CheckpointProbe(stash=True) as probe:
            part, _ = drive_sharded("rmat_sharded_ckpt_part", pg, mesh,
                                    MAIN_EPS, MAIN_DELTA, checkpoint_dir=root,
                                    max_epochs=SHARDED_RESUME_AT, **cfg)
            if part.n_epochs != SHARDED_RESUME_AT \
                    or latest_step(root) != SHARDED_RESUME_AT:
                raise AssertionError(f"checkpointed sharded run: "
                                     f"{part.n_epochs} epochs, latest step "
                                     f"{latest_step(root)}")
            n_bytes = step_bytes(root, SHARDED_RESUME_AT)
            damaged = flip_byte(root, SHARDED_RESUME_AT)
            res, counts = drive_sharded("rmat_sharded_resumed", pg, mesh,
                                        MAIN_EPS, MAIN_DELTA,
                                        checkpoint_dir=root,
                                        max_epochs=MAIN_MAX_EPOCHS, **cfg)
        quarantined = os.path.isdir(os.path.join(
            root, f"step_{SHARDED_RESUME_AT:08d}.quarantined-0"))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    back = SHARDED_RESUME_AT - 1
    if not quarantined or list(probe.restored) != [back]:
        raise AssertionError(f"the damaged step was not quarantined or the "
                             f"run did not fall back to step {back}: "
                             f"restored {list(probe.restored)}")
    got, want = probe.restored[back], probe.saved[back]
    for i, (g, w) in enumerate(zip(got, want)):
        if g.dtype != w.dtype or not np.array_equal(g, w):
            raise AssertionError(f"restored leaf {i} of step {back} is not "
                                 f"what the interrupted run held")
    log(f"  checkpointed: {n_bytes} bytes a step; byte flipped in "
        f"{damaged}; quarantined, fell back to step {back}: its "
        f"{len(got)} leaves and the generator state restored bitwise; "
        f"{probe.summary()}")
    if same_run(res, base):
        log(f"  resumed run bitwise [14]'s: tau {res.tau}, {res.n_epochs} "
            f"epochs")
        return counts
    second, _ = drive_sharded("rmat_sharded_again", pg, mesh, MAIN_EPS,
                              MAIN_DELTA, max_epochs=MAIN_MAX_EPOCHS, **cfg)
    d_res = float(np.abs(res.btilde - base.btilde).max())
    d_two = float(np.abs(second.btilde - base.btilde).max())
    log(f"  resumed run differs from [14]'s: max |diff| {d_res} (tau "
        f"{res.tau} vs {base.tau}); a second uninterrupted run: max |diff| "
        f"{d_two} (tau {second.tau})")
    if same_run(second, base) or not d_res < 2 * MAIN_EPS:
        raise AssertionError("the sharded resume breaks its contract")
    return counts


# ---------------------------------------------------------------------------
# [16] the SPMD lane: independent samplers, one process each
# ---------------------------------------------------------------------------

def check_spmd_counts(label: str, res) -> dict:
    """One rank's launch counts of the run just made: every level of its
    searches through the flat kernel and its words pass, one stop check
    an epoch, nothing else."""
    from repro_torch.kernels import frontier, stopcheck
    counts = all_counts()
    want = {k: 0 for k in counts}
    want.update({frontier.FLAT: res.bfs_levels, frontier.WORDS: res.bfs_levels,
                 stopcheck.STOPCHECK: len(res.stats)})
    if counts != want or res.bfs_levels == 0 or not res.stats:
        raise AssertionError(f"{label}: launches {counts}, expected {want}")
    return counts


def spmd_rank(rank: int, ckpt_root: str, settings: dict) -> dict:
    """[16] on one rank of the spawned gloo group, on the card: the
    production cell's run in each aggregation mode, the checkpointed
    resume of the hierarchical run, hyperbolic(HYPER_N) at HYPER_EPS.
    Each run resets the launch counts just before it and checks them
    just after.  ``settings`` are the parent's SPMD_SETTINGS."""
    import zlib
    import numpy as np
    import torch
    from repro_torch.core import (AdaptiveConfig, SamplerMesh,
                                  hyperbolic_graph, rmat_graph, run_adaptive,
                                  run_kadabra)
    from repro_torch.core.distributed import assert_replicated
    from repro_torch.kernels import _build
    from repro_torch.kernels.frontier import kernel as frontier
    from repro_torch.kernels.stopcheck import kernel as stopcheck
    globals().update(settings)
    libs = {}
    t0 = time.perf_counter()
    if torch.device(DEVICE).type == "cuda":
        torch.cuda.set_device(0)
        # the parent's builds
        frontier.library(), frontier.relax_library(), stopcheck.library()
        libs = {k: _build.build_report(k)["seconds"]
                for k in ("frontier", "relax", "stopcheck")}
    mesh = SamplerMesh(SPMD_SHAPE, SPMD_AXES, device=DEVICE)
    t_setup = time.perf_counter() - t0
    t0 = time.perf_counter()
    rmat = rmat_graph(RMAT_SCALE, EDGE_FACTOR, seed=SEED, device=DEVICE)
    crc = zlib.crc32(rmat.indices.cpu().numpy().tobytes(),
                     zlib.crc32(rmat.indptr.cpu().numpy().tobytes()))
    assert_replicated(mesh, {"graph_crc32": crc, "n_edges": rmat.n_edges})
    out = {"rank": rank, "libs": libs, "setup_s": t_setup,
           "graph_s": time.perf_counter() - t0, "staged": mesh.staged}

    def run(label, mode, max_epochs=MAIN_MAX_EPOCHS, checkpoint_dir=None):
        config = AdaptiveConfig(eps=MAIN_EPS, delta=MAIN_DELTA,
                                sample_batch_size=BATCH, aggregation=mode,
                                max_epochs=max_epochs)
        reset_counts()
        t1 = time.perf_counter()
        res = run_kadabra(rmat, config=config, seed=SEED, mesh=mesh,
                          checkpoint_dir=checkpoint_dir)
        seconds = time.perf_counter() - t1
        return {"btilde": res.btilde, "tau": res.tau,
                "n_epochs": res.n_epochs, "converged": res.converged,
                "bfs_levels": res.bfs_levels, "seconds": seconds,
                "phases": res.phase_seconds,
                "epochs": [s.aggregation for s in res.stats],
                "epoch_numbers": [s.epoch for s in res.stats],
                "counts": check_spmd_counts(f"rank {rank} {label}", res)}

    for mode in SPMD_MODES:
        out[mode] = run(mode, mode)
    out["part"] = run("part", "hierarchical", max_epochs=RESUME_AT,
                      checkpoint_dir=ckpt_root)
    out["resumed"] = run("resumed", "hierarchical", checkpoint_dir=ckpt_root)
    del rmat
    torch.cuda.empty_cache()
    hyper = hyperbolic_graph(HYPER_N, seed=SEED, device=DEVICE)
    reset_counts()
    res = run_kadabra(hyper, config=AdaptiveConfig(eps=HYPER_EPS,
                                                   delta=0.1),
                      seed=SEED, mesh=mesh)
    check_spmd_counts(f"rank {rank} hyperbolic", res)
    out["hyperbolic"] = {"btilde": res.btilde, "tau": res.tau,
                         "n_epochs": res.n_epochs}
    # the weighted stream on the same graph with dyadic weights
    reset_counts()
    res = run_adaptive(weighted_graph(hyper), ("betweenness",),
                       stream="weighted", seed=SEED, mesh=mesh,
                       config=AdaptiveConfig(eps=HYPER_EPS, delta=0.1,
                                             aggregation="hierarchical"))
    out["weighted"] = {
        "btilde": res.reports[0].scores, "tau": res.tau,
        "n_epochs": res.n_epochs, "converged": res.converged,
        "distance_cap": res.distance_cap, "rounds": res.bfs_levels,
        "dag_rounds": res.dag_rounds,
        "counts": check_weighted_counts(f"rank {rank} weighted",
                                        res.bfs_levels, res.dag_rounds,
                                        len(res.stats))}
    return out


def spmd_bitwise(label: str, a: dict, b: dict) -> None:
    if not (np_equal(a["btilde"], b["btilde"]) and a["tau"] == b["tau"]
            and a["n_epochs"] == b["n_epochs"]
            and a["converged"] == b["converged"]):
        raise AssertionError(f"{label}: tau {a['tau']} vs {b['tau']}, "
                             f"epochs {a['n_epochs']} vs {b['n_epochs']}, "
                             "btilde equal "
                             f"{np_equal(a['btilde'], b['btilde'])}")


def np_equal(a, b) -> bool:
    import numpy as np
    return bool(np.array_equal(a, b))


def phase_spmd(main_res) -> dict:
    """[16] a-e: SPMD_RANKS ranks spawned on the one card in a gloo group
    over a FileStore (spmd_rank each), checked against one another, [4]
    and exact Brandes.  Returns the path's launch counts, summed over
    the ranks."""
    import shutil
    import tempfile
    import numpy as np
    from repro_torch.core import brandes_numpy, hyperbolic_graph
    from repro_torch.launch import spawn_local
    root = tempfile.mkdtemp(prefix="chip_smoke_spmd_")
    t0 = time.perf_counter()
    try:
        ranks = spawn_local(spmd_rank, SPMD_RANKS,
                            args=(os.path.join(root, "ckpt"),
                                  {k: globals()[k] for k in SPMD_SETTINGS}),
                            backend="gloo", timeout=SPMD_TIMEOUT,
                            store_dir=root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    wall = time.perf_counter() - t0
    r0 = ranks[0]
    log(f"  {SPMD_RANKS} ranks spawned and done in {wall:.1f} s; rank 0 "
        f"loaded the parent's kernel builds (nvcc seconds {r0['libs']}) and "
        f"made its mesh in {r0['setup_s']:.2f} s; R-MAT built and checked "
        f"alike on every rank in {r0['graph_s']:.1f} s; frames staged "
        f"through the host: {r0['staged']}")
    for r in ranks:
        if any(r["libs"].values()):
            raise AssertionError(f"rank {r['rank']} rebuilt a kernel: "
                                 f"{r['libs']}")
    for mode in SPMD_MODES:
        res = r0[mode]
        for r in ranks[1:]:
            spmd_bitwise(f"{mode}: rank {r['rank']} against rank 0",
                         r[mode], res)
        if mode != "hierarchical":
            spmd_bitwise(f"{mode} against hierarchical", res,
                         r0["hierarchical"])
        if not res["converged"]:
            raise AssertionError(f"{mode}: not converged in "
                                 f"{res['n_epochs']} epochs")
        gap = float(np.abs(res["btilde"] - main_res.btilde).max())
        per_rank = [(r["rank"], r[mode]["bfs_levels"],
                     r[mode]["counts"]["stopcheck"]) for r in ranks]
        log(f"  {mode}: {res['seconds']:.1f} s, phases "
            + ", ".join(f"{k} {v:.2f} s" for k, v in res["phases"].items())
            + f" ({sum(res['phases'].values()):.2f} s against [4]'s "
            f"{sum(main_res.phase_seconds.values()):.2f} s); tau {res['tau']} "
            f"([4] {main_res.tau}), epochs {res['n_epochs']} ([4] "
            f"{main_res.n_epochs}), converged; max |b_spmd - b_[4]| {gap:.5f}"
            f"; bitwise on every rank and across the modes; (rank, levels "
            f"= flat and words launches, stop checks) {per_rank}")
        draw = wait = 0.0
        staged = 0
        for n, e in enumerate(res["epochs"], 1):
            log(f"    epoch {n:3d}: start {e['start_s'] * 1e3:8.3f} ms, draw "
                f"{e['draw_s'] * 1e3:9.3f} ms, blocked in wait() "
                f"{e['wait_s'] * 1e3:8.3f} ms, staged {e['staged_bytes']} "
                f"bytes")
            draw += e["draw_s"]
            wait += e["wait_s"]
            staged += e["staged_bytes"]
        log(f"    rank 0 over {len(res['epochs'])} epochs: draw {draw:.3f} s, "
            f"wait {wait:.3f} s ({wait / max(draw + wait, 1e-9):.1%} of "
            f"draw + wait), staged {staged / 1e6:.1f} MB")
    part, resumed, base = r0["part"], r0["resumed"], r0["hierarchical"]
    for r in ranks:
        spmd_bitwise(f"rank {r['rank']} resumed against its uninterrupted "
                     "run", r["resumed"], r["hierarchical"])
        if r["part"]["n_epochs"] != RESUME_AT or \
                r["resumed"]["epoch_numbers"] != list(
                    range(RESUME_AT + 1, base["n_epochs"] + 1)):
            raise AssertionError(f"rank {r['rank']}: the stopped run drew "
                                 f"{r['part']['n_epochs']} epochs, the "
                                 f"resumed one epochs "
                                 f"{r['resumed']['epoch_numbers']}")
    log(f"  [16d] resumed after {RESUME_AT} epochs: btilde, tau "
        f"{resumed['tau']} and {resumed['n_epochs']} epochs bitwise the "
        f"uninterrupted hierarchical run on every rank; stopped run "
        f"{part['seconds']:.1f} s, resumed {resumed['seconds']:.1f} s")
    hyper = hyperbolic_graph(HYPER_N, seed=SEED, device="cpu")
    err = float(np.abs(r0["hyperbolic"]["btilde"]
                       - brandes_numpy(hyper)).max())
    for r in ranks[1:]:
        if not np_equal(r["hyperbolic"]["btilde"], r0["hyperbolic"]["btilde"]):
            raise AssertionError("hyperbolic: ranks differ")
    log(f"  [16e] hyperbolic({HYPER_N}) on {SPMD_RANKS} ranks: tau "
        f"{r0['hyperbolic']['tau']}, {r0['hyperbolic']['n_epochs']} epochs, "
        f"max |b~ - b| = {err:.5f} (eps {HYPER_EPS})")
    if not err < HYPER_EPS:
        raise AssertionError(f"SPMD hyperbolic: max error {err} >= "
                             f"{HYPER_EPS}")
    wr = r0["weighted"]
    for r in ranks[1:]:
        spmd_bitwise(f"weighted: rank {r['rank']} against rank 0",
                     r["weighted"], wr)
        if r["weighted"]["distance_cap"] != wr["distance_cap"]:
            raise AssertionError("weighted: the ranks' distance caps differ")
    exact, _ = weighted_brandes(weighted_graph(hyper))
    err = float(np.abs(wr["btilde"] - exact).max())
    log(f"  [16e] weighted hyperbolic({HYPER_N}) (dyadic weights), "
        f"hierarchical, on {SPMD_RANKS} ranks: tau {wr['tau']}, "
        f"{wr['n_epochs']} epochs, distance cap {wr['distance_cap']}, "
        f"{wr['rounds']} relaxation rounds and {wr['dag_rounds']} DAG rounds "
        f"a rank; bitwise on every rank; max |b~ - b| = {err:.5f} against "
        f"exact weighted Brandes (eps {HYPER_EPS}); launches a rank "
        f"{wr['counts']}")
    if not (err < HYPER_EPS and wr["converged"]):
        raise AssertionError(f"SPMD weighted hyperbolic: max error {err} "
                             f">= {HYPER_EPS}")
    keys = r0["hierarchical"]["counts"]
    return {k: sum(r["hierarchical"]["counts"][k] for r in ranks)
            for k in keys}


def phase_nccl(n_nodes: int) -> None:
    """[16f] a one-rank NCCL group in this process: the three
    aggregations on a (1, v_pad) frame on the card (the production
    frame's length at SPMD_RANKS ranks), each bitwise its input, each
    timed a call."""
    import datetime
    import shutil
    import tempfile
    import torch
    import torch.distributed as dist
    from repro_torch.core import SamplerMesh
    from repro_torch.core.distributed import AGGREGATIONS
    from repro_torch.core.engine import _pad_len
    root = tempfile.mkdtemp(prefix="chip_smoke_nccl_")
    dist.init_process_group(
        "nccl", store=dist.FileStore(os.path.join(root, "store"), 1), rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=120))
    try:
        mesh = SamplerMesh((1, 1), SPMD_AXES, device=DEVICE)
        v_pad = _pad_len(n_nodes, SPMD_RANKS)
        gen = torch.Generator(device=DEVICE).manual_seed(SEED)
        x = torch.randint(0, 1000, (1, v_pad), generator=gen,
                          device=DEVICE).float()
        for mode, fn in AGGREGATIONS.items():
            handle = fn(x, mesh)
            got = handle.wait()
            torch.cuda.synchronize()
            if not torch.equal(got, x) or handle.staged_bytes:
                raise AssertionError(f"NCCL {mode}: not the input's bits, or "
                                     f"{handle.staged_bytes} bytes staged")
            ms = cuda_time_ms(lambda: fn(x, mesh).wait(), 20)
            log(f"  [16f] NCCL {mode} on one rank, (1, {v_pad}) float32 on "
                f"the card: bitwise the input, {ms:.4f} ms a call, nothing "
                "staged")
    finally:
        dist.destroy_process_group()
        shutil.rmtree(root, ignore_errors=True)


# ---------------------------------------------------------------------------
# [17] the sharded cooperative lane over torch.distributed: one shard a rank
# ---------------------------------------------------------------------------

GROUP_BIDIR = ("dist_s", "dist_t", "sigma_s", "sigma_t")


def group_pairs(n_nodes: int):
    """The (s, t) pairs of [17]'s batches: the same on every process of
    the card (one seeded generator on it)."""
    import torch
    from repro_torch.core import sample_pairs
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 7)
    return sample_pairs(gen, n_nodes, BATCH)


class LevelClock:
    """Wraps the sharded searches' level call (``core/bfs.py``'s
    ``frontier_expand``) to time it, the card synchronized on both
    sides: ``seconds`` and ``calls`` while entered."""

    def __enter__(self):
        import repro_torch.core.bfs as bfs
        import torch
        self.seconds, self.calls = 0.0, 0
        self._orig = orig = bfs.frontier_expand

        def timed(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = orig(*args, **kw)
            torch.cuda.synchronize()
            self.seconds += time.perf_counter() - t0
            self.calls += 1
            return out

        bfs.frontier_expand = timed
        return self

    def __exit__(self, *exc):
        import repro_torch.core.bfs as bfs
        bfs.frontier_expand = self._orig


LAYOUT_ARRAYS = ("src", "dst", "block_nb", "block_sb", "block_first")


def layout_crc(arrays: dict, row: int, n_blocks: int, block_e: int) -> int:
    """CRC32 of a partition's stacked layout ``arrays`` (host tensors) at
    ``row``, cut to ``n_blocks`` edge blocks."""
    import zlib
    crc = 0
    for name in LAYOUT_ARRAYS:
        cut = n_blocks * (block_e if name in ("src", "dst") else 1)
        crc = zlib.crc32(arrays[name][row, :cut].numpy().tobytes(), crc)
    return crc


def tensor_crc(*tensors) -> int:
    import zlib
    crc = 0
    for t in tensors:
        crc = zlib.crc32(t.cpu().numpy().tobytes(), crc)
    return crc


def check_group_counts(label: str, levels: int, stop_checks: int) -> dict:
    """One rank's launches: every level one sharded level launch and one
    words pass, nothing flat or replicated, ``stop_checks`` K3."""
    from repro_torch.kernels import frontier, stopcheck
    counts = all_counts()
    want = {k: 0 for k in counts}
    want.update({frontier.NODE_BLOCKED_WIDE: levels, frontier.WORDS: levels,
                 stopcheck.STOPCHECK: stop_checks})
    if counts != want or levels == 0:
        raise AssertionError(f"{label}: launches {counts}, expected {want}")
    return counts


def group_rank(rank: int, work: str, settings: dict) -> dict:
    """[17] on one rank of the spawned gloo group, on the card: the
    rank's own shard of the production graph (a local partition), (a)-(c)
    one bidirectional and one forward batch against the parent's
    ShardMesh references (saved under ``work``), (d) ``run_kadabra`` at
    GROUP_MAX_EPOCHS, (e) hyperbolic(HYPER_N) to its stop rule, stopped
    and resumed, and resumed from the parent's ShardMesh step.
    ``settings`` are the parent's GROUP_SETTINGS."""
    import zlib
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.core import (AdaptiveConfig, GroupShardMesh,
                                  bfs_sssp_batched_sharded,
                                  bidirectional_bfs_batched_sharded,
                                  delta_sssp_batched_sharded,
                                  hyperbolic_graph, partition_graph,
                                  rmat_graph, run_kadabra)
    from repro_torch.core.distributed import assert_replicated
    from repro_torch.kernels import _build
    from repro_torch.kernels.frontier import kernel as frontier
    from repro_torch.kernels.stopcheck import kernel as stopcheck
    globals().update(settings)
    libs = {}
    t0 = time.perf_counter()
    if torch.device(DEVICE).type == "cuda":
        torch.cuda.set_device(0)
        # the parent's builds
        frontier.library(), frontier.relax_library(), stopcheck.library()
        libs = {k: _build.build_report(k)["seconds"]
                for k in ("frontier", "relax", "stopcheck")}
    mesh = GroupShardMesh(DEVICE)
    rmat = rmat_graph(RMAT_SCALE, EDGE_FACTOR, seed=SEED, device=DEVICE)
    crc = zlib.crc32(rmat.indices.cpu().numpy().tobytes(),
                     zlib.crc32(rmat.indptr.cpu().numpy().tobytes()))
    assert_replicated(mesh, {"graph_crc32": crc, "n_edges": rmat.n_edges})
    pg = partition_graph(rmat, GROUP_SHARDS, shard=rank)
    torch.cuda.synchronize()
    lay = pg.shards
    out = {"rank": rank, "libs": libs, "staged": mesh.staged,
           "setup_s": time.perf_counter() - t0,
           "layout": {"crc32": layout_crc(
               {k: getattr(lay, k).cpu() for k in LAYOUT_ARRAYS}, 0,
               lay.n_edge_blocks, lay.block_e),
               "n_edge_blocks": lay.n_edge_blocks},
           "budget": pg.exchange_budget}

    def load(name):
        return torch.from_numpy(np.load(os.path.join(work, name + ".npy"))
                                ).to(DEVICE)

    # (a)-(c): one bidirectional batch, timed by part
    s, t = group_pairs(rmat.n_nodes)
    reset_counts()
    mesh.traffic(reset=True)
    torch.cuda.synchronize()
    with LevelClock() as clock:
        t1 = time.perf_counter()
        res = bidirectional_bfs_batched_sharded(pg, s, t, mesh=mesh)
        torch.cuda.synchronize()
        search_s = time.perf_counter() - t1
    counts = check_group_counts(f"rank {rank} bidirectional batch",
                                res.n_iters, 0)
    search_traffic = mesh.traffic(reset=True)
    t1 = time.perf_counter()
    full = {f: mesh.all_gather(getattr(res, f), what="state")
            for f in GROUP_BIDIR}
    torch.cuda.synchronize()
    gather_s = time.perf_counter() - t1
    out["bidir"] = {
        "n_iters": res.n_iters, "exchange": res.exchange.tolist(),
        "search_s": search_s, "level_call_s": clock.seconds,
        "level_calls": clock.calls, "traffic": search_traffic,
        "gather_s": gather_s, "gather_traffic": mesh.traffic(reset=True),
        "counts": counts,
        "crc32": tensor_crc(full["dist_s"], full["dist_t"], res.d,
                            res.split),
        "sigma_crc32": tensor_crc(full["sigma_s"], full["sigma_t"])}
    for f in ("dist_s", "dist_t"):
        if not torch.equal(full[f], load(f).int()):
            raise AssertionError(f"rank {rank}: bidirectional {f} is not "
                                 "the ShardMesh run's")
    for f in ("d", "split"):
        if not torch.equal(getattr(res, f), load(f)):
            raise AssertionError(f"rank {rank}: bidirectional {f} differs")
    out["bidir"]["cells"] = {f: check_cells(f"rank {rank} {f}", full[f],
                                            load(f))
                             for f in ("sigma_s", "sigma_t")}
    del res, full
    reset_counts()
    res = bfs_sssp_batched_sharded(pg, s, mesh=mesh)
    counts = check_group_counts(f"rank {rank} forward batch", res.n_iters, 0)
    dist = mesh.all_gather(res.dist, what="state")
    sigma = mesh.all_gather(res.sigma, what="state")
    if not (torch.equal(dist, load("fwd_dist").int())
            and torch.equal(res.levels, load("fwd_levels"))):
        raise AssertionError(f"rank {rank}: forward dist or levels differ")
    out["forward"] = {"n_iters": res.n_iters,
                      "exchange": res.exchange.tolist(), "counts": counts,
                      "crc32": tensor_crc(dist, res.levels),
                      "sigma_crc32": tensor_crc(sigma),
                      "cells": check_cells(f"rank {rank} forward sigma",
                                           sigma, load("fwd_sigma"))}
    del res, dist, sigma
    torch.cuda.empty_cache()

    # (d) the production cell at GROUP_MAX_EPOCHS
    cfg = AdaptiveConfig(eps=MAIN_EPS, delta=MAIN_DELTA,
                         sample_batch_size=BATCH,
                         max_epochs=GROUP_MAX_EPOCHS)
    reset_counts()
    mesh.traffic(reset=True)
    t1 = time.perf_counter()
    res = run_kadabra(pg, config=cfg, seed=SEED, mesh=mesh)
    out["run"] = {"btilde": res.btilde, "tau": res.tau,
                  "n_epochs": res.n_epochs, "converged": res.converged,
                  "bfs_levels": res.bfs_levels,
                  "seconds": time.perf_counter() - t1,
                  "phases": res.phase_seconds,
                  "exchange": [s.exchange for s in res.stats],
                  "traffic": mesh.traffic(reset=True),
                  "counts": check_group_counts(f"rank {rank} run_kadabra",
                                               res.bfs_levels,
                                               len(res.stats))}
    del rmat, pg, res
    torch.cuda.empty_cache()

    # (e) accuracy and resume on hyperbolic(HYPER_N)
    hyper = hyperbolic_graph(HYPER_N, seed=SEED, device=DEVICE)
    hpg = partition_graph(hyper, GROUP_SHARDS, shard=rank,
                          block_v=HYPER_BLOCK_V)
    hcfg = AdaptiveConfig(eps=HYPER_EPS, delta=0.1)

    def hrun(label, config, ckpt=None):
        reset_counts()
        res = run_kadabra(hpg, config=config, seed=SEED, mesh=mesh,
                          checkpoint_dir=ckpt)
        check_group_counts(f"rank {rank} hyperbolic {label}",
                           res.bfs_levels, len(res.stats))
        return {"btilde": res.btilde, "tau": res.tau,
                "n_epochs": res.n_epochs, "converged": res.converged,
                "epochs": [s.epoch for s in res.stats]}

    out["hyper"] = hrun("run", hcfg)
    out["hyper_part"] = hrun("stopped", dataclasses.replace(hcfg,
                                                            max_epochs=1),
                             os.path.join(work, "own"))
    out["hyper_resumed"] = hrun("resumed", hcfg, os.path.join(work, "own"))
    out["hyper_cross"] = hrun("resumed from ShardMesh", hcfg,
                              os.path.join(work, "shard_mesh"))

    # one weighted batch on the same graph with dyadic weights, a shard
    # a rank, against the parent's ShardMesh batch
    wpg = partition_graph(weighted_graph(hyper), GROUP_SHARDS, shard=rank,
                          block_v=HYPER_BLOCK_V)
    s = group_pairs(HYPER_N)[0]
    reset_counts()
    res = delta_sssp_batched_sharded(wpg, s, mesh=mesh)
    counts = check_weighted_counts(f"rank {rank} weighted batch",
                                   res.n_iters, res.n_dag_rounds, 0)
    dist = mesh.all_gather(res.dist, what="state")
    sigma = mesh.all_gather(res.sigma, what="state")
    for f, got in (("w_dist", dist), ("w_levels", res.levels),
                   ("w_buckets", res.buckets), ("w_sigma", sigma)):
        if not torch.equal(got, load(f)):
            raise AssertionError(f"rank {rank}: weighted batch {f} is not "
                                 "the ShardMesh run's")
    out["weighted"] = {"n_iters": res.n_iters,
                       "n_dag_rounds": res.n_dag_rounds,
                       "exchange": res.exchange.tolist(), "counts": counts,
                       "crc32": tensor_crc(dist, sigma, res.levels,
                                           res.buckets)}
    return out


def group_same(label: str, a: dict, b) -> None:
    """Two runs' btilde, tau, epochs and convergence bitwise (``b`` a
    rank's dict or a BetweennessResult)."""
    if not isinstance(b, dict):
        b = {"btilde": b.btilde, "tau": b.tau, "n_epochs": b.n_epochs,
             "converged": b.converged}
    spmd_bitwise(label, a, b)


def group_reference(pg, mesh, work: str) -> dict:
    """The ShardMesh batches of (a) on the whole partition, saved under
    ``work`` for the ranks (distances as int8: they fit); -> their
    levels and seconds, and the level call's."""
    import numpy as np
    import torch
    from repro_torch.core import (bfs_sssp_batched_sharded,
                                  bidirectional_bfs_batched_sharded)
    s, t = group_pairs(pg.n_nodes)

    def save(name, x):
        x = x.cpu()
        if name.startswith(("dist", "fwd_dist")):
            x = x.to(torch.int8)
        np.save(os.path.join(work, name + ".npy"), x.numpy())

    res = bidirectional_bfs_batched_sharded(pg, s, t, mesh=mesh)   # warm
    del res
    torch.cuda.synchronize()
    with LevelClock() as clock:
        t0 = time.perf_counter()
        res = bidirectional_bfs_batched_sharded(pg, s, t, mesh=mesh)
        torch.cuda.synchronize()
        search_s = time.perf_counter() - t0
    out = {"n_iters": res.n_iters, "exchange": res.exchange.tolist(),
           "search_s": search_s, "level_call_s": clock.seconds}
    for f in GROUP_BIDIR:
        save(f, mesh.all_gather(getattr(res, f)))
    save("d", res.d)
    save("split", res.split)
    del res
    res = bfs_sssp_batched_sharded(pg, s, mesh=mesh)
    out["fwd_n_iters"] = res.n_iters
    save("fwd_dist", mesh.all_gather(res.dist))
    save("fwd_sigma", mesh.all_gather(res.sigma))
    save("fwd_levels", res.levels)
    return out


def phase_sharded_group(one_card: dict) -> dict:
    """[17] a-e: GROUP_SHARDS ranks spawned on the one card in a gloo
    group, one vertex shard each (group_rank), checked against the
    parent's ShardMesh(GROUP_SHARDS) runs, one another and exact
    Brandes; then (f) a one-rank NCCL group in this process.
    ``one_card`` is [14]'s level_breakdown, logged beside (c).  Returns
    (d)'s launch counts, summed over the ranks."""
    import dataclasses
    import shutil
    import tempfile
    import numpy as np
    import torch
    from repro_torch.core import (AdaptiveConfig, ShardMesh, brandes_numpy,
                                  delta_sssp_batched_sharded,
                                  hyperbolic_graph, partition_graph,
                                  rmat_graph, run_kadabra)
    from repro_torch.launch import spawn_local
    work = tempfile.mkdtemp(prefix="chip_smoke_group_")
    try:
        rmat = rmat_graph(RMAT_SCALE, EDGE_FACTOR, seed=SEED, device=DEVICE)
        pg = partition_graph(rmat, GROUP_SHARDS)
        mesh = ShardMesh(GROUP_SHARDS, DEVICE)
        log(f"  {GROUP_SHARDS} shards at the card's blocking: block_v "
            f"{pg.shards.block_v}, shard_rows {pg.shard_rows}, v_pad "
            f"{pg.v_pad}, {pg.shards.n_edge_blocks} edge blocks a shard "
            f"(the largest), exchange chunks of {pg.exchange_chunk_rows} "
            f"rows, budget {pg.exchange_budget} of "
            f"{pg.exchange_chunks_per_shard}")
        t0 = time.perf_counter()
        ref = group_reference(pg, mesh, work)
        # the whole partition's layout, for each rank's shard
        arrays = {k: getattr(pg.shards, k).cpu() for k in LAYOUT_ARRAYS}
        block_e, n_nodes, rows = (pg.shards.block_e, pg.n_nodes,
                                  pg.shard_rows)
        cfg = AdaptiveConfig(eps=MAIN_EPS, delta=MAIN_DELTA,
                             sample_batch_size=BATCH,
                             max_epochs=GROUP_MAX_EPOCHS)
        base = [run_kadabra(pg, config=cfg, seed=SEED, mesh=mesh)
                for _ in range(2)]
        stable = same_run(base[0], base[1])
        log(f"  ShardMesh({GROUP_SHARDS}) references in "
            f"{time.perf_counter() - t0:.1f} s: one bidirectional batch "
            f"{ref['n_iters']} levels in {ref['search_s'] * 1e3:.1f} ms "
            f"({ref['search_s'] * 1e3 / ref['n_iters']:.3f} ms a level, the "
            f"level call {ref['level_call_s'] * 1e3 / ref['n_iters']:.3f} "
            f"ms), exchange tally {ref['exchange']}; forward batch "
            f"{ref['fwd_n_iters']} levels; run_kadabra at max_epochs "
            f"{GROUP_MAX_EPOCHS}: tau {base[0].tau}, {base[0].bfs_levels} "
            f"levels, two runs bitwise alike: {stable}")
        del pg
        torch.cuda.empty_cache()
        hyper = hyperbolic_graph(HYPER_N, seed=SEED, device=DEVICE)
        hpg = partition_graph(hyper, GROUP_SHARDS, block_v=HYPER_BLOCK_V)
        hcfg = AdaptiveConfig(eps=HYPER_EPS, delta=0.1)
        hbase = run_kadabra(hpg, config=hcfg, seed=SEED, mesh=mesh)
        run_kadabra(hpg, config=dataclasses.replace(hcfg, max_epochs=1),
                    seed=SEED, mesh=mesh,
                    checkpoint_dir=os.path.join(work, "shard_mesh"))
        wpg = partition_graph(weighted_graph(hyper), GROUP_SHARDS,
                              block_v=HYPER_BLOCK_V)
        wres = delta_sssp_batched_sharded(wpg, group_pairs(HYPER_N)[0],
                                          mesh=mesh)
        for f, x in (("w_dist", mesh.all_gather(wres.dist)),
                     ("w_sigma", mesh.all_gather(wres.sigma)),
                     ("w_levels", wres.levels),
                     ("w_buckets", wres.buckets)):
            np.save(os.path.join(work, f + ".npy"), x.cpu().numpy())
        t0 = time.perf_counter()
        ranks = spawn_local(group_rank, GROUP_SHARDS,
                            args=(work, {k: globals()[k]
                                         for k in GROUP_SETTINGS}),
                            backend="gloo", timeout=GROUP_TIMEOUT,
                            store_dir=work)
        wall = time.perf_counter() - t0
    finally:
        shutil.rmtree(work, ignore_errors=True)
    r0 = ranks[0]
    log(f"  {GROUP_SHARDS} ranks spawned and done in {wall:.1f} s; rank 0 "
        f"loaded the parent's builds (nvcc seconds {r0['libs']}), built "
        f"R-MAT and its shard in {r0['setup_s']:.1f} s; tensors on the "
        f"card staged through the host: {r0['staged']}")
    for r in ranks:
        if any(r["libs"].values()):
            raise AssertionError(f"rank {r['rank']} rebuilt a kernel: "
                                 f"{r['libs']}")
        nb = r["layout"]["n_edge_blocks"]
        pad = arrays["src"][r["rank"], nb * block_e:]
        if r["layout"]["crc32"] != layout_crc(arrays, r["rank"], nb,
                                              block_e) \
                or not bool((pad == n_nodes).all()) \
                or not bool((arrays["dst"][r["rank"], nb * block_e:]
                             == rows).all()) \
                or r["budget"] != r0["budget"]:
            raise AssertionError(f"rank {r['rank']}: its shard is not row "
                                 f"{r['rank']} of the parent's partition")
    blocks = [r["layout"]["n_edge_blocks"] for r in ranks]
    log(f"  (a) every rank's shard is its row of the parent's partition up "
        f"to the inert padding (CRC32 of the layout; edge blocks {blocks}); "
        f"budget {r0['budget']}")
    for kind in ("bidir", "forward"):
        for r in ranks:
            a, b = r[kind], r0[kind]
            if (a["crc32"], a["sigma_crc32"], a["exchange"], a["n_iters"]) \
                    != (b["crc32"], b["sigma_crc32"], b["exchange"],
                        b["n_iters"]):
                raise AssertionError(f"{kind}: rank {r['rank']} is not "
                                     "bitwise rank 0")
    bd, fw = r0["bidir"], r0["forward"]
    if bd["n_iters"] != ref["n_iters"] or fw["n_iters"] != ref["fwd_n_iters"]:
        raise AssertionError(f"levels differ from the ShardMesh run: "
                             f"{bd['n_iters']}, {fw['n_iters']} vs "
                             f"{ref['n_iters']}, {ref['fwd_n_iters']}")
    log(f"  (a) bidirectional batch of {BATCH}: {bd['n_iters']} levels, "
        f"exchange {bd['exchange']} (levels, sparse); dist_s, dist_t, d "
        f"and split bitwise the ShardMesh({GROUP_SHARDS}) run on every "
        f"rank; sigma (exact cells, others, max |diff|) {bd['cells']}; "
        f"forward batch {fw['n_iters']} levels, dist and levels bitwise, "
        f"sigma {fw['cells']}; every rank bitwise rank 0 (CRC32 of the "
        "gathered state)")
    log(f"  (b) launches a rank: bidirectional {bd['counts']}, forward "
        f"{fw['counts']}: one level launch and one words pass a level, no "
        "flat or replicated node-blocked launch")
    tr = bd["traffic"]
    levels, sparse = bd["exchange"]
    dense = levels - sparse
    xch_s = sum(tr.get(k, {}).get("seconds", 0.0)
                for k in ("bits", "pick", "dense", "sparse"))
    red_s = tr.get("reduce", {}).get("seconds", 0.0)
    rest = bd["search_s"] - xch_s - red_s - bd["level_call_s"]
    rest_14 = (one_card["sharded_level_ms"] - one_card["exchange_ms"]
               - one_card["wide_ms"])
    log(f"  (c) rank 0, a level of the bidirectional batch: "
        f"{bd['search_s'] * 1e3 / levels:.3f} ms = exchange "
        f"{xch_s * 1e3 / levels:.3f} ms (bits, pick and the chosen "
        f"protocol's gathers, staged) + the level call "
        f"{bd['level_call_s'] * 1e3 / levels:.3f} ms + the reductions "
        f"{red_s * 1e3 / levels:.3f} ms + the rest {rest * 1e3 / levels:.3f}"
        f" ms; ShardMesh({GROUP_SHARDS}) on one card "
        f"{ref['search_s'] * 1e3 / ref['n_iters']:.3f} ms a level (its "
        f"level call {ref['level_call_s'] * 1e3 / ref['n_iters']:.3f} ms)"
        f"; [14]'s one-card level ({SHARDS} shards, the mid-BFS state) "
        f"{one_card['sharded_level_ms']:.3f} ms = exchange "
        f"{one_card['exchange_ms']:.3f} + the level call "
        f"{one_card['wide_ms']:.3f} + the rest {rest_14:.3f}")
    for name, n in (("dense", dense), ("sparse", sparse)):
        rec = tr.get(name)
        if rec is None:
            log(f"      {name}: 0 levels")
            continue
        log(f"      {name}: {n} levels, {rec['calls']} gathers, "
            f"{rec['sent_bytes'] / max(n, 1):.0f} bytes sent and "
            f"{rec['staged_bytes'] / max(n, 1):.0f} staged a level, "
            f"{rec['seconds'] * 1e3 / max(n, 1):.3f} ms a level")
    for name in ("bits", "pick", "reduce"):
        rec = tr.get(name, {"calls": 0, "sent_bytes": 0,
                            "staged_bytes": 0, "seconds": 0.0})
        log(f"      {name}: {rec['calls']} calls, {rec['sent_bytes']} bytes "
            f"sent, {rec['staged_bytes']} staged, {rec['seconds'] * 1e3:.3f}"
            f" ms in all")
    st = bd["gather_traffic"]["state"]
    log(f"      the state's gather once a batch (4 tensors): "
        f"{bd['gather_s']:.3f} s, {st['sent_bytes']} bytes sent, "
        f"{st['staged_bytes']} staged")
    if "dense" in tr and dense == 0 or "sparse" in tr and sparse == 0:
        raise AssertionError(f"a protocol crossed the wire on no level of "
                             f"its own: {tr}, tally {bd['exchange']}")

    run = r0["run"]
    for r in ranks[1:]:
        spmd_bitwise(f"(d) rank {r['rank']} against rank 0", r["run"], run)
    gap = float(np.abs(run["btilde"] - base[0].btilde).max())
    if stable:
        group_same("(d) against the ShardMesh run", run, base[0])
    elif not gap < 2 * MAIN_EPS:
        raise AssertionError(f"(d): max |b - b_ShardMesh| {gap} >= 2 eps")
    rt = run["traffic"]
    log(f"  (d) run_kadabra, max_epochs {GROUP_MAX_EPOCHS}: "
        f"{run['seconds']:.1f} s, phases "
        + ", ".join(f"{k} {v:.2f} s" for k, v in run["phases"].items())
        + f"; tau {run['tau']}, epochs {run['n_epochs']}, BFS levels "
        f"{run['bfs_levels']}; every rank bitwise rank 0; against the "
        f"ShardMesh run (two of which were bitwise alike: {stable}): "
        f"max |diff| {gap}; launches a rank {run['counts']}")
    for name, rec in sorted(rt.items()):
        log(f"      {name}: {rec['calls']} calls, "
            f"{rec['sent_bytes'] / 1e9:.3f} GB sent, "
            f"{rec['staged_bytes'] / 1e9:.3f} GB staged, "
            f"{rec['seconds']:.2f} s")

    hyper_cpu = hyperbolic_graph(HYPER_N, seed=SEED, device="cpu")
    err = float(np.abs(r0["hyper"]["btilde"]
                       - brandes_numpy(hyper_cpu)).max())
    for r in ranks:
        spmd_bitwise(f"(e) rank {r['rank']} against rank 0", r["hyper"],
                     r0["hyper"])
        spmd_bitwise(f"(e) rank {r['rank']} resumed", r["hyper_resumed"],
                     r["hyper"])
        group_same(f"(e) rank {r['rank']} from the ShardMesh step",
                   r["hyper_cross"], hbase)
        if r["hyper_part"]["n_epochs"] != 1 or \
                r["hyper_resumed"]["epochs"][:1] != [2] or \
                r["hyper_cross"]["epochs"][:1] != [2]:
            raise AssertionError(f"(e) rank {r['rank']}: the resumed runs "
                                 "did not start at epoch 2")
    group_same("(e) against the ShardMesh run", r0["hyper"], hbase)
    log(f"  (e) hyperbolic({HYPER_N}) in {GROUP_SHARDS} ranks: tau "
        f"{r0['hyper']['tau']}, {r0['hyper']['n_epochs']} epochs, max |b~ - "
        f"b| = {err:.5f} (eps {HYPER_EPS}); stopped after 1 epoch and "
        f"resumed, and resumed from the ShardMesh({GROUP_SHARDS}) step: "
        f"bitwise on every rank, and bitwise the ShardMesh run")
    if not (err < HYPER_EPS and r0["hyper"]["converged"]):
        raise AssertionError(f"(e) hyperbolic: max error {err} >= "
                             f"{HYPER_EPS}")
    wb = r0["weighted"]
    for r in ranks:
        if (r["weighted"]["crc32"], r["weighted"]["exchange"]) != \
                (wb["crc32"], wb["exchange"]):
            raise AssertionError(f"(e) weighted: rank {r['rank']} is not "
                                 "bitwise rank 0")
    if (wb["n_iters"], wb["n_dag_rounds"]) != (wres.n_iters,
                                               wres.n_dag_rounds):
        raise AssertionError("(e) weighted: the rounds differ from the "
                             "ShardMesh batch's")
    log(f"  (e) one weighted batch of {BATCH} on the weighted "
        f"hyperbolic({HYPER_N}) in {GROUP_SHARDS} ranks: {wb['n_iters']} "
        f"relaxation rounds, {wb['n_dag_rounds']} DAG rounds, exchange "
        f"{wb['exchange']}; dist, sigma, levels and buckets bitwise the "
        f"ShardMesh({GROUP_SHARDS}) batch on every rank; launches a rank "
        f"{wb['counts']}")
    phase_nccl_group(rmat)
    del rmat
    torch.cuda.empty_cache()
    keys = run["counts"]
    return {k: sum(r["run"]["counts"][k] for r in ranks) for k in keys}


def phase_nccl_group(rmat) -> None:
    """[17f] a one-rank NCCL group in this process: one bidirectional
    batch on ``partition_graph(rmat, 1, shard=0)`` over a GroupShardMesh
    (collectives on the card, nothing staged) against the ShardMesh(1)
    batch on the whole one-shard partition."""
    import datetime
    import shutil
    import tempfile
    import torch
    import torch.distributed as dist
    from repro_torch.core import (GroupShardMesh, ShardMesh,
                                  bidirectional_bfs_batched_sharded,
                                  partition_graph)
    s, t = group_pairs(rmat.n_nodes)
    one = partition_graph(rmat, 1)
    want = bidirectional_bfs_batched_sharded(one, s, t,
                                             mesh=ShardMesh(1, DEVICE))
    root = tempfile.mkdtemp(prefix="chip_smoke_nccl_group_")
    dist.init_process_group(
        "nccl", store=dist.FileStore(os.path.join(root, "store"), 1), rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=120))
    try:
        mesh = GroupShardMesh(DEVICE)
        local = partition_graph(rmat, 1, shard=0)
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = bidirectional_bfs_batched_sharded(local, s, t, mesh=mesh)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        counts = check_group_counts("[17f] NCCL batch", got.n_iters, 0)
        traffic = mesh.traffic(reset=True)
    finally:
        dist.destroy_process_group()
        shutil.rmtree(root, ignore_errors=True)
    if mesh.staged or any(v["staged_bytes"] for v in traffic.values()):
        raise AssertionError(f"[17f] NCCL staged bytes: {traffic}")
    for f in ("dist_s", "dist_t", "d", "split"):
        if not torch.equal(getattr(got, f), getattr(want, f)):
            raise AssertionError(f"[17f] NCCL {f} is not the ShardMesh(1) "
                                 "batch's")
    cells = {f: check_cells(f"[17f] {f}", getattr(got, f), getattr(want, f))
             for f in ("sigma_s", "sigma_t")}
    bitwise = all(torch.equal(getattr(got, f), getattr(want, f))
                  for f in ("sigma_s", "sigma_t"))
    log(f"  (f) one-rank NCCL GroupShardMesh, one bidirectional batch on "
        f"partition_graph(rmat, 1, shard=0): {got.n_iters} levels in "
        f"{ms:.1f} ms, collectives on the card, nothing staged; dist, d and "
        f"split bitwise the ShardMesh(1) batch, sigma (exact cells, "
        f"others, max |diff|) {cells}, all bitwise: {bitwise}; launches "
        f"{counts}; collectives {sorted(traffic)}")



# ---------------------------------------------------------------------------
# [18] the weighted delta-stepping lane: W1 and W2
# ---------------------------------------------------------------------------

def check_weighted_counts(label: str, rounds: int, dag_rounds: int,
                          stop_checks: int) -> dict:
    """The launches of the weighted run just made: every relaxation round
    one W1 launch, every DAG round one W2 launch, ``stop_checks`` K3,
    nothing else (no BFS level, no words pass)."""
    from repro_torch.kernels import frontier, stopcheck
    counts = all_counts()
    want = {k: 0 for k in counts}
    want.update({frontier.RELAX: rounds, frontier.DAG_SIGMA: dag_rounds,
                 stopcheck.STOPCHECK: stop_checks})
    if counts != want or rounds == 0 or dag_rounds == 0:
        raise AssertionError(f"{label}: launches {counts}, expected {want}")
    return counts


def weighted_graph(graph):
    """``graph`` with the JAX package's dyadic weights at SEED (multiples
    of 1/16 in [1/16, 2], both directions of an edge alike)."""
    from repro_torch.core import symmetric_dyadic_weights, with_weights
    return with_weights(graph, symmetric_dyadic_weights(graph, seed=SEED))


def weighted_brandes(graph):
    """Exact weighted betweenness normalized by n(n-1) (the oracle of
    tests/test_weighted.py: scipy's Dijkstra, then per source the
    distance-ordered DP), on the host.  A source's on-DAG edges are taken
    in groups of equal destination distance: every in-edge of a group
    comes from a strictly nearer vertex (weights > 0), so each group's
    counts (forward) and dependencies (backward) are one np.add.at."""
    import numpy as np
    import scipy.sparse as sp
    from scipy.sparse.csgraph import dijkstra
    n, e = graph.n_nodes, graph.n_edges
    src = graph.src[:e].cpu().numpy().astype(np.int64)
    dst = graph.dst[:e].cpu().numpy().astype(np.int64)
    w = graph.weight[:e].cpu().numpy().astype(np.float64)
    dist = dijkstra(sp.csr_matrix((w, (src, dst)), shape=(n, n)),
                    directed=True)
    bc = np.zeros(n)
    for s in range(n):
        d = dist[s]
        on = np.isfinite(d[src]) & (d[src] + w == d[dst])
        es, ed = src[on], dst[on]
        idx = np.argsort(d[ed], kind="stable")
        es, ed = es[idx], ed[idx]
        key = d[ed]
        bounds = np.concatenate([[0], np.flatnonzero(np.diff(key)) + 1,
                                 [key.size]])
        sigma = np.zeros(n)
        sigma[s] = 1.0
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            np.add.at(sigma, ed[lo:hi], sigma[es[lo:hi]])
        dep = np.zeros(n)
        for lo, hi in zip(bounds[-2::-1], bounds[:0:-1]):
            u, v = es[lo:hi], ed[lo:hi]
            np.add.at(dep, u, sigma[u] / sigma[v] * (1.0 + dep[v]))
        dep[s] = 0.0
        bc += dep
    return bc / (n * (n - 1)), dist


def linked_sources(graph, batch: int, seed: int):
    """``batch`` seeded sources among the vertices with a neighbour."""
    import torch
    gen = torch.Generator(device=graph.device).manual_seed(seed)
    linked = torch.nonzero(graph.degree > 0)[:, 0]
    pick = torch.randint(0, linked.shape[0], (batch,), generator=gen,
                         device=graph.device)
    return linked[pick].to(torch.int32)


def mid_weighted_state(graph, sources):
    """One weighted batch from ``sources``, its state captured half way
    through the relaxation rounds (tent, the round's bucket) and half way
    through the DAG rounds (tent, sigma, final): the inputs W1 and W2
    see on the main path.  -> (captures, the batch's SSSPResult)."""
    import torch
    from repro_torch.core import bfs as core_bfs
    from repro_torch.kernels.frontier import dag_sigma, frontier_relax
    probe = core_bfs.delta_sssp_batched(graph, sources)
    half_r, half_d = probe.n_iters // 2, max(probe.n_dag_rounds // 2, 1)
    seen = {"relax": 0, "dag": 0}
    cap = {}
    relax0, dag0 = core_bfs.frontier_relax, core_bfs.dag_sigma

    def relax(src, dst, weight, tent, active, **kw):
        if seen["relax"] == half_r:
            cap["relax"] = (tent.clone(), active.clone())
        seen["relax"] += 1
        return frontier_relax(src, dst, weight, tent, active, **kw)

    def dag(src, dst, weight, tent, sigma, final, **kw):
        seen["dag"] += 1
        if seen["dag"] == half_d:
            cap["dag"] = (tent.clone(), sigma.clone(), final.clone())
        return dag_sigma(src, dst, weight, tent, sigma, final, **kw)

    core_bfs.frontier_relax, core_bfs.dag_sigma = relax, dag
    try:
        res = core_bfs.delta_sssp_batched(graph, sources)
    finally:
        core_bfs.frontier_relax, core_bfs.dag_sigma = relax0, dag0
    torch.cuda.synchronize()
    for f in ("dist", "sigma", "levels", "buckets"):
        if not torch.equal(getattr(res, f), getattr(probe, f)):
            raise AssertionError(f"two weighted batches differ in {f}")
    return cap, res


def plan_bytes(rplan) -> int:
    p = rplan.plan
    return sum(t.numel() * t.element_size() for t in (
        p.ids_sorted, p.offsets, p.item_begin, p.item_end, p.split_seg,
        p.split_first, rplan.weight, rplan.item_row))


def check_relax_kernel(graph, tent, active) -> dict:
    """W1 at the captured round against its plain version (min is exact:
    bitwise), timed a call beside its kernels' device time, the plain
    version, and the bound of the function on this round's bucket (not
    of the pull's traffic): the bucket mask, tent at its cells, the
    bucket rows' out-edges (CSR offsets, targets, weights) and the
    output once, an add and a min for each edge and active column of
    its source."""
    import torch
    from repro_torch.kernels.frontier import (frontier_relax_batched_ref,
                                              frontier_relax_pull)
    rplan = graph.relax_plan()
    rows, batch = tent.shape
    got = frontier_relax_pull(rplan, tent, active)
    want = frontier_relax_batched_ref(graph.src, graph.dst, graph.weight,
                                      tent, active)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        bad = int((got != want).sum())
        raise AssertionError(f"W1: {bad} cells differ from its plain version")
    n_act = int(active.any(dim=1).sum())
    log(f"  W1 frontier_relax: bitwise its plain version ({n_act} rows in "
        f"the bucket, {int(torch.isfinite(got).sum())} finite candidates)")
    ms = cuda_time_ms(lambda: frontier_relax_pull(rplan, tent, active), 20)
    device = kernel_device_ms(lambda: frontier_relax_pull(rplan, tent,
                                                          active),
                              20, ("relax_pull_kernel",
                                   "relax_pull_combine_kernel"))
    plain = cuda_time_ms(lambda: frontier_relax_batched_ref(
        graph.src, graph.dst, graph.weight, tent, active), 3)
    act = active[: graph.n_nodes].sum(dim=1, dtype=torch.int64)
    deg = torch.diff(graph.indptr.long())
    n_act_cells = int(act.sum())
    n_act_edges = int(deg[act > 0].sum())
    n_edge_cells = int((deg * act).sum())
    n_bytes = (rows * batch + 4 * n_act_cells + 8 * n_act
               + 8 * n_act_edges + 4 * rows * batch)
    b_ms, b_by = bound(n_bytes, 2.0 * n_edge_cells)
    log(f"  W1 bound's work: {n_act_cells} bucket cells, {n_act_edges} "
        f"out-edges of the bucket rows, {n_edge_cells} (edge, active "
        f"column) pairs; the pull's plan alone is {plan_bytes(rplan)} "
        f"bytes")
    log(f"  W1: {ms:.3f} ms a call; device time "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in device.items())
        + f"; plain {plain:.3f} ms, bound {b_ms:.3f} ms ({b_by}, "
        f"{n_bytes} bytes); library: none")
    return {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "device_ms": device}


def check_dag_kernel(graph, tent, sigma, final) -> dict:
    """W2 at the captured DAG round against its plain version: bitwise on
    the path's counts (exact integers: every order gives the same bits),
    and on non-integer sigma the same bits twice and within the
    summation-order bound; timed beside its plain version and bound."""
    import torch
    from repro_torch.kernels.frontier import (dag_round_batched_ref,
                                              dag_sigma_pull)
    rplan = graph.relax_plan()
    rows, batch = tent.shape
    got = dag_sigma_pull(rplan, tent, sigma, final)
    want = dag_round_batched_ref(graph.src, graph.dst, graph.weight, tent,
                                 sigma, final)
    torch.cuda.synchronize()
    exact = bool(want[0].max() < EXACT_LIMIT) and bool(
        torch.equal(want[0], torch.round(want[0])))
    if not (exact and torch.equal(got[0], want[0])
            and torch.equal(got[1], want[1])):
        raise AssertionError(f"W2: not bitwise its plain version (exact "
                             f"integer sums: {exact})")
    log(f"  W2 dag_sigma: bitwise its plain version on the path's counts "
        f"(exact integers; {int(final.sum())} of {final.numel()} cells "
        f"final, {int(got[1].sum())} waiting, "
        f"{int(((got[0] > 0) & ~got[1]).sum())} finalizing)")
    gen = torch.Generator(device=tent.device).manual_seed(SEED + 18)
    noisy = (sigma * (0.5 + torch.rand(sigma.shape, generator=gen,
                                       device=tent.device))).contiguous()
    a = dag_sigma_pull(rplan, tent, noisy, final)
    b = dag_sigma_pull(rplan, tent, noisy, final)
    ref = dag_round_batched_ref(graph.src, graph.dst, graph.weight, tent,
                                noisy, final)
    torch.cuda.synchronize()
    if not (torch.equal(a[0], b[0]) and torch.equal(a[1], ref[1])):
        raise AssertionError("W2: two launches on non-integer sigma differ")
    counts = torch.diff(rplan.plan.offsets)
    counts = torch.cat([counts, counts.new_zeros(rows - counts.shape[0])])
    tol = 2.0 * counts[:, None].float() * U32 * ref[0]
    gap = (a[0] - ref[0]).abs()
    if not bool((gap <= tol).all()):
        raise AssertionError(f"W2: max |diff| {float(gap.max())} beyond "
                             "the summation-order bound")
    log(f"  W2 on non-integer sigma: the same bits twice; max |diff| "
        f"{float(gap.max()):.3g} from the plain version (atomics), within "
        f"the order bound")
    ms = cuda_time_ms(lambda: dag_sigma_pull(rplan, tent, sigma, final), 20)
    device = kernel_device_ms(lambda: dag_sigma_pull(rplan, tent, sigma,
                                                     final),
                              20, ("dag_sigma_pull_kernel",
                                   "dag_sigma_pull_combine_kernel"))
    plain = cuda_time_ms(lambda: dag_round_batched_ref(
        graph.src, graph.dst, graph.weight, tent, sigma, final), 3)
    n_bytes = plan_bytes(rplan) + rows * batch * (4 + 4 + 1 + 4 + 1)
    b_ms, b_by = bound(n_bytes, 3.0 * graph.n_edges * batch)
    log(f"  W2: {ms:.3f} ms a call; device time "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in device.items())
        + f"; plain {plain:.3f} ms, bound {b_ms:.3f} ms ({b_by}, "
        f"{n_bytes} bytes); library: none")
    return {"max_abs_err": 0.0, "noisy_max_abs_err": float(gap.max()),
            "ms": ms, "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None, "device_ms": device}


def check_dijkstra(graph, sources, dist) -> None:
    """The distances of two of a batch's sources bitwise scipy's float64
    Dijkstra over the graph's CSR, cast to float32."""
    import numpy as np
    import scipy.sparse as sp
    from scipy.sparse.csgraph import dijkstra
    n = graph.n_nodes
    indptr = graph.indptr.cpu().numpy()
    e = int(indptr[-1])
    csr = sp.csr_matrix((graph.weight[:e].cpu().numpy().astype(np.float64),
                         graph.indices[:e].cpu().numpy(), indptr),
                        shape=(n, n))
    t0 = time.perf_counter()
    want = dijkstra(csr, directed=True, indices=sources[:2].tolist())
    got = dist[:n, :2].cpu().numpy().T
    want = np.where(np.isfinite(want), want, -1.0).astype(np.float32)
    if not np.array_equal(got, want):
        raise AssertionError(f"weighted distances differ from scipy's "
                             f"Dijkstra at {int((got != want).sum())} cells")
    log(f"  distances from sources {sources[:2].tolist()} bitwise scipy's "
        f"Dijkstra ({int((want >= 0).sum())} reached; scipy took "
        f"{time.perf_counter() - t0:.1f} s)")


def weighted_round_split(graph, sources) -> dict:
    """One weighted batch under the profiler: W1's and W2's device time
    against the batch's wall time, by round."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import delta_sssp_batched
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = delta_sssp_batched(graph, sources)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    dev = {"relax": 0.0, "dag": 0.0, "other": 0.0}
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = evt.self_device_time_total / 1e3
        key = ("relax" if "relax_pull" in evt.key else
               "dag" if "dag_sigma_pull" in evt.key else "other")
        dev[key] += ms
    rounds = res.n_iters + res.n_dag_rounds
    out = {"wall_ms": wall, "rounds": res.n_iters,
           "dag_rounds": res.n_dag_rounds,
           "w1_ms_a_round": dev["relax"] / max(res.n_iters, 1),
           "w2_ms_a_round": dev["dag"] / max(res.n_dag_rounds, 1),
           "other_device_ms": dev["other"],
           "idle_share": 1.0 - sum(dev.values()) / wall,
           "rest_ms_a_round": (wall - dev["relax"] - dev["dag"]) / rounds}
    log(f"  one batch of {sources.shape[0]} under the profiler: wall "
        f"{wall:.1f} ms for {res.n_iters} relaxation rounds and "
        f"{res.n_dag_rounds} DAG rounds: W1 {out['w1_ms_a_round']:.3f} ms "
        f"a round, W2 {out['w2_ms_a_round']:.3f} ms a round, the rest "
        f"(the host loop's PyTorch ops and its sync) "
        f"{out['rest_ms_a_round']:.3f} ms a round; other device time "
        f"{dev['other']:.1f} ms, device idle share {out['idle_share']:.3f}")
    return out


def phase_weighted():
    """[18] a-e: the weighted lane on the card (module docstring).
    Returns (W1's row, W2's row, the paths' launch counts)."""
    import numpy as np
    import torch
    from repro_torch.core import (AdaptiveConfig, ShardMesh,
                                  bfs_sssp_batched, compute_omega,
                                  delta_sssp_batched,
                                  delta_sssp_batched_sharded,
                                  erdos_renyi_graph, grid_graph,
                                  partition_graph, rmat_graph, run_adaptive,
                                  with_weights)
    from repro_torch.kernels.frontier import FLAT, launch_counts
    paths = {}
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    graph = weighted_graph(rmat_graph(RMAT_SCALE, EDGE_FACTOR, seed=SEED,
                                      device=DEVICE))
    rplan = graph.relax_plan()
    torch.cuda.synchronize()
    log(f"  weighted R-MAT 2^{RMAT_SCALE} x {EDGE_FACTOR} and its relax plan "
        f"built in {time.perf_counter() - t0:.1f} s: {rplan.plan.n_items} "
        f"items in {rplan.plan.split_seg.shape[0]} cut rows, mean weight "
        f"{float(graph.weight.double().sum()) / graph.n_edges:.6f}")

    # (a) W1 and W2 at a mid-SSSP state of the production graph, B = 64
    sources = linked_sources(graph, BATCH, SEED + 180)
    cap, batch = mid_weighted_state(graph, sources)
    log(f"[18a] a batch of {BATCH}: {batch.n_iters} relaxation rounds, "
        f"{batch.n_dag_rounds} DAG rounds, buckets "
        f"{batch.buckets.tolist()[:8]}..., DAG depth "
        f"{batch.levels.tolist()[:8]}...")
    w1 = check_relax_kernel(graph, *cap["relax"])
    w2 = check_dag_kernel(graph, *cap["dag"])
    check_dijkstra(graph, sources.cpu(), batch.dist)
    split = weighted_round_split(graph, sources)
    del cap
    torch.cuda.empty_cache()

    # (b) the production graph's run, single lane, eps cut to fit
    config = AdaptiveConfig(eps=WEIGHTED_EPS, delta=MAIN_DELTA,
                            sample_batch_size=BATCH,
                            max_epochs=MAIN_MAX_EPOCHS)
    reset_counts()
    t0 = time.perf_counter()
    res = run_adaptive(graph, ("betweenness",), stream="weighted",
                       config=config, seed=SEED, device=DEVICE)
    seconds = time.perf_counter() - t0
    paths["weighted"] = check_weighted_counts(
        "weighted run", res.bfs_levels, res.dag_rounds, len(res.stats))
    scores = res.reports[0].scores
    if not (np.isfinite(scores).all() and (scores >= 0).all()
            and (scores <= 1).all() and scores.shape == (graph.n_nodes,)):
        raise AssertionError("weighted run: scores not finite in [0, 1]")
    n_batches = -(-res.tau // BATCH)
    samp = res.phase_seconds["sampling"]
    per_sample = samp / max(sum(s.samples for s in res.stats), 1)
    omega = float(compute_omega(res.vertex_diameter, MAIN_EPS, MAIN_DELTA))
    proj = min(res.tau * (WEIGHTED_EPS / MAIN_EPS) ** 2, omega)
    log(f"[18b] run_adaptive betweenness, stream='weighted', R-MAT "
        f"2^{RMAT_SCALE} x {EDGE_FACTOR}, B={BATCH}, eps={WEIGHTED_EPS} "
        f"(cut from the cell's {MAIN_EPS} to fit the phase), delta "
        f"{MAIN_DELTA}: {seconds:.1f} s, phases "
        + ", ".join(f"{k} {v:.2f} s" for k, v in res.phase_seconds.items())
        + f"; tau {res.tau}, epochs {res.n_epochs}, converged "
        f"{res.converged}, vertex diameter {res.vertex_diameter}, distance "
        f"cap {res.distance_cap}; {res.bfs_levels} relaxation rounds and "
        f"{res.dag_rounds} DAG rounds in all (about "
        f"{res.bfs_levels / max(n_batches, 1):.1f} and "
        f"{res.dag_rounds / max(n_batches, 1):.1f} a batch, phase 1 and "
        f"calibration included); launches {paths['weighted']} (K3 one a "
        f"check, {len(res.stats)} checks)")
    log(f"  projection to eps {MAIN_EPS}: tau ~ {res.tau} x "
        f"({WEIGHTED_EPS}/{MAIN_EPS})^2, at most omega {omega:.0f}: "
        f"~{proj:.0f} samples at {per_sample * 1e3:.3f} ms a sample "
        f"(measured, sampling phase) = ~{proj * per_sample:.0f} s of "
        "sampling (not measured)")
    weighted_run = {"seconds": seconds, "tau": res.tau,
                    "n_epochs": res.n_epochs, "phases": res.phase_seconds,
                    "rounds": res.bfs_levels, "dag_rounds": res.dag_rounds,
                    "split": split}

    # (e) one sharded batch on ShardMesh(SHARDS) of the same graph
    t0 = time.perf_counter()
    pg = partition_graph(graph, SHARDS)
    mesh = ShardMesh(SHARDS, DEVICE)
    pg.shards.relax_plan()
    torch.cuda.synchronize()
    t_part = time.perf_counter() - t0
    reset_counts()
    t0 = time.perf_counter()
    sh = delta_sssp_batched_sharded(pg, sources, mesh=mesh)
    torch.cuda.synchronize()
    t_sh = time.perf_counter() - t0
    counts = check_weighted_counts("sharded batch", sh.n_iters,
                                   sh.n_dag_rounds, 0)
    v1 = graph.n_nodes + 1
    dist = mesh.all_gather(sh.dist)[:v1]
    for f, got in (("dist", dist), ("levels", sh.levels),
                   ("buckets", sh.buckets)):
        if not torch.equal(got, getattr(batch, f)):
            raise AssertionError(f"sharded batch: {f} differs from the "
                                 "replicated batch")
    cells = check_cells("sharded sigma", mesh.all_gather(sh.sigma)[:v1],
                        batch.sigma)
    log(f"[18e] one batch on ShardMesh({SHARDS}) (partitioned with weights "
        f"and its relax plan in {t_part:.1f} s): {t_sh * 1e3:.1f} ms, "
        f"{sh.n_iters} rounds (one W1 launch each over all {SHARDS} "
        f"shards), {sh.n_dag_rounds} DAG rounds, exchange "
        f"{sh.exchange.tolist()}; dist, levels and buckets bitwise the "
        f"replicated batch; sigma (exact cells, others, max |diff|) "
        f"{cells}; launches {counts}")
    del pg, mesh, sh, dist, graph, rplan, batch
    torch.cuda.empty_cache()

    # (c) accuracy against exact weighted Brandes
    for seed in range(SEED, SEED + 20):
        er = erdos_renyi_graph(ER_N, ER_DEGREE, seed=seed, device=DEVICE)
        if np.isfinite(dense_distances(er)).all():
            break
    else:
        raise AssertionError("no connected Erdos-Renyi instance in 20 seeds")
    er = weighted_graph(er)
    reset_counts()
    res = run_adaptive(er, ("betweenness",), stream="weighted",
                       eps=WER_EPS, delta=0.1, seed=SEED, device=DEVICE)
    paths["weighted_er"] = check_weighted_counts(
        "weighted ER", res.bfs_levels, res.dag_rounds, len(res.stats))
    t0 = time.perf_counter()
    exact, _ = weighted_brandes(er)
    err = float(np.abs(res.reports[0].scores - exact).max())
    log(f"[18c] weighted ER({ER_N}, seed {seed}) betweenness at eps "
        f"{WER_EPS}: tau {res.tau}, {res.n_epochs} epochs, converged "
        f"{res.converged}; max |b~ - b| = {err:.5f} against exact weighted "
        f"Brandes (scipy Dijkstra + DP, {time.perf_counter() - t0:.1f} s)")
    if not (err < WER_EPS and res.converged):
        raise AssertionError(f"weighted ER: max error {err} >= {WER_EPS}")

    # (d) R5 on the card: the unit grid against the BFS lane
    grid = grid_graph(WGRID_SIDE, WGRID_SIDE, device=DEVICE)
    unit = with_weights(grid, torch.ones(grid.n_edges, device=DEVICE))
    reset_counts()
    got = delta_sssp_batched(unit, [0], delta=1.0)
    check_weighted_counts("unit grid", got.n_iters, got.n_dag_rounds, 0)
    bfs = bfs_sssp_batched(grid, [0])
    torch.cuda.synchronize()
    rel = float(((got.sigma - bfs.sigma).abs()
                 / bfs.sigma.clamp(min=1e-30)).max())
    want_levels = 2 * (WGRID_SIDE - 1)
    if not (int(got.levels[0]) == int(bfs.levels[0]) == want_levels
            and torch.equal(got.dist, bfs.dist.float())
            and int(got.buckets[0]) == int(bfs.levels[0]) and rel < 1e-5
            and launch_counts[FLAT] == bfs.n_iters):
        raise AssertionError(f"unit grid: levels {got.levels.tolist()} vs "
                             f"BFS {bfs.levels.tolist()}, sigma rel {rel}")
    log(f"[18d] R5: {WGRID_SIDE} x {WGRID_SIDE} grid, unit weights, delta 1,"
        f" from corner 0: levels {int(got.levels[0])} (the BFS lane's "
        f"{int(bfs.levels[0])}; the reference stops at its sweep cap, "
        f"{WGRID_SIDE ** 2 + 1}), dist and buckets the BFS lane's, sigma "
        f"within {rel:.3g} relative of the BFS lane's (K1 on the card)")
    log(f"  [18] took {time.perf_counter() - t_phase:.1f} s")
    source = "src/repro_torch/kernels/frontier/csrc/relax.cu"
    shape = f"R-MAT 2^{RMAT_SCALE} x {EDGE_FACTOR} weighted, B={BATCH}"
    rows = [
        {"name": "frontier_relax", "route": "cuda", "source": source,
         "replaces": "src/repro/kernels/frontier/ref.py:110",
         "replaces_kind": "XLA-only function (no Pallas kernel)",
         "launches": 0, **w1, "shape": shape, "run": weighted_run},
        {"name": "dag_sigma", "route": "cuda", "source": source,
         "replaces": "src/repro/kernels/frontier/ref.py:147",
         "replaces_kind": "XLA-only function (no Pallas kernel)",
         "launches": 0, **w2, "shape": shape},
    ]
    return rows, paths


def attempt_costs(events) -> list:
    """A telemetry stream cut at each ``run.start``: each attempt's
    phases 1-2 seconds, and its epochs (number, seconds, error or None)
    from the ``phase.epoch`` spans, an epoch refused by its hook
    included."""
    attempts, begins = [], {}
    for e in events:
        if e.kind == "run.start":
            attempts.append({"phases_s": 0.0, "epochs": []})
        elif e.kind == "span.begin":
            begins[e.span] = e
        elif e.kind == "span.end" and attempts and e.span in begins:
            name = e.fields["name"]
            if name in ("phase.diameter", "phase.calibration"):
                attempts[-1]["phases_s"] += e.fields["seconds"]
            elif name == "phase.epoch":
                attempts[-1]["epochs"].append(
                    (begins[e.span].fields["epoch"], e.fields["seconds"],
                     e.fields.get("error")))
    return attempts


def ladder_summary(out) -> str:
    """A ResilientRunner result's path down the ladder, for the log."""
    steps = [e.detail for e in out.events
             if e.kind in ("shrink", "degrade", "migrate")]
    return "; ".join(steps)


def check_ladder(label: str, out, sched, lanes) -> None:
    """The run walked ``lanes`` (the shrink and degrade details), fired
    its whole schedule, ended on the single lane converged, and the final
    run's tau never fell."""
    if not sched.exhausted:
        raise AssertionError(f"{label}: faults left unfired: "
                             f"{[s for s in sched]}")
    walked = [e.detail for e in out.events if e.kind in ("shrink",
                                                         "degrade")]
    if walked != lanes:
        raise AssertionError(f"{label}: the ladder went {walked}, not "
                             f"{lanes}")
    taus = [st.tau for st in out.result.stats]
    if out.lane != "single" or not out.result.converged \
            or taus != sorted(taus):
        raise AssertionError(f"{label}: ended on {out.lane}, converged "
                             f"{out.result.converged}, taus {taus}")


def runtime_rank(rank: int, work: str, settings: dict) -> dict:
    """[19d] on one rank of the spawned gloo group, on the card:
    hyperbolic(HYPER_N) in RUNTIME_RANKS shards, one a rank
    (``GroupShardMesh``), under ``ResilientRunner``: a shrink to 2 ranks
    at epoch 2, then kills that exhaust the GroupShardMesh(2) and
    SamplerMesh(2) rungs (one retry each).  A rank lost in the shrink
    returns its ``DeviceLoss``; the others their result and events.
    ``settings`` are the parent's RUNTIME_SETTINGS."""
    import torch
    from repro_torch.core import (AdaptiveConfig, GroupShardMesh,
                                  hyperbolic_graph, partition_graph)
    from repro_torch.kernels.frontier import kernel as frontier
    from repro_torch.kernels.stopcheck import kernel as stopcheck
    from repro_torch.runtime import (DeviceLoss, FaultSchedule, FaultSpec,
                                     JSONLSink, ResilientRunner,
                                     RetryPolicy, Telemetry, read_jsonl)
    globals().update(settings)
    if torch.device(DEVICE).type == "cuda":
        torch.cuda.set_device(0)
        frontier.library(), stopcheck.library()     # the parent's builds
    mesh = GroupShardMesh(DEVICE)
    hyper = hyperbolic_graph(HYPER_N, seed=SEED, device=DEVICE)
    pg = partition_graph(hyper, RUNTIME_RANKS, block_v=HYPER_BLOCK_V,
                         shard=rank)
    sched = FaultSchedule([FaultSpec("shrink", 2, survivors=2),
                           FaultSpec("kill", 3), FaultSpec("kill", 4),
                           FaultSpec("kill", 5), FaultSpec("kill", 6)])
    trace = os.path.join(work, f"ladder-rank{rank}.jsonl")
    sink = JSONLSink(trace)
    runner = ResilientRunner(
        pg, mesh=mesh, checkpoint_dir=os.path.join(work, "group_ladder"),
        config=AdaptiveConfig(eps=HYPER_EPS, delta=0.1,
                              n0_base=RUNTIME_HYPER_N0),
        seed=SEED, schedule=sched,
        policy=RetryPolicy(max_retries=1, backoff_base=0.01,
                           backoff_cap=0.01),
        telemetry=Telemetry([sink], validate=True))
    t0 = time.perf_counter()
    out = {"rank": rank}
    try:
        res = runner.run()
    except DeviceLoss as e:
        out["device_loss"] = str(e)
    else:
        out.update(scores=res.result.reports[0].scores, tau=res.result.tau,
                   n_epochs=res.result.n_epochs, lane=res.lane,
                   converged=res.result.converged, attempts=res.attempts,
                   exhausted=sched.exhausted,
                   taus=[st.tau for st in res.result.stats],
                   events=[(e.kind, e.detail) for e in res.events])
    sink.close()
    out["seconds"] = time.perf_counter() - t0
    out["n_events"] = len(read_jsonl(trace, validate=True))
    return out


def phase_runtime(main_res, main_counts: dict) -> dict:
    """[19] a-e (see the module docstring).  ``main_res`` and
    ``main_counts`` are [4]'s result and launch counts.  Returns (a)'s
    launch counts."""
    import shutil
    import tempfile
    import numpy as np
    import torch
    from repro_torch.core import (AdaptiveConfig, ShardMesh, brandes_numpy,
                                  hyperbolic_graph, partition_graph,
                                  rmat_graph, run_kadabra)
    from repro_torch.kernels.frontier import FLAT
    from repro_torch.launch import spawn_local
    from repro_torch.runtime import (FaultSchedule, FaultSpec, JSONLSink,
                                     ResilientRunner, RetryPolicy, RingSink,
                                     Telemetry, read_jsonl,
                                     torch_profiler_trace,
                                     write_chrome_trace)
    work = tempfile.mkdtemp(prefix="chip_smoke_runtime_")
    try:
        rmat = rmat_graph(RMAT_SCALE, EDGE_FACTOR, seed=SEED, device=DEVICE)
        config = AdaptiveConfig(eps=MAIN_EPS, delta=MAIN_DELTA,
                                sample_batch_size=BATCH,
                                max_epochs=MAIN_MAX_EPOCHS)
        main_s = sum(main_res.phase_seconds.values())

        # (a) telemetry on [4]'s run
        path = os.path.join(work, "main.jsonl")
        sink, ring = JSONLSink(path), RingSink(0)
        reset_counts()
        t0 = time.perf_counter()
        res = run_kadabra(rmat, config=config, seed=SEED, device=DEVICE,
                          telemetry=Telemetry([ring, sink], validate=True))
        seconds = time.perf_counter() - t0
        sink.close()
        counts = read_counts("rmat_telemetry", FLAT, res.bfs_levels,
                             len(res.stats))
        if not same_run(res, main_res) or counts != main_counts:
            raise AssertionError(
                f"[19a] telemetry on is not [4]'s run: tau {res.tau} "
                f"({main_res.tau}), epochs {res.n_epochs} "
                f"({main_res.n_epochs}), btilde bitwise "
                f"{np.array_equal(res.btilde, main_res.btilde)}, launches "
                f"{counts} ({main_counts})")
        events = read_jsonl(path, validate=True)
        ends = [e for e in events if e.kind == "run.end"]
        n_stats = sum(e.kind == "epoch.stats" for e in events)
        if len(events) != len(ring.events) or len(ends) != 1 \
                or ends[0].fields["tau"] != res.tau \
                or ends[0].fields["n_epochs"] != res.n_epochs \
                or n_stats != res.n_epochs:
            raise AssertionError(f"[19a] the trace does not give the run: "
                                 f"{len(events)} events, run.end "
                                 f"{[e.fields for e in ends]}, {n_stats} "
                                 "epoch.stats")
        chrome = write_chrome_trace(os.path.join(work, "main_trace.json"),
                                    events)
        with open(chrome) as f:
            rows = json.load(f)["traceEvents"]
        log(f"[19a] telemetry on [4]'s run: {seconds:.2f} s (phases "
            + ", ".join(f"{k} {v:.2f} s"
                        for k, v in res.phase_seconds.items())
            + f"; [4]: {main_s:.2f} s), tau {res.tau}, epochs "
            f"{res.n_epochs}, btilde bitwise [4]'s, launches [4]'s "
            f"{counts[FLAT]} flat / {counts['frontier_words']} words / "
            f"{counts['stopcheck']} stop checks; {len(events)} events "
            f"re-read and valid, {n_stats} epoch.stats, run.end tau "
            f"{ends[0].fields['tau']}; Chrome trace {len(rows)} rows")

        # (b) ResilientRunner through five faults on the same run
        sched = FaultSchedule([FaultSpec("kill", 2), FaultSpec("nan", 3),
                               FaultSpec("hang", 4, delay=RUNTIME_HANG),
                               FaultSpec("corrupt", 5),
                               FaultSpec("truncate", 6)])
        ring = RingSink(0)
        root = os.path.join(work, "resilient")
        t0 = time.perf_counter()
        out = ResilientRunner(
            rmat, checkpoint_dir=root, config=config, seed=SEED,
            device=DEVICE, checkpoint_every=1, schedule=sched,
            epoch_timeout=RUNTIME_EPOCH_TIMEOUT,
            policy=RetryPolicy(max_retries=8, backoff_base=0.05,
                               backoff_cap=0.2),
            telemetry=Telemetry([ring], validate=True)).run()
        wall = time.perf_counter() - t0
        got = out.result.reports[0]
        failures = [e.detail for e in out.events if e.kind == "failure"]
        quarantined = sorted(d for d in os.listdir(os.path.join(root,
                                                                "rung0"))
                             if "quarantined" in d)
        if not sched.exhausted \
                or not np.array_equal(got.scores, main_res.btilde) \
                or got.tau != main_res.tau or out.attempts != 5 \
                or quarantined != ["step_00000004.quarantined-0",
                                   "step_00000005.quarantined-0"] \
                or not any("InvariantViolation" in d for d in failures) \
                or not any("EpochTimeoutError" in d for d in failures):
            raise AssertionError(
                f"[19b] exhausted {sched.exhausted}, tau {got.tau} "
                f"([4] {main_res.tau}), btilde bitwise "
                f"{np.array_equal(got.scores, main_res.btilde)}, attempts "
                f"{out.attempts}, quarantined {quarantined}, failures "
                f"{failures}")
        costs = attempt_costs(ring.events)
        kept = {}
        for a in costs:
            for epoch, sec, err in a["epochs"]:
                if err is None:
                    kept[epoch] = sec
        drawn = [(ep, sec) for a in costs for ep, sec, _ in a["epochs"]]
        # the hang sleeps in its epoch's hook, inside the refused epoch's
        # span: its delay is a term of its own, not an epoch drawn again
        lost_s = (sum(sec for _, sec in drawn) - sum(kept.values())
                  - RUNTIME_HANG)
        replay_s = sum(a["phases_s"] for a in costs[1:])
        sleeps = sum(float(e.detail.split()[1]) / 1e3 for e in out.events
                     if e.kind == "retry")
        rest_s = wall - main_s - replay_s - lost_s - sleeps - RUNTIME_HANG
        log(f"[19b] ResilientRunner, checkpoint_every=1, through kill@2, "
            f"nan@3, hang@4 ({RUNTIME_HANG} s against a "
            f"{RUNTIME_EPOCH_TIMEOUT} s epoch timeout), corrupt@5, "
            f"truncate@6: {wall:.2f} s against [4]'s {main_s:.2f} s; every "
            f"fault fired, btilde and tau ({got.tau}) bitwise [4]'s; "
            f"quarantined {quarantined}; failures "
            f"{[d.split(':')[0] for d in failures]}")
        for i, a in enumerate(costs):
            eps_ = [ep for ep, _, _ in a["epochs"]]
            log(f"  attempt {i + 1}: phases 1-2 {a['phases_s']:.3f} s, "
                f"epochs {eps_[0] if eps_ else '-'}-"
                f"{eps_[-1] if eps_ else '-'} in "
                f"{sum(sec for _, sec, _ in a['epochs']):.3f} s, "
                + (f"ended by {failures[i].split(':')[0]}"
                   if i < len(failures) else "completed"))
        log(f"  per failure: {(wall - main_s) / 5:.3f} s of wall over [4] "
            f"= phases 1-2 replayed {replay_s / 5:.3f} s + epochs drawn "
            f"again {(len(drawn) - len(kept)) / 5:.1f} in "
            f"{lost_s / 5:.3f} s + backoff {sleeps / 5:.3f} s + the hang's "
            f"{RUNTIME_HANG} s over five {RUNTIME_HANG / 5:.3f} s + the "
            f"rest (the steps' writes, restores, quarantine) "
            f"{rest_s / 5:.3f} s")

        # (c) the ladder on one card
        t0 = time.perf_counter()
        pg = partition_graph(rmat, SHARDS)
        sched = FaultSchedule([FaultSpec("shrink", 3, survivors=4),
                               FaultSpec("kill", 4), FaultSpec("kill", 5)])
        ring = RingSink(0)
        out = ResilientRunner(
            pg, mesh=ShardMesh(SHARDS, DEVICE),
            checkpoint_dir=os.path.join(work, "rmat_ladder"), config=config,
            seed=SEED, schedule=sched,
            policy=RetryPolicy(max_retries=1, backoff_base=0.05),
            telemetry=Telemetry([ring], validate=True)).run()
        wall = time.perf_counter() - t0
        check_ladder("[19c] R-MAT", out, sched, [
            f"{SHARDS} -> 4 devices",
            "sharded -> single (retry budget exhausted)"])
        err = float(np.abs(out.result.reports[0].scores
                           - main_res.btilde).max())
        if not err <= 2 * MAIN_EPS:
            raise AssertionError(f"[19c] R-MAT ladder: max |b - b_[4]| "
                                 f"{err} beyond 2 eps")
        lanes = [e.fields["lane"] for e in ring.events
                 if e.kind == "run.start"]
        log(f"[19c] ladder on one card, R-MAT in {SHARDS} shards: {wall:.2f} "
            f"s (partition included), attempts on {lanes}; "
            f"{ladder_summary(out)}; tau {out.result.tau}, epochs "
            f"{out.result.n_epochs}, max |b - b_[4]| {err:.5f} (2 eps "
            f"{2 * MAIN_EPS}), the final run's taus "
            f"{[st.tau for st in out.result.stats]}")
        del rmat, pg
        torch.cuda.empty_cache()
        hyper = hyperbolic_graph(HYPER_N, seed=SEED, device=DEVICE)
        exact = brandes_numpy(hyper)
        hcfg = AdaptiveConfig(eps=HYPER_EPS, delta=0.1,
                              n0_base=RUNTIME_HYPER_N0)
        sched = FaultSchedule([FaultSpec("shrink", 3, survivors=4),
                               FaultSpec("kill", 4), FaultSpec("kill", 5)])
        t0 = time.perf_counter()
        out = ResilientRunner(
            partition_graph(hyper, SHARDS, block_v=HYPER_BLOCK_V),
            mesh=ShardMesh(SHARDS, DEVICE),
            checkpoint_dir=os.path.join(work, "hyper_ladder"), config=hcfg,
            seed=SEED, schedule=sched,
            policy=RetryPolicy(max_retries=1, backoff_base=0.05)).run()
        wall = time.perf_counter() - t0
        check_ladder("[19c] hyperbolic", out, sched, [
            f"{SHARDS} -> 4 devices",
            "sharded -> single (retry budget exhausted)"])
        err = float(np.abs(out.result.reports[0].scores - exact).max())
        if not err < HYPER_EPS:
            raise AssertionError(f"[19c] hyperbolic ladder: max error {err}"
                                 f" >= {HYPER_EPS}")
        log(f"[19c] ladder on one card, hyperbolic({HYPER_N}) in {SHARDS} "
            f"shards (n0_base {RUNTIME_HYPER_N0}): {wall:.2f} s; "
            f"{ladder_summary(out)}; tau {out.result.tau}, epochs "
            f"{out.result.n_epochs}, max |b~ - b| = {err:.5f} (eps "
            f"{HYPER_EPS})")

        # (d) the ladder across processes
        t0 = time.perf_counter()
        ranks = spawn_local(runtime_rank, RUNTIME_RANKS,
                            args=(work, {k: globals()[k]
                                         for k in RUNTIME_SETTINGS}),
                            backend="gloo", timeout=GROUP_TIMEOUT,
                            store_dir=work)
        wall = time.perf_counter() - t0
        lost = [r["rank"] for r in ranks if "device_loss" in r]
        live = [r for r in ranks if "device_loss" not in r]
        if lost != [2, 3] or [r["rank"] for r in live] != [0, 1]:
            raise AssertionError(f"[19d] lost ranks {lost}, not [2, 3]")
        a, b = live
        walked = [d for k, d in a["events"] if k in ("shrink", "degrade")]
        want = [f"{RUNTIME_RANKS} -> 2 devices",
                "sharded -> spmd (retry budget exhausted)",
                "spmd -> single (retry budget exhausted)"]
        err = float(np.abs(a["scores"] - exact).max())
        if not (np.array_equal(a["scores"], b["scores"])
                and a["tau"] == b["tau"] and a["lane"] == "single"
                and a["exhausted"] and walked == want and a["converged"]
                and a["taus"] == sorted(a["taus"]) and err < HYPER_EPS):
            raise AssertionError(
                f"[19d] survivors bitwise alike "
                f"{np.array_equal(a['scores'], b['scores'])}, lane "
                f"{a['lane']}, ladder {walked}, exhausted {a['exhausted']}, "
                f"taus {a['taus']}, max error {err}")
        log(f"[19d] ladder across {RUNTIME_RANKS} ranks spawned on the card "
            f"(gloo): {wall:.1f} s (rank 0's runner {a['seconds']:.1f} s); "
            f"ranks 2-3 ended in DeviceLoss ({ranks[2]['device_loss']}); "
            f"ranks 0-1 walked {walked}, {a['attempts']} failed attempts, "
            f"bitwise alike, tau {a['tau']}, epochs {a['n_epochs']}, max "
            f"|b~ - b| = {err:.5f} (eps {HYPER_EPS}); trace events a rank "
            f"{[r['n_events'] for r in ranks]}, all valid")

        # (e) last: the torch.profiler gate around one run
        with torch_profiler_trace(os.path.join(work, "profile")) as trace:
            run_kadabra(hyper, config=AdaptiveConfig(eps=HYPER_EPS,
                                                     delta=0.1),
                        seed=SEED, device=DEVICE)
        with open(trace) as f:
            records = json.load(f)["traceEvents"]
        kernels = sum(r.get("cat") == "kernel" for r in records)
        log(f"[19e] torch_profiler_trace around hyperbolic({HYPER_N}): "
            f"{os.path.getsize(trace)} bytes, {len(records)} records, "
            f"{kernels} of them kernel records (no count asserted: "
            "ROADMAP §3's lost records)")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return counts


# ---------------------------------------------------------------------------
# [20] the equivariant GNNs on the molecule cell, GraphSAGE on minibatch_lg
# ---------------------------------------------------------------------------

def molecule_batch(rot=None):
    """The molecule cell's batch: MOL_GRAPHS molecules of MOL_ATOMS atoms
    (positions N(0, 1.5^2), 4 atom types, as the molecules example), each
    molecule's MOL_EDGES // 2 closest atom pairs as edges both ways, a
    pair-potential energy target; padded to the cell's nodes.  ``rot``
    rotates the positions (the target is invariant)."""
    import numpy as np
    import torch
    from repro_torch.configs._families import GNN_SHAPES
    from repro_torch.models.gnn import GraphBatch
    cell = GNN_SHAPES["molecule"]
    rng = np.random.default_rng((SEED, 0))
    g, a = MOL_GRAPHS, MOL_ATOMS
    n, pn = g * a, cell["nodes"]
    pos = rng.standard_normal((g, a, 3)) * 1.5
    z = rng.integers(0, 4, n)
    iu, ju = np.triu_indices(a, 1)
    d = np.linalg.norm(pos[:, iu] - pos[:, ju], axis=-1)     # (g, pairs)
    near = np.argsort(d, axis=1, kind="stable")[:, :MOL_EDGES // 2]
    off = (np.arange(g) * a)[:, None]
    i, j = (iu[near] + off).reshape(-1), (ju[near] + off).reshape(-1)
    src, dst = np.concatenate([i, j]), np.concatenate([j, i])
    pos = pos.reshape(n, 3)
    gid = np.repeat(np.arange(g), a)
    y = np.zeros(g)
    np.add.at(y, gid[src], 0.5 * np.exp(-np.linalg.norm(
        pos[src] - pos[dst], axis=1)))
    if rot is not None:
        pos = pos @ rot.T
    if len(src) != cell["edges"] or n > pn:
        raise AssertionError(f"molecule batch: {n} nodes and {len(src)} "
                             f"edges for the cell's {pn} and "
                             f"{cell['edges']}")

    def put(x, dtype, fill=0):
        full = np.full((pn, *np.shape(x)[1:]), fill, dtype)
        full[:len(x)] = x
        return torch.from_numpy(full).to(DEVICE)

    return GraphBatch(
        x=torch.zeros((pn, cell["d_feat"]), device=DEVICE),
        z=put(z, np.int32), pos=put(pos, np.float32),
        src=torch.from_numpy(src.astype(np.int32)).to(DEVICE),
        dst=torch.from_numpy(dst.astype(np.int32)).to(DEVICE),
        edge_mask=torch.ones(len(src), device=DEVICE),
        node_mask=put(np.ones(n), np.float32),
        labels=torch.zeros(pn, dtype=torch.int32, device=DEVICE),
        graph_id=put(gid, np.int32),
        y=torch.from_numpy(y.astype(np.float32)).to(DEVICE), n_graphs=g)


def k4_calls(name: str, cfg) -> tuple:
    """K4's launches (a forward, a training step) by the models' design.
    EGNN: a layer's message sum and coordinate mean forward; backward,
    every message sum's transposed call and the coordinate means' of all
    layers but the last, whose positions reach no loss.  NequIP and
    MACE: one call a layer each way (l = 0, 1, 2 in one)."""
    layers = cfg.n_layers
    if name.startswith("egnn") and cfg.update_pos:
        return 2 * layers, 4 * layers - 1
    return layers, 2 * layers


def model_outputs(name: str, out, params) -> list:
    """(label, tensor) of a forward; the energy last (EGNN: h @ head)."""
    if name.startswith("egnn"):
        return [("h", out[0]), ("pos", out[1]),
                ("energy", out[0].float() @ params["head"])]
    feats, energy = out
    return [(f"feats[{l}]", feats[l]) for l in sorted(feats)] + \
        [("energy", energy)]


def rel_gap(got, want) -> float:
    return float((got.float() - want.float()).abs().max()) / max(
        float(want.float().abs().max()), 1e-30)


def check_segsum_edge_plan(batch) -> dict:
    """K4 over the molecule batch's edge plan (ids = arange(E), seg =
    dst, no hot tier) and its transpose (every segment one entry) at
    EGNN's coordinate and message widths, NequIP's 32 x 9 and MACE's 128
    x 9; then timed at MACE's width beside its plain version, its bound
    and ``torch.sparse.mm``."""
    import torch
    from repro_torch.kernels.segsum import (gather_segment_sum_cuda,
                                            gather_segment_sum_ref)
    plan = batch.edge_plan()
    ids, e, v = batch.edge_ids(), batch.n_edges, batch.n_nodes
    err = 0.0
    for d in (3, 64, 288, 1152):
        err = max(err, check_segsum_call(f"edge plan D={d}", ids, batch.dst,
                                         batch.edge_mask, v, e, d, plan),
                  check_segsum_call(f"edge plan D={d} transposed",
                                    batch.dst, ids, batch.edge_mask, e, v,
                                    d, plan.transpose))
    d = 1152
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 5)
    table = torch.randn((e, d), generator=gen, device=DEVICE)
    cot = torch.randn((v, d), generator=gen, device=DEVICE)
    args = (ids, batch.dst, batch.edge_mask, table, v)
    ms = cuda_time_ms(lambda: gather_segment_sum_cuda(*args, plan), 50)
    back_ms = cuda_time_ms(lambda: gather_segment_sum_cuda(
        batch.dst, ids, batch.edge_mask, cot, e, plan.transpose), 50)
    plain = cuda_time_ms(lambda: gather_segment_sum_ref(*args), 20)
    csr = torch.sparse_csr_tensor(plan.offsets, plan.sorted_ids().long(),
                                  plan.weights_in_order(batch.edge_mask),
                                  (v, e), check_invariants=True)
    lib_ms = cuda_time_ms(lambda: torch.sparse.mm(csr, table), 20)
    b_ms, b_by = bound(segsum_bytes(plan, d, 4), 2.0 * e * d)
    log(f"  segsum at MACE's layer call (E={e}, N={v}, D={d} float32): "
        f"{ms:.4f} ms ({back_ms:.4f} ms transposed), plain {plain:.4f} ms, "
        f"torch.sparse.mm {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    return {"molecule_max_abs_err": err, "molecule_ms": ms,
            "molecule_transposed_ms": back_ms, "molecule_plain_ms": plain,
            "molecule_bound_ms": b_ms, "molecule_bound_by": b_by,
            "molecule_library_ms": lib_ms,
            "molecule_shape": f"edge plan of the molecule cell: N={e} "
                              f"entries, S={v}, V1={e}, D={d} float32"}


def run_molecule_model(name: str, cfg, fns, batch, rotated) -> tuple:
    """One model on the molecule batch: a counted forward, MOL_STEPS
    counted AdamW steps, the plain route's forward and first step held
    against them, the rotated batch's energy; times and peak memory
    logged.  Returns the path's launch counts and a function that takes
    one more step (for the profile)."""
    import numpy as np
    import torch
    from repro_torch.kernels.segsum import SEGSUM
    from repro_torch.optim import AdamWConfig, init_state
    from repro_torch.train import make_train_step
    init, fwd, loss = fns
    per_fwd, per_step = k4_calls(name, cfg)
    params0 = init(torch.Generator().manual_seed(SEED), cfg, device=DEVICE)
    opt = AdamWConfig()
    with torch.no_grad():
        fwd(params0, batch, cfg)          # pays one-time library set-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    with torch.no_grad():
        out = fwd(params0, batch, cfg)
    torch.cuda.synchronize()
    fwd_ms = (time.perf_counter() - t0) * 1e3
    counts = kernel_only(f"{name} forward", SEGSUM, per_fwd)
    outs = model_outputs(name, out, params0)
    for label, t in outs:
        if not bool(torch.isfinite(t.float()).all()):
            raise AssertionError(f"{name}: {label} not finite")

    step = make_train_step(lambda p, b: loss(p, b, cfg), opt)
    params, state = params0, init_state(params0)
    reset_counts()
    losses, step_ms = [], []
    for i in range(MOL_STEPS):
        t0 = time.perf_counter()
        params, state, metrics = step(params, state, batch)
        losses.append(float(metrics["loss"]))
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            params1, state1 = clone_tree(params), clone_tree(state)
    train = kernel_only(f"{name} train", SEGSUM, per_step * MOL_STEPS)
    peak = torch.cuda.max_memory_allocated()
    if not np.isfinite(losses).all():
        raise AssertionError(f"{name}: loss not finite: {losses}")

    reset_counts()
    with torch.no_grad():
        plain = fwd(params0, batch, cfg, use_kernel=False)
        rot = fwd(params0, rotated, cfg)
    plain_step = make_train_step(
        lambda p, b: loss(p, b, cfg, use_kernel=False), opt)
    plain_params1, plain_state1, plain_m = plain_step(
        params0, init_state(params0), batch)
    torch.cuda.synchronize()
    kernel_only(f"{name} plain route and rotation", SEGSUM, per_fwd)
    fwd_gaps = {label: rel_gap(t, p) for (label, t), (_, p) in
                zip(outs, model_outputs(name, plain, params0))}
    loss_gap = abs(losses[0] - float(plain_m["loss"])) / abs(
        float(plain_m["loss"]))
    grad_ratio, param_gap, param_excess = step_gaps(
        params1, plain_params1, state1["m"], plain_state1["m"], opt)
    energy = outs[-1][1]
    rot_gap = rel_gap(model_outputs(name, rot, params0)[-1][1], energy)
    log(f"  {name}: forward {fwd_ms:.2f} ms, {MOL_STEPS} AdamW steps "
        + ", ".join(f"{x:.2f}" for x in step_ms) + " ms; loss "
        + ", ".join(f"{x:.6g}" for x in losses) + f"; K4 launches "
        f"{counts[SEGSUM]} a forward, {train[SEGSUM] // MOL_STEPS} a step; "
        f"peak memory {peak / 2**20:.1f} MiB")
    log(f"  {name} kernel vs plain route: outputs "
        + ", ".join(f"{k} {v:.3g}" for k, v in fwd_gaps.items())
        + f" of their largest entry (limit {MOL_FWD_REL}); first-step "
        f"loss {loss_gap:.3g} (limit {MOL_LOSS_RTOL}); gradients "
        f"{grad_ratio:.3g} of a leaf's largest entry (limit "
        f"{GNN_GRAD_RTOL}); params max |diff| {param_gap:.3g}, "
        f"{param_excess:.3g} of the lr |dg| / eps bound; rotated energy "
        f"{rot_gap:.3g} of the largest (limit {MOL_ROT_REL})")
    if not (max(fwd_gaps.values()) <= MOL_FWD_REL
            and loss_gap <= MOL_LOSS_RTOL and grad_ratio <= GNN_GRAD_RTOL
            and param_excess <= 1.0 and rot_gap <= MOL_ROT_REL):
        raise AssertionError(f"{name}: beyond the stated tolerances")
    return {k: counts[k] + train[k] for k in counts}, \
        lambda: step(params, state, batch)


def phase_gnn_cells() -> tuple:
    """[20]: (a) the molecule cell's K4 calls and the three equivariant
    models at full width (EGNN once more in bf16); (b) GraphSAGE on a
    NeighborSampler batch of the minibatch_lg cell.  Returns (K4's extra
    row entries, the paths' launch counts)."""
    import numpy as np
    import torch
    from repro_torch.configs import egnn, graphsage_reddit, mace, nequip
    from repro_torch.configs._families import GNN_SHAPES
    from repro_torch.core import rmat_graph
    from repro_torch.data import NeighborSampler
    from repro_torch.kernels.segsum import SEGSUM
    from repro_torch.models import gnn
    from repro_torch.models.gnn import irreps
    from repro_torch.optim import AdamWConfig, init_state
    from repro_torch.train import make_train_step
    import dataclasses
    t0 = time.perf_counter()
    batch = molecule_batch()
    rotated = molecule_batch(irreps.random_rotation(7))
    log(f"[20a] molecule cell: {MOL_GRAPHS} molecules x {MOL_ATOMS} atoms, "
        f"{batch.n_edges} edges, padded to {batch.n_nodes} nodes (built in "
        f"{time.perf_counter() - t0:.2f} s)")
    row = check_segsum_edge_plan(batch)
    paths, steps = {}, {}
    models = (("egnn", egnn), ("nequip", nequip), ("mace", mace))
    for name, mod in models:
        cfg = mod.cfg_for_shape(mod.make_config(), GNN_SHAPES["molecule"])
        fns = tuple(getattr(gnn, f"{name}_{w}")
                    for w in ("init", "forward", "loss"))
        log(f"  {name}: {cfg}")
        paths[f"molecule_{name}"], steps[name] = run_molecule_model(
            name, cfg, fns, batch, rotated)
        if name == "egnn":
            egnn_cfg, egnn_fns = cfg, fns

    # EGNN in bf16: a counted forward and step, the distance from float32
    cfg = dataclasses.replace(egnn_cfg, agg_dtype="bf16")
    init, fwd, loss = egnn_fns
    per_fwd, per_step = k4_calls("egnn", cfg)
    params0 = init(torch.Generator().manual_seed(SEED), cfg, device=DEVICE)
    step = make_train_step(lambda p, b: loss(p, b, cfg), AdamWConfig())
    with torch.no_grad():
        fwd(params0, batch, cfg)            # the bf16 GEMMs' set-up
    step(params0, init_state(params0), batch)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    with torch.no_grad():
        out = fwd(params0, batch, cfg)
    torch.cuda.synchronize()
    fwd_ms = (time.perf_counter() - t0) * 1e3
    fwd_counts = kernel_only("egnn bf16 forward", SEGSUM, per_fwd)
    reset_counts()
    t0 = time.perf_counter()
    _, _, metrics = step(params0, init_state(params0), batch)
    step_loss = float(metrics["loss"])
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    step_counts = kernel_only("egnn bf16 train", SEGSUM, per_step)
    paths["molecule_egnn_bf16"] = {k: fwd_counts[k] + step_counts[k]
                                   for k in fwd_counts}
    with torch.no_grad():
        f32 = fwd(params0, batch, egnn_cfg)
    gaps = {label: rel_gap(t, w) for (label, t), (_, w) in zip(
        model_outputs("egnn", out, params0),
        model_outputs("egnn", f32, params0))}
    log(f"  egnn bf16: forward {fwd_ms:.2f} ms, a step {step_ms:.2f} ms "
        f"(loss {step_loss:.6g}); K4 launches {fwd_counts[SEGSUM]} a "
        f"forward (bf16 message sums, float32 coordinate means), "
        f"{step_counts[SEGSUM]} a step; distance from the float32 forward: "
        + ", ".join(f"{k} {v:.3g}" for k, v in gaps.items())
        + f" of the largest entry (bound {MOL_BF16_REL})")
    if not (np.isfinite(step_loss) and max(gaps.values()) <= MOL_BF16_REL):
        raise AssertionError("egnn bf16: beyond its bound")
    del batch, rotated
    torch.cuda.empty_cache()

    # (b) GraphSAGE on a sampled minibatch_lg batch
    cell = GNN_SHAPES["minibatch_lg"]
    t0 = time.perf_counter()
    graph = rmat_graph(SAMPLER_SCALE, SAMPLER_EDGE_FACTOR, seed=SEED,
                       device=DEVICE)
    rng = np.random.default_rng(SEED)
    feats = rng.standard_normal((graph.n_nodes, cell["d_feat"]),
                                dtype=np.float32)
    labels = rng.integers(0, cell["classes"], graph.n_nodes).astype(
        np.int32)
    build_s = time.perf_counter() - t0
    sampler = NeighborSampler(graph, SAMPLER_FANOUTS, SAMPLER_SEEDS,
                              seed=SEED)
    t0 = time.perf_counter()
    sub = sampler.sample(0)
    sample_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sbatch = sampler.to_graph_batch(sub, feats, labels,
                                    n_classes=cell["classes"],
                                    pad_nodes=cell["nodes"],
                                    pad_edges=cell["edges"], device=DEVICE)
    torch.cuda.synchronize()
    batch_s = time.perf_counter() - t0
    del feats
    if (sampler.total_nodes, sampler.total_edges) != (cell["nodes"],
                                                      cell["edges"]):
        raise AssertionError("the sampler does not fill the minibatch_lg "
                             "cell exactly")
    log(f"[20b] GraphSAGE on the minibatch_lg cell: R-MAT 2^{SAMPLER_SCALE}"
        f" x {SAMPLER_EDGE_FACTOR} (E={graph.n_edges}) and (V, "
        f"{cell['d_feat']}) float32 features in {build_s:.2f} s; "
        f"NeighborSampler {SAMPLER_SEEDS} seeds, fanouts {SAMPLER_FANOUTS}: "
        f"sample {sample_s * 1e3:.1f} ms, batch {batch_s * 1e3:.1f} ms "
        f"({sbatch.n_nodes} nodes, {sbatch.n_edges} edges, "
        f"{int(sbatch.edge_mask.sum())} live)")
    del graph
    cfg = graphsage_reddit.cfg_for_shape(graphsage_reddit.make_config(), cell)
    params0 = gnn.sage_init(torch.Generator().manual_seed(SEED), cfg,
                            device=DEVICE)
    opt = AdamWConfig()
    step = make_train_step(lambda p, b: gnn.sage_loss(p, b, cfg), opt)
    with torch.no_grad():
        gnn.sage_forward(params0, sbatch, cfg)        # plans and set-up
    step(params0, init_state(params0), sbatch)        # autograd set-up
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    with torch.no_grad():
        logits = gnn.sage_forward(params0, sbatch, cfg)
    torch.cuda.synchronize()
    fwd_ms = (time.perf_counter() - t0) * 1e3
    fwd_counts = kernel_only("graphsage minibatch forward", SEGSUM,
                             cfg.n_layers)
    reset_counts()
    t0 = time.perf_counter()
    params1, state1, m1 = step(params0, init_state(params0), sbatch)
    loss1 = float(m1["loss"])
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    step_counts = kernel_only("graphsage minibatch train", SEGSUM,
                              2 * cfg.n_layers)
    paths["graphsage_minibatch_lg"] = {k: fwd_counts[k] + step_counts[k]
                                       for k in fwd_counts}
    log(f"  graphsage-reddit on it: forward {fwd_ms:.2f} ms, an AdamW step "
        f"{step_ms:.2f} ms (loss {loss1:.6f}); K4 launches "
        f"{fwd_counts[SEGSUM]} a forward, {step_counts[SEGSUM]} a step")
    reset_counts()
    with torch.no_grad():
        plain_logits = gnn.sage_forward(params0, sbatch, cfg,
                                        use_kernel=False)
    plain_params1, plain_state1, plain_m = make_train_step(
        lambda p, b: gnn.sage_loss(p, b, cfg, use_kernel=False), opt)(
        params0, init_state(params0), sbatch)
    torch.cuda.synchronize()
    kernel_only("graphsage minibatch plain route", SEGSUM, 0)
    check_first_step(logits, plain_logits, loss1, float(plain_m["loss"]),
                     params1, plain_params1, state1["m"], plain_state1["m"],
                     opt)
    # last, after every timed run (a profiler session leaves overhead on
    # later launches): a step of each model under the profiler, device
    # time by kernel and idle share of the second of two
    for name, fn in steps.items():
        rows, wall_ms = profile_twice(fn)
        busy = sum(r[0] for r in rows)
        k4 = sum(r[0] for r in rows if "segsum" in r[2])
        log(f"  {name} profile of one molecule step: wall {wall_ms:.2f} ms, "
            f"device busy {busy:.2f} ms, idle share "
            f"{1 - busy / wall_ms:.3f}, {sum(r[1] for r in rows)} kernel "
            f"launches; K4 {k4:.3f} ms ({k4 / max(busy, 1e-9):.1%} of device "
            "time); the largest: "
            + "; ".join(f"{ms:.3f} ms x{calls} {key[:48]}" for ms, calls, key
                        in sorted(rows, reverse=True)[:3]))
    return row, paths


# ---------------------------------------------------------------------------
# [21] MoE serving (granite, moonshot), qwen2 and MIND's four cells
# ---------------------------------------------------------------------------

def moe_prefill_routing(params, prompt, cfg) -> tuple:
    """One more prefill with every MoE layer's routing recomputed beside
    it (``route`` on the layer's FFN input): each layer's share of
    (token, slot) choices dropped by capacity, and layer 0's float32
    router probabilities.  Counted as a prefill (one K5 launch a
    layer)."""
    import torch
    from unittest import mock
    from repro_torch.kernels.flashattn import FLASHATTN
    from repro_torch.models import moe, transformer
    real = transformer.moe_ffn
    dropped, first = [], []

    def observed(p, x, mcfg):
        s = min(mcfg.group_size, x.shape[0])
        probs = moe.router_probs(p["router"], x.reshape(-1, s, x.shape[1]))
        dropped.append((~moe.route(probs, mcfg).keep).float().mean())
        if not first:
            first.append(probs)
        return real(p, x, mcfg)

    reset_counts()
    with torch.no_grad(), mock.patch.object(transformer, "moe_ffn",
                                            observed):
        transformer.prefill_step(params, prompt, cfg)
    torch.cuda.synchronize()
    counts = kernel_only(f"{cfg.name} observed prefill", FLASHATTN,
                         cfg.n_layers)
    shares = torch.stack(dropped).tolist()
    log(f"  dropped by capacity ({moe.capacity(cfg.moe.group_size, cfg.moe)}"
        f" slots an expert a group of {cfg.moe.group_size}): share of "
        f"(token, slot) choices a layer, layers 0-{len(shares) - 1}: "
        + " ".join(f"{x:.4f}" for x in shares)
        + f"; mean {sum(shares) / len(shares):.4f}")
    return first[0], counts


def check_routing_on_devices(probs, mcfg) -> None:
    """``route`` on the card against the CPU on the same float32 router
    probabilities (G, S, E): expert ids, kept choices and slots bitwise;
    then on the probabilities rounded to multiples of 2^-6, where most
    tokens tie at their k-th expert, which the stable sort must break
    toward the lower index on both."""
    import torch
    from repro_torch.models.moe import route
    for label, p in (("as drawn", probs),
                     ("rounded to 2^-6", torch.round(probs * 64) / 64)):
        card, host = route(p, mcfg), route(p.cpu(), mcfg)
        same = {k: torch.equal(getattr(card, k).cpu(), getattr(host, k))
                for k in ("expert_ids", "keep", "pos")}
        top = torch.sort(p, dim=-1, descending=True).values
        k = mcfg.top_k
        ties = int((top[..., k - 1] == top[..., k]).sum())
        gate_gap = float((card.gates.cpu() - host.gates).abs().max())
        log(f"  routing {label} {tuple(p.shape)}: card vs CPU bitwise "
            f"{same}; tokens tied at the k-th expert {ties}; kept "
            f"{int(host.keep.sum())} of {host.keep.numel()}; gates max "
            f"|diff| {gate_gap:.3g}")
        if not all(same.values()):
            raise AssertionError(f"routing {label}: the card and the CPU "
                                 "route differently")


def phase_moe_serving() -> dict:
    """[21] (a)-(c): granite-moe, moonshot and qwen2 at full width, each
    freed before the next is drawn.  Returns the paths' launch counts."""
    import torch
    from repro_torch.configs import (granite_moe_3b_a800m,
                                     moonshot_v1_16b_a3b, qwen2_7b)
    paths = {}
    cfg = granite_moe_3b_a800m.make_config()
    log(f"[21a] {cfg.name} serving: prefill {GRANITE_BATCH} x "
        f"{GRANITE_PROMPT} (prefill_32k's length, batch cut from 32), "
        f"{GRANITE_GEN} decode steps, bfloat16 at full width and depth")
    params, prompt, cache, _, paths["granite_serve"] = serve_cell(
        cfg, GRANITE_BATCH, GRANITE_PROMPT, GRANITE_GEN, SEED + 21)
    del cache
    torch.cuda.empty_cache()
    probs, paths["granite_observed"] = moe_prefill_routing(params, prompt,
                                                           cfg)
    del params, prompt
    torch.cuda.empty_cache()
    check_routing_on_devices(probs, cfg.moe)
    del probs
    check_routes(cfg)
    torch.cuda.empty_cache()

    cfg = moonshot_v1_16b_a3b.make_config()
    log(f"[21b] {cfg.name} serving: prefill 1 x {MOONSHOT_PROMPT}, "
        f"{MOONSHOT_GEN} decode steps, bfloat16 at full width and depth "
        f"(cut: batch 1 and a prompt of {MOONSHOT_PROMPT}: its weights and "
        "a 2 x 32k cache exceed 80 GB)")
    params, _, cache, _, paths["moonshot_serve"] = serve_cell(
        cfg, 1, MOONSHOT_PROMPT, MOONSHOT_GEN, SEED + 22)
    del params, cache
    torch.cuda.empty_cache()

    cfg = qwen2_7b.make_config()
    log(f"[21c] {cfg.name} serving: prefill 1 x {QWEN_PROMPT}, {QWEN_GEN} "
        f"decode steps, bfloat16 at full width and depth")
    params, _, cache, _, paths["qwen2_serve"] = serve_cell(
        cfg, 1, QWEN_PROMPT, QWEN_GEN, SEED + 23)
    del params, cache
    torch.cuda.empty_cache()
    return paths


# ---------------------------------------------------------------------------
# [22] gemma3-27b: K5's window mode, the model at full width, the routes
# ---------------------------------------------------------------------------

def phase_flash_window() -> dict:
    """[22a] K5's sliding-window mode: bfloat16 at gemma3's local shape,
    float32, and the ragged shape in both types at several windows; the
    row of the window mode (the bfloat16 case's numbers, the others'
    under their own keys)."""
    import torch
    row = check_flash_case("gemma3 local", FLASH_WINDOW_SHAPE, torch.bfloat16,
                           True, SEED + 30, 5, window=GEMMA_WINDOW)
    torch.cuda.empty_cache()
    f32 = check_flash_case("gemma3 local float32", FLASH_WINDOW_F32_SHAPE,
                           torch.float32, True, SEED + 31, 10,
                           tf32_control=True, window=GEMMA_WINDOW)
    row.update({f"float32_{k}": v for k, v in f32.items()})
    for dtype in (torch.bfloat16, torch.float32):
        for window in FLASH_WINDOW_RAGGED:
            ragged = check_flash_case("ragged", FLASH_RAGGED_SHAPE, dtype,
                                      True, SEED + 32 + window, 20,
                                      window=window)
            row.update({f"ragged_{str(dtype)[6:]}_w{window}_{k}": v
                        for k, v in ragged.items()})
    torch.cuda.empty_cache()
    return row


def gemma_prefill(params, prompt, cfg, label: str) -> tuple:
    """One counted prefill (a K5 launch a layer, a window launch for each
    local one): (logits, cache, seconds, peak GiB from just before it)."""
    import torch
    from repro_torch.models.transformer import prefill_step
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    logits, cache = prefill_step(params, prompt, cfg)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = kernels_only(f"{cfg.name} {label}", k5_launches(cfg))
    finite_logits(f"{cfg.name} {label}", logits, prompt.shape[0], cfg)
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"  {label} 1 x {prompt.shape[1]}: {seconds:.3f} s "
        f"({prompt.shape[1] / seconds:.0f} tokens/s), K5 launches "
        f"{k5_summary(counts)}, peak memory {peak:.2f} GiB "
        f"(torch.cuda.max_memory_allocated)")
    return logits, cache, seconds, peak, counts


def phase_gemma() -> dict:
    """[22b] gemma3-27b at full width and depth in bfloat16, weights drawn
    on the card: a prefill of 1 x GEMMA_DECODE_PROMPT, the cache grown by
    GEMMA_GEN and as many greedy decode steps (no K5); then 1 x
    GEMMA_PROMPT prefilled twice (first and warm) if its peak, projected
    from the shorter prefill's (weights, and cache and activations linear
    in the prompt), fits the card, else once more at GEMMA_DECODE_PROMPT
    with the reason printed.  [22c] the kernel route against the plain
    route at full width, one period of 6 layers.  Returns the paths'
    launch counts."""
    import dataclasses
    import gc
    import torch
    from repro_torch.configs.gemma3_27b import make_config
    from repro_torch.models.transformer import (decode_step, grow_cache,
                                                init_params)
    from repro_torch.tree import tree_leaves
    cfg = make_config()
    paths = {}
    # earlier phases' tensors kept only by reference cycles (after [21d]:
    # 7.6-9.1 GiB, MIND's tables) go before 52.9 GiB of weights are drawn
    held = torch.cuda.memory_allocated() / 2**30
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  held on the card before drawing: {held:.2f} GiB, after "
        f"gc.collect() {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 33)
    t0 = time.perf_counter()
    params = init_params(gen, cfg, device=DEVICE)
    prompt = torch.randint(0, cfg.vocab, (1, GEMMA_PROMPT), generator=gen,
                           device=DEVICE)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(params))
    weights = torch.cuda.memory_allocated() / 2**30
    log(f"[22b] {cfg.name}: {n_params} parameters ({cfg.dtype}, "
        f"{weights:.2f} GiB on the card) drawn in "
        f"{time.perf_counter() - t0:.2f} s; {cfg.n_groups} groups of "
        f"{cfg.layer_pattern} and {cfg.n_remainder} remainder layers, "
        f"window {cfg.window}")
    with torch.no_grad():
        short = prompt[:, :GEMMA_DECODE_PROMPT]
        logits, cache, _, peak, prefill = gemma_prefill(
            params, short, cfg, "prefill before decode")
        cache = grow_cache(cache, GEMMA_GEN)
        tokens = torch.argmax(logits, -1)[:, None]
        ids = [tokens]
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(GEMMA_GEN):
            logits, cache = decode_step(params, cache, tokens, cfg)
            tokens = torch.argmax(logits, -1)[:, None]
            ids.append(tokens)
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
        decode = kernels_only(f"{cfg.name} decode", {})
        finite_logits(f"{cfg.name} decode", logits, 1, cfg)
        log(f"  decode: {GEMMA_GEN} steps of 1 token from a cache of "
            f"{cache['k'].shape[2]} slots, {decode_s / GEMMA_GEN * 1e3:.2f} "
            f"ms a step; K5 launches {k5_summary(decode)}; cache at len "
            f"{cache['len']}; first ids {torch.cat(ids, dim=1).tolist()}")
        paths["gemma3_serve"] = {k: prefill[k] + decode[k] for k in prefill}
        del cache, logits
        torch.cuda.empty_cache()
        total = torch.cuda.mem_get_info()[1] / 2**30
        scale = GEMMA_PROMPT / GEMMA_DECODE_PROMPT
        projected = weights + scale * (peak - weights)
        if projected < total - GEMMA_MARGIN_GIB:
            long = prompt
            log(f"  1 x {GEMMA_PROMPT}: projected peak {projected:.2f} GiB "
                f"({weights:.2f} of weights + {scale:g} x the "
                f"{peak - weights:.2f} above them at {GEMMA_DECODE_PROMPT}) "
                f"within the card's {total:.2f} GiB")
        else:
            long = short
            log(f"  1 x {GEMMA_PROMPT} left out: its projected peak "
                f"{projected:.2f} GiB ({weights:.2f} of weights + {scale:g} "
                f"x the {peak - weights:.2f} above them at "
                f"{GEMMA_DECODE_PROMPT}) does not fit the card's "
                f"{total:.2f} GiB less {GEMMA_MARGIN_GIB} GiB; prefilled at "
                f"{GEMMA_DECODE_PROMPT} instead")
        for run in ("first", "warm"):
            logits, cache, _, _, counts = gemma_prefill(
                params, long, cfg, f"{run} prefill")
            paths[f"gemma3_prefill_{run}"] = counts
            del cache, logits
            torch.cuda.empty_cache()
    del params, prompt
    torch.cuda.empty_cache()

    period = dataclasses.replace(cfg, n_layers=len(cfg.layer_pattern))
    log(f"[22c] {cfg.name} kernel route vs plain route at full width, depth "
        f"cut to one period ({period.n_layers} layers: "
        f"{period.layer_pattern}), 1 x {GEMMA_ROUTE_PROMPT} tokens (the "
        f"plain route's local layers in {GEMMA_ROUTE_PROMPT // cfg.attn_chunk}"
        f" chunks of {cfg.attn_chunk})")
    check_routes(period, GEMMA_ROUTE_PROMPT, (
        (" (masked_chunk_attention)", {}),
        (" (trapezoid_attention)", {"attn_trapezoid": True})))
    torch.cuda.empty_cache()
    return paths


def profile_granite() -> None:
    """granite-moe at [21a]'s shapes under the profiler, after every
    timed run (a profiler session leaves overhead on later launches): a
    decode step from a 2 x 32,800-slot cache and a warm 2 x 32,768
    prefill, device time by kernel and idle share (``profile_serving``).
    Not a phase of the smoke: ``tools/moe_recsys_phase.py`` calls it."""
    import torch
    from repro_torch.configs.granite_moe_3b_a800m import make_config
    from repro_torch.models.transformer import (decode_step, grow_cache,
                                                init_params, prefill_step)
    cfg = make_config()
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 21)
    params = init_params(gen, cfg, device=DEVICE)
    prompt = torch.randint(0, cfg.vocab, (GRANITE_BATCH, GRANITE_PROMPT),
                           generator=gen, device=DEVICE)
    with torch.no_grad():
        logits, cache = prefill_step(params, prompt, cfg)
        cache = grow_cache(cache, 2)
        tokens = torch.argmax(logits, -1)[:, None]
        profile_serving("granite decode step", lambda: decode_step(
            params, {**cache, "len": GRANITE_PROMPT}, tokens, cfg))
        del cache, logits
        torch.cuda.empty_cache()
        profile_serving("granite warm prefill",
                        lambda: prefill_step(params, prompt, cfg))
    del params
    torch.cuda.empty_cache()


def mind_train(params, cfg, batch: int) -> tuple:
    """MIND_STEPS AdamW steps at ``batch`` through the port's train step,
    a new batch a step; (losses, ms a step, peak GiB)."""
    import torch
    from repro_torch.data import recsys_batch_fn
    from repro_torch.models.recsys import train_loss
    from repro_torch.optim import AdamWConfig, init_state
    from repro_torch.train import make_train_step
    make = recsys_batch_fn(cfg.n_items, batch, cfg.hist_len, seed=SEED,
                           device=DEVICE)
    step = make_train_step(lambda p, b: train_loss(p, b, cfg), AdamWConfig())
    state = init_state(params)
    torch.cuda.reset_peak_memory_stats()
    losses, ms = [], []
    for i in range(MIND_STEPS):
        b = make(i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, metrics = step(params, state, b)
        losses.append(float(metrics["loss"]))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return losses, ms, torch.cuda.max_memory_allocated() / 2**30


def phase_mind() -> dict:
    """[21d] MIND at ``make_config()`` width (a 2^21 x 64 float32 table)
    on its four cells, batches from ``recsys_batch_fn``; no kernel runs.
    Returns the cells' launch counts."""
    import numpy as np
    import torch
    from repro_torch.configs._families import RECSYS_SHAPES
    from repro_torch.configs.mind import make_config
    from repro_torch.data import recsys_batch_fn
    from repro_torch.kernels.flashattn import FLASHATTN
    from repro_torch.models.recsys import (init_params, retrieval_scores,
                                           serve_interests)
    from repro_torch.tree import tree_map
    cfg = make_config()
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 24)
    params = init_params(gen, cfg, device=DEVICE)
    log(f"[21d] mind: {cfg}, table {cfg.n_items} x {cfg.embed_dim} float32 "
        "drawn on the card")
    paths = {}

    def counted(label, fn, iters):
        reset_counts()
        with torch.no_grad():
            out = fn()
        torch.cuda.synchronize()
        paths[f"mind_{label}"] = kernel_only(f"mind {label}", FLASHATTN, 0)
        with torch.no_grad():
            ms = cuda_time_ms(fn, iters)
        if not bool(torch.isfinite(out).all()):
            raise AssertionError(f"mind {label}: not finite")
        return out, ms

    for cell, iters in (("serve_p99", 20), ("serve_bulk", 3)):
        b = RECSYS_SHAPES[cell]["batch"]
        batch = recsys_batch_fn(cfg.n_items, b, cfg.hist_len, seed=SEED,
                                device=DEVICE)(0)
        out, ms = counted(cell, lambda: serve_interests(params, batch, cfg),
                          iters)
        norms = torch.linalg.vector_norm(out, dim=-1)
        log(f"  {cell}: {b} users -> interests {tuple(out.shape)} in "
            f"{ms:.3f} ms a call ({b / ms * 1e3:.0f} users/s; CUDA events, "
            f"{iters} calls after a warm-up); norms {float(norms.min()):.6f}"
            f"-{float(norms.max()):.6f}")
        if cell == "serve_p99":
            host = tree_map(lambda t: t.cpu(), params)
            want = serve_interests(host, {k: v.cpu() for k, v in
                                          batch.items()}, cfg)
            gap = float((out.cpu() - want).abs().max()) / float(
                want.abs().max())
            log(f"  serve_p99 on the card vs the CPU (same weights and "
                f"batch): max |diff| {gap:.3g} of the largest entry (limit "
                f"{MIND_SERVE_REL})")
            if not gap <= MIND_SERVE_REL:
                raise AssertionError("mind serve_p99: the card and the CPU "
                                     "disagree beyond the stated tolerance")
            del host
        del batch, out

    cell = RECSYS_SHAPES["retrieval_cand"]
    hist = recsys_batch_fn(cfg.n_items, 1, cfg.hist_len, seed=SEED,
                           device=DEVICE)(1)
    rng = np.random.default_rng((SEED, 21))
    batch = {"hist": hist["hist"], "hist_mask": hist["hist_mask"],
             "candidates": torch.from_numpy(rng.integers(
                 0, cfg.n_items, cell["candidates"]).astype(np.int32))
             .to(DEVICE)}
    out, ms = counted("retrieval_cand",
                      lambda: retrieval_scores(params, batch, cfg), 10)
    log(f"  retrieval_cand: 1 user x {cell['candidates']} candidates -> "
        f"{tuple(out.shape)} scores in {ms:.3f} ms a call (one (K, D) @ (D,"
        f" C) product and a max over K; 10 calls after a warm-up); best "
        f"{float(out.max()):.4f}")
    del batch, out

    b = RECSYS_SHAPES["train_batch"]["batch"]
    reset_counts()
    losses, ms, peak = mind_train(params, cfg, b)
    torch.cuda.synchronize()
    paths["mind_train"] = kernel_only("mind train", FLASHATTN, 0)
    log(f"  train_batch: {MIND_STEPS} AdamW steps at batch {b}: losses {[round(x, 6) for x in losses]}, ms a step "
        f"{[round(x, 1) for x in ms]}, peak memory {peak:.2f} GiB")
    if not all(np.isfinite(losses)):
        raise AssertionError("mind train: loss not finite")
    del params
    torch.cuda.empty_cache()
    return paths


# ---------------------------------------------------------------------------
# [23] LM training: K5's backward, llama3.2-3b trained at full width
# ---------------------------------------------------------------------------

def bwd_cost(shape, causal: bool, elem: int, window=None) -> tuple:
    """(bytes, operations) of one attention backward: q, o, dO (B, S, H,
    dh) and k, v (B, S, KV, dh) read once, the float32 (B, H, S)
    logsumexp read once, dq, dk, dv written once; the five products of
    FlashAttention-2's backward (S, dP, dV, dS, dQ, dK: q . k, dO . v,
    P^T dO, dS K, dS^T Q), 2 dh operations each, for every (query, key)
    pair the mask keeps."""
    b, s, h, kv, dh = shape
    return ((4 * b * s * h * dh + 4 * b * s * kv * dh) * elem + 4 * b * h * s,
            10.0 * b * h * flash_pairs(s, causal, window) * dh)


def sdpa_bwd_ms(q, k, v, do, causal: bool, window, iters: int) -> float:
    """The backward of ``scaled_dot_product_attention`` on the KV heads
    repeated beforehand (the library yardstick, called only here): the
    flash backend in bfloat16, the memory-efficient one in float32 or
    with the band of a window as a boolean mask; the graph built once,
    its backward timed."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    g = q.shape[2] // k.shape[2]
    qt = q.transpose(1, 2).detach().requires_grad_(True)
    kt = k.repeat_interleave(g, dim=2).transpose(1, 2).detach() \
        .requires_grad_(True)
    vt = v.repeat_interleave(g, dim=2).transpose(1, 2).detach() \
        .requires_grad_(True)
    dot = do.transpose(1, 2)
    flash = q.dtype == torch.bfloat16 and window is None
    backend = SDPBackend.FLASH_ATTENTION if flash \
        else SDPBackend.EFFICIENT_ATTENTION
    with sdpa_kernel(backend):
        if window is None:
            out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
        else:
            pos = torch.arange(q.shape[1], device=q.device)
            band = (pos[:, None] >= pos[None, :]) \
                & (pos[:, None] - pos[None, :] < window)
            out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=band)
    ms = cuda_time_ms(lambda: torch.autograd.grad(
        out, (qt, kt, vt), dot, retain_graph=True), iters)
    del out
    return ms


def check_lse_forward(label: str, q, k, v, causal: bool, window) -> tuple:
    """K5's forward with its logsumexp (the training route): its output
    bitwise the serving call's and within FLASH_TOL of the plain forward
    in float32 on the same inputs, its logsumexp within TRAIN_LSE_ATOL
    of the plain one, and the control (the kernel's logsumexp moved down
    one row) beyond that limit.  Returns (out, lse, the gaps)."""
    import torch
    from repro_torch.kernels.flashattn import (flash_attention_cuda,
                                               flash_attention_gqa_ref)
    out, lse = flash_attention_cuda(q, k, v, causal=causal, window=window,
                                    return_lse=True)
    serving = flash_attention_cuda(q, k, v, causal=causal, window=window)
    want, want_lse = flash_attention_gqa_ref(
        q.float(), k.float(), v.float(), causal=causal, window=window,
        return_lse=True)
    torch.cuda.synchronize()
    name = str(q.dtype)[6:]
    gaps = {"out": float((out.float() - want).abs().max()),
            "lse": float((lse - want_lse).abs().max()),
            "lse_control": float((lse.roll(1, dims=-1) - want_lse)
                                 .abs().max())}
    same = torch.equal(out, serving)
    del serving, want, want_lse
    if not (same and gaps["out"] <= FLASH_TOL[name]
            and gaps["lse"] <= TRAIN_LSE_ATOL[name] < gaps["lse_control"]):
        raise AssertionError(
            f"flash forward with logsumexp, {label}: output bitwise the "
            f"serving call's {same}; gaps {gaps} (output limit "
            f"{FLASH_TOL[name]}, logsumexp limit {TRAIN_LSE_ATOL[name]}, "
            "which the control must exceed)")
    return out, lse, gaps


def check_bwd_case(label: str, shape, dtype, causal: bool, window,
                   seed: int, iters: int) -> dict:
    """K5 bwd against its plain backward in float32 on the same inputs
    (N(0, 1) q, k, v, dO; the kernel forward's output and logsumexp,
    checked first by ``check_lse_forward``): each of dq, dk, dv within
    TRAIN_BWD_REL in relative L2; two calls the same bits; the control
    (the logsumexp shifted by TRAIN_LSE_SHIFT, and in a float32 window
    case the window off by one) beyond the limit.  Timed beside the
    plain backward, its bound and SDPA's backward."""
    import torch
    from repro_torch.kernels.flashattn import (flash_attention_bwd_cuda,
                                               flash_attention_gqa_bwd_ref)
    b, s, h, kv, dh = shape
    q, k, v = flash_inputs(shape, dtype, seed)
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 1000)
    do = torch.randn((b, s, h, dh), generator=gen, device=DEVICE,
                     dtype=torch.float32).to(dtype)
    out, lse, fwd_gaps = check_lse_forward(label, q, k, v, causal, window)

    def kernel(lse=lse, window=window):
        return flash_attention_bwd_cuda(q, k, v, out, lse, do, causal=causal,
                                        window=window)

    got, again = kernel(), kernel()
    want = flash_attention_gqa_bwd_ref(q.float(), k.float(), v.float(),
                                       out.float(), lse, do.float(),
                                       causal=causal, window=window)
    torch.cuda.synchronize()
    same = all(torch.equal(x, y) for x, y in zip(got, again))

    def gaps(grads):
        # relative L2; a window of 1 leaves dq = dk = 0 (each row's one
        # key takes all the weight): there the largest entry
        return [float((g.float() - w).abs().max()) if window == 1 and i < 2
                else rel_l2(g, w)
                for i, (g, w) in enumerate(zip(grads, want))]

    errs = gaps(got)
    err = max(float((g.float() - w).abs().max()) for g, w in zip(got, want))
    name = str(dtype)[6:]
    limit = TRAIN_BWD_REL[name]
    controls = {"lse": max(gaps(kernel(lse=lse + TRAIN_LSE_SHIFT)))}
    if window is not None and window < s and dtype == torch.float32:
        off = window - 1 if window > 1 else 2     # a window as wide as S
        controls[f"window {off}"] = max(gaps(kernel(window=off)))
    del got, again, want
    if not (same and all(e <= limit for e in errs)
            and all(c > limit for c in controls.values())):
        raise AssertionError(
            f"flash bwd {label}: relative L2 {errs} (limit {limit}), two "
            f"calls alike {same}, controls {controls} (must exceed it)")
    ms = cuda_time_ms(kernel, iters)
    plain = cuda_time_ms(lambda: flash_attention_gqa_bwd_ref(
        q, k, v, out, lse, do, causal=causal, window=window), 1)
    lib_ms = sdpa_bwd_ms(q, k, v, do, causal, window, iters)
    n_bytes, n_ops = bwd_cost(shape, causal, q.element_size(), window)
    if dtype == torch.bfloat16:
        b_ms, b_by = bound(n_bytes, n_ops, BF16_OPS_PER_S)
        extra, also = {}, ""
    else:
        b_ms, b_by = bound(n_bytes, FLASH_F32_PRODUCTS * n_ops,
                           TF32_OPS_PER_S)
        fp32_ms, _ = bound(n_bytes, n_ops, FP32_OPS_PER_S)
        extra = {"fp32_pipe_bound_ms": fp32_ms}
        also = (f"; as {FLASH_F32_PRODUCTS} TF32 products; the float32 "
                f"pipe's bound {fp32_ms:.3f} ms")
    mode = "causal" if causal else "full"
    if window is not None:
        mode = f"window {window}"
    log(f"  flash bwd {label} {name} {mode} (B, S, H/KV, dh) = ({b}, {s}, "
        f"{h}/{kv}, {dh}): the forward with its logsumexp bitwise the "
        f"serving call, max |diff| from the plain forward "
        f"{fwd_gaps['out']:.3g}, logsumexp {fwd_gaps['lse']:.3g} (limit {TRAIN_LSE_ATOL[name]}; "
        f"control {fwd_gaps['lse_control']:.3g}); dq, dk, dv relative L2 "
        f"{', '.join(f'{e:.3g}' for e in errs)} (limit {limit}), max |diff| "
        f"{err:.3g}; two calls bitwise alike; controls "
        f"{', '.join(f'{k} {c:.3g}' for k, c in controls.items())}; "
        f"{ms:.3f} ms ({n_ops / ms / 1e9:.1f} TFLOP/s), plain {plain:.3f} "
        f"ms, SDPA backward {lib_ms:.3f} ms, bound {b_ms:.3f} ms ({b_by}"
        f"{also})")
    return {"max_abs_err": err, "rel_l2": errs, "controls": controls,
            "forward_lse_gaps": fwd_gaps,
            "ms": ms, "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
            **extra, "library_ms": lib_ms,
            "library": "scaled_dot_product_attention backward",
            "shape": f"(B, S, H/KV, dh) = ({b}, {s}, {h}/{kv}, {dh}) "
                     f"{name}, {mode}"}


def time_forward_lse() -> dict:
    """K5's forward with its logsumexp output (the training route)
    beside the serving call at [11]'s shape, in turns (serving, lse,
    lse, serving)."""
    import torch
    from repro_torch.kernels.flashattn import flash_attention_cuda
    q, k, v = flash_inputs(FLASH_SHAPE, torch.bfloat16, SEED + 5)
    serving, lse = [], []
    for fn, times in ((False, serving), (True, lse), (True, lse),
                      (False, serving)):
        times.append(cuda_time_ms(lambda: flash_attention_cuda(
            q, k, v, return_lse=fn), 3))
    log(f"  K5 forward at [11]'s shape {FLASH_SHAPE} bfloat16 causal: "
        f"serving {serving[0]:.3f}, {serving[1]:.3f} ms; with the "
        f"logsumexp output {lse[0]:.3f}, {lse[1]:.3f} ms")
    del q, k, v
    torch.cuda.empty_cache()
    return {"fwd_serving_ms": serving, "fwd_lse_ms": lse}


def phase_flash_bwd() -> tuple:
    """[23a] the backward kernel at the training shapes; returns the rows
    of K5 bwd (llama's layer) and its window mode (gemma3's local
    layer), the other cases under their own keys."""
    import torch
    bf16, f32 = torch.bfloat16, torch.float32
    row = check_bwd_case("llama train_4k layer", TRAIN_BWD_LLAMA, bf16, True,
                         None, SEED + 50, 3)
    torch.cuda.empty_cache()
    window_row = check_bwd_case("gemma3 local layer", TRAIN_BWD_GEMMA, bf16,
                                True, GEMMA_WINDOW, SEED + 51, 3)
    torch.cuda.empty_cache()
    for key, args in (
            ("float32", ("float32", TRAIN_BWD_F32, f32, True, None)),
            ("float32_window", ("float32", TRAIN_BWD_F32, f32, True,
                                GEMMA_WINDOW)),
            ("dh16", ("head dim 16", TRAIN_BWD_DH16, f32, True, None))):
        row.update({f"{key}_{k}": v for k, v in check_bwd_case(
            *args, SEED + 52, 5).items()})
    for dtype in (bf16, f32):
        for window in TRAIN_BWD_RAGGED_WINDOWS:
            ragged = check_bwd_case("ragged", FLASH_RAGGED_SHAPE, dtype,
                                    True, window, SEED + 53 + window, 10)
            window_row.update({f"ragged_{str(dtype)[6:]}_w{window}_{k}": v
                               for k, v in ragged.items()})
    torch.cuda.empty_cache()
    row.update(time_forward_lse())
    return row, window_row


def profile_train(label: str, fn) -> None:
    """Device time by kernel of ``fn``'s second run under the profiler
    (K5's forward, its backward, the GEMMs, the rest) and its idle
    share."""
    rows, wall_ms = profile_twice(fn)
    busy = sum(r[0] for r in rows)
    share = 1.0 / max(busy, 1e-9)

    def total(*names):
        return sum(r[0] for r in rows if any(n in r[2] for n in names))

    fwd = total("flash_bf16_kernel", "flash_f32_kernel")
    bwd = total("bwd_dkdv_", "bwd_dq_", "bwd_delta_kernel")
    gemm = sum(r[0] for r in rows if any(
        w in r[2].lower() for w in ("gemm", "xmma", "cutlass", "nvjet")))
    rest = busy - fwd - bwd - gemm
    log(f"  profile of one {label}: wall {wall_ms:.1f} ms, device busy "
        f"{busy:.1f} ms, idle share {1 - busy / wall_ms:.3f}; K5 forward "
        f"{fwd:.1f} ms ({fwd * share:.1%}), K5 bwd {bwd:.1f} ms "
        f"({bwd * share:.1%}), GEMMs {gemm:.1f} ms ({gemm * share:.1%}), the "
        f"rest {rest:.1f} ms ({rest * share:.1%})")
    for ms, calls, key in sorted(rows, reverse=True)[:12]:
        log(f"  {ms:9.2f} ms {ms * share:6.1%} x{calls:<6d} {key[:80]}")


def lm_batch(cfg, batch: int, seq: int, step: int, device=None) -> dict:
    import torch
    from repro_torch.data import lm_batch_fn
    return {k: torch.from_numpy(v).to(device or DEVICE)
            for k, v in lm_batch_fn(cfg.vocab, batch, seq, SEED)(step).items()}


def train_launches(cfg, steps: int = 1, remat=None) -> dict:
    """K5's launches in ``steps`` training steps of ``cfg``: a forward
    launch a layer (two under remat "full" or "save_qkv", whose backward
    runs the attention again; the remainder layers run once) and a
    backward launch a layer, local layers in the window modes."""
    from repro_torch.kernels.flashattn import (FLASHATTN, FLASHATTN_BWD,
                                               FLASHATTN_BWD_WINDOW,
                                               FLASHATTN_WINDOW)
    from repro_torch.models.transformer import REMAT_SAVED
    remat = cfg.remat if remat is None else remat
    again = remat and "attn_out" not in REMAT_SAVED[cfg.remat_policy]
    pattern = cfg.layer_pattern
    kinds = [pattern[i % len(pattern)] for i in range(cfg.n_layers)]
    grouped = cfg.n_groups * len(pattern)
    fwd = {"global": 0, "local": 0}
    for i, kind in enumerate(kinds):
        fwd[kind] += 2 if again and i < grouped else 1
    return {FLASHATTN: steps * fwd["global"],
            FLASHATTN_WINDOW: steps * fwd["local"],
            FLASHATTN_BWD: steps * kinds.count("global"),
            FLASHATTN_BWD_WINDOW: steps * kinds.count("local")}


def phase_train_llama() -> dict:
    """[23b] llama3.2-3b at full width and depth, bfloat16, through
    ``launch/train.py``'s path (weights drawn on the card, the donating
    AdamW step, remat "full", sequence 4,096): the batch sized from two
    steps at 1 and 2 (K5 and K5 bwd checked at it unless (a) did), then
    TRAIN_STEPS steps, one profiled, and one step
    with ``loss_chunk`` on the last step's weights and batch.  Returns
    the launch counts of the TRAIN_STEPS steps."""
    import dataclasses
    import gc
    import math
    import torch
    from repro_torch.configs.llama3_2_3b import make_config
    from repro_torch.launch.train import build_lm_training
    from repro_torch.models.transformer import lm_loss
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import make_train_step
    from repro_torch.tree import tree_leaves
    gc.collect()
    torch.cuda.empty_cache()
    cfg = make_config()
    opt = AdamWConfig()
    t0 = time.perf_counter()
    params, state, step_fn = build_lm_training(cfg, opt, DEVICE, seed=SEED)
    torch.cuda.synchronize()
    leaves = tree_leaves(params)
    n_params = sum(t.numel() for t in leaves)
    param_bytes = sum(t.numel() * t.element_size() for t in leaves)
    held = torch.cuda.memory_allocated()
    log(f"  {cfg.name}: {n_params} parameters ({cfg.dtype}) and AdamW "
        f"state drawn in {time.perf_counter() - t0:.2f} s, "
        f"{held / 2**30:.2f} GiB on the card; remat {cfg.remat} "
        f"({cfg.remat_policy}), loss_chunk {cfg.loss_chunk}")
    want = train_launches(cfg)

    def step(fn, batch, label):
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, _, metrics = fn(params, state, batch)
        loss = float(metrics["loss"])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = kernels_only(label, want)
        if not math.isfinite(loss):
            raise AssertionError(f"{label}: loss {loss} not finite")
        return loss, dt, torch.cuda.max_memory_allocated(), counts

    peaks = [step(step_fn, lm_batch(cfg, n, TRAIN_SEQ, 0),
                  f"{cfg.name} sizing step at batch {n}")[2] for n in (1, 2)]
    torch.cuda.empty_cache()    # the sizing steps' blocks fit no later one
    slope = max(peaks[1] - peaks[0], 1)
    cap = torch.cuda.mem_get_info()[1] - TRAIN_MARGIN_GIB * 2**30
    fits = int((cap - (peaks[0] - slope)) // slope)
    batch = max(1, min(TRAIN_CELL_BATCH, fits))
    log(f"  batch: train_4k's {TRAIN_CELL_BATCH} cut to {batch}: sizing "
        f"steps at 1 and 2 peaked at {peaks[0] / 2**30:.2f} and "
        f"{peaks[1] / 2**30:.2f} GiB, {slope / 2**30:.2f} GiB a sequence of "
        f"{TRAIN_SEQ}; the card's {torch.cuda.mem_get_info()[1] / 2**30:.2f}"
        f" GiB less {TRAIN_MARGIN_GIB} GiB of margin fit {fits} (params "
        f"{param_bytes / 2**30:.2f} GiB, their bfloat16 gradients as much, "
        f"AdamW's float32 moments {2 * 4 * n_params / 2**30:.2f} GiB)")
    if batch != TRAIN_BWD_LLAMA[0]:     # (a) checked K5 at another batch
        check_bwd_case(f"llama train_4k layer at batch {batch}",
                       (batch,) + TRAIN_BWD_LLAMA[1:], torch.bfloat16, True,
                       None, SEED + 50, 1)
        torch.cuda.empty_cache()
    losses, times, peak = [], [], 0
    total = {}      # every kernel's launches over the steps
    snapshot = None
    for i in range(TRAIN_STEPS):
        b = lm_batch(cfg, batch, TRAIN_SEQ, i)
        if i == TRAIN_STEPS - 1:    # the chunked step's weights, on the host
            snapshot = [t.to("cpu", copy=True) for t in leaves]
        loss, dt, p, counts = step(step_fn, b, f"{cfg.name} step {i}")
        losses.append(loss)
        times.append(dt)
        peak = max(peak, p)
        total = {k: total.get(k, 0) + n for k, n in counts.items()}
    per_step = sum(times[1:]) / len(times[1:])
    log(f"  {TRAIN_STEPS} AdamW steps at {batch} x {TRAIN_SEQ}: losses "
        f"{', '.join(f'{x:.5f}' for x in losses)}; {per_step:.3f} s a step "
        f"after the first ({', '.join(f'{x:.3f}' for x in times)}), "
        f"{batch * TRAIN_SEQ / per_step:.0f} tokens/s; peak "
        f"{peak / 2**30:.2f} GiB (torch.cuda.max_memory_allocated); K5 "
        f"launches a step {want}")
    profile_train(f"{cfg.name} training step ({batch} x {TRAIN_SEQ})",
                  lambda: step_fn(params, state, b))
    for t, s in zip(leaves, snapshot):
        t.copy_(s)
    del snapshot
    chunked = dataclasses.replace(cfg, loss_chunk=TRAIN_LOSS_CHUNK)
    loss_c, dt_c, peak_c, _ = step(
        make_train_step(lambda p, x: lm_loss(p, x, chunked), opt,
                        donate=True), b, f"{cfg.name} chunked step")
    gap = abs(loss_c - losses[-1]) / abs(losses[-1])
    log(f"  loss_chunk {TRAIN_LOSS_CHUNK} on step {TRAIN_STEPS - 1}'s weights "
        f"and batch: loss {loss_c:.6f} vs {losses[-1]:.6f} unchunked "
        f"(relative gap {gap:.3g}, limit {TRAIN_CHUNK_RTOL}); {dt_c:.3f} s; "
        f"peak {peak_c / 2**30:.2f} GiB vs {peak / 2**30:.2f}")
    if gap > TRAIN_CHUNK_RTOL:
        raise AssertionError(f"{cfg.name}: the chunked loss {loss_c} and the "
                             f"unchunked {losses[-1]} disagree")
    del params, state, leaves, step_fn
    gc.collect()
    torch.cuda.empty_cache()
    return total


def route_grads(params, cfg, batch, use_kernel, label) -> tuple:
    """(loss, every leaf's gradient) of ``lm_loss`` on one route, its K5
    launches checked."""
    import torch
    from repro_torch.models.transformer import lm_loss
    from repro_torch.tree import tree_leaves, tree_unflatten
    leaves = [t.detach().requires_grad_(True) for t in tree_leaves(params)]
    reset_counts()
    loss = lm_loss(tree_unflatten(params, leaves), batch, cfg,
                   use_kernel=use_kernel)
    grads = torch.autograd.grad(loss, leaves)
    torch.cuda.synchronize()
    kernels_only(label, train_launches(cfg) if use_kernel is None else {})
    return float(loss.detach()), [g.float() for g in grads]


def check_train_routes() -> None:
    """[23c] the kernel route against the plain route at full width, depth
    cut to TRAIN_ROUTE_LAYERS, one batch of 1 x TRAIN_SEQ, weights drawn
    in float32 and rounded to bfloat16 values: the loss and every leaf's
    gradient.  Float32: within LLAMA_F32_RTOL (relative L2 a leaf).
    bfloat16: each leaf's relative L2 distance from the float32 plain
    route's within LLAMA_BF16_RATIO of the plain bfloat16 route's, the
    loss within TRAIN_BF16_LOSS_RTOL of the plain bfloat16 route's."""
    import dataclasses
    import gc
    import torch
    from repro_torch.configs.llama3_2_3b import make_config
    from repro_torch.models.transformer import init_params
    from repro_torch.tree import tree_leaves
    cfg = dataclasses.replace(make_config(), n_layers=TRAIN_ROUTE_LAYERS)
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 41)
    params = init_params(gen, cfg32, device=DEVICE)
    for leaf in tree_leaves(params):
        leaf.copy_(leaf.to(torch.bfloat16))
    batch = lm_batch(cfg, 1, TRAIN_SEQ, 7)
    k32 = route_grads(params, cfg32, batch, None, "float32 kernel route")
    p32 = route_grads(params, cfg32, batch, False, "float32 plain route")
    loss_gap = abs(k32[0] - p32[0]) / abs(p32[0])
    leaf_gaps = [rel_l2(g, w) for g, w in zip(k32[1], p32[1])]
    log(f"  route check, {cfg.name} at full width, {TRAIN_ROUTE_LAYERS} "
        f"layers, 1 x {TRAIN_SEQ}, float32: loss {k32[0]:.7f} (kernel) vs "
        f"{p32[0]:.7f} (plain), relative gap {loss_gap:.3g}; the largest "
        f"leaf gradient's relative L2 gap {max(leaf_gaps):.3g} (limit "
        f"{LLAMA_F32_RTOL}, {len(leaf_gaps)} leaves)")
    if loss_gap > LLAMA_F32_RTOL or max(leaf_gaps) > LLAMA_F32_RTOL:
        raise AssertionError("train routes float32: kernel and plain routes "
                             "disagree beyond LLAMA_F32_RTOL")
    del k32
    p16 = init_params(gen, cfg, device=DEVICE)
    for dst, src in zip(tree_leaves(p16), tree_leaves(params)):
        dst.copy_(src)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    k16 = route_grads(p16, cfg, batch, None, "bfloat16 kernel route")
    q16 = route_grads(p16, cfg, batch, False, "bfloat16 plain route")
    ratios = []
    for gk, gp, w in zip(k16[1], q16[1], p32[1]):
        ratios.append(rel_l2(gk, w) / max(rel_l2(gp, w), 1e-30))
    loss_gap = abs(k16[0] - q16[0]) / abs(q16[0])
    worst = max(range(len(ratios)), key=ratios.__getitem__)
    log(f"  route check, bfloat16: loss {k16[0]:.6f} (kernel) vs "
        f"{q16[0]:.6f} (plain) vs {p32[0]:.6f} (float32 plain), kernel vs "
        f"plain relative gap {loss_gap:.3g} (limit {TRAIN_BF16_LOSS_RTOL}); "
        f"each leaf's gradient distance from the float32 plain route, "
        f"kernel / plain: largest ratio {ratios[worst]:.3g} (leaf {worst}, "
        f"limit {LLAMA_BF16_RATIO}), median "
        f"{sorted(ratios)[len(ratios) // 2]:.3g}")
    if max(ratios) > LLAMA_BF16_RATIO or loss_gap > TRAIN_BF16_LOSS_RTOL:
        raise AssertionError("train routes bfloat16: the kernel route beyond "
                             "the stated limits")
    del p16, k16, q16, p32
    gc.collect()
    torch.cuda.empty_cache()


def check_train_example() -> dict:
    """[23d] ``examples/train_lm_torch.py``'s default run on the card
    (its own assertion: the loss falls by more than 1.0); then
    TRAIN_SMOKE_STEPS steps of the llama, gemma3 and granite smoke
    configs on the card against the CPU's.  Returns the launch counts of
    the example and of gemma3's smoke steps."""
    import importlib
    import importlib.util
    import torch
    from repro_torch.models.transformer import init_params, lm_loss
    from repro_torch.optim import AdamWConfig, init_state
    from repro_torch.train import make_train_step
    from repro_torch.tree import tree_map
    path = Path(__file__).resolve().parent / "examples" / "train_lm_torch.py"
    spec = importlib.util.spec_from_file_location("train_lm_torch", path)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    cfg = example.make_config()
    reset_counts()
    t0 = time.perf_counter()
    losses = example.main(["--device", DEVICE])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    paths = {"train_example": kernels_only(
        "train_lm_torch example", train_launches(cfg, len(losses)))}
    log(f"  examples/train_lm_torch.py ({cfg.name}, head dim {cfg.hd}, "
        f"{str(cfg.dtype)[6:]}): {len(losses)} steps in {seconds:.1f} s, "
        f"loss {losses[0]:.4f} -> {losses[-1]:.4f}; K5 launches "
        f"{paths['train_example']}")
    for name in ("llama3_2_3b", "gemma3_27b", "granite_moe_3b_a800m"):
        mod = importlib.import_module(f"repro_torch.configs.{name}")
        cfg = mod.make_smoke_config()
        step = make_train_step(lambda p, b, cfg=cfg: lm_loss(p, b, cfg),
                               AdamWConfig(), donate=True)
        params = init_params(torch.Generator().manual_seed(SEED), cfg,
                             device="cpu")
        card = tree_map(lambda x: x.to(DEVICE, copy=True), params)
        states = init_state(params), init_state(card)
        got, want = [], []
        reset_counts()
        for i in range(TRAIN_SMOKE_STEPS):
            want.append(float(step(params, states[0], lm_batch(
                cfg, 2, 96, i, "cpu"))[2]["loss"]))
            got.append(float(step(card, states[1], lm_batch(
                cfg, 2, 96, i))[2]["loss"]))
        torch.cuda.synchronize()
        counts = kernels_only(f"{cfg.name} steps",
                              train_launches(cfg, TRAIN_SMOKE_STEPS))
        paths[f"{cfg.name}_train"] = counts
        gap = max(abs(g - w) / abs(w) for g, w in zip(got, want))
        log(f"  {cfg.name} ({cfg.n_layers} layers, head dim {cfg.hd}): "
            f"{TRAIN_SMOKE_STEPS} steps of 2 x 96 on the card, losses "
            f"{', '.join(f'{x:.6f}' for x in got)}, the CPU's "
            f"{', '.join(f'{x:.6f}' for x in want)} (largest relative gap "
            f"{gap:.3g}, limit {TRAIN_SMOKE_RTOL}); K5 launches {counts}")
        if gap > TRAIN_SMOKE_RTOL:
            raise AssertionError(f"{cfg.name}: the card's training losses "
                                 "stray from the CPU's")
    return paths


def phase_train() -> tuple:
    """[23]: (a), (c), (b), (d), each timed.  Returns the rows of K5 bwd
    and its window mode, and the training paths' launch counts."""
    t0 = time.perf_counter()
    row, window_row = phase_flash_bwd()
    log(f"  [23a] took {time.perf_counter() - t0:.1f} s")
    t1 = time.perf_counter()
    check_train_routes()
    log(f"  [23c] took {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    paths = {"llama_train": phase_train_llama()}
    log(f"  [23b] took {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    paths.update(check_train_example())
    log(f"  [23d] took {time.perf_counter() - t1:.1f} s")
    log(f"  [23] took {time.perf_counter() - t0:.1f} s")
    return row, window_row, paths


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    load_main_config()
    import numpy as np
    from repro_torch.core import (brandes_numpy, grid_graph,
                                  hyperbolic_graph, rmat_graph,
                                  with_csc_layout)
    from repro_torch.configs._families import GNN_SHAPES
    from repro_torch.configs.graphsage_reddit import (cfg_for_shape,
                                                      make_config)
    from repro_torch.data import graph_to_batch
    from repro_torch.kernels.flashattn import (FLASHATTN, FLASHATTN_BWD,
                                               FLASHATTN_BWD_WINDOW,
                                               FLASHATTN_WINDOW)
    from repro_torch.kernels.frontier import (FLAT, NODE_BLOCKED,
                                              NODE_BLOCKED_WIDE, WORDS)
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
    # the stop check a call and the grid's node-blocked level are timed
    # first: a torch.profiler session leaves overhead on every later
    # launch in the process, and both are bound by their host time
    stop_row = time_stopcheck(rmat.n_nodes)
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
    main_res = res      # [16] compares the SPMD lane's runs with it
    if not res.converged:
        log(f"  the epoch cap {MAIN_MAX_EPOCHS} was hit: converged=False")
    # right after [4] and before its profiled rounds: both runs timed alike
    log(f"[15a] checkpointed resume of [4]: stopped after {RESUME_AT} "
        f"epochs, resumed twice")
    paths["rmat_resumed"] = phase_resume(rmat, res)
    phase_profile("rmat", rmat, 4, BATCH)
    rows.append({"name": STOPCHECK, "route": "cuda",
                 "source": "src/repro_torch/kernels/stopcheck/csrc/"
                           "stopcheck.cu",
                 "replaces": "src/repro/kernels/stopcheck/kernel.py:45",
                 "launches": 0, **stop_row,
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
        f"(B, S, H, KV, dh) = {FLASH_SHAPE} and {FLASH_DH64_SHAPE} bfloat16 "
        f"causal, {FLASH_F32_SHAPE} float32, {FLASH_RAGGED_SHAPE} "
        "non-causal")
    rows.append({"name": FLASHATTN, "route": "cuda",
                 "source": "src/repro_torch/kernels/flashattn/csrc/"
                           "flashattn.cu",
                 "replaces": "src/repro/kernels/flashattn/kernel.py:70",
                 "launches": 0, **phase_flash()})

    log(f"[12] llama3.2-3b serving: prefill {LLAMA_BATCH} x {LLAMA_PROMPT} "
        f"(prefill_32k's length, batch cut from 32), {LLAMA_GEN} decode "
        f"steps, bfloat16 at full width and depth")
    paths["llama_serve"] = phase_llama()
    torch.cuda.empty_cache()

    log(f"[14] sharded cooperative lane: R-MAT 2^{RMAT_SCALE} x "
        f"{EDGE_FACTOR}, B={BATCH}, in {SHARDS} shards on one card "
        f"(ShardMesh), eps={MAIN_EPS}; then hyperbolic({HYPER_N}) in "
        f"{SHARDS} shards")
    wide_row, sharded_paths = phase_sharded()
    paths.update(sharded_paths)
    rows.append({"name": NODE_BLOCKED_WIDE, "route": "cuda",
                 "source": "src/repro_torch/kernels/frontier/csrc/"
                           "frontier.cu",
                 "replaces": "src/repro/kernels/frontier/kernel.py:405",
                 "launches": 0, **wide_row})
    torch.cuda.empty_cache()

    log(f"[16] SPMD lane: {SPMD_RANKS} ranks spawned on the one card in a "
        f"gloo group, mesh {SPMD_SHAPE} {SPMD_AXES}; run_kadabra R-MAT "
        f"2^{RMAT_SCALE} x {EDGE_FACTOR}, B={BATCH}, eps={MAIN_EPS} in each "
        f"of {SPMD_MODES}, resumed after {RESUME_AT} epochs; "
        f"hyperbolic({HYPER_N}); then a one-rank NCCL group")
    paths["rmat_spmd"] = phase_spmd(main_res)
    phase_nccl(1 << RMAT_SCALE)

    log(f"[17] sharded lane over torch.distributed: R-MAT 2^{RMAT_SCALE} x "
        f"{EDGE_FACTOR}, B={BATCH}, in {GROUP_SHARDS} shards, one a rank, "
        f"{GROUP_SHARDS} ranks spawned on the one card in a gloo group; a "
        f"batch each way, run_kadabra at max_epochs {GROUP_MAX_EPOCHS}, "
        f"hyperbolic({HYPER_N}) stopped and resumed; then a one-rank NCCL "
        "group")
    paths["rmat_group"] = phase_sharded_group(wide_row)
    torch.cuda.empty_cache()

    log(f"[18] weighted delta-stepping lane: R-MAT 2^{RMAT_SCALE} x "
        f"{EDGE_FACTOR} with dyadic weights, B={BATCH}: W1 and W2 at a "
        f"mid-search state, run_adaptive at eps {WEIGHTED_EPS}, one "
        f"ShardMesh({SHARDS}) batch; weighted ER({ER_N}) against exact "
        f"Brandes; R5's {WGRID_SIDE} x {WGRID_SIDE} unit grid")
    weighted_rows, weighted_paths = phase_weighted()
    paths.update(weighted_paths)
    torch.cuda.empty_cache()

    log(f"[19] runtime: [4]'s run with telemetry on, ResilientRunner through "
        f"five faults on it, the ladder ShardMesh({SHARDS}) -> 4 -> single "
        f"on R-MAT and hyperbolic({HYPER_N}), the ladder GroupShardMesh("
        f"{RUNTIME_RANKS}) -> 2 -> SamplerMesh(2) -> single across "
        f"{RUNTIME_RANKS} ranks, a torch.profiler trace")
    paths["rmat_telemetry"] = phase_runtime(main_res, paths["rmat_bidir"])
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    log("[20] GNN cells: EGNN, NequIP and MACE at full width on the molecule "
        "cell (K4 over the edge plan), EGNN in bf16; GraphSAGE on a "
        "NeighborSampler batch of the minibatch_lg cell")
    k4_row, gnn_paths = phase_gnn_cells()
    paths.update(gnn_paths)
    next(r for r in rows if r["name"] == SEGSUM).update(k4_row)
    log(f"  [20] took {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    log(f"[21] MoE serving (granite-moe, moonshot), qwen2 and MIND's four "
        f"cells; {smi}")
    paths.update(phase_moe_serving())
    paths.update(phase_mind())
    log(f"  [21] took {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    log(f"[22] gemma3-27b: K5's window mode at (B, S, H, KV, dh) = "
        f"{FLASH_WINDOW_SHAPE} bfloat16 and {FLASH_WINDOW_F32_SHAPE} float32,"
        f" window {GEMMA_WINDOW}, {FLASH_RAGGED_SHAPE} at windows "
        f"{FLASH_WINDOW_RAGGED}; the model at full width; its routes; {smi}")
    window_row = {"name": FLASHATTN_WINDOW, "route": "cuda",
                  "source": "src/repro_torch/kernels/flashattn/csrc/"
                            "flashattn.cu",
                  "replaces": "src/repro/models/attention.py:97",
                  "launches": 0, **phase_flash_window()}
    paths.update(phase_gemma())
    log(f"  [22] took {time.perf_counter() - t0:.1f} s")

    log(f"[23] LM training: K5's backward at (B, S, H, KV, dh) = "
        f"{TRAIN_BWD_LLAMA} and {TRAIN_BWD_GEMMA} bfloat16 (window "
        f"{GEMMA_WINDOW}), {TRAIN_BWD_F32} float32, {TRAIN_BWD_DH16}, "
        f"{FLASH_RAGGED_SHAPE} at windows {TRAIN_BWD_RAGGED_WINDOWS}; the "
        f"routes at {TRAIN_ROUTE_LAYERS} layers; llama3.2-3b trained at full "
        f"width, {TRAIN_STEPS} steps at {TRAIN_SEQ} tokens; the example and "
        f"three smoke configs; {smi}")
    bwd_row, bwd_window_row, train_paths = phase_train()
    paths.update(train_paths)

    # each row's launches: the run of the path that row's kernel carries;
    # the node-blocked rows' words pass beside it
    for row, main_path in zip(rows, ("rmat_bidir", "grid", "forward",
                                     "graphsage", "llama_serve",
                                     "rmat_sharded")):
        row["launches"] = paths[main_path][row["name"]]
        row["launches_by_path"] = {k: c[row["name"]]
                                   for k, c in paths.items()}
    # beside the launches of each frontier route, its words passes
    for row, main_path in zip(rows[:2] + rows[5:],
                              ("rmat_bidir", "grid", "rmat_sharded")):
        row["words_launches"] = paths[main_path][WORDS]
        row["words_launches_by_path"] = {k: c[WORDS]
                                         for k, c in paths.items()}
    # the weighted lane's kernels: launches of [18b]'s run
    for row in weighted_rows:
        row["launches"] = paths["weighted"][row["name"]]
        row["launches_by_path"] = {k: c.get(row["name"], 0)
                                   for k, c in paths.items()}
    rows.extend(weighted_rows)
    # K5's window mode: launches of [22b]'s prefill and decode
    window_row["launches"] = paths["gemma3_serve"][FLASHATTN_WINDOW]
    window_row["launches_by_path"] = {k: c.get(FLASHATTN_WINDOW, 0)
                                      for k, c in paths.items()}
    rows.append(window_row)
    # K5's backward: launches of [23b]'s llama steps; its window mode's,
    # of [23d]'s gemma3 smoke steps
    source = "src/repro_torch/kernels/flashattn/csrc/flashattn_bwd.cu"
    kind = ("XLA autodiff of dense_attention / masked_chunk_attention (the "
            "TPU kernel has no backward)")
    for row, kernel, main_path in (
            (bwd_row, FLASHATTN_BWD, "llama_train"),
            (bwd_window_row, FLASHATTN_BWD_WINDOW, "gemma3-smoke_train")):
        rows.append({"name": kernel, "route": "cuda", "source": source,
                     "replaces": "src/repro/models/transformer.py:256",
                     "replaces_kind": kind,
                     "launches": paths[main_path][kernel], **row,
                     "launches_by_path": {k: c.get(kernel, 0)
                                          for k, c in paths.items()}})
    log(f"[13] total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
