"""The adaptive sampling engine: the single-device lane, the SPMD lane of
independent samplers and the sharded cooperative lane
(``repro.core.engine``).

Phases, as in the JAX package:

  1. diameter     double-sweep bounds on the vertex diameter;
  2. calibration  a fixed number of samples, from which each estimator
                  builds its stop-rule parameters;
  3. epochs       per epoch: fold the previous frame into the aggregate,
                  draw the next frame (the surplus of the last round
                  seeds it), and evaluate every estimator's stopping rule
                  on the aggregate;
  4. flush        a metric's result is the flush (aggregate + frame +
                  surplus) of the first epoch its rule fires, or of the
                  last epoch when ``max_epochs`` is reached.

State frames are channel-stacked (C, V+1) float32 tensors, one row per
estimator channel, with host-side int sample counts.  Randomness comes
from one ``torch.Generator`` on the run's device, seeded from ``seed``;
the JAX ``lax.scan`` over rounds is a Python loop here.  One draw stream
feeds every estimator: the bidirectional one, or the forward one when
an estimator reads distance columns (closeness, harmonic), or, asked for
by name on a graph with weights, the weighted one (delta-stepping
searches and DAG walks): its phase 1 is the weighted double sweep, whose
hop bound sets omega and whose weighted-diameter bound is the run's
``RunContext.distance_cap``, which closeness normalizes by.  Every
epoch evaluates every estimator's stop rule, stopped or not, as the JAX
engine does; on the card each evaluation is one launch of the stop-check
kernel.

The sharded lane takes a :class:`PartitionedGraph` with
``mesh=ShardMesh(n_shards)`` (all shards on one device) or
``mesh=GroupShardMesh()`` (one shard a process of a ``torch.distributed``
group, each rank calling the run with its own local partition,
``partition_graph(graph, S, shard=rank)``, and the same arguments):
every search is sharded over the mesh, the mesh draws one stream of
samples cooperatively, and each epoch's stats carry the priced frontier
exchange.  Its diameter phase resolves an ``"auto"`` exchange budget;
calibration draws ``calib_samples_per_device * n_shards`` samples, as in
the reference.  On a ``GroupShardMesh`` the state each batch gathers,
and so every draw, fold and stop rule, is the same on every rank: the
ranks check after calibration that they hold the same diameter, budget,
B, n0 and parameters, rank 0 alone writes checkpoints, and a step
resumes on either mesh of the same shard count.

With ``checkpoint_dir`` the loop's state is published every
``checkpoint_every`` epochs (:class:`_EngineCheckpointer`), and a run
started again on the same directory resumes from the newest step that
verifies, bit for bit the uninterrupted run's on either lane.

The SPMD lane takes a replicated :class:`Graph` with
``mesh=SamplerMesh(...)`` (:mod:`repro_torch.core.distributed`): one
process a sampler, every rank calling the run with the same graph and
seed.  Phase 1 draws from a generator seeded with ``seed`` alone, so
every rank finds the same diameter; each rank then samples from its own
generator (:func:`~repro_torch.core.distributed.sampler_generator`).
Calibration draws ``calib_samples_per_device`` on each rank and sums
them with one blocking all_reduce, after which the ranks check that they
hold the same diameter, parameters and epoch length.  An epoch starts
the aggregation of the previous frame (``AdaptiveConfig.aggregation``:
``"hierarchical"``, ``"flat"`` or ``"root"``), draws ``n0 =
epoch_length(W)`` samples on each rank meanwhile, then waits for the
sum and evaluates every stop rule on it, on every rank.  Frames are
``(C, v_pad)``, zero past V+1 (:func:`_pad_len`); the estimators read
``[:V]``.  Each rank returns the same result.  A mesh of one rank is the
single-device lane.

Every lane takes a supervision hook, ``on_epoch(epoch, state)``, called
once an epoch after the epoch's draws and stop checks and before its
freeze and save (the runtime's :class:`~repro_torch.runtime.ResilientRunner`
is its user), and a telemetry bus (``telemetry=``,
:mod:`repro_torch.runtime.telemetry`) that reads what the loop already
holds on the host: with it on, every lane draws, launches and returns
the same bits as with it off.  On the lanes of many processes every rank
runs its hook, and one small all_reduce then makes the ranks agree on
the outcome before any of them goes on (:func:`_agree_on_hook`).
"""
from __future__ import annotations

import dataclasses
import time
import zlib
from functools import partial
from types import SimpleNamespace
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve_device
from .bfs import _default_delta, _window_start
from .diameter import (estimate_diameter, estimate_diameter_sharded,
                       estimate_diameter_weighted,
                       estimate_diameter_weighted_sharded)
from .distributed import (AGGREGATIONS, SamplerMesh, allreduce_ints,
                          assert_replicated, flat_allreduce,
                          sampler_generator)
from .epoch import epoch_length, frame_schema_id
from .errors import HOOK_FAILURES, DeviceLoss
from .estimators import get_estimator
from .estimators.base import DrawBatch, Estimator, MetricReport, RunContext
from .graph import Graph
from .partition import (PartitionedGraph, auto_exchange_budget,
                        exchange_plan, max_active_source_chunks)
from .sampler import (sample_path_batched, sample_path_batched_sharded,
                      sample_path_forward_batched,
                      sample_path_forward_batched_sharded,
                      sample_path_weighted_batched,
                      sample_path_weighted_batched_sharded)
from .shards import SHARD_MESHES, GroupShardMesh, canonical_device

__all__ = ["DEFAULT_SAMPLE_BATCH_SIZE", "AdaptiveConfig",
           "AdaptiveRunResult", "EngineEpochStats", "FoldResult",
           "draw_fold", "make_agg_fn", "resolve_estimators",
           "resolve_sample_batch_size", "resolve_stream", "run_adaptive",
           "run_fixed"]

DEFAULT_SAMPLE_BATCH_SIZE = 16


def resolve_sample_batch_size(requested, n_nodes: int,
                              vertex_diameter: int) -> int:
    """The concurrent-sample width B: an explicit ``requested`` wins;
    otherwise 64 on low-diameter graphs (VD within 4 log2 V), 16 in the
    middle and 8 beyond 12 log2 V, where path lengths within a batch
    vary widely."""
    if requested is not None:
        return max(1, int(requested))
    logv = max(1.0, float(np.log2(max(n_nodes, 2))))
    ratio = float(vertex_diameter) / logv
    if ratio <= 4.0:
        return 64
    if ratio <= 12.0:
        return DEFAULT_SAMPLE_BATCH_SIZE
    return 8


@dataclasses.dataclass(frozen=True)
class AdaptiveConfig:
    eps: float = 0.01
    delta: float = 0.1
    calib_samples_per_device: int = 32
    n0_base: int = 1000
    n0_exponent: float = 1.33
    max_epochs: int = 10_000
    diameter_sweeps: int = 2
    # the SPMD lane's aggregation of each epoch's frame:
    # "hierarchical" | "flat" | "root" (repro_torch.core.distributed)
    aggregation: str = "hierarchical"
    # None: resolve B from the diameter estimate (resolve_sample_batch_size)
    sample_batch_size: Optional[int] = None


class EngineEpochStats(NamedTuple):
    """Per-epoch record; max_f/max_g hold one entry per estimator."""
    epoch: int
    tau: int          # aggregated samples the stop rules read
    max_f: tuple
    max_g: tuple
    seconds: float
    samples: int      # samples drawn this epoch
    # sharded lane: ExchangePlan.epoch_accounting of the epoch's draws
    # (levels dense and sparse, bytes); None on the other lanes
    exchange: Optional[dict] = None
    # SPMD lane, this rank: seconds starting the previous frame's
    # aggregation, drawing this epoch's frame and blocked in its wait(),
    # and the bytes staged to the host and back; None on the other lanes
    aggregation: Optional[dict] = None


class AdaptiveRunResult(NamedTuple):
    reports: tuple        # MetricReport per estimator, metrics order
    tau: int              # samples in the final flush
    n_epochs: int
    converged: bool       # every metric's own rule fired
    vertex_diameter: int
    stats: list           # list[EngineEpochStats]
    phase_seconds: dict   # diameter / calibration / sampling
    bfs_levels: int       # frontier expansions (relaxation rounds on the
                          # weighted stream) of the whole run
    dag_rounds: int = 0   # the weighted stream's DAG rounds
    distance_cap: float = 0.0   # the weighted stream's distance bound


def resolve_estimators(metrics) -> tuple:
    """Metric names (or Estimator instances) -> tuple of plugins."""
    if isinstance(metrics, (str, Estimator)):
        metrics = (metrics,)
    ests = [m if isinstance(m, Estimator) else get_estimator(m)
            for m in metrics]
    if not ests:
        raise ValueError("metrics must name at least one estimator")
    names = [e.name for e in ests]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate metrics {names}")
    return tuple(ests)


def resolve_stream(estimators, stream: Optional[str] = None,
                   graph=None) -> str:
    """The draw stream: ``"bidir"`` (KADABRA's bidirectional search)
    unless an estimator needs the forward stream's distance columns.
    ``"weighted"`` is taken only when asked for, and needs a ``graph``
    with weights (else ``ValueError``).  A forward estimator on an
    explicit ``"bidir"`` raises ``ValueError``."""
    need_fwd = [e.name for e in estimators if e.needs_forward]
    if stream is None:
        return "forward" if need_fwd else "bidir"
    if stream == "weighted":
        if graph is not None and getattr(graph, "weight", None) is None:
            raise ValueError("stream='weighted' needs a graph with weights: "
                             "attach them with repro_torch.core.graph."
                             "with_weights (and partition that graph)")
        return stream
    if stream not in ("bidir", "forward"):
        raise ValueError(f"unknown stream {stream!r} (expected 'bidir', "
                         "'forward' or 'weighted')")
    if stream == "bidir" and need_fwd:
        raise ValueError(
            f"estimators {need_fwd} need the forward stream; the "
            "bidirectional stream carries no per-source distances")
    return stream


def _pad_len(v: int, n_dev: int) -> int:
    """A frame's length: V+1 (the sink row) rounded up to a multiple of
    the mesh's size, so that every tier's reduce_scatter tiles it."""
    return -(-(v + 1) // n_dev) * n_dev


def make_agg_fn(mesh: SamplerMesh, aggregation: str):
    """``x -> Aggregation`` of ``aggregation`` over ``mesh``: one of
    ``"hierarchical"``, ``"flat"`` or ``"root"``.  A (C, v_pad) frame is
    aggregated whole, flattened to (C * v_pad,) around the collectives
    (``mesh.size`` divides v_pad)."""
    fn = AGGREGATIONS.get(aggregation)
    if fn is None:
        raise ValueError(f"unknown aggregation {aggregation!r} (expected "
                         f"one of {sorted(AGGREGATIONS)})")
    return partial(fn, mesh=mesh)


def lane_state_shapes(n_channels: int, n_nodes: int,
                      n_samplers: int = 1) -> tuple:
    """The shapes of a lane's aggregate, frame and surplus counts (the
    frozen snapshot has the aggregate's): ``(C, V+1)`` each on the
    single and sharded lanes; on the SPMD lane of ``n_samplers`` ranks
    the aggregate and a rank's frame are ``(C, v_pad)``
    (:func:`_pad_len`) and its surplus ``(C, V+1)``."""
    v1 = n_nodes + 1
    if n_samplers == 1:
        return ((n_channels, v1),) * 3
    frame = (n_channels, _pad_len(n_nodes, n_samplers))
    return frame, frame, (n_channels, v1)


def _channel_offsets(estimators) -> tuple:
    offs, o = [], 0
    for e in estimators:
        offs.append(o)
        o += e.n_channels
    return tuple(offs)


# ---------------------------------------------------------------------------
# The shared draw-and-fold
# ---------------------------------------------------------------------------

class FoldResult(NamedTuple):
    """``n_samples`` new samples (plus any carry) folded through every
    estimator, and the surplus of the last round folded apart."""
    counts: torch.Tensor      # (C, V+1) float32
    tau: int
    sur_counts: torch.Tensor  # (C, V+1) float32
    sur_tau: int
    n_levels: int             # BFS levels (relaxation rounds) expanded
    # (2,) int32 [levels exchanged, of which sparse] summed over the
    # rounds, on the device (sharded draws); None otherwise
    exchange: Optional[torch.Tensor] = None
    n_dag_rounds: int = 0     # the weighted stream's DAG rounds


def draw_fold(graph, gen: torch.Generator, n_samples: int, *,
              estimators, ctx: RunContext, stream: str = "bidir",
              batch_size: int = 1, carry=None, mesh=None) -> FoldResult:
    """Take exactly ``n_samples`` new samples in rounds of ``batch_size``
    from ``stream`` (``"bidir"``, ``"forward"`` or ``"weighted"``) and
    fold them through every estimator's ``accumulate``.

    When ``batch_size`` does not divide ``n_samples``, the surplus
    samples of the last round (valid i.i.d. draws) are folded into a
    separate frame, which the engine carries into the next epoch.
    ``carry`` ((C, V+1) counts, tau) is added to the returned frame.
    With ``mesh`` (a ``ShardMesh`` or ``GroupShardMesh``) ``graph`` is a
    :class:`PartitionedGraph`, every round's search is sharded, and the
    result carries the rounds' exchange tally.
    """
    if mesh is None:
        draws = {"bidir": sample_path_batched,
                 "forward": sample_path_forward_batched,
                 "weighted": sample_path_weighted_batched}
    else:
        draws = {"bidir": partial(sample_path_batched_sharded, mesh=mesh),
                 "forward": partial(sample_path_forward_batched_sharded,
                                    mesh=mesh),
                 "weighted": partial(sample_path_weighted_batched_sharded,
                                     mesh=mesh)}
    draw = draws.get(stream)
    if draw is None:
        raise ValueError(f"unknown stream {stream!r} (expected 'bidir', "
                         "'forward' or 'weighted')")
    batch_size = max(1, min(int(batch_size), int(n_samples)))
    rounds = -(-n_samples // batch_size)
    dev = graph.device
    xch = None if mesh is None else torch.zeros(2, dtype=torch.int32,
                                                device=dev)
    n_ch = sum(e.n_channels for e in estimators)
    counts = torch.zeros((n_ch, ctx.n_nodes + 1), dtype=torch.float32,
                         device=dev)
    sur_counts = torch.zeros_like(counts)
    tau = 0
    if carry is not None:
        counts = counts + carry[0]
        tau = int(carry[1])
    n_levels = n_dag = 0
    for r in range(rounds):
        ps = draw(graph, gen, batch_size)
        n_levels += ps.n_levels
        n_dag += getattr(ps, "n_dag_rounds", 0)
        if xch is not None:
            xch += ps.exchange
        batch = DrawBatch(ps.internal, ps.valid, ps.length,
                          getattr(ps, "dist", None),
                          getattr(ps, "sources", None))
        n_keep = min(batch_size, n_samples - r * batch_size)
        keep = torch.arange(batch_size, device=dev) < n_keep
        counts = counts + torch.cat(
            [e.accumulate(batch, keep, ctx) for e in estimators])
        tau += n_keep
        if n_keep < batch_size:
            sur_counts = sur_counts + torch.cat(
                [e.accumulate(batch, ~keep, ctx) for e in estimators])
    return FoldResult(counts, tau, sur_counts,
                      rounds * batch_size - n_samples, n_levels, xch, n_dag)


def _check_all(estimators, offsets, agg_counts, agg_tau, params, ctx):
    """Every estimator's stopping rule on its slice of the aggregate ->
    ((E,) bool done, (E,) max_f, (E,) max_g) as numpy arrays."""
    ds, fs, gs = [], [], []
    for est, off, p in zip(estimators, offsets, params):
        d, f, g = est.stopping_rule(
            agg_counts[off: off + est.n_channels], agg_tau, p, ctx)
        ds.append(d)
        fs.append(f)
        gs.append(g)
    out = torch.stack([torch.stack(ds).float(), torch.stack(fs),
                       torch.stack(gs)]).cpu().numpy()
    return out[0] > 0, out[1], out[2]


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _sharded_diameter(pg: PartitionedGraph, mesh, gen, n_sweeps: int,
                      weighted: bool = False):
    """The double sweep on the sharded search -> (estimate, pg): the BFS
    one, or with ``weighted`` the weighted one.  With
    ``exchange_budget="auto"`` the second sweeps' levels (the weighted
    sweeps' buckets, [k delta, (k+1) delta) of the mean weight delta)
    are the occupancy sample: the returned pg carries the derived
    budget."""
    sweeps = (estimate_diameter_weighted_sharded if weighted
              else estimate_diameter_sharded)
    if not pg.exchange_budget_auto:
        return sweeps(pg, mesh, gen, n_sweeps), pg
    est, dist = sweeps(pg, mesh, gen, n_sweeps, return_dist=True)
    if weighted:
        # the search's own windows: its default delta, its window index
        delta = _default_delta(pg.weight, pg.n_edges).to(dist.device)
        dist = torch.where(dist >= 0, _window_start(dist, delta), -1.0)
    dist = dist.cpu().numpy()
    occupancies = []
    for lvl in np.unique(dist[dist >= 0]):
        rows = (dist == lvl).any(axis=1)
        occupancies.append(max_active_source_chunks(pg, rows))
    return est, dataclasses.replace(
        pg, exchange_budget=auto_exchange_budget(pg, occupancies),
        exchange_budget_auto=False)


def _phase_one(graph, mesh, gen, n_sweeps: int, stream: str):
    """Phase 1 of a lane -> (vertex diameter, distance cap, levels, DAG
    rounds, graph): the BFS double sweep, or on the weighted stream the
    weighted one (its hop bound, and its weighted-diameter bound as the
    cap; 0.0 otherwise).  On a sharded lane the graph returned carries
    an "auto" budget resolved from the sweeps."""
    weighted = stream == "weighted"
    if mesh is None:
        est = (estimate_diameter_weighted if weighted
               else estimate_diameter)(graph, gen, n_sweeps=n_sweeps)
    else:
        est, graph = _sharded_diameter(graph, mesh, gen, n_sweeps, weighted)
    return (int(est.vertex_diameter), float(est.upper) if weighted else 0.0,
            est.n_levels, getattr(est, "n_dag_rounds", 0), graph)


def _lane(graph, mesh, cfg: AdaptiveConfig, estimators, stream, gen,
          offsets):
    """Phase 1 and the per-epoch pieces of a lane: the single-device lane
    (``mesh`` None) or the sharded cooperative lane, where the mesh is
    one sampler: an epoch draws ``n0`` samples for the whole mesh, and
    calibration what ``n_shards`` devices would."""
    ns = SimpleNamespace()
    dev = graph.device
    t0 = time.perf_counter()
    ns.vd, ns.dist_cap, ns.diam_levels, ns.diam_dag, graph = _phase_one(
        graph, mesh, gen, cfg.diameter_sweeps, stream)
    n_cal = cfg.calib_samples_per_device * (1 if mesh is None
                                            else graph.n_shards)
    _sync(dev)
    ns.graph, ns.gen, ns.n_samplers = graph, gen, 1
    ns.t_diam = time.perf_counter() - t0

    def calibrate(bsz, ctx):
        return draw_fold(graph, gen, n_cal, estimators=estimators, ctx=ctx,
                         stream=stream, batch_size=bsz, mesh=mesh)

    def make_epoch(params, ctx, n0, bsz):
        def epoch_step(state):
            agg_c, agg_t, fr_c, fr_t, sur_c, sur_t = state
            agg_c = agg_c + fr_c
            agg_t = agg_t + fr_t
            fold = draw_fold(graph, gen, n0, estimators=estimators,
                             ctx=ctx, stream=stream, batch_size=bsz,
                             carry=(sur_c, sur_t), mesh=mesh)
            checks = _check_all(estimators, offsets, agg_c, agg_t, params,
                                ctx)
            return ((agg_c, agg_t, fold.counts, fold.tau, fold.sur_counts,
                     fold.sur_tau), checks, fold, None)
        return epoch_step

    def flush(state):
        agg_c, agg_t, fr_c, fr_t, sur_c, sur_t = state
        return (agg_c + fr_c) + sur_c, agg_t + fr_t + sur_t

    def init_state(ctx):
        shape, _, _ = lane_state_shapes(
            sum(e.n_channels for e in estimators), ctx.n_nodes)
        z = torch.zeros(shape, dtype=torch.float32, device=dev)
        return (z, 0, z, 0, z, 0)

    ns.calibrate, ns.make_epoch = calibrate, make_epoch
    ns.flush, ns.init_state = flush, init_state
    return ns


def _padded(counts: torch.Tensor, v_pad: int) -> torch.Tensor:
    """(C, V+1) counts as a (C, v_pad) frame, zero past V+1."""
    return torch.nn.functional.pad(counts, (0, v_pad - counts.shape[1]))


def _spmd_lane(graph, mesh: SamplerMesh, cfg: AdaptiveConfig, estimators,
               stream, gen, offsets, seed: int):
    """Phase 1 and the per-epoch pieces of the SPMD lane: ``mesh.size``
    independent samplers, one a rank, whose frames are summed by
    ``cfg.aggregation`` (paper Alg. 2).  ``gen`` (seeded with ``seed``
    alone) draws the diameter's seeds, the same on every rank; the
    samples come from this rank's :func:`sampler_generator`."""
    ns = SimpleNamespace()
    dev = graph.device
    v1 = graph.n_nodes + 1
    v_pad = _pad_len(graph.n_nodes, mesh.size)
    agg = make_agg_fn(mesh, cfg.aggregation)
    t0 = time.perf_counter()
    ns.vd, ns.dist_cap, ns.diam_levels, ns.diam_dag, _ = _phase_one(
        graph, None, gen, cfg.diameter_sweeps, stream)
    _sync(dev)
    ns.graph, ns.n_samplers = graph, mesh.size
    ns.gen = sampler_generator(seed, mesh.rank, dev)
    ns.t_diam = time.perf_counter() - t0

    def calibrate(bsz, ctx):
        # pleasingly parallel draws, then one blocking reduce
        fold = draw_fold(graph, ns.gen, cfg.calib_samples_per_device,
                         estimators=estimators, ctx=ctx, stream=stream,
                         batch_size=bsz)
        counts = flat_allreduce(_padded(fold.counts, v_pad), mesh).wait()
        tau = int(allreduce_ints([fold.tau], mesh).wait()[0])
        return fold._replace(counts=counts, tau=tau)

    def make_epoch(params, ctx, n0, bsz):
        def epoch_step(state):
            agg_c, agg_t, fr_c, fr_t, sur_c, sur_t = state
            t0 = time.perf_counter()
            # 1. the previous frame goes to the aggregation ...
            inc_c = agg(fr_c)
            inc_t = allreduce_ints([fr_t], mesh)
            t1 = time.perf_counter()
            # 2. ... while this rank draws the next one, the previous
            #    surplus seeding it
            fold = draw_fold(graph, ns.gen, n0, estimators=estimators,
                             ctx=ctx, stream=stream, batch_size=bsz,
                             carry=(sur_c, sur_t))
            new_c = _padded(fold.counts, v_pad)
            _sync(dev)
            t2 = time.perf_counter()
            # 3. the sum, and every stop rule on it, on every rank
            agg_c = agg_c + inc_c.wait()
            agg_t = agg_t + int(inc_t.wait()[0])
            t3 = time.perf_counter()
            checks = _check_all(estimators, offsets, agg_c, agg_t, params,
                                ctx)
            timing = {"start_s": t1 - t0, "draw_s": t2 - t1,
                      "wait_s": t3 - t2, "staged_bytes": inc_c.staged_bytes}
            return ((agg_c, agg_t, new_c, fold.tau, fold.sur_counts,
                     fold.sur_tau), checks, fold._replace(exchange=None),
                    timing)
        return epoch_step

    def flush(state):
        # each rank's frame plus its surplus, then one aggregation
        agg_c, agg_t, fr_c, fr_t, sur_c, sur_t = state
        c = fr_c.clone()
        c[:, :v1] += sur_c
        inc_c, inc_t = agg(c), allreduce_ints([fr_t + sur_t], mesh)
        return agg_c + inc_c.wait(), agg_t + int(inc_t.wait()[0])

    def init_state(ctx):
        agg, _, sur = lane_state_shapes(
            sum(e.n_channels for e in estimators), ctx.n_nodes, mesh.size)
        z = torch.zeros(agg, dtype=torch.float32, device=dev)
        return (z, 0, z, 0, torch.zeros(sur, dtype=torch.float32,
                                        device=dev), 0)

    ns.calibrate, ns.make_epoch = calibrate, make_epoch
    ns.flush, ns.init_state = flush, init_state
    return ns


def _params_crc(params) -> int:
    """CRC32 over the bits of every estimator's stop-rule parameters."""
    crc = 0
    for p in params:
        for x in (p if isinstance(p, tuple) else (p,)):
            if isinstance(x, torch.Tensor):
                b = x.detach().cpu().numpy().tobytes()
            elif isinstance(x, (int, float, np.number)):
                b = np.float64(x).tobytes()
            else:
                b = repr(x).encode()
            crc = zlib.crc32(b, crc)
    return crc


# ---------------------------------------------------------------------------
# Checkpointing (schema-stamped loop state)
# ---------------------------------------------------------------------------

class _EngineCheckpointer:
    """Mid-run persistence of the loop's state: every ``checkpoint_every``
    epochs the 10 leaves

        (agg counts (C, V+1) float32, agg tau, frame counts, frame tau,
         surplus counts, surplus tau (the taus 0-d int64),
         frozen counts (C, V+1), frozen tau (E,) int64,
         stop epoch (E,) int64 (-1 where a metric has not stopped),
         the generator's state (uint8))

    are published through :class:`repro_torch.checkpoint.CheckpointManager`,
    stamped with the run's :func:`frame_schema_id`, after the epoch's
    draws and freeze.  The frozen leaves carry each stopped metric's
    deciding snapshot, and the generator's state is taken after the
    epoch's draws, so a resumed run (phases 1-2 replayed from the seed,
    then the state and the generator overwritten) continues the
    uninterrupted run's stream exactly."""

    def __init__(self, checkpoint_dir: str, checkpoint_every: int,
                 schema: str, dev: torch.device, telemetry=None):
        from ..checkpoint.store import CheckpointManager
        self.telemetry = telemetry
        self.mgr = CheckpointManager(checkpoint_dir, keep=3,
                                     save_every=checkpoint_every,
                                     schema=schema, telemetry=telemetry)
        cpu = torch.device("cpu")
        # where each leaf lives in the loop: counts on the run's device,
        # taus, the frozen bookkeeping and the generator state on the host
        self.devices = (dev, cpu, dev, cpu, dev, cpu, dev, cpu, cpu, cpu)

    @staticmethod
    def leaves(state, frozen_c, frozen_tau, stop_epoch, gen) -> tuple:
        agg_c, agg_t, fr_c, fr_t, sur_c, sur_t = state
        return (agg_c, np.int64(agg_t), fr_c, np.int64(fr_t), sur_c,
                np.int64(sur_t), frozen_c, frozen_tau, stop_epoch,
                gen.get_state())

    def restore_state(self, state, frozen_c, frozen_tau, stop_epoch, gen):
        """-> (state, frozen_c, frozen_tau, stop_epoch, epoch): the newest
        step that verifies, with ``gen`` set to its state, or the
        arguments and epoch 0 when there is none."""
        out = self.mgr.restore_or_none(
            self.leaves(state, frozen_c, frozen_tau, stop_epoch, gen),
            device=self.devices)
        if out is None:
            return state, frozen_c, frozen_tau, stop_epoch, 0
        return self._unpack(out, gen)

    @staticmethod
    def _unpack(out, gen):
        lv, step, meta = out
        gen.set_state(lv[9])
        state = (lv[0], int(lv[1]), lv[2], int(lv[3]), lv[4], int(lv[5]))
        return (state, lv[6], lv[7].numpy(), lv[8].numpy(),
                int(meta.get("epoch", step)))

    def save_state(self, epoch: int, state, frozen_c, frozen_tau,
                   stop_epoch, gen, done: bool) -> None:
        self.mgr.maybe_save(
            epoch, self.leaves(state, frozen_c, frozen_tau, stop_epoch, gen),
            metadata={"epoch": epoch, "done": bool(done)})

    def wait(self) -> None:
        self.mgr.wait()


def _agree_on_step(mesh, mgr, like, root: str, schema: str, device):
    """Rank 0's restore into ``like`` on ``device`` (or None) and the
    step every rank of ``mesh`` reads: -1 for none.  Rank 0 alone reads
    the store (it may quarantine a damaged step) and broadcasts the
    step's number; a failure on rank 0 raises on every rank, of the same
    class where it is a checkpoint error."""
    from ..checkpoint.store import (CheckpointError, CheckpointLayoutError,
                                    CheckpointSchemaError)
    kinds = (CheckpointSchemaError, CheckpointLayoutError, CheckpointError,
             RuntimeError)
    out, code, failure = None, -1, None
    if mesh.rank == 0:
        try:
            out = mgr.restore_or_none(like, device=device)
            code = -1 if out is None else out[1]
        except Exception as e:  # noqa: BLE001 - every rank must hear
            failure = e
            code = -2 - next(i for i, k in enumerate(kinds)
                             if isinstance(e, k) or k is RuntimeError)
    t = torch.tensor([code], dtype=torch.int64, device=mesh.comm_device)
    torch.distributed.broadcast(t, src=mesh.root, group=mesh.group)
    code = int(t[0])
    if failure is not None:
        raise failure
    if code < -1:
        raise kinds[-2 - code](
            f"rank 0 of the {type(mesh).__name__} could not restore the "
            f"checkpoint under {root} (schema {schema!r}); see its error")
    return out, code


class _GroupCheckpointer(_EngineCheckpointer):
    """The checkpoint of the sharded lane on a :class:`GroupShardMesh`:
    the lane's state is replicated (the mesh is one sampler), so a step
    holds :class:`_EngineCheckpointer`'s 10 leaves under the one-card
    lane's schema (``sharded<S>``) and resumes on ``ShardMesh(S)`` or on
    S ranks alike.  Rank 0 alone publishes; on resume it picks the
    newest step that verifies and broadcasts its number (or its
    failure), and every other rank restores that step."""

    def __init__(self, checkpoint_dir: str, checkpoint_every: int,
                 schema: str, mesh: GroupShardMesh, telemetry=None):
        super().__init__(checkpoint_dir, checkpoint_every, schema,
                         mesh.device, telemetry)
        self.mesh, self.root, self.schema = mesh, checkpoint_dir, schema

    def restore_state(self, state, frozen_c, frozen_tau, stop_epoch, gen):
        from ..checkpoint.store import restore
        like = self.leaves(state, frozen_c, frozen_tau, stop_epoch, gen)
        out, step = _agree_on_step(self.mesh, self.mgr, like, self.root,
                                   self.schema, self.devices)
        if step == -1:
            return state, frozen_c, frozen_tau, stop_epoch, 0
        if out is None:
            out = restore(self.root, like, step=step, device=self.devices,
                          expect_schema=self.schema,
                          telemetry=self.telemetry)
        return self._unpack(out, gen)

    def save_state(self, epoch: int, state, frozen_c, frozen_tau,
                   stop_epoch, gen, done: bool) -> None:
        if self.mesh.rank == 0:
            super().save_state(epoch, state, frozen_c, frozen_tau,
                               stop_epoch, gen, done)


class _SpmdCheckpointer:
    """The SPMD lane's checkpoint: :class:`_EngineCheckpointer`'s 10
    leaves with the per-rank ones stacked over the mesh's ranks (frames
    (W, C, v_pad), surplus (W, C, V+1), generator states (W, n)),
    gathered to the mesh's rank 0, which alone publishes them.  The
    aggregate, the taus and the frozen leaves are the same on every
    rank.  On resume, rank 0 picks the newest step that verifies and
    broadcasts its number (or that it failed, so that every rank
    raises); each rank then restores that step and takes its own row.
    A step of another world size is another schema (lane ``spmd<W>``)
    and raises ``CheckpointSchemaError``."""

    def __init__(self, checkpoint_dir: str, checkpoint_every: int,
                 schema: str, mesh: SamplerMesh, telemetry=None):
        from ..checkpoint.store import CheckpointManager
        self.root, self.schema, self.every = (checkpoint_dir, schema,
                                              checkpoint_every)
        self.mesh, self.telemetry = mesh, telemetry
        self.mgr = (CheckpointManager(checkpoint_dir, keep=3,
                                      save_every=checkpoint_every,
                                      schema=schema, telemetry=telemetry)
                    if mesh.rank == 0 else None)

    def _stack(self, x: torch.Tensor):
        """(W, *x.shape): every rank's ``x`` on rank 0; None elsewhere."""
        m = self.mesh
        t = x.to(m.comm_device)
        rows = ([torch.empty_like(t) for _ in range(m.size)]
                if m.rank == 0 else None)
        torch.distributed.gather(t, rows, dst=m.root, group=m.group)
        return None if rows is None else torch.stack(rows)

    def save_state(self, epoch: int, state, frozen_c, frozen_tau,
                   stop_epoch, gen, done: bool) -> None:
        if epoch % self.every:
            return
        agg_c, agg_t, fr_c, fr_t, sur_c, sur_t = state
        leaves = (agg_c, np.int64(agg_t), self._stack(fr_c), np.int64(fr_t),
                  self._stack(sur_c), np.int64(sur_t), frozen_c, frozen_tau,
                  stop_epoch, self._stack(gen.get_state()))
        if self.mgr is not None:
            self.mgr.maybe_save(epoch, leaves,
                                metadata={"epoch": epoch, "done": bool(done)})

    def restore_state(self, state, frozen_c, frozen_tau, stop_epoch, gen):
        """As :meth:`_EngineCheckpointer.restore_state`, each rank
        taking its own row of the stacked leaves."""
        from ..checkpoint.store import restore
        w, r = self.mesh.size, self.mesh.rank
        agg_c, agg_t, fr_c, fr_t, sur_c, sur_t = state
        g = gen.get_state()
        like = (agg_c, np.int64(0), fr_c.new_empty((w, *fr_c.shape)),
                np.int64(0), sur_c.new_empty((w, *sur_c.shape)), np.int64(0),
                frozen_c, frozen_tau, stop_epoch, g.new_empty((w, g.numel())))
        out, step = _agree_on_step(self.mesh, self.mgr, like, self.root,
                                   self.schema, "cpu")
        if step == -1:
            return state, frozen_c, frozen_tau, stop_epoch, 0
        if out is None:
            out = restore(self.root, like, step=step, device="cpu",
                          expect_schema=self.schema,
                          telemetry=self.telemetry)
        lv, _, meta = out
        gen.set_state(lv[9][r].clone())
        dev = self.mesh.device
        state = (lv[0].to(dev), int(lv[1]), lv[2][r].to(dev), int(lv[3]),
                 lv[4][r].to(dev), int(lv[5]))
        return (state, lv[6].to(dev), lv[7].numpy(), lv[8].numpy(),
                int(meta.get("epoch", step)))

    def wait(self) -> None:
        if self.mgr is not None:
            self.mgr.wait()


def _hook_failure_classes() -> tuple:
    """The exception classes a rank's failed hook is known to the other
    ranks by, the most specific first (any other: ``RuntimeError``)."""
    from ..checkpoint.store import (CheckpointError,
                                    CheckpointIntegrityError,
                                    CheckpointLayoutError,
                                    CheckpointSchemaError)
    return HOOK_FAILURES + (CheckpointSchemaError, CheckpointLayoutError,
                            CheckpointIntegrityError, CheckpointError)


def _agree_on_hook(mesh, epoch: int, failure) -> None:
    """The ranks of a process mesh (a :class:`SamplerMesh` or a
    :class:`GroupShardMesh`) agree on their hooks' outcome at ``epoch``
    with one all_reduce of two ints a rank (its failure's class, a
    :class:`DeviceLoss`'s survivors), so that no rank goes on into a
    collective the others left.  If any rank's hook raised, every rank
    raises: the failing ones their own exception, the others the same
    class (``RuntimeError`` for one the runtime does not know) naming the
    lowest failing rank."""
    size = mesh.size if isinstance(mesh, SamplerMesh) else mesh.n_shards
    classes = _hook_failure_classes()
    codes = [0] * (2 * size)
    if failure is not None:
        codes[mesh.rank] = 1 + next(
            (i for i, k in enumerate(classes) if isinstance(failure, k)),
            len(classes))
        codes[size + mesh.rank] = getattr(failure, "survivors", 0)
    got = allreduce_ints(codes, mesh).wait().tolist()
    failed = [r for r in range(size) if got[r]]
    if failure is not None:
        raise failure
    if not failed:
        return
    r = failed[0]
    cls = (classes + (RuntimeError,))[got[r] - 1]
    what = (cls.__name__ if cls is not RuntimeError
            else "an exception of a class the runtime does not know")
    msg = (f"rank {r} of the {type(mesh).__name__} raised {what} in its "
           f"on_epoch hook at epoch {epoch}")
    if cls is DeviceLoss:
        raise cls(got[size + r], msg)
    raise cls(msg)


def _run_hook(on_epoch, epoch: int, state, mesh, ckpt):
    """``ckpt.wait()`` (the pending publish lands, or its error is
    raised), then ``on_epoch(epoch, state)`` -> its replacement state or
    None; on a process mesh the ranks then agree on the outcome of both
    (:func:`_agree_on_hook`): only rank 0 publishes."""
    if not isinstance(mesh, (SamplerMesh, GroupShardMesh)):
        if ckpt is not None:
            ckpt.wait()
        return on_epoch(epoch, state)
    failure = replacement = None
    try:
        if ckpt is not None:
            ckpt.wait()
        replacement = on_epoch(epoch, state)
    except Exception as e:  # noqa: BLE001 - every rank must hear
        failure = e
    _agree_on_hook(mesh, epoch, failure)
    return replacement


def _resolve_lane(graph, mesh, device):
    """(graph on the run's device, mesh or None, device).  A
    PartitionedGraph needs a shard mesh with its shard count on its own
    device: a ShardMesh holding all its shards, or a GroupShardMesh the
    size of the partition's shard count, each rank holding its own
    shard; a plain Graph with a SamplerMesh of more than one rank is the
    SPMD lane, on the mesh's device (one rank: the single lane)."""
    if isinstance(mesh, SamplerMesh):
        if isinstance(graph, PartitionedGraph):
            raise TypeError("a SamplerMesh samples a replicated Graph; a "
                            "PartitionedGraph needs a ShardMesh or a "
                            "GroupShardMesh")
        if device is not None and canonical_device(device) != mesh.device:
            raise ValueError(f"device={device!r} differs from the mesh's "
                             f"{mesh.device}")
        return (graph.to(mesh.device), mesh if mesh.size > 1 else None,
                mesh.device)
    if isinstance(graph, PartitionedGraph):
        if mesh is None:
            raise ValueError(
                "a PartitionedGraph needs the mesh its shards map onto "
                "(mesh=ShardMesh(...) or GroupShardMesh(...)); use a plain "
                "Graph for the single-device lane")
        if not isinstance(mesh, SHARD_MESHES):
            raise TypeError(f"mesh must be a ShardMesh or a GroupShardMesh, "
                            f"got {type(mesh)}")
        if device is not None and canonical_device(device) != mesh.device:
            raise ValueError(f"device={device!r} differs from the mesh's "
                             f"{mesh.device}")
        mesh.check(graph)
        return graph, mesh, mesh.device
    if mesh is not None:
        raise TypeError(f"a replicated Graph takes a SamplerMesh, got "
                        f"{type(mesh)}")
    dev = resolve_device(DEFAULT_DEVICE if device is None else device)
    return graph.to(dev), None, dev


# ---------------------------------------------------------------------------
# The driver
# ---------------------------------------------------------------------------

def run_adaptive(graph, metrics=("betweenness",), *,
                 eps: Optional[float] = None, delta: Optional[float] = None,
                 seed: int = 0, config: Optional[AdaptiveConfig] = None,
                 stream: Optional[str] = None, device=None,
                 mesh=None, checkpoint_dir: Optional[str] = None,
                 checkpoint_every: int = 1, on_epoch=None,
                 telemetry=None) -> AdaptiveRunResult:
    """Adaptive sampling for the estimators named by ``metrics``.

    ``graph`` is a :class:`Graph`, moved to ``device`` (``None`` means
    ``"cuda"``, which raises without a card; pass ``device="cpu"`` for
    the CPU), or a :class:`PartitionedGraph` with
    ``mesh=ShardMesh(n_shards, device)`` or, called on every rank of a
    group with the rank's own shard
    (``partition_graph(graph, S, shard=rank)``),
    ``mesh=GroupShardMesh(device)``: the sharded lane, on the mesh's
    device, where the graph must already lie (``device``, if given, must
    name it); every rank returns the same result.  A :class:`Graph` with
    ``mesh=SamplerMesh(...)`` is the SPMD lane: every rank of the mesh
    calls the run with the same graph and arguments, on the mesh's
    device, and every rank returns the same result (module docstring).
    Explicit ``eps``/``delta`` override ``config``'s.  ``seed`` seeds
    the run's ``torch.Generator`` (on the SPMD lane, the diameter's; the
    ranks' own are derived from it).  ``stream`` is resolved by
    :func:`resolve_stream`.

    ``checkpoint_dir`` publishes the loop's state every
    ``checkpoint_every`` epochs (at least 1) and resumes from the newest
    step there that verifies: the result is bitwise the uninterrupted
    run's at the same seed.  A step of another metric set, lane or
    generator device raises ``CheckpointSchemaError``; on the SPMD lane
    the mesh's rank 0 writes the steps, and a step of another world size
    raises too; on a ``GroupShardMesh`` rank 0 writes them, and a step
    resumes on ``ShardMesh`` and ``GroupShardMesh`` alike at the same
    shard count (another count raises).  Resuming a completed run draws
    nothing and reports the same result.

    ``on_epoch(epoch, state)`` is the supervision hook
    (:class:`repro_torch.runtime.ResilientRunner`): called once an epoch
    with the 1-based epoch and the lane's 6-leaf state (aggregate counts,
    aggregate tau, frame counts, frame tau, surplus counts, surplus tau;
    the taus Python ints), after the pending checkpoint publish has
    landed and before the epoch is frozen into any metric's snapshot or
    saved.  A hook that raises aborts the run without the epoch reaching
    the disk (earlier epochs' publishes still land); one that returns a
    tuple replaces the state from there on.  On a ``SamplerMesh`` or a
    ``GroupShardMesh`` every rank must pass a hook (or none): each rank
    runs its own, then one all_reduce makes every rank raise if any
    rank's hook raised (the failing rank its own exception, the others
    the same class naming that rank; :func:`_agree_on_hook`).

    ``telemetry`` is None (nothing happens), a
    :class:`repro_torch.runtime.Telemetry`, a JSONL path or a sink
    (:func:`repro_torch.runtime.resolve_telemetry`).  On, the run emits
    ``run.start`` (lane ``single``, ``spmd`` or ``sharded``) and
    ``run.end``, one ``epoch.stats`` an epoch and, on the sharded lane,
    one ``exchange.epoch`` (the epoch's priced exchange tally), wraps
    phases 1 and 2, each epoch and the final flush in spans, and hands
    the bus to the checkpoint store.  It reads only host values the loop
    holds anyway: every lane gives the same bits and launches with it on
    as off.
    """
    from ..runtime.telemetry import resolve_telemetry
    telemetry = resolve_telemetry(telemetry)
    if int(checkpoint_every) < 1:
        raise ValueError(f"checkpoint_every must be >= 1, got "
                         f"{checkpoint_every}")
    cfg = config if config is not None else AdaptiveConfig()
    overrides = {k: v for k, v in (("eps", eps), ("delta", delta))
                 if v is not None}
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    estimators = resolve_estimators(metrics)
    stream = resolve_stream(estimators, stream, graph)
    graph, mesh, dev = _resolve_lane(graph, mesh, device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    offsets = _channel_offsets(estimators)
    n_est = len(estimators)

    spmd = isinstance(mesh, SamplerMesh)
    group = isinstance(mesh, GroupShardMesh)
    telemetry.emit("run.start", lane=("single" if mesh is None else "spmd"
                                      if spmd else "sharded"),
                   metrics=[e.name for e in estimators],
                   n_nodes=int(graph.n_nodes), eps=float(cfg.eps),
                   delta=float(cfg.delta))

    # ---- phase 1: diameter ---------------------------------------------
    with telemetry.span("phase.diameter"):
        if spmd:
            lane = _spmd_lane(graph, mesh, cfg, estimators, stream, gen,
                              offsets, seed)
        else:
            lane = _lane(graph, mesh, cfg, estimators, stream, gen, offsets)
    graph = lane.graph
    ctx = RunContext(graph.n_nodes, lane.vd, lane.dist_cap)
    bsz = resolve_sample_batch_size(cfg.sample_batch_size, ctx.n_nodes,
                                    ctx.vertex_diameter)
    xplan = (exchange_plan(graph, bsz) if isinstance(mesh, SHARD_MESHES)
             else None)
    bfs_levels, dag_rounds = lane.diam_levels, lane.diam_dag

    # ---- phase 2: calibration ------------------------------------------
    t0 = time.perf_counter()
    with telemetry.span("phase.calibration"):
        cal = lane.calibrate(bsz, ctx)
        bfs_levels += cal.n_levels
        dag_rounds += cal.n_dag_rounds
        params = tuple(
            est.make_params(graph, ctx, cfg.eps, cfg.delta,
                            cal.counts[off: off + est.n_channels], cal.tau)
            for est, off in zip(estimators, offsets))
        _sync(dev)
    t_cal = time.perf_counter() - t0

    # ---- phase 3: the adaptive loop --------------------------------------
    n0 = epoch_length(lane.n_samplers, base=cfg.n0_base,
                      exponent=cfg.n0_exponent)
    if spmd or group:
        # every rank must run the same loop: a rank-dependent bit here
        # would leave the others waiting in a collective
        same = {"vertex_diameter": ctx.vertex_diameter, "batch": bsz,
                "n0": n0, "calibration_tau": cal.tau,
                "distance_cap_bits": int(np.float64(
                    ctx.distance_cap).view(np.int64)),
                "params_crc32": _params_crc(params)}
        if group:
            same["exchange_budget"] = graph.exchange_budget
        assert_replicated(mesh, same)
    epoch_step = lane.make_epoch(params, ctx, n0, bsz)
    state = lane.init_state(ctx)
    # which metric owns each channel row (the frozen snapshot's row masks)
    row_metric = np.concatenate([np.full(e.n_channels, i)
                                 for i, e in enumerate(estimators)])
    frozen_c = torch.zeros_like(state[0])
    frozen_tau = np.zeros(n_est, dtype=np.int64)
    stop_epoch = np.full(n_est, -1, dtype=np.int64)
    epoch = 0
    ckpt = None
    if checkpoint_dir:
        lane_name = ("single" if mesh is None else f"spmd{mesh.size}"
                     if spmd else f"sharded{graph.n_shards}")
        schema = frame_schema_id(estimators, lane=lane_name,
                                 generator=lane.gen.device.type,
                                 stream=stream)
        ckpt_cls = (_SpmdCheckpointer if spmd else _GroupCheckpointer
                    if group else _EngineCheckpointer)
        ckpt = ckpt_cls(checkpoint_dir, int(checkpoint_every), schema,
                        mesh if spmd or group else dev,
                        telemetry=telemetry)
        state, frozen_c, frozen_tau, stop_epoch, epoch = ckpt.restore_state(
            state, frozen_c, frozen_tau, stop_epoch, lane.gen)
    stopped = stop_epoch >= 0

    def freeze(which, flushed):
        rows = torch.as_tensor(np.isin(row_metric, np.nonzero(which)[0]),
                               device=dev)
        return (torch.where(rows[:, None], flushed[0], frozen_c),
                np.where(which, flushed[1], frozen_tau),
                np.where(which, epoch, stop_epoch))

    stats = []
    last_flush = None
    t0 = time.perf_counter()
    try:
        while not stopped.all() and epoch < cfg.max_epochs:
            with telemetry.span("phase.epoch", epoch=epoch + 1):
                te = time.perf_counter()
                state, (done, mf, mg), fold, timing = epoch_step(state)
                bfs_levels += fold.n_levels
                dag_rounds += fold.n_dag_rounds
                xch = fold.exchange
                epoch += 1
                if on_epoch is not None:
                    # the hook sees a settled disk (and a publish error
                    # surfaces here), and runs before the freeze and the
                    # save, so that a refused epoch reaches neither
                    replacement = _run_hook(on_epoch, epoch, state, mesh,
                                            ckpt)
                    if replacement is not None:
                        state = tuple(replacement)
                newly = done & ~stopped
                if newly.any():
                    # freeze each newly stopped metric at this epoch's
                    # flush: f/g are not monotone, so a later snapshot
                    # would not reproduce the decision
                    last_flush = lane.flush(state)
                    frozen_c, frozen_tau, stop_epoch = freeze(newly,
                                                              last_flush)
                    stopped |= newly
                xacct = None
                if xch is not None:
                    xch = xch.tolist()
                    xacct = xplan.epoch_accounting(xch[0], xch[1])
                stats.append(EngineEpochStats(
                    epoch, int(state[1]), tuple(float(x) for x in mf),
                    tuple(float(x) for x in mg), time.perf_counter() - te,
                    int(state[3]) * lane.n_samplers, xacct, timing))
                if telemetry:
                    st = stats[-1]
                    telemetry.emit("epoch.stats", epoch=epoch, tau=st.tau,
                                   samples=st.samples, seconds=st.seconds,
                                   max_f=list(st.max_f),
                                   max_g=list(st.max_g))
                    if xacct is not None:
                        telemetry.emit("exchange.epoch", epoch=epoch,
                                       **xacct)
                if ckpt is not None:
                    ckpt.save_state(epoch, state, frozen_c, frozen_tau,
                                    stop_epoch, lane.gen,
                                    done=bool(stopped.all()))
    finally:
        # earlier good epochs land even when the loop raises, and a
        # publish error surfaces here
        if ckpt is not None:
            ckpt.wait()
    converged = stopped.copy()
    if not stopped.all():
        # max_epochs reached: freeze what never converged (not written to
        # the checkpoint, so a resume with a higher max_epochs samples on)
        with telemetry.span("phase.flush"):
            last_flush = lane.flush(state)
        frozen_c, frozen_tau, stop_epoch = freeze(~stopped, last_flush)
    _sync(dev)
    t_samp = time.perf_counter() - t0

    reports = tuple(
        MetricReport(name=est.name,
                     scores=est.finalize(frozen_c[off: off + est.n_channels],
                                         int(frozen_tau[i]), p, ctx),
                     tau=int(frozen_tau[i]), converged=bool(converged[i]),
                     omega=float(getattr(p, "omega", np.nan)),
                     stop_epoch=int(stop_epoch[i]),
                     extras=est.extras(p, ctx))
        for i, (est, off, p) in enumerate(zip(estimators, offsets, params)))
    # a resumed completed run draws nothing: its tau is the frozen one
    tau_total = (int(last_flush[1]) if last_flush is not None
                 else int(frozen_tau.max(initial=0)))
    telemetry.emit("run.end", tau=tau_total, n_epochs=epoch,
                   converged=bool(converged.all()))
    return AdaptiveRunResult(
        reports, tau_total, epoch, bool(converged.all()),
        ctx.vertex_diameter, stats,
        {"diameter": lane.t_diam, "calibration": t_cal,
         "sampling": t_samp}, bfs_levels, dag_rounds, ctx.distance_cap)


def run_fixed(graph, n_samples: int, *, metrics=("betweenness",),
              seed: int = 0, batch_size: Optional[int] = None,
              stream: Optional[str] = None, device=None,
              mesh=None) -> tuple:
    """Non-adaptive baseline: exactly ``n_samples`` samples of one shared
    draw stream, folded through every requested metric, with no stop
    rule.  Returns a :class:`MetricReport` per metric in ``metrics``
    order, with ``converged=False`` (no guarantee attaches to a fixed
    run), ``omega`` NaN and ``stop_epoch`` 0.

    ``batch_size=None`` takes ``DEFAULT_SAMPLE_BATCH_SIZE``.  The
    diameter is swept only when a metric normalizes by it (closeness;
    on the weighted stream the weighted sweep, whose bound is the
    distance cap), and always on a :class:`PartitionedGraph` (with
    ``mesh=`` a ``ShardMesh`` or, on every rank, a ``GroupShardMesh``,
    as in :func:`run_adaptive`), where it also resolves an ``"auto"``
    budget.
    With ``mesh=SamplerMesh(...)`` (W ranks) each rank draws ``ceil(n /
    W)`` samples from its own generator and one all_reduce sums them:
    ``tau`` is ``W * ceil(n / W)``, the same on every rank.
    """
    estimators = resolve_estimators(metrics)
    stream = resolve_stream(estimators, stream, graph)
    graph, mesh, dev = _resolve_lane(graph, mesh, device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    needs_vd = stream in ("forward", "weighted") and any(
        e.needs_diameter for e in estimators)
    vd, cap = 0, 0.0
    sharded = isinstance(mesh, SHARD_MESHES)
    if sharded or needs_vd:
        vd, cap, _, _, graph = _phase_one(graph, mesh if sharded else None,
                                          gen, 2, stream)
    ctx = RunContext(graph.n_nodes, vd if needs_vd else 0,
                     cap if needs_vd else 0.0)
    bsz = DEFAULT_SAMPLE_BATCH_SIZE if batch_size is None else batch_size
    if isinstance(mesh, SamplerMesh):
        fold = draw_fold(graph, sampler_generator(seed, mesh.rank, dev),
                         -(-n_samples // mesh.size), estimators=estimators,
                         ctx=ctx, stream=stream, batch_size=bsz)
        counts = flat_allreduce(fold.counts, mesh).wait()
        tau = int(allreduce_ints([fold.tau], mesh).wait()[0])
    else:
        fold = draw_fold(graph, gen, n_samples, estimators=estimators,
                         ctx=ctx, stream=stream, batch_size=bsz, mesh=mesh)
        counts, tau = fold.counts, fold.tau
    reports = []
    for est, off in zip(estimators, _channel_offsets(estimators)):
        sl = counts[off: off + est.n_channels]
        reports.append(MetricReport(
            name=est.name, scores=est.finalize(sl, tau, None, ctx),
            tau=tau, converged=False, omega=float("nan"), stop_epoch=0,
            extras=est.extras(None, ctx)))
    return tuple(reports)
