"""The adaptive sampling engine, single-device lane
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
the JAX ``lax.scan`` over rounds is a Python loop here.

Not in this slice (each raises ``NotImplementedError`` naming the
ROADMAP §1 item that adds it): the forward and weighted streams with
closeness and harmonic (items 9 and 13), checkpointing (10), meshes
(11, 12), and the supervision hook and telemetry (14).
"""
from __future__ import annotations

import dataclasses
import time
from types import SimpleNamespace
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve_device
from .diameter import estimate_diameter
from .epoch import epoch_length
from .estimators import get_estimator
from .estimators.base import DrawBatch, Estimator, MetricReport, RunContext
from .graph import Graph
from .sampler import sample_path_batched

__all__ = ["DEFAULT_SAMPLE_BATCH_SIZE", "AdaptiveConfig",
           "AdaptiveRunResult", "EngineEpochStats", "FoldResult",
           "draw_fold", "resolve_estimators", "resolve_sample_batch_size",
           "resolve_stream", "run_adaptive"]

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


class AdaptiveRunResult(NamedTuple):
    reports: tuple        # MetricReport per estimator, metrics order
    tau: int              # samples in the final flush
    n_epochs: int
    converged: bool       # every metric's own rule fired
    vertex_diameter: int
    stats: list           # list[EngineEpochStats]
    phase_seconds: dict   # diameter / calibration / sampling
    bfs_levels: int       # frontier expansions of the whole run


_FORWARD_METRICS = {"closeness": 9, "harmonic": 9}


def resolve_estimators(metrics) -> tuple:
    """Metric names (or Estimator instances) -> tuple of plugins."""
    if isinstance(metrics, (str, Estimator)):
        metrics = (metrics,)
    ests = []
    for m in metrics:
        if isinstance(m, Estimator):
            ests.append(m)
        elif m in _FORWARD_METRICS:
            raise NotImplementedError(
                f"metric {m!r} needs the forward stream, not ported yet "
                f"(ROADMAP §1 item {_FORWARD_METRICS[m]})")
        else:
            ests.append(get_estimator(m))
    if not ests:
        raise ValueError("metrics must name at least one estimator")
    names = [e.name for e in ests]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate metrics {names}")
    return tuple(ests)


def resolve_stream(estimators, stream: Optional[str] = None) -> str:
    """Only the bidirectional stream is ported in this slice."""
    if stream in (None, "bidir"):
        need_fwd = [e.name for e in estimators if e.needs_forward]
        if need_fwd:
            raise NotImplementedError(
                f"estimators {need_fwd} need the forward stream "
                "(ROADMAP §1 item 9)")
        return "bidir"
    if stream == "forward":
        raise NotImplementedError("stream='forward' is ROADMAP §1 item 9")
    if stream == "weighted":
        raise NotImplementedError("stream='weighted' is ROADMAP §1 item 13")
    raise ValueError(f"unknown stream {stream!r} (expected 'bidir', "
                     "'forward' or 'weighted')")


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
    n_levels: int             # BFS levels the rounds expanded


def draw_fold(graph: Graph, gen: torch.Generator, n_samples: int, *,
              estimators, ctx: RunContext, batch_size: int = 1,
              carry=None) -> FoldResult:
    """Take exactly ``n_samples`` new samples in rounds of ``batch_size``
    and fold them through every estimator's ``accumulate``.

    When ``batch_size`` does not divide ``n_samples``, the surplus
    samples of the last round (valid i.i.d. draws) are folded into a
    separate frame, which the engine carries into the next epoch.
    ``carry`` ((C, V+1) counts, tau) is added to the returned frame.
    """
    batch_size = max(1, min(int(batch_size), int(n_samples)))
    rounds = -(-n_samples // batch_size)
    dev = graph.device
    n_ch = sum(e.n_channels for e in estimators)
    counts = torch.zeros((n_ch, ctx.n_nodes + 1), dtype=torch.float32,
                         device=dev)
    sur_counts = torch.zeros_like(counts)
    tau = 0
    if carry is not None:
        counts = counts + carry[0]
        tau = int(carry[1])
    n_levels = 0
    for r in range(rounds):
        ps = sample_path_batched(graph, gen, batch_size)
        n_levels += ps.n_levels
        batch = DrawBatch(ps.internal, ps.valid, ps.length)
        n_keep = min(batch_size, n_samples - r * batch_size)
        keep = torch.arange(batch_size, device=dev) < n_keep
        counts = counts + torch.cat(
            [e.accumulate(batch, keep, ctx) for e in estimators])
        tau += n_keep
        if n_keep < batch_size:
            sur_counts = sur_counts + torch.cat(
                [e.accumulate(batch, ~keep, ctx) for e in estimators])
    return FoldResult(counts, tau, sur_counts,
                      rounds * batch_size - n_samples, n_levels)


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


def _single_lane(graph: Graph, cfg: AdaptiveConfig, estimators, gen,
                 offsets):
    """Phase 1 and the per-epoch pieces of the single-device lane."""
    ns = SimpleNamespace()
    dev = graph.device
    t0 = time.perf_counter()
    diam = estimate_diameter(graph, gen, n_sweeps=cfg.diameter_sweeps)
    _sync(dev)
    ns.vd, ns.diam_levels = int(diam.vertex_diameter), diam.n_levels
    ns.t_diam = time.perf_counter() - t0

    def calibrate(bsz, ctx):
        return draw_fold(graph, gen, cfg.calib_samples_per_device,
                         estimators=estimators, ctx=ctx, batch_size=bsz)

    def make_epoch(params, ctx, n0, bsz):
        def epoch_step(state):
            agg_c, agg_t, fr_c, fr_t, sur_c, sur_t = state
            agg_c = agg_c + fr_c
            agg_t = agg_t + fr_t
            fold = draw_fold(graph, gen, n0, estimators=estimators,
                             ctx=ctx, batch_size=bsz, carry=(sur_c, sur_t))
            checks = _check_all(estimators, offsets, agg_c, agg_t, params,
                                ctx)
            return ((agg_c, agg_t, fold.counts, fold.tau, fold.sur_counts,
                     fold.sur_tau), checks, fold.n_levels)
        return epoch_step

    def flush(state):
        agg_c, agg_t, fr_c, fr_t, sur_c, sur_t = state
        return (agg_c + fr_c) + sur_c, agg_t + fr_t + sur_t

    def init_state(ctx):
        z = torch.zeros((sum(e.n_channels for e in estimators),
                         ctx.n_nodes + 1), dtype=torch.float32, device=dev)
        return (z, 0, z, 0, z, 0)

    ns.calibrate, ns.make_epoch = calibrate, make_epoch
    ns.flush, ns.init_state = flush, init_state
    return ns


# ---------------------------------------------------------------------------
# The driver
# ---------------------------------------------------------------------------

def run_adaptive(graph: Graph, metrics=("betweenness",), *,
                 eps: Optional[float] = None, delta: Optional[float] = None,
                 seed: int = 0, config: Optional[AdaptiveConfig] = None,
                 stream: Optional[str] = None, device=DEFAULT_DEVICE,
                 mesh=None, checkpoint_dir: Optional[str] = None,
                 on_epoch=None, telemetry=None) -> AdaptiveRunResult:
    """Adaptive sampling for the estimators named by ``metrics`` on one
    device.

    ``graph`` is moved to ``device`` (default ``"cuda"``; raises without
    a card unless ``device="cpu"``).  Explicit ``eps``/``delta`` override
    ``config``'s.  ``seed`` seeds the run's one ``torch.Generator``.
    """
    for value, item in ((mesh, "items 11-12 (SPMD and sharded lanes)"),
                        (checkpoint_dir, "item 10 (checkpointing)"),
                        (on_epoch, "item 14 (runtime)"),
                        (telemetry, "item 14 (runtime)")):
        if value is not None:
            raise NotImplementedError(
                f"this argument is not ported yet: ROADMAP §1 {item}")
    cfg = config if config is not None else AdaptiveConfig()
    overrides = {k: v for k, v in (("eps", eps), ("delta", delta))
                 if v is not None}
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    dev = resolve_device(device)
    graph = graph.to(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    estimators = resolve_estimators(metrics)
    resolve_stream(estimators, stream)
    offsets = _channel_offsets(estimators)
    n_est = len(estimators)

    # ---- phase 1: diameter ---------------------------------------------
    lane = _single_lane(graph, cfg, estimators, gen, offsets)
    ctx = RunContext(graph.n_nodes, lane.vd)
    bsz = resolve_sample_batch_size(cfg.sample_batch_size, ctx.n_nodes,
                                    ctx.vertex_diameter)
    bfs_levels = lane.diam_levels

    # ---- phase 2: calibration ------------------------------------------
    t0 = time.perf_counter()
    cal = lane.calibrate(bsz, ctx)
    bfs_levels += cal.n_levels
    params = tuple(
        est.make_params(graph, ctx, cfg.eps, cfg.delta,
                        cal.counts[off: off + est.n_channels], cal.tau)
        for est, off in zip(estimators, offsets))
    _sync(dev)
    t_cal = time.perf_counter() - t0

    # ---- phase 3: the adaptive loop --------------------------------------
    n0 = epoch_length(1, base=cfg.n0_base, exponent=cfg.n0_exponent)
    epoch_step = lane.make_epoch(params, ctx, n0, bsz)
    state = lane.init_state(ctx)
    frozen = [None] * n_est          # (counts slice, tau) per estimator
    stop_epoch = [-1] * n_est
    stopped = np.zeros(n_est, dtype=bool)
    stats = []
    last_flush = None
    epoch = 0
    t0 = time.perf_counter()
    while not stopped.all() and epoch < cfg.max_epochs:
        te = time.perf_counter()
        state, (done, mf, mg), n_levels = epoch_step(state)
        bfs_levels += n_levels
        epoch += 1
        newly = done & ~stopped
        if newly.any():
            # freeze each newly stopped metric at this epoch's flush: f/g
            # are not monotone, so a later snapshot would not reproduce
            # the decision
            last_flush = lane.flush(state)
            for i in np.nonzero(newly)[0]:
                off = offsets[i]
                frozen[i] = (last_flush[0][off: off + estimators[i]
                                           .n_channels], last_flush[1])
                stop_epoch[i] = epoch
            stopped |= newly
        stats.append(EngineEpochStats(
            epoch, int(state[1]), tuple(float(x) for x in mf),
            tuple(float(x) for x in mg), time.perf_counter() - te,
            int(state[3])))
    converged = stopped.copy()
    if not stopped.all():
        # max_epochs reached: freeze what never converged
        last_flush = lane.flush(state)
        for i in np.nonzero(~stopped)[0]:
            off = offsets[i]
            frozen[i] = (last_flush[0][off: off + estimators[i].n_channels],
                         last_flush[1])
            stop_epoch[i] = epoch
    _sync(dev)
    t_samp = time.perf_counter() - t0

    reports = tuple(
        MetricReport(name=est.name,
                     scores=est.finalize(frozen[i][0], frozen[i][1], p, ctx),
                     tau=int(frozen[i][1]), converged=bool(converged[i]),
                     omega=float(getattr(p, "omega", np.nan)),
                     stop_epoch=stop_epoch[i], extras=est.extras(p, ctx))
        for i, (est, p) in enumerate(zip(estimators, params)))
    return AdaptiveRunResult(
        reports, int(last_flush[1]), epoch, bool(converged.all()),
        ctx.vertex_diameter, stats,
        {"diameter": lane.t_diam, "calibration": t_cal,
         "sampling": t_samp}, bfs_levels)
