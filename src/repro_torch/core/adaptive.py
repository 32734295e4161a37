"""``run_kadabra``: the paper's KADABRA on one device, on the independent
samplers of a :class:`SamplerMesh`, or cooperatively over the shards of
a :class:`PartitionedGraph` on one device or one shard a process
(``repro.core.adaptive``), a thin mapping of
the engine's result onto :class:`BetweennessResult`; and
``run_fixed_sampling``, its fixed-count baseline."""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np

from .engine import (AdaptiveConfig, AdaptiveRunResult, run_adaptive,
                     run_fixed)

__all__ = ["BetweennessResult", "EpochStats", "run_fixed_sampling",
           "run_kadabra"]


class EpochStats(NamedTuple):
    epoch: int
    tau: int
    max_f: float
    max_g: float
    seconds: float
    exchange: Optional[dict] = None   # sharded lane: the priced exchange
    # SPMD lane: this rank's draw and wait seconds and staged bytes
    aggregation: Optional[dict] = None


class BetweennessResult(NamedTuple):
    btilde: np.ndarray    # (V,) approximate normalized betweenness
    tau: int              # total samples
    n_epochs: int
    converged: bool
    omega: float
    vertex_diameter: int
    stats: list           # list[EpochStats]
    phase_seconds: dict   # diameter / calibration / sampling
    bfs_levels: int       # frontier expansions of the whole run


def run_kadabra(graph, *, eps: Optional[float] = None,
                delta: Optional[float] = None, seed: int = 0,
                config: Optional[AdaptiveConfig] = None,
                device=None, mesh=None,
                checkpoint_dir: Optional[str] = None,
                checkpoint_every: int = 1, on_epoch=None,
                telemetry=None) -> BetweennessResult:
    """Approximate betweenness with adaptive sampling (KADABRA): the
    betweenness estimator on the bidirectional stream.

    Explicit ``eps``/``delta`` override ``config``'s (defaults 0.01 /
    0.1).  ``device`` defaults to ``"cuda"`` and raises without a card
    unless ``device="cpu"`` is passed.  A :class:`PartitionedGraph` runs
    the sharded lane with ``mesh=ShardMesh(n_shards, device)``, on the
    mesh's device, or, called on every rank of a group with the rank's
    own shard (``partition_graph(graph, S, shard=rank)``), with
    ``mesh=GroupShardMesh(device)``: one vertex shard a process, whose
    ranks meet only in the mesh's collectives and all return the same
    result.  A :class:`Graph` with ``mesh=SamplerMesh(...)`` runs the
    SPMD lane, called on every rank (``config.aggregation`` picks the
    aggregation).  ``checkpoint_dir`` and ``checkpoint_every`` make the
    run resumable, and ``on_epoch`` and ``telemetry`` supervise and
    observe it, as in :func:`run_adaptive`.
    """
    res: AdaptiveRunResult = run_adaptive(
        graph, ("betweenness",), eps=eps, delta=delta, seed=seed,
        config=config, stream="bidir", device=device, mesh=mesh,
        checkpoint_dir=checkpoint_dir, checkpoint_every=checkpoint_every,
        on_epoch=on_epoch, telemetry=telemetry)
    rep = res.reports[0]
    stats = [EpochStats(s.epoch, s.tau, s.max_f[0], s.max_g[0], s.seconds,
                        s.exchange, s.aggregation) for s in res.stats]
    return BetweennessResult(rep.scores, rep.tau, res.n_epochs,
                             rep.converged, rep.omega, res.vertex_diameter,
                             stats, res.phase_seconds, res.bfs_levels)


def run_fixed_sampling(graph, n_samples: int, *, seed: int = 0,
                       batch_size: Optional[int] = None,
                       device=None, mesh=None) -> np.ndarray:
    """Non-adaptive baseline (a fixed sample count, no stop rule): the
    betweenness estimates of :func:`run_fixed` on the bidirectional
    stream."""
    reports = run_fixed(graph, n_samples, metrics=("betweenness",),
                        seed=seed, batch_size=batch_size, device=device,
                        mesh=mesh)
    return reports[0].scores
