"""``run_kadabra``: the paper's KADABRA on one device
(``repro.core.adaptive``), a thin mapping of the engine's result onto
:class:`BetweennessResult`."""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np

from ..device import DEFAULT_DEVICE
from .engine import AdaptiveConfig, AdaptiveRunResult, run_adaptive

__all__ = ["BetweennessResult", "EpochStats", "run_kadabra"]


class EpochStats(NamedTuple):
    epoch: int
    tau: int
    max_f: float
    max_g: float
    seconds: float


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
                device=DEFAULT_DEVICE) -> BetweennessResult:
    """Approximate betweenness with adaptive sampling (KADABRA): the
    betweenness estimator on the bidirectional stream.

    Explicit ``eps``/``delta`` override ``config``'s (defaults 0.01 /
    0.1).  ``device`` defaults to ``"cuda"`` and raises without a card
    unless ``device="cpu"`` is passed.
    """
    res: AdaptiveRunResult = run_adaptive(
        graph, ("betweenness",), eps=eps, delta=delta, seed=seed,
        config=config, stream="bidir", device=device)
    rep = res.reports[0]
    stats = [EpochStats(s.epoch, s.tau, s.max_f[0], s.max_g[0], s.seconds)
             for s in res.stats]
    return BetweennessResult(rep.scores, rep.tau, res.n_epochs,
                             rep.converged, rep.omega, res.vertex_diameter,
                             stats, res.phase_seconds, res.bfs_levels)
