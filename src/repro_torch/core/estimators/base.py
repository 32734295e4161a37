"""The estimator-plugin protocol of the adaptive engine
(``repro.core.estimators.base``).

An adaptive sampling algorithm is a draw (one BFS-backed sample), an
accumulate (fold the draw into a per-vertex state frame), a stopping
rule (read a consistent aggregated frame) and a finalize (frame to
scores).  The engine owns everything else; an estimator contributes its
frame channels and the four hooks.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

__all__ = ["DrawBatch", "Estimator", "MetricReport", "RunContext"]


class RunContext(NamedTuple):
    """Per-run facts every hook may read.  ``distance_cap`` is nonzero
    only on the weighted stream (ROADMAP §1 item 13): a bound on the
    weighted distances, which closeness then normalizes by in place of
    the vertex diameter."""
    n_nodes: int
    vertex_diameter: int
    distance_cap: float = 0.0


class DrawBatch(NamedTuple):
    """One round of B shared draws, as every accumulator sees it.

    The port carries the drawn paths as vertex lists (``internal``, -1
    padded) where the JAX package carries a dense (B, V+1) indicator
    matrix; a fold over one equals a fold over the other.

    The bidirectional stream carries no ``dist``: each side's search
    stops at the meeting level, so it has no unbiased per-source
    distances.  The forward stream runs each source's search to
    exhaustion and carries its distance columns and sources, which
    closeness and harmonic read.
    """
    internal: torch.Tensor  # (B, L) int64 internal path vertices
    valid: torch.Tensor     # (B,) bool
    length: torch.Tensor    # (B,) int32, -1 if invalid
    dist: Optional[torch.Tensor] = None     # (rows >= V+1, B) int32
    sources: Optional[torch.Tensor] = None  # (B,) int32


class MetricReport(NamedTuple):
    """Per-metric result of an adaptive run."""
    name: str
    scores: np.ndarray   # (V,) final estimates
    tau: int             # samples in the deciding snapshot
    converged: bool      # its own stopping rule fired (vs max_epochs)
    omega: float         # its static sample cap
    stop_epoch: int      # epoch whose snapshot produced ``scores``
    extras: dict


class Estimator:
    """Base class: subclasses set the class attributes and the hooks."""

    name: str = "?"
    channels: tuple = ()
    needs_forward: bool = False   # requires the forward (full-SSSP) stream
    needs_diameter: bool = False  # accumulate reads ctx.vertex_diameter
    stop_rule: str = "bernstein"  # registered in kernels.stopcheck.ops

    @property
    def n_channels(self) -> int:
        return len(self.channels)

    def make_params(self, graph, ctx: RunContext, eps: float, delta: float,
                    calib_counts, calib_tau):
        """Stopping-rule parameters from the calibration frame
        (``calib_counts`` is this estimator's (C, V+1) slice)."""
        raise NotImplementedError

    def accumulate(self, batch: DrawBatch, keep, ctx: RunContext):
        """Fold the samples with ``keep`` True into a (C, V+1)
        increment; the others contribute exactly zero."""
        raise NotImplementedError

    def stopping_rule(self, counts, tau, params, ctx: RunContext):
        """(done, max_f, max_g) from this estimator's (C, V+1) slice of
        the aggregated frame."""
        raise NotImplementedError

    def finalize(self, counts, tau, params, ctx: RunContext) -> np.ndarray:
        """Scores (V,) from the deciding snapshot."""
        raise NotImplementedError

    def extras(self, params, ctx: RunContext) -> dict:
        return {}
