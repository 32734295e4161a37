"""Betweenness centrality as an estimator plugin (KADABRA)
(``repro.core.estimators.kadabra``)."""
from __future__ import annotations

import numpy as np
import torch

from ...kernels.stopcheck.ops import get_stop_rule
from ..kadabra import KadabraParams, calibrate_deltas, compute_omega
from .base import DrawBatch, Estimator, RunContext

__all__ = ["BetweennessEstimator"]


class BetweennessEstimator(Estimator):
    """One ``path_counts`` channel: the observation of vertex x in one
    sample is the indicator that x is internal to the drawn path."""

    name = "betweenness"
    channels = ("path_counts",)
    needs_forward = False
    stop_rule = "bernstein"

    def make_params(self, graph, ctx: RunContext, eps: float, delta: float,
                    calib_counts, calib_tau):
        btilde0 = calib_counts[0][: ctx.n_nodes] / max(float(calib_tau), 1.0)
        omega = compute_omega(ctx.vertex_diameter, eps, delta,
                              device=btilde0.device)
        lil, liu, _tau_star = calibrate_deltas(btilde0, eps, delta, omega)
        return KadabraParams(eps, delta, omega, lil, liu)

    def accumulate(self, batch: DrawBatch, keep, ctx: RunContext):
        ids = batch.internal[keep[:, None] & (batch.internal >= 0)]
        counts = torch.zeros(ctx.n_nodes + 1, dtype=torch.float32,
                             device=ids.device)
        counts.index_add_(0, ids, torch.ones(ids.shape, dtype=torch.float32,
                                             device=ids.device))
        return counts[None, :]

    def stopping_rule(self, counts, tau, params, ctx: RunContext):
        return get_stop_rule(self.stop_rule)(counts[0][: ctx.n_nodes], tau,
                                             params)

    def finalize(self, counts, tau, params, ctx: RunContext) -> np.ndarray:
        return counts[0][: ctx.n_nodes].cpu().numpy() / max(int(tau), 1)
