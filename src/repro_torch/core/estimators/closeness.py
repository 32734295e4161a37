"""Closeness centrality as an estimator plugin
(``repro.core.estimators.closeness``).

Sample uniform sources s, read the full distance column of the forward
stream's search from s, and estimate each vertex's farness as the mean
of its distance from the drawn sources.  The observation is normalized
into [0, 1] by ``cap``, the phase-1 vertex-diameter bound (or the
weighted stream's distance bound):

    x_v(s) = min(d(s, v), cap) / cap      (reached)
           = 1                            (unreached: the cap penalty)
           = 0                            (v == s, and the sink row)

so the shared Bernstein stop rule applies unchanged: its bounds use only
that observations lie in [0, 1].  ``finalize`` de-normalizes,

    farness(v) ~= mean_v * cap * n / (n - 1),   closeness(v) = 1 / farness(v)

(the n/(n-1) corrects for the s == v draws, which observe 0).  A second
channel counts the sources that reached each vertex.
"""
from __future__ import annotations

import numpy as np
import torch

from ...kernels.stopcheck.ops import get_stop_rule
from ..kadabra import KadabraParams, calibrate_deltas
from .base import DrawBatch, Estimator, RunContext

__all__ = ["ClosenessEstimator", "DistanceEstimator", "hoeffding_omega"]


def hoeffding_omega(n_nodes: int, eps: float, delta: float, c: float = 0.5,
                    *, device=None):
    """Static sample cap for the means of n [0, 1] observables: Hoeffding
    and a union bound over the vertices, omega = c/eps^2 * ln(2n/delta),
    as a () float32 tensor."""
    n = torch.clamp(torch.as_tensor(n_nodes, dtype=torch.float32,
                                    device=device), min=2.0)
    return (c / (eps * eps)) * torch.log(2.0 * n / delta)


class DistanceEstimator(Estimator):
    """Shared base of the plugins that read distance columns: forward
    stream only, the Hoeffding omega and the calibration waterfilling
    over channel 0; subclasses give the observation ``_obs``."""

    needs_forward = True
    stop_rule = "bernstein"

    def _obs(self, batch: DrawBatch, ctx: RunContext):
        """(C, V+1, B) float32 observations of one round."""
        raise NotImplementedError

    def _dist(self, batch: DrawBatch, ctx: RunContext):
        """(V+1, B) float32 distance columns, cut to the logical rows."""
        if batch.dist is None:
            raise ValueError(
                f"estimator {self.name!r} needs the forward stream; the "
                "bidirectional stream carries no per-source distances")
        return batch.dist[: ctx.n_nodes + 1].float()

    def make_params(self, graph, ctx: RunContext, eps: float, delta: float,
                    calib_counts, calib_tau):
        btilde0 = calib_counts[0][: ctx.n_nodes] / max(float(calib_tau), 1.0)
        omega = hoeffding_omega(ctx.n_nodes, eps, delta,
                                device=btilde0.device)
        lil, liu, _tau_star = calibrate_deltas(btilde0, eps, delta, omega)
        return KadabraParams(eps, delta, omega, lil, liu)

    def accumulate(self, batch: DrawBatch, keep, ctx: RunContext):
        obs = self._obs(batch, ctx)
        return (obs * keep.float()[None, None, :]).sum(dim=2)

    def stopping_rule(self, counts, tau, params, ctx: RunContext):
        return get_stop_rule(self.stop_rule)(counts[0][: ctx.n_nodes], tau,
                                             params)


class ClosenessEstimator(DistanceEstimator):
    name = "closeness"
    channels = ("dist_sum", "reached")
    needs_diameter = True   # the [0, 1] normalization cap

    def _cap(self, ctx: RunContext) -> float:
        if ctx.distance_cap > 0.0:
            return float(np.float32(ctx.distance_cap))
        return float(max(int(ctx.vertex_diameter), 1))

    def _obs(self, batch: DrawBatch, ctx: RunContext):
        d = self._dist(batch, ctx)
        # a device scalar, so the division is a true one on the card too
        cap = torch.full((), self._cap(ctx), dtype=torch.float32,
                         device=d.device)
        x = torch.where(d < 0.0, 1.0, torch.clamp(d / cap, 0.0, 1.0))
        reached = (d >= 0.0).float()
        obs = torch.stack([x, reached])
        obs[:, ctx.n_nodes] = 0.0                     # the sink row
        return obs

    def finalize(self, counts, tau, params, ctx: RunContext) -> np.ndarray:
        n = ctx.n_nodes
        mean = counts[0][:n].cpu().numpy() / max(int(tau), 1)
        farness = mean * self._cap(ctx) * n / max(n - 1, 1)
        return np.where(farness > 0.0, 1.0 / np.maximum(farness, 1e-30),
                        0.0)

    def extras(self, params, ctx: RunContext) -> dict:
        return {"distance_cap": self._cap(ctx),
                "scale_note": "eps/delta hold on the cap-normalized "
                              "farness scale"}
