"""Harmonic centrality as an estimator plugin
(``repro.core.estimators.harmonic``).

The sampled-sources scheme of closeness on the same forward stream, with
the reciprocal distance as the observation:

    x_v(s) = 1 / max(d(s, v), 1)   (reached, d > 0)
           = 0                     (unreached, v == s, and the sink row)

already in [0, 1] with no cap, and 0 for unreachable pairs.  The
max(d, 1) floor is a no-op on hop distances; on the weighted stream it
clamps d < 1 (the truncated-harmonic convention).  ``finalize`` reports
the normalized harmonic centrality h(v) = 1/(n-1) sum_{u != v} 1/d(u, v),
the sample mean times n/(n-1).
"""
from __future__ import annotations

import numpy as np
import torch

from .base import DrawBatch, RunContext
from .closeness import DistanceEstimator

__all__ = ["HarmonicEstimator"]


class HarmonicEstimator(DistanceEstimator):
    name = "harmonic"
    channels = ("inv_dist_sum",)
    needs_diameter = False

    def _obs(self, batch: DrawBatch, ctx: RunContext):
        d = self._dist(batch, ctx)
        x = torch.where(d > 0.0, 1.0 / torch.clamp(d, min=1.0), 0.0)
        x[ctx.n_nodes] = 0.0                          # the sink row
        return x[None]

    def finalize(self, counts, tau, params, ctx: RunContext) -> np.ndarray:
        n = ctx.n_nodes
        mean = counts[0][:n].cpu().numpy() / max(int(tau), 1)
        return mean * n / max(n - 1, 1)

    def extras(self, params, ctx: RunContext) -> dict:
        return {"normalized": True,
                "scale_note": "scores are 1/(n-1) * sum 1/d; multiply by "
                              "(n-1) for the unnormalized convention"}
