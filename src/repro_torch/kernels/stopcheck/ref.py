"""Plain PyTorch version of the fused stop check
(``repro.kernels.stopcheck.ref``).

Contract: from the aggregated counts (V,), tau, omega and the per-vertex
budgets ln(1/delta_L), ln(1/delta_U), produce

    out = [max_x f(x), max_x g(x)]        (2,) float32

with f and g the Bernstein bounds of :mod:`repro_torch.core.kadabra`
(the same expressions, so the stop rule reads the same bits whether it
calls this or evaluates the bounds itself).  A NaN in any input
propagates to the output, as ``torch.max`` does.
"""
from __future__ import annotations

import torch

__all__ = ["stopcheck_ref"]


def stopcheck_ref(counts, tau, log_inv_delta_l, log_inv_delta_u, omega):
    # the bounds live in core.kadabra, whose stop rule calls back into
    # this package: import at call time
    from ...core.kadabra import _f32, f_term, g_term
    tauf = torch.clamp(_f32(tau, counts.device), min=1.0)
    btilde = counts / tauf
    max_f = f_term(btilde, log_inv_delta_l, omega, tauf).max()
    max_g = g_term(btilde, log_inv_delta_u, omega, tauf).max()
    return torch.stack([max_f, max_g])
