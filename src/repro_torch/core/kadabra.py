"""KADABRA statistics: sample cap omega, stopping condition, calibration
(``repro.core.kadabra``), in float32 as in the JAX package.

* omega = c/eps^2 * (floor(log2(VD - 2)) + 1 + ln(2/delta)), c = 0.5;
* stop when max_x f < eps and max_x g < eps, with the Bernstein-style
  bounds f (lower side) and g (upper side) of b~(x) = c~(x)/tau;
* per-vertex failure budgets ln(1/delta_L(x)), ln(1/delta_U(x)) from a
  closed-form waterfilling over a trial stopping time tau*, bisected
  (64 steps) until the union bound spends exactly delta.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..kernels.stopcheck.ops import stopcheck

__all__ = ["KadabraParams", "calibrate_deltas", "check_stop",
           "compute_omega", "f_term", "g_term"]


class KadabraParams(NamedTuple):
    eps: float
    delta: float
    omega: torch.Tensor            # () float32 static sample cap
    log_inv_delta_l: torch.Tensor  # (V,) float32
    log_inv_delta_u: torch.Tensor  # (V,) float32


def _f32(x, device=None):
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def compute_omega(vertex_diameter, eps: float, delta: float,
                  c: float = 0.5, *, device=None):
    """Static sample-size cap (KADABRA's omega)."""
    vd = torch.clamp(_f32(vertex_diameter, device), min=4.0)
    log2_term = torch.floor(torch.log2(vd - 2.0)) + 1.0
    return (c / (eps * eps)) * (log2_term + math.log(2.0 / delta))


def f_term(btilde, log_inv_delta_l, omega, tau):
    """Lower-side deviation bound f (must fall below eps)."""
    tau = torch.clamp(_f32(tau, btilde.device), min=1.0)
    ell = torch.clamp(log_inv_delta_l, min=1e-8)
    a = omega / tau - 1.0 / 3.0
    return (ell / tau) * (-a + torch.sqrt(a * a + 2.0 * btilde * omega / ell))


def g_term(btilde, log_inv_delta_u, omega, tau):
    """Upper-side deviation bound g (must fall below eps)."""
    tau = torch.clamp(_f32(tau, btilde.device), min=1.0)
    ell = torch.clamp(log_inv_delta_u, min=1e-8)
    b = omega / tau + 1.0 / 3.0
    return (ell / tau) * (b + torch.sqrt(b * b + 2.0 * btilde * omega / ell))


def check_stop(counts, tau, params: KadabraParams):
    """(done, max_f, max_g) on a consistent snapshot; ``counts`` is the
    (V,) count vector with the sink row stripped.  The maxima come from
    :func:`~repro_torch.kernels.stopcheck.ops.stopcheck`: the CUDA kernel
    on the card, the plain version on the CPU."""
    tauf = torch.clamp(_f32(tau, counts.device), min=1.0)
    max_f, max_g = stopcheck(counts, tau, params.log_inv_delta_l,
                             params.log_inv_delta_u, params.omega).unbind()
    done = (max_f < params.eps) & (max_g < params.eps)
    # the static cap: never more than omega samples in total
    done = done | (tauf >= params.omega)
    return done, max_f, max_g


def _required_log_inv_delta(btilde, eps: float, omega, tau):
    """Smallest ln(1/delta) budgets so that f < eps and g < eps at tau
    (x_f is +inf where f < eps for every delta)."""
    a = omega / tau - 1.0 / 3.0
    b = omega / tau + 1.0 / 3.0
    den_f = 2.0 * btilde * omega - 2.0 * eps * tau * a
    x_f = torch.where(den_f > 0.0,
                      (eps * tau) ** 2 / torch.clamp(den_f, min=1e-30),
                      math.inf)
    x_g = (eps * tau) ** 2 / (2.0 * btilde * omega + 2.0 * eps * tau * b)
    return x_f, x_g


def calibrate_deltas(btilde0, eps: float, delta: float, omega,
                     n_iters: int = 64):
    """Waterfilling of per-vertex failure budgets from the calibration
    estimates ``btilde0`` (V,).  Returns (ln(1/delta_L), ln(1/delta_U),
    tau*); the budgets satisfy sum(delta_L + delta_U) <= delta."""
    omega = _f32(omega, btilde0.device)

    def budget_used(tau_star):
        x_f, x_g = _required_log_inv_delta(btilde0, eps, omega, tau_star)
        return torch.exp(-x_f).sum() + torch.exp(-x_g).sum()

    lo, hi = _f32(1.0, btilde0.device), omega
    for _ in range(n_iters):
        # budget_used decreases in tau*; feasible means used <= delta
        mid = 0.5 * (lo + hi)
        infeasible = budget_used(mid) > delta
        lo = torch.where(infeasible, mid, lo)
        hi = torch.where(infeasible, hi, mid)
    tau_star = hi
    x_f, x_g = _required_log_inv_delta(btilde0, eps, omega, tau_star)
    used = torch.exp(-x_f).sum() + torch.exp(-x_g).sum()
    # rescale so the union bound holds with equality
    slack = torch.log(delta / torch.clamp(used, min=1e-30))
    log_inv_l = torch.clamp(x_f - slack, 1e-6, 1e30)
    log_inv_u = torch.clamp(x_g - slack, 1e-6, 1e30)
    return log_inv_l, log_inv_u, tau_star
