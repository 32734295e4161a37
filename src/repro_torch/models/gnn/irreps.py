"""Minimal E(3)-irreps machinery for NequIP and MACE, l_max <= 2
(``repro.models.gnn.irreps``).

Three ingredients, as in the JAX package:

  * real spherical harmonics Y_l(r^), l in {0, 1, 2}, as Cartesian
    polynomials (component-normalized): ``_sh_np`` in numpy, ``sh`` and
    ``sh_all`` in torch;
  * coupling (Gaunt) tensors C^{l1 l2 -> l3}[m1, m2, m3], the triple
    product's mean over an exact sphere quadrature: the same numpy
    arithmetic as the JAX package, so the same bits;
  * Wigner matrices D_l(R) for tests, solved from Y_l(R r) = D_l(R) Y_l(r)
    over samples.

Feature layout: a dict {l: (N, C, 2l+1)} of per-node (or per-edge)
tensors.  :func:`coupling_tensor` keeps each coupling tensor once per
(device, dtype), so a layer does not copy it from the host.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

__all__ = ["DIMS", "L_MAX", "coupling", "coupling_tensor", "paths",
           "random_rotation", "sh", "sh_all", "tensor_product", "wigner_d"]

L_MAX = 2
DIMS = {0: 1, 1: 3, 2: 5}


# ---------------------------------------------------------------------------
# Real spherical harmonics (numpy reference + torch evaluation)
# ---------------------------------------------------------------------------

def _sh_np(l: int, r: np.ndarray) -> np.ndarray:
    """Component-normalized real SH of unit vectors r (N, 3) -> (N, 2l+1)."""
    x, y, z = r[..., 0], r[..., 1], r[..., 2]
    if l == 0:
        return np.ones((*r.shape[:-1], 1))
    if l == 1:
        return np.stack([y, z, x], axis=-1) * np.sqrt(3.0)
    if l == 2:
        c = np.sqrt(15.0)
        return np.stack([
            c * x * y,
            c * y * z,
            np.sqrt(5.0) / 2.0 * (3.0 * z * z - 1.0),
            c * x * z,
            c / 2.0 * (x * x - y * y),
        ], axis=-1)
    raise ValueError(l)


def sh(l: int, r: torch.Tensor) -> torch.Tensor:
    """Torch twin of :func:`_sh_np`; r must be unit vectors (..., 3)."""
    x, y, z = r[..., 0], r[..., 1], r[..., 2]
    if l == 0:
        return torch.ones((*r.shape[:-1], 1), dtype=r.dtype, device=r.device)
    if l == 1:
        return torch.stack([y, z, x], dim=-1) * float(np.sqrt(3.0))
    if l == 2:
        c = float(np.sqrt(15.0))
        return torch.stack([
            c * x * y,
            c * y * z,
            float(np.sqrt(5.0) / 2.0) * (3.0 * z * z - 1.0),
            c * x * z,
            c / 2.0 * (x * x - y * y),
        ], dim=-1)
    raise ValueError(l)


def sh_all(r: torch.Tensor, l_max: int = L_MAX) -> dict:
    return {l: sh(l, r) for l in range(l_max + 1)}


# ---------------------------------------------------------------------------
# Numerical coupling tensors
# ---------------------------------------------------------------------------

def _random_units(n: int, seed: int = 0) -> np.ndarray:
    g = np.random.default_rng(seed)
    v = g.standard_normal((n, 3))
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


@lru_cache(maxsize=None)
def _sphere_quadrature(n_theta: int = 16, n_phi: int = 32):
    """Exact quadrature on S^2 for polynomials up to degree ~2*n_theta:
    Gauss-Legendre in cos(theta) x uniform phi; the weights average to 1
    (they compute the mean over the sphere)."""
    u, wu = np.polynomial.legendre.leggauss(n_theta)   # u = cos(theta)
    phi = 2.0 * np.pi * np.arange(n_phi) / n_phi
    uu, pp = np.meshgrid(u, phi, indexing="ij")
    st = np.sqrt(1.0 - uu ** 2)
    pts = np.stack([st * np.cos(pp), st * np.sin(pp), uu], axis=-1)
    w = np.broadcast_to(wu[:, None] / 2.0 / n_phi, uu.shape)
    return pts.reshape(-1, 3), w.reshape(-1)


@lru_cache(maxsize=None)
def coupling(l1: int, l2: int, l3: int) -> np.ndarray | None:
    """C[m1, m2, m3] with Y_{l1 m1} Y_{l2 m2} = sum C[...] Y_{l3 m3} + ...

    With the component normalization <Y_{lm} Y_{lm'}> = delta_{mm'}, the
    coefficient is the triple product's mean over the sphere, computed
    by exact quadrature.  None when the path is forbidden (triangle or
    parity rule).  Float64, read-only: the array is shared by every
    caller.
    """
    if not (abs(l1 - l2) <= l3 <= l1 + l2) or (l1 + l2 + l3) % 2 != 0:
        return None
    pts, w = _sphere_quadrature()
    y1 = _sh_np(l1, pts)                      # (N, d1)
    y2 = _sh_np(l2, pts)                      # (N, d2)
    y3 = _sh_np(l3, pts)                      # (N, d3)
    c = np.einsum("n,nx,ny,nz->xyz", w, y1, y2, y3)
    c[np.abs(c) < 1e-10] = 0.0
    if np.abs(c).max() < 1e-8:
        return None
    c.setflags(write=False)
    return c


_COUPLING_TENSORS: dict = {}


def coupling_tensor(l1: int, l2: int, l3: int, device,
                    dtype=torch.float32) -> torch.Tensor:
    """:func:`coupling` as a tensor of ``dtype`` on ``device``, made once
    per (path, device, dtype)."""
    key = (l1, l2, l3, torch.device(device), dtype)
    if key not in _COUPLING_TENSORS:
        c = coupling(l1, l2, l3)
        if c is None:
            raise ValueError(f"path {(l1, l2, l3)} is forbidden")
        _COUPLING_TENSORS[key] = torch.from_numpy(np.array(c)).to(
            device=key[3], dtype=dtype)
    return _COUPLING_TENSORS[key]


def paths(l_max: int = L_MAX) -> list:
    """All allowed (l1, l2, l3) couplings with every l <= l_max."""
    out = []
    for l1 in range(l_max + 1):
        for l2 in range(l_max + 1):
            for l3 in range(l_max + 1):
                if coupling(l1, l2, l3) is not None:
                    out.append((l1, l2, l3))
    return out


def tensor_product(feats_a: dict, feats_b: dict, weights: dict,
                   l_max: int = L_MAX) -> dict:
    """Channel-wise ("uvu") weighted tensor product of two irrep dicts.

    feats_a[l1]: (N, C, 2l1+1); feats_b[l2]: (N, 2l2+1) shared over the
    channels or (N, C, 2l2+1); weights[(l1, l2, l3)]: (N, C) or (C,) path
    weights (a path without one is unweighted).  The output dict has the
    same channel count C for every l3, its keys in the order the paths
    first reach them.
    """
    out: dict = {}
    for (l1, l2, l3) in paths(l_max):
        if l1 not in feats_a or l2 not in feats_b:
            continue
        a = feats_a[l1]                                 # (N, C, d1)
        b = feats_b[l2]
        c = coupling_tensor(l1, l2, l3, a.device, a.dtype)
        n, ch, d1 = a.shape
        d2, d3 = c.shape[1], c.shape[2]
        if b.dim() == 2:                                 # (N, d2) shared
            # (N, d1, d3) per edge, then one batched product over C
            bc = (b @ c.permute(1, 0, 2).reshape(d2, d1 * d3)).reshape(
                n, d1, d3)
            term = torch.bmm(a, bc)
        else:
            outer = (a[:, :, :, None] * b[:, :, None, :]).reshape(
                n, ch, d1 * d2)
            term = outer @ c.reshape(d1 * d2, d3)
        w = weights.get((l1, l2, l3))
        if w is not None:
            term = term * (w[..., None] if w.dim() == 2 else w[None, :, None])
        out[l3] = term if l3 not in out else out[l3] + term
    return out


# ---------------------------------------------------------------------------
# Wigner matrices (tests only)
# ---------------------------------------------------------------------------

def wigner_d(l: int, rot: np.ndarray) -> np.ndarray:
    """D_l(R) with Y_l(R r) = D_l(R) @ Y_l(r), solved numerically."""
    pts = _random_units(2048, seed=99)
    y = _sh_np(l, pts)
    y_rot = _sh_np(l, pts @ rot.T)
    d, *_ = np.linalg.lstsq(y, y_rot, rcond=None)
    return d.T


def random_rotation(seed: int = 0) -> np.ndarray:
    g = np.random.default_rng(seed)
    q, _ = np.linalg.qr(g.standard_normal((3, 3)))
    if np.linalg.det(q) < 0:
        q[:, 0] = -q[:, 0]
    return q
