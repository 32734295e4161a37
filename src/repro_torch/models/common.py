"""Shared model substrate (``repro.models.common``): initializers,
norms, activations and RoPE.  Parameters are plain dicts of tensors, as
the JAX package keeps plain pytrees of arrays.

The JAX module's ``LoopConfig``, ``shard`` and ``active_mesh`` steer the
dry-run cost extrapolation and the TPU mesh; on one GPU they have no
role, so nothing here takes a ``loop=`` argument.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

__all__ = ["DEFAULT_DTYPE", "apply_rope", "dense_init", "embed_init",
           "ones_init", "rms_norm", "rope_frequencies", "silu_f32",
           "swiglu", "zeros_init"]

DEFAULT_DTYPE = torch.bfloat16


# a leaf of more draws than this is drawn a slice of dim 0 at a time, so
# that its float32 draws never exist whole (moonshot's stacked experts,
# 8.9e9 values, would take 35 GB in float32)
_DRAW_LIMIT = 1 << 31


def _normal(generator: torch.Generator, shape, std: float, dtype,
            device) -> torch.Tensor:
    shape = tuple(shape)
    device = device or generator.device
    if len(shape) > 1 and math.prod(shape) > _DRAW_LIMIT:
        out = torch.empty(shape, dtype=dtype, device=device)
        for i in range(shape[0]):
            out[i] = _normal(generator, shape[1:], std, dtype, device)
        return out
    x = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=generator.device) * std
    return x.to(dtype=dtype, device=device)


def dense_init(generator: torch.Generator, shape, dtype=DEFAULT_DTYPE,
               scale: float = 1.0, *, device=None,
               fan_in: int | None = None) -> torch.Tensor:
    """N(0, 1) float32 draws from ``generator`` times scale / sqrt(fan
    in), cast to ``dtype`` and moved to ``device`` (default: the
    generator's).  Fan in is ``shape[0]`` for a matrix, 1 for a vector,
    unless given (a stack of matrices passes its matrices' fan in)."""
    if fan_in is None:
        fan_in = shape[0] if len(shape) >= 2 else 1
    return _normal(generator, shape, scale / (fan_in ** 0.5), dtype, device)


def embed_init(generator: torch.Generator, shape, dtype=DEFAULT_DTYPE, *,
               device=None) -> torch.Tensor:
    """N(0, 0.02^2) draws, as the JAX ``embed_init``."""
    return _normal(generator, shape, 0.02, dtype, device)


def zeros_init(shape, dtype=DEFAULT_DTYPE, *, device=None) -> torch.Tensor:
    return torch.zeros(tuple(shape), dtype=dtype, device=device)


def ones_init(shape, dtype=DEFAULT_DTYPE, *, device=None) -> torch.Tensor:
    return torch.ones(tuple(shape), dtype=dtype, device=device)


def rms_norm(x, gamma, eps: float = 1e-6):
    """RMS norm over the last axis in float32, cast back to ``x.dtype``."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * gamma.float()).to(x.dtype)


def silu_f32(gate):
    """silu(gate) in float32, cast back to ``gate.dtype`` (swiglu's
    activation, as the reference computes it).  The float32 copy of a
    bfloat16 ``gate`` is activated in place where no gradient flows
    through it: the same values without a second float32 temporary."""
    x = gate.float()
    return F.silu(x, inplace=x is not gate and not x.requires_grad).to(
        gate.dtype)


def swiglu(gate, up):
    return silu_f32(gate) * up


def rope_frequencies(head_dim: int, theta: float = 10_000.0,
                     device=None) -> torch.Tensor:
    half = head_dim // 2
    exps = torch.arange(half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta: float = 10_000.0):
    """x (..., S, H, dh); positions broadcastable to (..., S).  Float32
    angles, rotation of the two halves of dh, cast back to ``x.dtype``."""
    freqs = rope_frequencies(x.shape[-1], theta, device=x.device)
    angles = positions[..., None].float() * freqs          # (..., S, dh/2)
    cos = torch.cos(angles)[..., None, :]                   # (..., S, 1, dh/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)
