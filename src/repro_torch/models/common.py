"""Shared model substrate (``repro.models.common``): the initializer
GraphSAGE uses.  Parameters are plain dicts of tensors, as the JAX
package keeps plain pytrees of arrays."""
from __future__ import annotations

import torch

__all__ = ["DEFAULT_DTYPE", "dense_init"]

DEFAULT_DTYPE = torch.bfloat16


def dense_init(generator: torch.Generator, shape, dtype=DEFAULT_DTYPE,
               scale: float = 1.0, *, device=None) -> torch.Tensor:
    """N(0, 1) float32 draws from ``generator`` times scale / sqrt(fan
    in), cast to ``dtype`` and moved to ``device`` (default: the
    generator's).  Fan in is ``shape[0]`` for a matrix, 1 for a vector."""
    fan_in = shape[0] if len(shape) >= 2 else 1
    std = scale / (fan_in ** 0.5)
    x = torch.randn(tuple(shape), generator=generator, dtype=torch.float32,
                    device=generator.device) * std
    return x.to(dtype=dtype, device=device or generator.device)
