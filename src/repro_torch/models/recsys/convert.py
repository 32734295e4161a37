"""Carry MIND's weights across from the JAX package: its param tree as
numpy arrays in, the port's param dict out (same names and layout, each
leaf's type kept)."""
from __future__ import annotations

import numpy as np
import torch

from ...device import DEFAULT_DEVICE, resolve_device

__all__ = ["mind_params_from_numpy"]

_KEYS = ("item_embed", "routing_init", "s_matrix")


def mind_params_from_numpy(tree, *, device=DEFAULT_DEVICE) -> dict:
    """``tree`` holds ``item_embed``, ``s_matrix`` and ``routing_init``,
    each an array."""
    if set(tree) != set(_KEYS):
        raise ValueError(f"not a JAX MIND param tree: expected keys "
                         f"{list(_KEYS)}, got {sorted(tree)}")
    dev = resolve_device(device)
    return {k: torch.from_numpy(np.array(v, copy=True)).to(dev)
            for k, v in tree.items()}
