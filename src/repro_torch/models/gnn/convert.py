"""Carry GraphSAGE weights across from the JAX package: its param tree
as numpy arrays in, the port's param dict out (same names, same
layout)."""
from __future__ import annotations

import numpy as np
import torch

from ...device import DEFAULT_DEVICE, resolve_device

__all__ = ["sage_params_from_numpy"]


def sage_params_from_numpy(tree, *, device=DEFAULT_DEVICE) -> dict:
    """``tree`` holds ``embed_in``, ``embed_z``, ``head`` and ``layers``
    (a list of dicts of ``w_self`` and ``w_neigh``), each an array."""
    dev = resolve_device(device)

    def tensor(a):
        return torch.from_numpy(np.array(a, np.float32, copy=True)).to(dev)

    return {"embed_in": tensor(tree["embed_in"]),
            "embed_z": tensor(tree["embed_z"]),
            "layers": [{k: tensor(lp[k]) for k in ("w_self", "w_neigh")}
                       for lp in tree["layers"]],
            "head": tensor(tree["head"])}
