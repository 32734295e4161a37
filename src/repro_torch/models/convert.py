"""Carry LM weights across from the JAX package: its param tree
(``repro.models.transformer.init_params``) as numpy arrays in, the
port's param dict out, with the same names, nesting and layout."""
from __future__ import annotations

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve_device

__all__ = ["lm_params_from_numpy"]


def _tensor(a) -> torch.Tensor:
    a = np.array(a, copy=True)
    if a.dtype.name == "bfloat16":      # ml_dtypes' bfloat16: same bits
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def lm_params_from_numpy(tree, *, dtype=None, device=DEFAULT_DEVICE) -> dict:
    """``tree`` holds ``embed``, ``ln_f``, ``groups`` (a list of dicts of
    stacked leaves), ``remainder`` (a list of dicts) and optionally
    ``lm_head``, each leaf an array; an MoE layer's dict nests ``moe``
    (``router``, ``w_gate``, ``w_up``, ``w_down``).  Leaves keep their
    type unless ``dtype`` is given, which casts every leaf but the MoE
    router: that stays float32, as the reference draws and uses it."""
    dev = resolve_device(device)

    def carry(t, key=None):
        if isinstance(t, dict):
            return {k: carry(v, k) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(carry(v) for v in t)
        return _tensor(t).to(device=dev, dtype=None if key == "router"
                             else dtype)

    return carry(tree)
