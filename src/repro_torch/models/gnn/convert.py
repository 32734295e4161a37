"""Carry GNN weights across from the JAX package: its param tree as numpy
arrays in, the port's param dict out (same names, same layout, same
keys: the int keys of NequIP's and MACE's per-l mixers and the
``(l1, l2, l3)`` tuple keys of their radial MLPs stay as they are, so
``repro_torch.tree`` walks the leaves in ``jax.tree.leaves`` order)."""
from __future__ import annotations

import numpy as np
import torch

from ...device import DEFAULT_DEVICE, resolve_device

__all__ = ["egnn_params_from_numpy", "mace_params_from_numpy",
           "nequip_params_from_numpy", "sage_params_from_numpy"]


def _tensor(a, dev) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32, copy=True)).to(dev)


def _carry(tree, dev):
    """Dicts (keys kept), lists and tuples of arrays, as tensors."""
    if isinstance(tree, dict):
        return {k: _carry(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_carry(v, dev) for v in tree)
    return _tensor(tree, dev)


def _check_keys(tree, top: tuple, layer: tuple, name: str) -> None:
    if set(tree) != set(top) or any(set(lp) != set(layer)
                                    for lp in tree["layers"]):
        raise ValueError(f"not a JAX {name} param tree: expected keys "
                         f"{sorted(top)} and layer keys {sorted(layer)}")


def sage_params_from_numpy(tree, *, device=DEFAULT_DEVICE) -> dict:
    """``tree`` holds ``embed_in``, ``embed_z``, ``head`` and ``layers``
    (a list of dicts of ``w_self`` and ``w_neigh``), each an array."""
    _check_keys(tree, ("embed_in", "embed_z", "head", "layers"),
                ("w_self", "w_neigh"), "GraphSAGE")
    return _carry(tree, resolve_device(device))


def egnn_params_from_numpy(tree, *, device=DEFAULT_DEVICE) -> dict:
    """``tree`` holds ``embed_z``, ``embed_x``, ``head`` and ``layers`` (a
    list of dicts of the lists ``edge_mlp``, ``coord_mlp`` and
    ``node_mlp``)."""
    _check_keys(tree, ("embed_z", "embed_x", "head", "layers"),
                ("edge_mlp", "coord_mlp", "node_mlp"), "EGNN")
    return _carry(tree, resolve_device(device))


def nequip_params_from_numpy(tree, *, device=DEFAULT_DEVICE) -> dict:
    """``tree`` holds ``embed_z``, ``head`` (a list) and ``layers`` (a list
    of dicts of ``mix`` {l: array}, ``gate`` and ``radial`` {(l1, l2, l3):
    list})."""
    _check_keys(tree, ("embed_z", "head", "layers"),
                ("mix", "gate", "radial"), "NequIP")
    return _carry(tree, resolve_device(device))


def mace_params_from_numpy(tree, *, device=DEFAULT_DEVICE) -> dict:
    """``tree`` holds ``embed_z``, ``head`` (a list) and ``layers`` (a list
    of dicts of ``mix_a``, ``mix_b2``, ``mix_b3`` {l: array}, ``radial``
    {(l1, l2, l3): list} and ``update``)."""
    _check_keys(tree, ("embed_z", "head", "layers"),
                ("mix_a", "mix_b2", "mix_b3", "radial", "update"), "MACE")
    return _carry(tree, resolve_device(device))
