"""AdamW (``repro.optim.adamw``): float32 moments beside each parameter,
global grad-norm clipping in float32, decoupled weight decay, in the JAX
package's order of operations.  Functional: every step returns new
parameter and state trees.

``compress="int8"`` compresses the gradient all-reduce, which one GPU
does not have: it raises until the SPMD lane (ROADMAP item 11).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..tree import tree_leaves, tree_map, tree_unflatten

__all__ = ["AdamWConfig", "apply_updates", "init_state"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: Optional[float] = 1.0
    compress: Optional[str] = None   # None | "int8"


def _no_compression(compress) -> None:
    if compress:
        raise NotImplementedError(
            "int8 gradient compression shrinks the cross-device all-reduce; "
            "it waits for the port's SPMD lane (ROADMAP item 11)")


def init_state(params, compress: bool = False) -> dict:
    _no_compression(compress)
    leaves = tree_leaves(params)
    return {"m": tree_map(_zeros_f32, params),
            "v": tree_map(_zeros_f32, params), "err": None,
            "step": torch.zeros((), dtype=torch.int32,
                                device=leaves[0].device if leaves else None)}


def _zeros_f32(p):
    return torch.zeros_like(p, dtype=torch.float32)


def apply_updates(params, grads, state, cfg: AdamWConfig):
    """One AdamW step; returns (new_params, new_state, metrics)."""
    _no_compression(cfg.compress)
    step = state["step"] + 1
    grads = tree_map(lambda g: g.float(), grads)

    gnorm = torch.sqrt(sum(torch.sum(g * g) for g in tree_leaves(grads)))
    if cfg.grad_clip is not None:
        scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12),
                            max=1.0)
        grads = tree_map(lambda g: g * scale, grads)

    b1t = 1.0 - cfg.b1 ** step.float()
    b2t = 1.0 - cfg.b2 ** step.float()

    def upd(p, g, m, v):
        m2 = cfg.b1 * m + (1.0 - cfg.b1) * g
        v2 = cfg.b2 * v + (1.0 - cfg.b2) * g * g
        mhat = m2 / b1t
        vhat = v2 / b2t
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) \
            + cfg.weight_decay * p.float()
        return (p.float() - cfg.lr * delta).to(p.dtype), m2, v2

    out = [upd(*leaf) for leaf in zip(tree_leaves(params), tree_leaves(grads),
                                      tree_leaves(state["m"]),
                                      tree_leaves(state["v"]))]
    new_params, new_m, new_v = (tree_unflatten(params, [o[i] for o in out])
                                for i in range(3))
    new_state = {"m": new_m, "v": new_v, "err": None, "step": step}
    return new_params, new_state, {"grad_norm": gnorm}
