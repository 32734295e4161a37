"""AdamW (``repro.optim.adamw``): float32 moments beside each parameter,
global grad-norm clipping in float32, decoupled weight decay, in the JAX
package's order of operations.  ``apply_updates`` is functional: every
step returns new parameter and state trees.  ``apply_updates_`` is the
port's counterpart of the JAX launcher's ``donate_argnums=(0, 1)``: it
writes each parameter and moment leaf in place, a slice of at most
``UPDATE_CHUNK`` elements at a time, so no float32 temporary larger
than a slice outlives its use (the functional step holds old and new
moments at once: 57.8 GB for llama3.2-3b's 3.61e9 parameters).  The
same float32 expressions in the same order, element by element: its
results are bitwise the functional step's.

``compress="int8"`` compresses a data-parallel gradient all-reduce, which
one GPU does not have: it raises until data-parallel training (FSDP/TP,
ROADMAP §1 item 16).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..tree import tree_leaves, tree_map, tree_unflatten

__all__ = ["AdamWConfig", "UPDATE_CHUNK", "apply_updates",
           "apply_updates_", "init_state"]

# elements of a leaf updated at once by apply_updates_ (64 MB of float32)
UPDATE_CHUNK = 1 << 24


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
            "int8 gradient compression shrinks the data-parallel gradient "
            "all-reduce; it waits for data-parallel training (FSDP/TP, "
            "ROADMAP §1 item 16): the SPMD sampling lane has no gradient")


def init_state(params, compress: bool = False) -> dict:
    _no_compression(compress)
    leaves = tree_leaves(params)
    return {"m": tree_map(_zeros_f32, params),
            "v": tree_map(_zeros_f32, params), "err": None,
            "step": torch.zeros((), dtype=torch.int32,
                                device=leaves[0].device if leaves else None)}


def _zeros_f32(p):
    return torch.zeros_like(p, dtype=torch.float32)


def _clip_scale(gnorm, cfg: AdamWConfig):
    return torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12),
                       max=1.0)


def _moments(m, v, g, cfg: AdamWConfig):
    """The new float32 moments of gradient ``g``."""
    return cfg.b1 * m + (1.0 - cfg.b1) * g, \
        cfg.b2 * v + (1.0 - cfg.b2) * g * g


def _new_param(p, m2, v2, b1t, b2t, cfg: AdamWConfig):
    """The parameter after the step, in ``p``'s type."""
    mhat = m2 / b1t
    vhat = v2 / b2t
    delta = mhat / (torch.sqrt(vhat) + cfg.eps) \
        + cfg.weight_decay * p.float()
    return (p.float() - cfg.lr * delta).to(p.dtype)


def apply_updates(params, grads, state, cfg: AdamWConfig):
    """One AdamW step; returns (new_params, new_state, metrics)."""
    _no_compression(cfg.compress)
    step = state["step"] + 1
    grads = tree_map(lambda g: g.float(), grads)

    gnorm = torch.sqrt(sum(torch.sum(g * g) for g in tree_leaves(grads)))
    if cfg.grad_clip is not None:
        scale = _clip_scale(gnorm, cfg)
        grads = tree_map(lambda g: g * scale, grads)

    b1t = 1.0 - cfg.b1 ** step.float()
    b2t = 1.0 - cfg.b2 ** step.float()

    def upd(p, g, m, v):
        m2, v2 = _moments(m, v, g, cfg)
        return _new_param(p, m2, v2, b1t, b2t, cfg), m2, v2

    out = [upd(*leaf) for leaf in zip(tree_leaves(params), tree_leaves(grads),
                                      tree_leaves(state["m"]),
                                      tree_leaves(state["v"]))]
    new_params, new_m, new_v = (tree_unflatten(params, [o[i] for o in out])
                                for i in range(3))
    new_state = {"m": new_m, "v": new_v, "err": None, "step": step}
    return new_params, new_state, {"grad_norm": gnorm}


def apply_updates_(params, grads, state, cfg: AdamWConfig,
                   chunk: int = UPDATE_CHUNK):
    """One AdamW step that donates ``params`` and ``state``: every
    parameter and moment leaf is written in place (each must be
    contiguous), ``state["step"]`` replaced; returns (params, state,
    metrics), the same objects.  The gradient norm is taken leaf by leaf
    (one leaf's float32 gradient and its square at a time), each leaf
    updated ``chunk`` elements at a time; the expressions and their
    order are ``apply_updates``'s, so the results are its bits."""
    _no_compression(cfg.compress)
    step = state["step"] + 1
    leaves = list(zip(tree_leaves(params), tree_leaves(grads),
                      tree_leaves(state["m"]), tree_leaves(state["v"])))
    if any(not t.is_contiguous() for p, _, m, v in leaves
           for t in (p, m, v)):
        raise ValueError("apply_updates_ writes leaves in place through flat "
                         "views: every parameter and moment must be "
                         "contiguous")

    def sq(g):
        g = g.float()
        return torch.sum(g * g)

    gnorm = torch.sqrt(sum(sq(g) for _, g, _, _ in leaves))
    scale = _clip_scale(gnorm, cfg) if cfg.grad_clip is not None else None
    b1t = 1.0 - cfg.b1 ** step.float()
    b2t = 1.0 - cfg.b2 ** step.float()
    for p, g, m, v in leaves:
        pf, gf, mf, vf = p.view(-1), g.reshape(-1), m.view(-1), v.view(-1)
        for lo in range(0, pf.numel(), chunk):
            hi = lo + chunk
            gc = gf[lo:hi].float()
            if scale is not None:
                gc = gc * scale
            m2, v2 = _moments(mf[lo:hi], vf[lo:hi], gc, cfg)
            pf[lo:hi] = _new_param(pf[lo:hi], m2, v2, b1t, b2t, cfg)
            mf[lo:hi] = m2
            vf[lo:hi] = v2
    state["step"] = step
    return params, state, {"grad_norm": gnorm}
