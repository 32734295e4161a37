"""Generic train/eval step factories (``repro.train.step``).

``make_train_step(loss_fn, opt_cfg)`` returns
    (params, opt_state, batch) -> (params, opt_state, metrics)
for any ``loss_fn(params, batch) -> scalar``; gradients come from
``torch.autograd.grad`` over the parameter leaves.  Microbatching
(gradient accumulation) runs the same loss over slices of the batch with
gradients summed in float32, as the JAX package's ``lax.scan`` does.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from ..optim.adamw import AdamWConfig, apply_updates
from ..tree import tree_leaves, tree_map, tree_unflatten

__all__ = ["make_eval_step", "make_train_step"]


def _slice_batch(batch, i: int, parts: int):
    """Slice ``i`` of ``parts`` along dim 0 of every tensor of a dict or
    dataclass batch (other fields stay as they are)."""
    def cut(x):
        if not isinstance(x, torch.Tensor):
            return x
        size = x.shape[0] // parts
        return x[i * size:(i + 1) * size]

    if isinstance(batch, dict):
        return {k: cut(v) for k, v in batch.items()}
    return type(batch)(**{f.name: cut(getattr(batch, f.name))
                          for f in dataclasses.fields(batch) if f.init
                          and not f.name.startswith("_")})


def _value_and_grad(loss_fn, params, batch):
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    loss = loss_fn(tree_unflatten(params, leaves), batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return loss.detach(), tree_unflatten(params, grads)


def make_train_step(loss_fn: Callable, opt_cfg: AdamWConfig,
                    microbatch: Optional[int] = None):
    """``loss_fn(params, batch) -> scalar``.  ``microbatch``: number of
    accumulation slices (must divide the batch's leading dim)."""

    def step(params, opt_state, batch):
        if microbatch is None or microbatch == 1:
            loss, grads = _value_and_grad(loss_fn, params, batch)
        else:
            loss = torch.zeros((), dtype=torch.float32)
            grads = tree_map(lambda p: torch.zeros(p.shape,
                                                   dtype=torch.float32,
                                                   device=p.device), params)
            for i in range(microbatch):
                sl, g = _value_and_grad(loss_fn, params,
                                        _slice_batch(batch, i, microbatch))
                loss = loss.to(sl.device) + sl
                grads = tree_map(lambda a, x: a + x.float(), grads, g)
            loss = loss / microbatch
            grads = tree_map(lambda g: g / microbatch, grads)
        params, opt_state, om = apply_updates(params, grads, opt_state,
                                              opt_cfg)
        return params, opt_state, {"loss": loss, **om}

    return step


def make_eval_step(loss_fn: Callable):
    """``(params, batch) -> loss_fn(params, batch)``, without autograd."""
    def step(params, batch):
        with torch.no_grad():
            return loss_fn(params, batch)
    return step
