"""Dispatcher of the frontier expansion (``repro.kernels.frontier.ops``).

:func:`frontier_expand` routes one batched (or unbatched) expansion to a
lane; the decision is the pure function :func:`select_route`:

* ``"ref"``          the plain PyTorch version, for CPU tensors only;
* ``"node_blocked"`` the node-blocked CUDA kernel, for CUDA tensors of a
  graph that carries a ``CSCLayout``;
* ``"flat"``         the pull over the COO edges' in-edge plan (words
  pass and ``frontier_pull_kernel``), for CUDA tensors otherwise.

On the card both routes keep their state in device memory, so unlike the
TPU kernels the pull has no fit limit; the node-blocked kernel's only
limit is the shared memory of one staged edge block.  The pull's plan is
built once per graph and handed in as ``plan``: the plan itself, or a
callable that gives it (``Graph.pull_plan``), called only when the flat
route runs, so a CPU or node-blocked level builds none.  Without one the
flat route builds it from ``src``/``dst`` at each call.
A forced lane that cannot be honoured raises: a kernel forced on a CPU
tensor, ``"node_blocked"`` without a layout, an edge block over the
card's shared memory, or the plain version forced on a CUDA tensor.
Nothing falls back quietly.
"""
from __future__ import annotations

import torch

from .kernel import (MAX_SMEM_BYTES, frontier_expand_flat,
                     frontier_expand_node_blocked, node_blocked_smem_bytes)
from .ref import frontier_expand_batched_ref

__all__ = ["LANES", "frontier_expand", "select_route"]

LANES = ("flat", "node_blocked", "ref")


def select_route(*, cuda: bool, csc=None, lane=None) -> str:
    """The lane :func:`frontier_expand` takes for a state on a CUDA
    device (``cuda=True``) or the CPU, with an optional layout and an
    optional forced ``lane``.  Raises ``ValueError`` when a forced lane
    cannot be honoured."""
    if lane is not None and lane not in LANES:
        raise ValueError(f"unknown lane {lane!r} (expected one of {LANES})")
    if lane is None:
        if not cuda:
            return "ref"
        lane = "node_blocked" if csc is not None else "flat"
    if lane == "ref":
        if cuda:
            raise ValueError("the plain version runs only on CPU tensors; "
                             "a CUDA state goes through a kernel")
        return "ref"
    if not cuda:
        raise ValueError(f"lane {lane!r} is a CUDA kernel but the state "
                         "lies on the CPU; use lane=None or 'ref'")
    if lane == "node_blocked":
        if csc is None:
            raise ValueError("lane='node_blocked' requires a CSCLayout "
                             "(csc=...)")
        smem = node_blocked_smem_bytes(csc.block_e)
        if smem > MAX_SMEM_BYTES:
            raise ValueError(
                f"node-blocked edge block block_e={csc.block_e} needs "
                f"{smem} bytes of shared memory, over the card's "
                f"{MAX_SMEM_BYTES}; shrink the blocking")
    return lane


def frontier_expand(src, dst, dist, sigma, level, *, csc=None, lane=None,
                    plan=None):
    """Route one frontier expansion (module docstring).

    Batched state is (rows, B) with ``level`` (B,); unbatched state is
    (rows,) with a scalar ``level``.
    """
    batched = dist.dim() == 2
    d2 = dist if batched else dist[:, None]
    s2 = sigma if batched else sigma[:, None]
    lv = torch.as_tensor(level, dtype=torch.int32,
                         device=dist.device).reshape(d2.shape[1])
    route = select_route(cuda=dist.is_cuda, csc=csc, lane=lane)
    if route == "node_blocked":
        out = frontier_expand_node_blocked(csc, d2.contiguous(),
                                           s2.contiguous(), lv)
    elif route == "flat":
        out = frontier_expand_flat(src, dst, d2.contiguous(),
                                   s2.contiguous(), lv,
                                   plan() if callable(plan) else plan)
    else:
        # the COO sum at the state's row count, as the JAX package's
        # automatic CPU route takes it with or without a layout
        out = frontier_expand_batched_ref(src, dst, d2, s2, lv)
    return out if batched else out[:, 0]
