"""Dispatcher of the frontier expansion (``repro.kernels.frontier.ops``).

:func:`frontier_expand` routes one batched (or unbatched) expansion to a
lane; the decision is the pure function :func:`select_route`:

* ``"ref"``          the plain PyTorch version, for CPU tensors only;
* ``"node_blocked"`` the node-blocked CUDA kernel, for CUDA tensors of a
  graph that carries a ``CSCLayout``;
* ``"flat"``         the pull over the COO edges' in-edge plan (words
  pass and ``frontier_pull_kernel``), for CUDA tensors otherwise;
* ``"sharded_nb"``   with ``shard=`` (one vertex shard's layout view, the
  state the gathered global rows): the node-blocked kernel in wide_state
  mode, for CUDA tensors, writing the shard's (shard_rows, B) tile;
* ``"sharded_ref"``  its plain version, for CPU tensors;
* ``"sharded_level"`` with ``shards=`` (a whole ``ShardedCSCLayout``, the
  state the gathered masked frontier values): every shard's tile of the
  level at once, one words pass and one node-blocked launch over the
  layout's real edge blocks, for CUDA tensors, into the
  (S, shard_rows, B) stack;
* ``"sharded_level_ref"`` its plain version, for CPU tensors.

A forced ``lane`` with a shard (or shards) maps as in the JAX package:
``"node_blocked"`` to ``"sharded_nb"`` (``"sharded_level"``), ``"ref"``
to ``"sharded_ref"`` (``"sharded_level_ref"``), and ``"flat"`` raises
(its output rows are the state's).

On the card both routes keep their state in device memory, so unlike the
TPU kernels the pull has no fit limit; the node-blocked kernel's only
limit is the shared memory of one staged edge block.  The pull's plan is
built once per graph and handed in as ``plan``: the plan itself, or a
callable that gives it (``Graph.pull_plan``), called only when the flat
route runs, so a CPU or node-blocked level builds none.  Without one the
flat route builds it from ``src``/``dst`` at each call.
A forced lane that cannot be honoured raises: a kernel forced on a CPU
tensor, ``"node_blocked"`` without a layout, an edge block over the
card's shared memory, the plain version forced on a CUDA tensor, or
more than one of ``csc=``, ``shard=`` and ``shards=``.  Nothing falls
back quietly.
"""
from __future__ import annotations

import torch

from .kernel import (MAX_SMEM_BYTES, frontier_expand_flat,
                     frontier_expand_node_blocked,
                     frontier_expand_sharded_level, node_blocked_smem_bytes)
from .ref import (frontier_expand_batched_ref,
                  frontier_expand_sharded_level_ref,
                  frontier_expand_sharded_ref)

__all__ = ["LANES", "frontier_expand", "select_route"]

LANES = ("flat", "node_blocked", "ref")


def _check_smem(layout, what: str) -> None:
    smem = node_blocked_smem_bytes(layout.block_e)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(
            f"{what} edge block block_e={layout.block_e} needs {smem} "
            f"bytes of shared memory, over the card's {MAX_SMEM_BYTES}; "
            "shrink the blocking")


def _select_sharded(cuda: bool, layout, lane, route: str) -> str:
    """The kernel route ``route`` for a sharded layout, or its plain
    version's; raises where ``lane`` cannot be honoured."""
    if lane == "flat":
        raise ValueError("the flat kernel cannot serve the sharded lane "
                         "(local output rows != gathered input rows); use "
                         "lane=None, 'node_blocked' or 'ref'")
    if lane is None:
        lane = "node_blocked" if cuda else "ref"
    if lane == "ref":
        if cuda:
            raise ValueError("the plain version runs only on CPU tensors; "
                             "a CUDA state goes through a kernel")
        return {"sharded_nb": "sharded_ref",
                "sharded_level": "sharded_level_ref"}[route]
    if not cuda:
        raise ValueError("lane 'node_blocked' (sharded) is a CUDA kernel but "
                         "the state lies on the CPU; use lane=None or 'ref'")
    _check_smem(layout, "sharded node-blocked")
    return route


def select_route(*, cuda: bool, csc=None, shard=None, shards=None,
                 lane=None) -> str:
    """The lane :func:`frontier_expand` takes for a state on a CUDA
    device (``cuda=True``) or the CPU, with an optional layout (``csc``,
    one shard's view ``shard`` or a whole sharded layout ``shards``, at
    most one) and an optional forced ``lane``.  Raises ``ValueError``
    when a forced lane cannot be honoured."""
    if lane is not None and lane not in LANES:
        raise ValueError(f"unknown lane {lane!r} (expected one of {LANES})")
    if sum(x is not None for x in (csc, shard, shards)) > 1:
        raise ValueError("pass csc= (the replicated layout), shard= (one "
                         "shard's view) or shards= (the sharded layout), "
                         "not both")
    if shard is not None:
        return _select_sharded(cuda, shard, lane, "sharded_nb")
    if shards is not None:
        return _select_sharded(cuda, shards, lane, "sharded_level")
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
        _check_smem(csc, "node-blocked")
    return lane


def frontier_expand(src, dst, dist, sigma, level, *, csc=None, shard=None,
                    shards=None, lane=None, plan=None):
    """Route one frontier expansion (module docstring).

    Batched state is (rows, B) with ``level`` (B,); unbatched state is
    (rows,) with a scalar ``level``.  With ``shard=`` the state covers the
    gathered global rows and the result is the shard's tile
    (``src``/``dst`` are not read).  With ``shards=`` ``sigma`` is the
    gathered masked frontier values, ``src``, ``dst`` and ``dist`` are
    not read (pass None), and the result is the (S, shard_rows[, B])
    stack of every shard's tile.
    """
    batched = sigma.dim() == 2
    s2 = sigma if batched else sigma[:, None]
    lv = torch.as_tensor(level, dtype=torch.int32,
                         device=sigma.device).reshape(s2.shape[1])
    route = select_route(cuda=sigma.is_cuda, csc=csc, shard=shard,
                         shards=shards, lane=lane)
    d2 = None if dist is None else dist if batched else dist[:, None]
    if route == "sharded_level":
        out = frontier_expand_sharded_level(shards, s2.contiguous(), lv)
    elif route == "sharded_level_ref":
        out = frontier_expand_sharded_level_ref(shards, s2, lv)
    elif route == "sharded_nb":
        out = frontier_expand_node_blocked(shard, d2.contiguous(),
                                           s2.contiguous(), lv,
                                           wide_state=True)
    elif route == "sharded_ref":
        out = frontier_expand_sharded_ref(shard, d2, s2, lv)
    elif route == "node_blocked":
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
    return out if batched else out[..., 0]
