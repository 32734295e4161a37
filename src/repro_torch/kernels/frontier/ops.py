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

The weighted lane has two dispatchers of the same contract,
:func:`frontier_relax` (one min-plus relaxation round) and
:func:`dag_sigma` (one round of the shortest-path-DAG count); their
routes (:func:`select_weighted_route`) are

* ``"ref"``            the plain version over the COO edges, CPU only;
* ``"pull"``           the weighted pull kernel (W1 or W2) over the
  graph's relax plan (``Graph.relax_plan``, handed in as ``plan``), CUDA;
* ``"sharded_level_ref"`` / ``"sharded_level"`` with ``shards=``: every
  held shard's tile from the gathered state, the kernel in one launch
  over the layout's cached relax plan.

A forced ``lane`` is ``"pull"`` or ``"ref"``; ``"flat"`` and
``"node_blocked"`` raise (the weighted rounds have no such kernel), as
does the plain version forced on a CUDA state or the kernel on a CPU one.
"""
from __future__ import annotations

import torch

from .kernel import (MAX_SMEM_BYTES, RelaxPlan, build_relax_plan,
                     dag_sigma_pull, frontier_expand_flat,
                     frontier_expand_node_blocked,
                     frontier_expand_sharded_level, frontier_relax_pull,
                     node_blocked_smem_bytes)
from .ref import (dag_round_batched_ref, dag_round_sharded_level_ref,
                  frontier_expand_batched_ref,
                  frontier_expand_sharded_level_ref,
                  frontier_expand_sharded_ref, frontier_relax_batched_ref,
                  frontier_relax_sharded_level_ref)

__all__ = ["LANES", "WEIGHTED_LANES", "dag_sigma", "frontier_expand",
           "frontier_relax", "select_route", "select_weighted_route"]

LANES = ("flat", "node_blocked", "ref")
WEIGHTED_LANES = ("pull", "ref")


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


# ---------------------------------------------------------------------------
# The weighted lane
# ---------------------------------------------------------------------------

def select_weighted_route(*, cuda: bool, shards=None, lane=None) -> str:
    """The route of :func:`frontier_relax` and :func:`dag_sigma` for a
    state on a CUDA device (``cuda=True``) or the CPU (module docstring);
    raises ``ValueError`` when a forced lane cannot be honoured."""
    if lane is not None and lane not in WEIGHTED_LANES:
        if lane in LANES:
            raise ValueError(f"lane {lane!r} has no weighted kernel; the "
                             "weighted rounds take lane=None, 'pull' or "
                             "'ref'")
        raise ValueError(f"unknown lane {lane!r} (expected one of "
                         f"{WEIGHTED_LANES})")
    if lane is None:
        lane = "pull" if cuda else "ref"
    if lane == "ref" and cuda:
        raise ValueError("the plain version runs only on CPU tensors; a "
                         "CUDA state goes through a kernel")
    if lane == "pull" and not cuda:
        raise ValueError("lane 'pull' is a CUDA kernel but the state lies "
                         "on the CPU; use lane=None or 'ref'")
    if shards is None:
        return lane
    return "sharded_level_ref" if lane == "ref" else "sharded_level"


def _weighted_layout(layout, what: str):
    if layout.weight is None:
        raise ValueError(f"{what} carries no weights")
    return layout


def _graph_plan(src, dst, weight, tent, plan) -> RelaxPlan:
    if callable(plan):
        plan = plan()
    if plan is None:
        return build_relax_plan(src, dst, weight, tent.shape[0])
    if plan.plan.ids is not src or plan.plan.seg is not dst \
            or plan.source_weight is not weight:
        raise ValueError("the relax plan was not built for these edges and "
                         "weights")
    return plan


def frontier_relax(src, dst, weight, tent, active, *, shards=None,
                   lane=None, plan=None):
    """One min-plus relaxation round (W1's dispatcher): ``tent`` (rows, B)
    float32 tentative distances, +inf unreached, ``active`` (rows, B) bool
    the round's bucket; returns the candidates (rows, B), the min over
    each row's in-edges with an active source of ``tent[u] + w`` (+inf
    without one).  With ``shards=`` the state is the gathered global one
    and the result the (n_local_shards, shard_rows, B) stack of the held
    shards' tiles (the edge operands are not read there; pass None)."""
    route = select_weighted_route(cuda=tent.is_cuda, shards=shards,
                                  lane=lane)
    if route == "ref":
        return frontier_relax_batched_ref(src, dst, weight, tent, active)
    if route == "pull":
        return frontier_relax_pull(_graph_plan(src, dst, weight, tent, plan),
                                   tent, active)
    layout = _weighted_layout(shards, "the sharded layout")
    if route == "sharded_level_ref":
        return frontier_relax_sharded_level_ref(layout, tent, active)
    return frontier_relax_pull(layout.relax_plan(), tent, active).view(
        layout.n_local_shards, layout.shard_rows, tent.shape[1])


def dag_sigma(src, dst, weight, tent, sigma, final, *, shards=None,
              lane=None, plan=None):
    """One round of the shortest-path-DAG count (W2's dispatcher) on
    converged ``tent``: ``(sums, waiting)``, for every cell not ``final``
    the sum of ``sigma`` over its on-DAG in-neighbours and whether one of
    them is not final; 0 and False on final cells.  ``shards=`` takes
    the gathered global state as :func:`frontier_relax` does."""
    route = select_weighted_route(cuda=tent.is_cuda, shards=shards,
                                  lane=lane)
    if route == "ref":
        return dag_round_batched_ref(src, dst, weight, tent, sigma, final)
    if route == "pull":
        return dag_sigma_pull(_graph_plan(src, dst, weight, tent, plan), tent,
                              sigma, final)
    layout = _weighted_layout(shards, "the sharded layout")
    if route == "sharded_level_ref":
        return dag_round_sharded_level_ref(layout, tent, sigma, final)
    sums, waiting = dag_sigma_pull(layout.relax_plan(), tent, sigma, final)
    shape = (layout.n_local_shards, layout.shard_rows, tent.shape[1])
    return sums.view(shape), waiting.view(shape)

