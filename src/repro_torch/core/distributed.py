"""Aggregation of the sampling state over a ``torch.distributed`` group
(``repro.core.distributed``): the paper's MPI layer.

The paper aggregates each epoch's state frames in tiers: the processes
of a node over the *local* communicator, then the first process of each
node over the *global* one.  A :class:`SamplerMesh` names its axes as
the JAX mesh does: the ``"pod"`` axis is the global tier and every other
axis the local one (:func:`sampler_axes`).  Rank ``r`` of the mesh's
group sits at the row-major position ``r`` of ``shape``, as device ``r``
of a JAX mesh does, and the mesh holds one process subgroup a tier: one
local subgroup for each pod, one global subgroup for each local index.

Three aggregations, each started at once (``async_op=True``) and
returned as an :class:`Aggregation` whose ``wait()`` gives the sum:

* :func:`hierarchical_allreduce`: reduce_scatter over the local tier,
  all_reduce over the global tier, all_gather over the local tier, so
  each element crosses the global tier once;
* :func:`flat_allreduce`: one all_reduce over the mesh (the paper's
  Algorithm 1);
* :func:`reduce_to_root_and_broadcast`: the paper's literal
  reduce(dst=0), then broadcast(src=0).

Where the collectives run is the group's backend's choice.  NCCL runs
them on the rank's card.  Gloo runs them on the host: a frame that lies
on a card is copied to pinned host memory before the first stage and
back after the last one, inside the :class:`Aggregation`, which counts
those bytes (``staged_bytes``), as MPI aggregates host memory in the
paper.
"""
from __future__ import annotations

import logging
import math
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..device import DEFAULT_DEVICE
from .shards import canonical_device

__all__ = ["AGGREGATIONS", "Aggregation", "SamplerMesh",
           "assert_replicated", "allreduce_ints", "flat_allreduce",
           "hierarchical_allreduce", "reduce_to_root_and_broadcast",
           "sampler_axes", "sampler_generator"]

_log = logging.getLogger(__name__)


def sampler_axes(mesh) -> tuple:
    """(local axes, global axes): ``"pod"``, if present, is the global
    tier; every other axis is the local tier."""
    names = tuple(mesh.axis_names)
    return (tuple(n for n in names if n != "pod"),
            tuple(n for n in names if n == "pod"))


def sampler_generator(seed: int, rank: int, device) -> torch.Generator:
    """The sampling generator of mesh rank ``rank``: seeded from
    ``np.random.SeedSequence([seed, rank])``, so every rank draws its own
    stream and a run can be replayed rank by rank in one process."""
    state = np.random.SeedSequence([int(seed), int(rank)]).generate_state(
        1, np.uint64)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(state[0]))
    return gen


class SamplerMesh:
    """The independent samplers of the SPMD lane: one process a sampler,
    ``shape`` over ``axis_names``, built after
    ``torch.distributed.init_process_group`` over the default group or
    ``group``, whose size must be the product of ``shape``.  Every rank
    of that group builds it with the same arguments: the tiers'
    subgroups are created on each, in the same order.

    ``device`` is this rank's device (a run on the mesh must name it, if
    it names one); ``comm_device`` is where the collectives run: the
    card under NCCL, the host under gloo.
    """

    def __init__(self, shape, axis_names, device=DEFAULT_DEVICE,
                 group=None):
        if not dist.is_available() or not dist.is_initialized():
            raise RuntimeError("build a SamplerMesh after "
                               "torch.distributed.init_process_group")
        self.shape = tuple(int(s) for s in shape)
        self.axis_names = tuple(axis_names)
        if len(self.shape) != len(self.axis_names) or \
                len(set(self.axis_names)) != len(self.axis_names) or \
                min(self.shape, default=0) < 1:
            raise ValueError(f"shape {self.shape} and axis_names "
                             f"{self.axis_names} do not name one axis a "
                             "dimension")
        self.group = group
        self.size = dist.get_world_size(group)
        if self.size != math.prod(self.shape):
            raise ValueError(f"the group has {self.size} ranks but the mesh "
                             f"{self.shape} has {math.prod(self.shape)}")
        self.rank = dist.get_rank(group)
        self.device = canonical_device(device)
        self.backend = str(dist.get_backend(group))
        if self.backend == "nccl":
            if self.device.type != "cuda":
                raise ValueError("an NCCL group runs its collectives on the "
                                 f"card, but the mesh's device is "
                                 f"{self.device}")
            self.comm_device = self.device
        else:
            self.comm_device = torch.device("cpu")
        # global ranks in mesh order (a subgroup's ranks are numbered in
        # the order of their global ranks)
        self._global = [r if group is None else dist.get_global_rank(group, r)
                        for r in range(self.size)]
        self.root = self._global[0]
        self.local_axes, self.global_axes = sampler_axes(self)
        self.local_group, self.local_size = self._tier(self.local_axes)
        self.global_group, self.global_size = self._tier(self.global_axes)
        _log.info("SamplerMesh %s %s: rank %d of %d on %s; %s collectives "
                  "on %s%s", self.shape, self.axis_names, self.rank,
                  self.size, self.device, self.backend, self.comm_device,
                  ", frames staged through pinned host memory"
                  if self.staged else "")

    @property
    def staged(self) -> bool:
        """Whether a frame on this rank's device is copied to the host
        for each collective (gloo with a card)."""
        return self.comm_device != self.device

    def _tier(self, axes) -> tuple:
        """(process group, size) of the tier over ``axes``: the ranks
        that share this rank's coordinates on every other axis.  ``None``
        and 1 when no axis names it; the mesh's own group when it is the
        whole mesh.  A tier of one rank still has its group, as a JAX
        collective over an axis of size 1 still runs."""
        if not axes:
            return None, 1
        size = math.prod(s for s, n in zip(self.shape, self.axis_names)
                         if n in axes)
        if size == self.size:
            return self.group, size
        coords = np.stack(np.unravel_index(np.arange(self.size), self.shape))
        others = [i for i, n in enumerate(self.axis_names) if n not in axes]
        keys = [tuple(coords[others, r]) for r in range(self.size)]
        mine = None
        for key in sorted(set(keys)):
            ranks = [self._global[r] for r in range(self.size)
                     if keys[r] == key]
            # over the default group every rank makes every subgroup; over
            # a subgroup only its own ranks build the mesh
            pg = dist.new_group(
                ranks, use_local_synchronization=self.group is not None)
            if key == keys[self.rank]:
                mine = pg
        return mine, size


class Aggregation:
    """A started aggregation.  ``wait()`` waits for the first stage,
    runs the later ones (each blocking), and returns the sum with the
    input's shape, type and device; ``staged_bytes`` counts the copies
    to the host and back (0 where the collectives run on the frame's own
    device)."""

    def __init__(self, x: torch.Tensor, buf: torch.Tensor, work,
                 rest: Optional[Callable[[], None]] = None):
        self._shape, self._device = x.shape, x.device
        self._buf, self._work, self._rest = buf, work, rest
        self.staged_bytes = (2 * buf.numel() * buf.element_size()
                             if buf.device != x.device else 0)

    def wait(self) -> torch.Tensor:
        if self._work is not None:
            self._work.wait()
            self._work = None
        if self._rest is not None:
            self._rest()
            self._rest = None
        out = self._buf.view(self._shape)
        if out.device != self._device:
            out = out.to(self._device, non_blocking=True)
        return out


def _stage(x: torch.Tensor, mesh: SamplerMesh) -> torch.Tensor:
    """A flat copy of ``x`` on the collectives' device (they work in
    place): pinned host memory when ``x`` lies on a card and the
    collectives on the host."""
    if x.device == mesh.comm_device:
        return x.reshape(-1).clone()
    buf = torch.empty(x.numel(), dtype=x.dtype,
                      pin_memory=x.device.type == "cuda")
    buf.copy_(x.reshape(-1))
    return buf


def _reduce_scatter(out, inp, group, async_op):
    fn = getattr(dist, "reduce_scatter_single", None) or \
        dist.reduce_scatter_tensor
    return fn(out, inp, group=group, async_op=async_op)


def _all_gather(out, inp, group):
    fn = getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor
    return fn(out, inp, group=group)


def hierarchical_allreduce(x: torch.Tensor, mesh: SamplerMesh) -> Aggregation:
    """reduce_scatter over the local tier, all_reduce over the global
    tier, all_gather over the local tier: the sum over the mesh.

    The reduce_scatter tiles the flattened frame over the local tier, so
    its length must divide by the tier's size (``_pad_len`` pads a frame
    so).  Only that first stage is started here; ``wait()`` waits for
    it, then runs the all_reduce and the all_gather, each blocking, since
    each reads the stage before.  With no local axis it is the
    all_reduce over the global tier alone (nothing with no axis at
    all), as in the JAX package."""
    buf = _stage(x, mesh)
    if not mesh.local_axes:
        work = (dist.all_reduce(buf, group=mesh.global_group, async_op=True)
                if mesh.global_axes else None)
        return Aggregation(x, buf, work)
    if buf.numel() % mesh.local_size:
        raise ValueError(f"a frame of {buf.numel()} elements does not tile "
                         f"over the local tier's {mesh.local_size} ranks; "
                         "pad it (_pad_len)")
    part = torch.empty(buf.numel() // mesh.local_size, dtype=buf.dtype,
                       device=buf.device)
    work = _reduce_scatter(part, buf, mesh.local_group, async_op=True)

    def rest():
        if mesh.global_axes:
            dist.all_reduce(part, group=mesh.global_group)
        _all_gather(buf, part, mesh.local_group)

    return Aggregation(x, buf, work, rest)


def flat_allreduce(x: torch.Tensor, mesh: SamplerMesh) -> Aggregation:
    """One all_reduce over the whole mesh."""
    buf = _stage(x, mesh)
    return Aggregation(x, buf, dist.all_reduce(buf, group=mesh.group,
                                               async_op=True))


def reduce_to_root_and_broadcast(x: torch.Tensor,
                                 mesh: SamplerMesh) -> Aggregation:
    """The paper's reduce to rank 0, then its broadcast of the sum: the
    reduce is started here, ``wait()`` waits for it and runs the
    broadcast, blocking."""
    buf = _stage(x, mesh)
    work = dist.reduce(buf, dst=mesh.root, group=mesh.group, async_op=True)
    return Aggregation(x, buf, work, lambda: dist.broadcast(
        buf, src=mesh.root, group=mesh.group))


AGGREGATIONS = {"hierarchical": hierarchical_allreduce,
                "flat": flat_allreduce,
                "root": reduce_to_root_and_broadcast}


def allreduce_ints(values, mesh, op=dist.ReduceOp.SUM):
    """A started all_reduce of host ints over ``mesh``'s group (a
    :class:`SamplerMesh` or a ``GroupShardMesh``), as int64 on the
    collectives' device (nothing staged); ``wait()`` gives the (n,)
    tensor there."""
    t = torch.tensor(list(values), dtype=torch.int64,
                     device=mesh.comm_device)
    return Aggregation(t, t, dist.all_reduce(t, op=op, group=mesh.group,
                                             async_op=True))


def assert_replicated(mesh, values: dict) -> None:
    """Raise ``RuntimeError`` unless every rank of ``mesh`` (a
    :class:`SamplerMesh` or a ``GroupShardMesh``) holds the same int for
    each name of ``values``: one all_reduce of the max of (x, -x)."""
    names = list(values)
    got = allreduce_ints([*values.values(), *(-v for v in values.values())],
                         mesh, dist.ReduceOp.MAX).wait().tolist()
    n = len(names)
    differ = {k: (-got[n + i], got[i]) for i, k in enumerate(names)
              if got[i] != -got[n + i]}
    if differ:
        raise RuntimeError(f"the ranks of the {type(mesh).__name__} "
                           f"disagree on "
                           f"{differ} (min, max): a rank-dependent bit "
                           "would split their loops")
