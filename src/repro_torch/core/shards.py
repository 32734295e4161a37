"""The shard meshes of the sharded cooperative lane.

The JAX package runs each vertex shard on its own device inside
``shard_map`` and joins them with collectives.  Two meshes give the
port's sharded code (``core/bfs.py``, ``core/diameter.py``,
``core/sampler.py``) those collectives over a stack of shard slices,
the state's leading axis, with the same few methods:

* ``all_gather(x, tiled=True)`` -> ``all_gather``;
* ``psum`` / ``pmax`` / ``pmin`` -> ``psum`` / ``pmax`` / ``pmin`` (the
  replicated result, once);
* ``axis_index`` -> ``axis_index``, the held shards' global positions;
* ``lax.cond`` on a replicated predicate -> ``select``.

:class:`ShardMesh` holds all shards on one device: the sharded state is
one stacked tensor of shape ``(n_shards, shard_rows, B)``, its gathered
("wide") view the ``reshape(v_pad, B)`` of it, and each collective an
operation over the leading shard axis that moves nothing.  A shard's
local step is one operation over the whole stack, which gives the bits
of running it shard by shard (integer sums and float max are exact, and
the elementwise steps read no other shard).

:class:`GroupShardMesh` holds one shard a process of a
``torch.distributed`` group, as the reference holds one a device: the
stack has one row (this rank's shard), and each collective is one call
over the group: a tiled all_gather, or ``all_reduce`` with SUM,
MAX or MIN.  NCCL runs them on the card; gloo on the host, a tensor on
the card staged through pinned host buffers kept from call to call
(the plan fixes their sizes).  The mesh tallies each collective's
calls, bytes sent, bytes staged and host seconds under the name its
caller gives (:meth:`GroupShardMesh.traffic`).
"""
from __future__ import annotations

import time

import torch
import torch.distributed as dist

from ..device import DEFAULT_DEVICE, resolve_device

__all__ = ["GroupShardMesh", "SHARD_MESHES", "ShardMesh",
           "canonical_device"]


def canonical_device(device) -> torch.device:
    """``device`` resolved (raising without a card, as every entry point)
    and with a CUDA index: ``"cuda"`` names the current card."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class ShardMesh:
    """``n_shards`` vertex shards held on one ``device``."""

    def __init__(self, n_shards: int, device=DEFAULT_DEVICE):
        if int(n_shards) < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        self.n_shards = int(n_shards)
        self.device = canonical_device(device)

    def check(self, pg) -> None:
        """Raise ``ValueError`` unless ``pg`` holds all of this mesh's
        shards and lies on its device (nothing moves between
        devices)."""
        _check_count(pg, self.n_shards)
        if pg.shards.n_local_shards != self.n_shards:
            raise ValueError(
                f"the PartitionedGraph holds {pg.shards.n_local_shards} of "
                f"its {pg.n_shards} shards (a process's local partition); a "
                "ShardMesh holds them all: build it without shard=")
        _check_device(pg, self.device)

    def axis_index(self) -> torch.Tensor:
        """(S,) int64: each shard's position on the mesh axis."""
        return torch.arange(self.n_shards, device=self.device)

    # ``what`` names the collective for a GroupShardMesh's tally; nothing
    # moves here

    def all_gather(self, x: torch.Tensor, what: str = "gather"
                   ) -> torch.Tensor:
        """Tiled gather of the per-shard blocks (S, n, ...) -> (S * n,
        ...): a view, no copy."""
        return x.reshape(x.shape[0] * x.shape[1], *x.shape[2:])

    def psum(self, x: torch.Tensor, what: str = "reduce") -> torch.Tensor:
        """Sum over the shards, in x's own type (exact for integers)."""
        return x.sum(dim=0, dtype=x.dtype)

    def pmax(self, x: torch.Tensor, what: str = "reduce") -> torch.Tensor:
        return x.amax(dim=0)

    def pmin(self, x: torch.Tensor, what: str = "reduce") -> torch.Tensor:
        return x.amin(dim=0)

    @staticmethod
    def select(pred: torch.Tensor, if_true, if_false) -> torch.Tensor:
        """``lax.cond`` on the replicated 0-d ``pred``: both branches are
        built and the pick stays on the device, so no host round trip
        splits the level (nothing crosses a wire here)."""
        return torch.where(pred, if_true(), if_false())


def _check_count(pg, n_shards: int) -> None:
    if pg.n_shards != n_shards:
        raise ValueError(
            f"PartitionedGraph carries {pg.n_shards} shards but the mesh "
            f"has {n_shards}; rebuild with partition_graph(graph, "
            f"{n_shards})")


def _check_device(pg, device: torch.device) -> None:
    if canonical_device(pg.device) != device:
        raise ValueError(f"the PartitionedGraph lies on {pg.device} but the "
                         f"mesh on {device}; move one of them")


_REDUCE_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
               "min": dist.ReduceOp.MIN}


def _all_gather_into(out: torch.Tensor, inp: torch.Tensor, group) -> None:
    fn = getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor
    fn(out, inp, group=group)


class GroupShardMesh:
    """One vertex shard a process: the shard count is the size of a
    ``torch.distributed`` group (the default one, or ``group``), and
    this rank holds shard ``rank``.  Built on every rank after
    ``init_process_group``.

    The collectives take the local stack, leading axis 1 (this rank's
    shard), and give what :class:`ShardMesh` gives for the whole stack,
    on every rank.  ``device`` is this rank's device; the collectives
    run on ``comm_device``: the card under NCCL, the host under gloo.
    Every rank must call every collective, in the same order: a loop
    test or protocol pick that reads anything but replicated values
    would leave a rank waiting in a collective that the others skipped.
    """

    def __init__(self, device=DEFAULT_DEVICE, group=None):
        if not dist.is_available() or not dist.is_initialized():
            raise RuntimeError("build a GroupShardMesh after "
                               "torch.distributed.init_process_group")
        self.group = group
        self.n_shards = dist.get_world_size(group)
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
        # the global rank of the group's rank 0 (a broadcast's source)
        self.root = 0 if group is None else dist.get_global_rank(group, 0)
        self._pinned: dict = {}
        self._traffic: dict = {}

    @property
    def staged(self) -> bool:
        """Whether a tensor on this rank's device is copied to the host
        for each collective (gloo with a card)."""
        return self.comm_device != self.device

    def check(self, pg) -> None:
        """Raise ``ValueError`` unless ``pg`` is cut into this group's
        shard count, holds this rank's shard alone
        (``partition_graph(graph, S, shard=rank)``) and lies on the
        mesh's device."""
        _check_count(pg, self.n_shards)
        lay = pg.shards
        if lay.n_local_shards != 1 or lay.first_shard != self.rank:
            raise ValueError(
                f"rank {self.rank} must hold its own shard alone, but the "
                f"PartitionedGraph holds shards {lay.first_shard} .. "
                f"{lay.first_shard + lay.n_local_shards - 1}; build it "
                f"with partition_graph(graph, {self.n_shards}, "
                f"shard={self.rank})")
        _check_device(pg, self.device)

    def axis_index(self) -> torch.Tensor:
        """(1,) int64: this rank's shard."""
        return torch.tensor([self.rank], device=self.device)

    def traffic(self, reset: bool = False) -> dict:
        """{name: {"calls", "sent_bytes", "staged_bytes", "seconds"}}
        since the last reset, by the name each collective was called
        with: ``sent_bytes`` what this rank put into the collectives,
        ``staged_bytes`` the copies to the host and back, ``seconds``
        the host time of the calls, staging included (a staged call
        first waits for the card's earlier work, outside its time)."""
        out = {k: dict(v) for k, v in self._traffic.items()}
        if reset:
            self._traffic = {}
        return out

    def _tally(self, what: str, sent: int, staged: int, t0: float) -> None:
        rec = self._traffic.setdefault(what, {"calls": 0, "sent_bytes": 0,
                                              "staged_bytes": 0,
                                              "seconds": 0.0})
        rec["calls"] += 1
        rec["sent_bytes"] += sent
        rec["staged_bytes"] += staged
        rec["seconds"] += time.perf_counter() - t0

    def _buffer(self, role: str, shape, dtype) -> torch.Tensor:
        """A pinned host buffer, made on first use and kept: a run's
        collectives repeat a few shapes, fixed by its plan and B."""
        key = (role, tuple(shape), dtype)
        buf = self._pinned.get(key)
        if buf is None:
            buf = torch.empty(shape, dtype=dtype, pin_memory=True)
            self._pinned[key] = buf
        return buf

    def _start(self) -> float:
        if self.staged:
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def all_gather(self, x: torch.Tensor, what: str = "gather"
                   ) -> torch.Tensor:
        """Tiled gather over the ranks: this rank's (1, n, ...) block ->
        the (S * n, ...) blocks of every rank, rank order, on every
        rank."""
        if x.shape[0] != 1:
            raise ValueError(f"a GroupShardMesh holds one shard a rank; got "
                             f"a stack of {x.shape[0]}")
        t0 = self._start()
        part = x[0].contiguous()
        shape = (self.n_shards * part.shape[0], *part.shape[1:])
        nbytes = part.numel() * part.element_size()
        if not self.staged:
            out = torch.empty(shape, dtype=part.dtype, device=part.device)
            _all_gather_into(out, part, self.group)
            self._tally(what, nbytes, 0, t0)
            return out
        inp = self._buffer("in", part.shape, part.dtype)
        host = self._buffer("out", shape, part.dtype)
        inp.copy_(part)
        _all_gather_into(host, inp, self.group)
        # a blocking copy: the buffer is refilled by the next call
        out = host.to(self.device)
        self._tally(what, nbytes, nbytes * (1 + self.n_shards), t0)
        return out

    def _reduce(self, x: torch.Tensor, op: str, what: str) -> torch.Tensor:
        if x.shape[0] != 1:
            raise ValueError(f"a GroupShardMesh holds one shard a rank; got "
                             f"a stack of {x.shape[0]}")
        t0 = self._start()
        part = x[0]
        nbytes = part.numel() * part.element_size()
        if not self.staged:
            out = part.clone()
            dist.all_reduce(out, op=_REDUCE_OPS[op], group=self.group)
            self._tally(what, nbytes, 0, t0)
            return out
        host = self._buffer("reduce", part.shape, part.dtype)
        host.copy_(part)
        dist.all_reduce(host, op=_REDUCE_OPS[op], group=self.group)
        out = host.to(self.device)
        self._tally(what, nbytes, 2 * nbytes, t0)
        return out

    def psum(self, x: torch.Tensor, what: str = "reduce") -> torch.Tensor:
        """Sum over the ranks, in x's own type (exact for integers)."""
        return self._reduce(x, "sum", what)

    def pmax(self, x: torch.Tensor, what: str = "reduce") -> torch.Tensor:
        return self._reduce(x, "max", what)

    def pmin(self, x: torch.Tensor, what: str = "reduce") -> torch.Tensor:
        return self._reduce(x, "min", what)

    @staticmethod
    def select(pred: torch.Tensor, if_true, if_false) -> torch.Tensor:
        """``lax.cond`` on the replicated 0-d ``pred``, read on the host
        (the same on every rank): only the chosen branch runs, so only
        its collectives cross the wire."""
        return if_true() if bool(pred) else if_false()


# the meshes the sharded lane runs on
SHARD_MESHES = (ShardMesh, GroupShardMesh)
