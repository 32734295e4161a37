"""The shard mesh of the sharded cooperative lane, on one device.

The JAX package runs each vertex shard on its own device inside
``shard_map`` and joins them with collectives.  Here all shards lie on
one device: the sharded state is one stacked tensor of shape
``(n_shards, shard_rows, B)``, and its gathered ("wide") view is the
``reshape(v_pad, B)`` of it.  Each collective the reference uses has one
counterpart, an operation over the leading shard axis:

* ``all_gather(x, tiled=True)`` -> :meth:`ShardMesh.all_gather`;
* ``psum`` / ``pmax`` / ``pmin`` -> :meth:`psum` / :meth:`pmax` /
  :meth:`pmin` (the replicated result, once);
* ``axis_index`` -> :meth:`axis_index`, each shard's position.

These are the only places where shards meet; a shard's local step is one
operation over the whole stack, which gives the bits of running it shard
by shard (integer sums and float max are exact, and the elementwise steps
read no other shard).  Nothing here leaves the device.  A later transport
over ``torch.distributed`` (ROADMAP §1 item 11b) puts a process group
behind the same few methods.
"""
from __future__ import annotations

import torch

from ..device import DEFAULT_DEVICE, resolve_device

__all__ = ["ShardMesh", "canonical_device"]


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
        """Raise ``ValueError`` unless ``pg`` has this mesh's shard count
        and lies on its device (nothing moves between devices)."""
        if pg.n_shards != self.n_shards:
            raise ValueError(
                f"PartitionedGraph carries {pg.n_shards} shards but the "
                f"mesh has {self.n_shards}; rebuild with "
                f"partition_graph(graph, {self.n_shards})")
        if canonical_device(pg.device) != self.device:
            raise ValueError(f"the PartitionedGraph lies on {pg.device} but "
                             f"the mesh on {self.device}; move one of them")

    def axis_index(self) -> torch.Tensor:
        """(S,) int64: each shard's position on the mesh axis."""
        return torch.arange(self.n_shards, device=self.device)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Tiled gather of the per-shard blocks (S, n, ...) -> (S * n,
        ...): a view, no copy."""
        return x.reshape(x.shape[0] * x.shape[1], *x.shape[2:])

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """Sum over the shards, in x's own type (exact for integers)."""
        return x.sum(dim=0, dtype=x.dtype)

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        return x.amax(dim=0)

    def pmin(self, x: torch.Tensor) -> torch.Tensor:
        return x.amin(dim=0)
