"""What the sharded level call's grid order and padding cost on the card.

The sharded level (``frontier_expand_sharded_level``: one words pass over
the gathered values, one ``frontier_nb_kernel`` launch over a table of
edge blocks) is launched here straight through its C entry point with
other tables over the same layout, at one mid-BFS level, B=64, of R-MAT
2^20 x 30 in 8 shards at the card's blocking:

* ``real blocks, layout order``: the table as built (shard, then
  destination node block, then source block);
* ``real blocks, source-major in a shard``: (shard, source block,
  destination node block): blocks in flight share their source rows;
* ``real blocks, source-major``: (source block, shard, node block);
* ``every block``: the padding blocks too, as the per-shard route walks
  them.

Each is held bitwise against the table as built (the sums are exact
integers) and timed a call with CUDA events, beside the per-shard route's
8 calls.  Needs a CUDA card and nvcc:

    PYTHONPATH=src python tools/sharded_level_probe.py
"""
from __future__ import annotations

import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402
import repro_torch.core as tc  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.frontier import kernel as fk  # noqa: E402


def level(shards, table, fvals):
    rows, batch = fvals.shape
    words = torch.empty((rows, -(-batch // 32)), dtype=torch.int32,
                        device=fvals.device)
    out = torch.empty((shards.n_shards, shards.shard_rows, batch),
                      device=fvals.device)
    code = fk.library().frontier_nb_sharded_level_launch(
        shards.src.data_ptr(), shards.dst.data_ptr(),
        shards.block_nb.data_ptr(), table.data_ptr(), table.shape[0],
        fvals.data_ptr(), words.data_ptr(), out.data_ptr(), rows,
        shards.shard_rows, shards.n_shards, shards.n_edge_blocks,
        shards.block_e, shards.block_v, batch,
        _build.raw_stream(fvals.device))
    _build.check(code, "sharded level launch")
    return out


def order(table, *keys):
    """``table`` stably sorted by the keys, last key fastest."""
    key = torch.zeros_like(table, dtype=torch.int64)
    for k, span in keys:
        key = key * span + k
    return table[torch.sort(key, stable=True).indices]


def main() -> None:
    cs.phase_device()
    graph = tc.rmat_graph(cs.RMAT_SCALE, cs.EDGE_FACTOR, seed=cs.SEED,
                          device="cuda")
    pg = tc.partition_graph(graph, cs.SHARDS)
    shards = pg.shards
    dist, sigma, levels = cs.mid_bfs_state(graph, cs.BATCH)
    fvals = torch.zeros((pg.v_pad, cs.BATCH), device="cuda")
    fvals[: dist.shape[0]] = torch.where(dist == levels, sigma, 0.0)
    fdist = torch.where(fvals > 0, levels, -1).to(torch.int32)
    del dist, sigma
    real = shards.real_blocks()
    f = real.long()
    s = f // shards.n_edge_blocks
    sb = shards.block_sb.view(-1)[f].long()
    nb = shards.block_nb.view(-1)[f].long()
    n_sb = pg.v_pad // shards.block_v
    bps = shards.blocks_per_shard
    every = torch.arange(pg.n_shards * shards.n_edge_blocks,
                         dtype=torch.int32, device="cuda")
    tables = {
        "real blocks, layout order": real,
        "real blocks, source-major in a shard":
            order(real, (s, pg.n_shards), (sb, n_sb), (nb, bps)),
        "real blocks, source-major":
            order(real, (sb, n_sb), (s, pg.n_shards), (nb, bps)),
        "every block": every,
    }
    want = level(shards, real, fvals)
    torch.cuda.synchronize()
    views = [shards.shard(i) for i in range(pg.n_shards)]
    per_shard = cs.cuda_time_ms(lambda: [fk.frontier_expand_node_blocked(
        v, fdist, fvals, levels, wide_state=True) for v in views], 10)
    cs.log(f"R-MAT 2^{cs.RMAT_SCALE} x {cs.EDGE_FACTOR}, B={cs.BATCH}, "
           f"{pg.n_shards} shards: {real.shape[0]} real of {every.shape[0]} "
           f"edge blocks; the per-shard route's {pg.n_shards} calls "
           f"{per_shard:.3f} ms")
    for _ in range(2):    # two rounds: the spread of one call
        for name, table in tables.items():
            got = level(shards, table, fvals)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"{name}: not the level's bits")
            ms = cs.cuda_time_ms(lambda: level(shards, table, fvals), 20)
            cs.log(f"  {name:40s} {table.shape[0]:7d} blocks  {ms:.3f} ms "
                   "a level")


if __name__ == "__main__":
    main()
