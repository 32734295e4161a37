"""The port's CUDA kernels against their plain versions, on the card.

Run on a machine with a card:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_kernels_gpu.py

Without a card every test skips (the ``cuda`` fixture decides at run
time, so every worker collects the same tests).  This file imports
torch and the port only, so it runs where JAX is not installed.
"""
import dataclasses
import time

import pytest
import torch

import repro_torch.core as tc
from repro_torch.kernels import flashattn as fa
from repro_torch.kernels import frontier as tf
from repro_torch.kernels import segsum as tk
from repro_torch.kernels import stopcheck as ts

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    # the plain versions' float32 products in full float32 (PyTorch's
    # default for matmul, not for cuDNN): a TF32 plain route would sit
    # ~1e-3 from the float32 kernels it is held against
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    return torch.device("cuda")


def _state(graph, batch, seed=0):
    gen = torch.Generator(device=graph.device).manual_seed(seed)
    sources = torch.randint(0, graph.n_nodes, (batch,), generator=gen,
                            device=graph.device, dtype=torch.int32)
    res = tc.bfs_sssp_batched(graph, sources)
    return res.dist, res.sigma, (res.levels // 2).to(torch.int32)


@pytest.mark.parametrize("batch", [1, 5, 8, 64])
def test_flat_kernel_matches_plain(cuda, batch):
    """The pull at an R-MAT mid level (its hubs cut into items), one
    words launch and one pull launch, bitwise on exact integer sums."""
    graph = tc.rmat_graph(12, 16, seed=1, device=cuda)
    dist, sigma, levels = _state(graph, batch)
    plan = graph.pull_plan()
    assert plan.n_items > 0
    before = dict(tf.launch_counts)
    got = tf.frontier_expand_flat(graph.src, graph.dst, dist, sigma, levels,
                                  plan)
    want = tf.frontier_expand_batched_ref(graph.src, graph.dst, dist, sigma,
                                          levels)
    torch.cuda.synchronize()
    assert tf.launch_counts[tf.FLAT] == before[tf.FLAT] + 1
    assert tf.launch_counts[tf.WORDS] == before[tf.WORDS] + 1
    assert want.max() < 2 ** 24        # exact integer sums: bitwise
    assert torch.equal(got, want)


def _star(leaves, device):
    """A hub (vertex 0) with ``leaves`` neighbours."""
    ids = torch.arange(1, leaves + 1)
    return tc.from_edge_list(torch.stack([torch.zeros_like(ids), ids], 1),
                             leaves + 1, device=device)


@pytest.mark.parametrize("batch", [1, 8, 33, 64, 96])
@pytest.mark.parametrize("split", [tf.PULL_SPLIT, 5])
def test_pull_kernel_at_every_width(cuda, batch, split):
    """B = 1 .. 96 (W = 1, 2, 3 frontier words; 1 or 4 columns a lane),
    with rows past the plan's (padding, dist -3) that must come out zero
    whatever the fresh output held."""
    graph = tc.rmat_graph(10, 8, seed=4, device=cuda)
    dist, sigma, levels = _state(graph, batch, seed=batch)
    dist = torch.cat([dist, dist.new_full((7, batch), -3)]).contiguous()
    sigma = torch.cat([sigma, sigma.new_full((7, batch), 5.0)]).contiguous()
    plan = tf.build_pull_plan(graph.src, graph.dst, graph.n_nodes + 1,
                              split=split)
    torch.full((4 * dist.numel(),), 7.0, device=cuda)   # dirty the cache
    got = tf.frontier_expand_flat(graph.src, graph.dst, dist, sigma, levels,
                                  plan)
    want = tf.frontier_expand_batched_ref(graph.src, graph.dst, dist, sigma,
                                          levels)
    torch.cuda.synchronize()
    assert want.max() < 2 ** 24 and bool(want.any())
    assert torch.equal(got, want)
    assert not bool(got[graph.n_nodes:].any())


@pytest.mark.parametrize("batch,split", [(64, tf.PULL_SPLIT), (33, 5),
                                         (8, 3)])
def test_pull_kernel_adds_in_the_plain_pull_order(cuda, batch, split):
    """On non-integer sigma two launches give the same bits, and those of
    the pull's plain version on the CPU, whose index_add_ adds in the
    kernel's order (each row's sources in plan order, a split row's
    partials in item order)."""
    graph = tc.rmat_graph(11, 8, seed=6, device=cuda)
    dist, sigma, levels = _state(graph, batch, seed=split)
    gen = torch.Generator(device=cuda).manual_seed(split)
    sigma = (sigma * (0.5 + torch.rand(sigma.shape, generator=gen,
                                       device=cuda))).contiguous()
    plan = tf.build_pull_plan(graph.src, graph.dst, graph.n_nodes + 1,
                              split=split)
    assert plan.n_items > 0
    a = tf.frontier_expand_flat(graph.src, graph.dst, dist, sigma, levels,
                                plan)
    b = tf.frontier_expand_flat(graph.src, graph.dst, dist, sigma, levels,
                                plan)
    cpu = graph.to("cpu")
    want = tf.frontier_pull_ref(
        tf.build_pull_plan(cpu.src, cpu.dst, cpu.n_nodes + 1, split=split),
        dist.cpu(), sigma.cpu(), levels.cpu())
    torch.cuda.synchronize()
    assert not torch.equal(want, torch.round(want))
    assert torch.equal(a, b)
    assert torch.equal(a.cpu(), want)


def test_pull_kernel_combines_a_hub(cuda):
    """A hub over ``split`` in-edges goes through the combine kernel: its
    row is the sum of its items' partial rows."""
    from torch.profiler import ProfilerActivity, profile
    graph = _star(3 * tf.PULL_SPLIT + 17, cuda)
    plan = graph.pull_plan()
    assert plan.n_items == 4 and plan.split_seg.tolist() == [0]
    dist, sigma, _ = _state(graph, 8)
    levels = torch.ones(8, dtype=torch.int32, device=cuda)
    levels[:2] = 0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        got = tf.frontier_expand_flat(graph.src, graph.dst, dist, sigma,
                                      levels, plan)
        torch.cuda.synchronize()
    names = [evt.key for evt in prof.key_averages()]
    assert any("frontier_pull_combine_kernel" in n for n in names), names
    want = tf.frontier_expand_batched_ref(graph.src, graph.dst, dist, sigma,
                                          levels)
    assert torch.equal(got, want) and bool(want[0].any())


@pytest.mark.parametrize("block_v,block_e,padded", [
    (256, 512, False), (None, None, True), (100, 128, True)])
def test_node_blocked_kernel_matches_plain(cuda, block_v, block_e, padded):
    graph = tc.rmat_graph(12, 16, seed=2, device=cuda)
    csc = tc.build_csc_layout(graph, block_v=block_v, block_e=block_e)
    dist, sigma, levels = _state(graph, 8, seed=3)
    if padded:
        extra = csc.v_pad - dist.shape[0]
        dist = torch.cat([dist, dist.new_full((extra, 8), -3)])
        sigma = torch.cat([sigma, sigma.new_zeros((extra, 8))])
    got = tf.frontier_expand_node_blocked(csc, dist, sigma, levels)
    want = tf.frontier_expand_node_blocked_ref(csc, dist, sigma, levels)
    torch.cuda.synchronize()
    assert got.shape == dist.shape
    assert torch.equal(got, want)


@pytest.mark.parametrize("batch", [1, 5, 8, 64, 65])
def test_node_blocked_kernel_matches_plain_at_every_width(cuda, batch):
    """B divides 32, 32 divides B, and neither (the words kernel's two
    routes; one and three words a row): bitwise, two launches a level."""
    graph = tc.rmat_graph(11, 16, seed=4, device=cuda)
    csc = tc.build_csc_layout(graph, block_v=512, block_e=256)
    dist, sigma, levels = _state(graph, batch, seed=batch)
    tf.reset_launch_counts()
    got = tf.frontier_expand_node_blocked(csc, dist, sigma, levels)
    want = tf.frontier_expand_node_blocked_ref(csc, dist, sigma, levels)
    torch.cuda.synchronize()
    assert tf.launch_counts == {tf.FLAT: 0, tf.NODE_BLOCKED: 1,
                                tf.NODE_BLOCKED_WIDE: 0, tf.WORDS: 1}
    assert want.max() < 2 ** 24 and torch.equal(got, want)


def test_node_blocked_kernel_without_frontier(cuda):
    """No row on any frontier: every edge block skips itself and the
    output is the words pass's zeros."""
    graph = tc.rmat_graph(10, 8, seed=5, device=cuda)
    csc = tc.build_csc_layout(graph, block_v=256, block_e=128)
    dist, sigma, _ = _state(graph, 8)
    levels = torch.full((8,), 10 ** 6, dtype=torch.int32, device=cuda)
    got = tf.frontier_expand_node_blocked(csc, dist, sigma, levels)
    torch.cuda.synchronize()
    assert got.shape == dist.shape and not bool(got.any())


def test_node_blocked_kernel_with_every_block_active(cuda):
    """Every real row on every frontier (dist 0 at level 0), so every
    edge block that holds a real edge is active: bitwise (integer
    sigma, sums below 2^24)."""
    graph = tc.rmat_graph(10, 8, seed=6, device=cuda)
    csc = tc.build_csc_layout(graph, block_v=256, block_e=128)
    gen = torch.Generator().manual_seed(6)
    sigma = torch.randint(1, 100, (graph.n_nodes + 1, 8), generator=gen
                          ).float().to(cuda)
    dist = torch.full((graph.n_nodes + 1, 8), 0, dtype=torch.int32,
                      device=cuda)
    dist[graph.n_nodes] = -3
    levels = torch.zeros(8, dtype=torch.int32, device=cuda)
    real = (csc.src.view(csc.n_edge_blocks, csc.block_e)
            < graph.n_nodes).any(dim=1)
    assert bool(real.sum() > 1)
    assert torch.equal(tf.frontier_block_bitmap(csc, dist, levels).bool(),
                       real)
    got = tf.frontier_expand_node_blocked(csc, dist, sigma, levels)
    want = tf.frontier_expand_node_blocked_ref(csc, dist, sigma, levels)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("batch", [8, 65])
def test_node_blocked_kernel_on_hubs(cuda, batch):
    """Two hubs joined to every other vertex: every edge block sees its
    destinations repeat, so it sorts its edges by destination and sums
    each hub's edges before one atomic (float4 and scalar columns)."""
    n = 3000
    rest = torch.arange(2, n)
    edges = torch.cat([torch.stack([torch.zeros_like(rest), rest], 1),
                       torch.stack([torch.ones_like(rest), rest], 1)])
    graph = tc.from_edge_list(edges, n, device=cuda)
    csc = tc.build_csc_layout(graph, block_v=512, block_e=1024)
    gen = torch.Generator().manual_seed(batch)
    dist = torch.randint(0, 2, (n + 1, batch), generator=gen,
                         dtype=torch.int32).to(cuda)
    dist[n] = -3
    sigma = torch.randint(1, 50, (n + 1, batch), generator=gen).float().to(
        cuda)
    levels = torch.ones(batch, dtype=torch.int32, device=cuda)
    got = tf.frontier_expand_node_blocked(csc, dist, sigma, levels)
    want = tf.frontier_expand_node_blocked_ref(csc, dist, sigma, levels)
    torch.cuda.synchronize()
    assert want[:2].max() < 2 ** 24 and bool(want[:2].min() > 0)
    assert torch.equal(got, want)


def test_node_blocked_kernel_with_wide_node_blocks(cuda):
    """Node blocks of 2^21 rows leave the sort key no room: the edge
    blocks walk their edges unsorted, with the same result."""
    graph = tc.rmat_graph(10, 8, seed=7, device=cuda)
    csc = tc.build_csc_layout(graph, block_v=1 << 21, block_e=1024)
    dist, sigma, levels = _state(graph, 8, seed=7)
    extra = csc.v_pad - dist.shape[0]
    dist = torch.cat([dist, dist.new_full((extra, 8), -3)])
    sigma = torch.cat([sigma, sigma.new_zeros((extra, 8))])
    got = tf.frontier_expand_node_blocked(csc, dist, sigma, levels)
    want = tf.frontier_expand_node_blocked_ref(csc, dist, sigma, levels)
    torch.cuda.synchronize()
    assert want.max() < 2 ** 24 and torch.equal(got, want)


@pytest.mark.parametrize("batch", [1, 5, 8, 31, 32, 33, 64, 65])
def test_words_kernel_matches_plain(cuda, batch):
    """The frontier words bitwise against their plain version, and the
    output it zeroes."""
    gen = torch.Generator().manual_seed(batch)
    dist = torch.randint(-3, 4, (1000, batch), generator=gen,
                         dtype=torch.int32).to(cuda)
    levels = torch.randint(0, 3, (batch,), generator=gen,
                           dtype=torch.int32).to(cuda)
    before = tf.launch_counts[tf.WORDS]
    words, out = tf.frontier_words(dist, levels)
    torch.cuda.synchronize()
    assert tf.launch_counts[tf.WORDS] == before + 1
    assert torch.equal(words, tf.frontier_words_ref(dist, levels))
    assert out.shape == dist.shape and not bool(out.any())


def test_dispatcher_routes_cuda_state_to_kernels(cuda):
    graph = tc.grid_graph(20, 20, device=cuda)
    dist, sigma, levels = _state(graph, 4)
    tf.reset_launch_counts()
    tf.frontier_expand(graph.src, graph.dst, dist, sigma, levels)
    csc = tc.build_csc_layout(graph, block_v=128, block_e=256)
    tf.frontier_expand(graph.src, graph.dst, dist, sigma, levels, csc=csc)
    # each route's level starts with a words pass
    assert tf.launch_counts == {tf.FLAT: 1, tf.NODE_BLOCKED: 1,
                                tf.NODE_BLOCKED_WIDE: 0, tf.WORDS: 2}
    with pytest.raises(ValueError, match="CPU tensors"):
        tf.frontier_expand(graph.src, graph.dst, dist, sigma, levels,
                           lane="ref")


def test_run_kadabra_on_the_card(cuda):
    graph = tc.hyperbolic_graph(300, 20.0, seed=1, device=cuda)
    tf.reset_launch_counts()
    ts.reset_launch_counts()
    res = tc.run_kadabra(graph, eps=0.05, device=cuda)
    assert tf.launch_counts[tf.FLAT] == tf.launch_counts[tf.WORDS] \
        == res.bfs_levels > 0
    assert tf.launch_counts[tf.NODE_BLOCKED] == 0
    assert ts.launch_counts[ts.STOPCHECK] == res.n_epochs > 0
    import numpy as np
    assert np.abs(res.btilde - tc.brandes_numpy(graph)).max() < 0.05


# ---------------------------------------------------------------------------
# K2's wide_state mode (the sharded lane)
# ---------------------------------------------------------------------------

_SHARDED = {
    # name: (graph, n_shards, block_v, block_e)
    "rmat": (lambda dev: tc.rmat_graph(14, 16, seed=3, device=dev), 8, 1024,
             1024),
    "grid": (lambda dev: tc.grid_graph(64, 8, device=dev), 8, 64, 128),
}


def _wide_state(graph, pg, batch, seed):
    """A mid-BFS level as the sharded lane hands it to each shard: the
    masked frontier values over the global rows and their synthesized
    dist."""
    dist, sigma, levels = _state(graph, batch, seed=seed)
    fvals = torch.zeros((pg.v_pad, batch), device=dist.device)
    fvals[: dist.shape[0]] = torch.where(dist == levels, sigma, 0.0)
    fdist = torch.where(fvals > 0, levels, -1).to(torch.int32)
    return fdist, fvals, levels


@pytest.mark.parametrize("name,batch", [("rmat", 64), ("rmat", 5),
                                        ("grid", 8), ("grid", 65)])
def test_wide_kernel_matches_plain_on_every_shard(cuda, name, batch):
    """Every shard's wide call against the plain version, bitwise on
    integer sigma, one wide launch and one words pass a shard; the
    shards' tiles together are the replicated level's rows."""
    make, n_shards, block_v, block_e = _SHARDED[name]
    graph = make(cuda)
    pg = tc.partition_graph(graph, n_shards, block_v=block_v,
                            block_e=block_e)
    fdist, fvals, levels = _wide_state(graph, pg, batch, seed=batch)
    tf.reset_launch_counts()
    tiles = []
    for s in range(n_shards):
        view = pg.shards.shard(s)
        got = tf.frontier_expand_node_blocked(view, fdist, fvals, levels,
                                              wide_state=True)
        want = tf.frontier_expand_sharded_ref(view, fdist, fvals, levels)
        torch.cuda.synchronize()
        assert got.shape == (pg.shard_rows, batch)
        assert want.max() < 2 ** 24 and torch.equal(got, want)
        tiles.append(got)
    assert tf.launch_counts == {tf.FLAT: 0, tf.NODE_BLOCKED: 0,
                                tf.NODE_BLOCKED_WIDE: n_shards,
                                tf.WORDS: n_shards}
    whole = tf.frontier_expand_batched_ref(graph.src, graph.dst, fdist,
                                           fvals, levels)
    assert torch.equal(torch.cat(tiles), whole)


def test_wide_kernel_leaves_canary_rows(cuda):
    """A layout whose destinations point past the tile (frontier sources
    included) writes nothing there: canary rows past out_rows keep their
    value, and the tile is the plain sum without those edges."""
    graph = tc.grid_graph(64, 8, device=cuda)
    pg = tc.partition_graph(graph, 4, block_v=64, block_e=128)
    fdist, fvals, levels = _wide_state(graph, pg, 8, seed=2)
    view = pg.shards.shard(1)
    rows = view.v_pad
    hit = (fdist[view.src.long()] == levels).any(dim=1)
    bad = torch.nonzero(hit)[:, 0][::3]
    assert bad.numel() > 4
    dst = view.dst.clone()
    dst[bad] = (rows + torch.arange(bad.numel(), device=cuda) % 4).to(
        torch.int32)
    broken = tc.CSCLayout(**{**view.__dict__, "dst": dst})
    kept = tc.CSCLayout(**{**view.__dict__, "src": view.src.clone()})
    kept.src[bad] = graph.n_nodes
    canary = 7.0
    out = torch.full((rows + 4, 8), canary, device=cuda)
    words = torch.empty((fdist.shape[0], 1), dtype=torch.int32, device=cuda)
    code = tf.kernel.library().frontier_nb_wide_launch(
        broken.src.data_ptr(), broken.dst.data_ptr(),
        broken.block_nb.data_ptr(), fdist.data_ptr(), levels.data_ptr(),
        fvals.data_ptr(), words.data_ptr(), out.data_ptr(), fdist.shape[0],
        rows, broken.n_edge_blocks, broken.block_e, broken.block_v, 8,
        torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert code == 0
    assert bool((out[rows:] == canary).all())
    want = tf.frontier_expand_sharded_ref(kept, fdist, fvals, levels)
    assert torch.equal(out[:rows], want)


def _exact_equal(got, want):
    """Bitwise where the plain value is an exact integer below 2^24,
    within rtol 1e-6 elsewhere (atomics add in a varying order)."""
    exact = (want < 2 ** 24) & (want == torch.round(want))
    assert torch.equal(got[exact], want[exact])
    gap = (got[~exact] - want[~exact]).abs()
    assert bool((gap <= 1e-6 * want[~exact].abs()).all())


@pytest.mark.parametrize("name,batch", [("rmat", 64), ("rmat", 5),
                                        ("grid", 8), ("grid", 65)])
def test_sharded_level_kernel_matches_plain(cuda, name, batch):
    """The sharded level call (one words pass over the gathered values,
    one node-blocked launch over the real blocks) against its plain
    version, bitwise where the sums are exact, one wide launch and one
    words pass for the whole level; each shard's tile is also the
    per-shard wide kernel's."""
    make, n_shards, block_v, block_e = _SHARDED[name]
    graph = make(cuda)
    pg = tc.partition_graph(graph, n_shards, block_v=block_v,
                            block_e=block_e)
    fdist, fvals, levels = _wide_state(graph, pg, batch, seed=batch)
    tf.reset_launch_counts()
    got = tf.frontier_expand_sharded_level(pg.shards, fvals, levels)
    torch.cuda.synchronize()
    assert tf.launch_counts == {tf.FLAT: 0, tf.NODE_BLOCKED: 0,
                                tf.NODE_BLOCKED_WIDE: 1, tf.WORDS: 1}
    want = tf.frontier_expand_sharded_level_ref(pg.shards, fvals, levels)
    assert got.shape == (n_shards, pg.shard_rows, batch)
    _exact_equal(got, want)
    assert bool(want.any())
    for s in range(n_shards):
        tile = tf.frontier_expand_node_blocked(pg.shards.shard(s), fdist,
                                               fvals, levels,
                                               wide_state=True)
        _exact_equal(got[s], tile)
    real = pg.shards.real_blocks()
    assert 0 < real.shape[0] <= n_shards * pg.shards.n_edge_blocks


@pytest.mark.parametrize("name", ["rmat", "grid"])
def test_sharded_level_kernel_on_one_rank_shard(cuda, name):
    """A local layout (one process's shard, ``partition_graph(...,
    shard=s)``): one words pass and one launch over that shard's real
    blocks into its (1, shard_rows, B) tile, which is row s of the whole
    layout's call (same gathered values, global source ids)."""
    make, n_shards, block_v, block_e = _SHARDED[name]
    graph = make(cuda)
    pg = tc.partition_graph(graph, n_shards, block_v=block_v,
                            block_e=block_e)
    _fdist, fvals, levels = _wide_state(graph, pg, 64, seed=3)
    whole = tf.frontier_expand_sharded_level_ref(pg.shards, fvals, levels)
    for s in (0, n_shards - 1):
        local = tc.partition_graph(graph, n_shards, block_v=block_v,
                                   block_e=block_e, shard=s)
        tf.reset_launch_counts()
        got = tf.frontier_expand_sharded_level(local.shards, fvals, levels)
        torch.cuda.synchronize()
        assert tf.launch_counts == {tf.FLAT: 0, tf.NODE_BLOCKED: 0,
                                    tf.NODE_BLOCKED_WIDE: 1, tf.WORDS: 1}
        assert got.shape == (1, pg.shard_rows, 64)
        _exact_equal(got[0], whole[s])


def test_sharded_level_kernel_leaves_the_next_tile_and_canary_rows(cuda):
    """Shards whose destinations point past their tile (frontier sources
    included): shard 1's would land in shard 2's tile, the last shard's
    past the stack.  The range check keeps both out: shard 2's tile and
    the canary rows past the stack keep what they should, and the stack
    is the plain sum without those edges."""
    graph = tc.grid_graph(64, 8, device=cuda)
    pg = tc.partition_graph(graph, 3, block_v=64, block_e=128)
    # three quarters of the rows on every sample's frontier, integer
    # values: exact sums
    gen = torch.Generator().manual_seed(2)
    fvals = torch.zeros((pg.v_pad, 8))
    fvals[:graph.n_nodes] = torch.randint(0, 4, (graph.n_nodes, 8),
                                          generator=gen).float()
    fvals = fvals.to(cuda)
    levels = torch.zeros(8, dtype=torch.int32, device=cuda)
    shards = pg.shards
    rows = shards.shard_rows
    dst, src = shards.dst.clone(), shards.src.clone()
    for s in (1, shards.n_shards - 1):
        hit = (fvals[shards.src[s].long()] > 0).any(dim=1)
        bad = torch.nonzero(hit)[:, 0][::3]
        assert bad.numel() > 4
        dst[s, bad] = (rows + torch.arange(bad.numel(), device=cuda) % 4).to(
            torch.int32)
        src[s, bad] = graph.n_nodes
    broken = dataclasses.replace(shards, dst=dst, _cache={})
    kept = dataclasses.replace(shards, src=src, _cache={})
    canary = 7.0
    stack = shards.n_shards * rows
    out = torch.full((stack + 4, 8), canary, device=cuda)
    words = torch.empty((fvals.shape[0], 1), dtype=torch.int32, device=cuda)
    real = broken.real_blocks()
    code = tf.kernel.library().frontier_nb_sharded_level_launch(
        broken.src.data_ptr(), broken.dst.data_ptr(),
        broken.block_nb.data_ptr(), real.data_ptr(), real.shape[0],
        fvals.data_ptr(), words.data_ptr(), out.data_ptr(), fvals.shape[0],
        rows, broken.n_shards, broken.n_edge_blocks, broken.block_e,
        broken.block_v, 8, torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert code == 0
    assert bool((out[stack:] == canary).all())
    want = tf.frontier_expand_sharded_level_ref(kept, fvals, levels)
    assert torch.equal(out[:stack].view(want.shape), want)
    assert bool(want[2].any())


def test_sharded_lane_launches_the_level_kernel_once_a_level(cuda):
    """The sharded BFS, bidirectional search and run_kadabra on the card:
    every level one sharded level launch (and one words pass) for all
    shards, no flat or replicated node-blocked launch; the BFS gives the
    replicated bits."""
    graph = tc.grid_graph(32, 16, device=cuda)
    pg = tc.partition_graph(graph, 4, block_v=64, block_e=128)
    mesh = tc.ShardMesh(4, cuda)
    sources = torch.tensor([0, 100, 511], dtype=torch.int32, device=cuda)
    tf.reset_launch_counts()
    res = tc.bfs_sssp_batched_sharded(pg, sources, mesh=mesh)
    want = tc.bfs_sssp_batched(graph.to("cpu"), sources.cpu())
    v1 = graph.n_nodes + 1
    assert torch.equal(mesh.all_gather(res.dist)[:v1].cpu(), want.dist)
    assert torch.equal(mesh.all_gather(res.sigma)[:v1].cpu(), want.sigma)
    assert tf.launch_counts == {tf.FLAT: 0, tf.NODE_BLOCKED: 0,
                                tf.NODE_BLOCKED_WIDE: res.n_iters,
                                tf.WORDS: res.n_iters}
    hyper = tc.hyperbolic_graph(300, 20.0, seed=1, device=cuda)
    hpg = tc.partition_graph(hyper, 4, block_v=128, block_e=256)
    tf.reset_launch_counts()
    ts.reset_launch_counts()
    run = tc.run_kadabra(hpg, eps=0.05, mesh=tc.ShardMesh(4, cuda))
    assert tf.launch_counts[tf.NODE_BLOCKED_WIDE] \
        == tf.launch_counts[tf.WORDS] == run.bfs_levels > 0
    assert tf.launch_counts[tf.FLAT] == tf.launch_counts[tf.NODE_BLOCKED] \
        == 0
    assert ts.launch_counts[ts.STOPCHECK] == run.n_epochs > 0
    import numpy as np
    assert np.abs(run.btilde - tc.brandes_numpy(hyper)).max() < 0.05


def _stop_inputs(v, device, seed=0):
    gen = torch.Generator().manual_seed(seed)
    counts = torch.randint(0, 200, (v,), generator=gen).float()
    lil = torch.rand(v, generator=gen) * 20 + 1e-3
    liu = torch.rand(v, generator=gen) * 20 + 1e-3
    return counts.to(device), lil.to(device), liu.to(device)


@pytest.mark.parametrize("v", [1, 1000, 5000, 40000, 1 << 20,
                               (1 << 20) + 3])
@pytest.mark.parametrize("offset", [0, 1])
def test_stopcheck_kernel_matches_plain(cuda, v, offset):
    """``offset`` 1 starts every stream one element into its storage, so
    the kernel takes its scalar loads (the pointers are not 16-byte
    aligned)."""
    counts, lil, liu = (t[offset:] for t in _stop_inputs(v + offset, cuda,
                                                         seed=v))
    omega = torch.tensor(84_000.0, device=cuda)
    before = ts.launch_counts[ts.STOPCHECK]
    got = ts.stopcheck_fused(counts, 17_408, lil, liu, omega)
    want = ts.stopcheck_ref(counts, 17_408, lil, liu, omega)
    torch.cuda.synchronize()
    assert ts.launch_counts[ts.STOPCHECK] == before + 1
    # explicitly rounded arithmetic in the plain version's order: bitwise
    assert torch.equal(got, want)


def test_stopcheck_kernel_resets_its_ticket(cuda):
    """1,000 checks back to back on one stream, over inputs that change
    from check to check: each gives the plain version's bits, so the last
    block of every launch found the ticket at 0 and left it there."""
    counts, lil, liu = _stop_inputs(1 << 20, cuda, seed=5)
    omega = torch.tensor(84_000.0, device=cuda)
    outs = []
    for i in range(1000):
        counts[i] = float(1000 + i)
        outs.append(ts.stopcheck_fused(counts.clone(), 17_408 + i, lil, liu,
                                       omega))
    torch.cuda.synchronize()
    counts, _, _ = _stop_inputs(1 << 20, cuda, seed=5)
    for i in (0, 1, 2, 499, 998, 999):
        counts_i = counts.clone()
        counts_i[:i + 1] = torch.arange(1000, 1001 + i, device=cuda).float()
        assert torch.equal(outs[i], ts.stopcheck_ref(counts_i, 17_408 + i,
                                                     lil, liu, omega))


def test_stopcheck_kernel_scratch_per_stream(cuda):
    """Checks on two streams in flight together: each stream has its own
    scratch pairs and ticket, and both results are the plain version's."""
    a = _stop_inputs(1 << 20, cuda, seed=6)
    b = _stop_inputs(1 << 20, cuda, seed=7)
    omega = torch.tensor(84_000.0, device=cuda)
    s1, s2 = torch.cuda.Stream(), torch.cuda.Stream()
    torch.cuda.synchronize()
    got = []
    for _ in range(50):
        with torch.cuda.stream(s1):
            got.append((0, ts.stopcheck_fused(a[0], 17_408, a[1], a[2],
                                              omega)))
        with torch.cuda.stream(s2):
            got.append((1, ts.stopcheck_fused(b[0], 17_408, b[1], b[2],
                                              omega)))
    torch.cuda.synchronize()
    want = [ts.stopcheck_ref(x[0], 17_408, x[1], x[2], omega) for x in (a, b)]
    assert all(torch.equal(out, want[k]) for k, out in got)


def test_stopcheck_is_one_launch_a_check(cuda):
    """The profiler sees one kernel launch a check, and it is the
    stop-check kernel: 10 checks in the second of two traced steps (the
    first warms the trace up: a trace can miss the first launches of a
    session), and 10 counted launches in each."""
    from torch.profiler import ProfilerActivity, profile, schedule
    counts, lil, liu = _stop_inputs(1 << 20, cuda, seed=8)
    omega = torch.tensor(84_000.0, device=cuda)
    ts.stopcheck_fused(counts, 64, lil, liu, omega)
    torch.cuda.synchronize()
    traced, counted = [], []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                 on_trace_ready=lambda p: traced.append(p.key_averages())
                 ) as prof:
        for _ in range(2):
            # the checks sit 0.25 s inside the traced step at both ends,
            # away from the edges of the trace's window
            time.sleep(0.25)
            ts.reset_launch_counts()
            for _ in range(10):
                ts.stopcheck_fused(counts, 64, lil, liu, omega)
            torch.cuda.synchronize()
            counted.append(ts.launch_counts[ts.STOPCHECK])
            time.sleep(0.25)
            prof.step()
    assert counted == [10, 10]
    kernels = [e for e in traced[-1]
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0 and "Memcpy" not in e.key
               and "Memset" not in e.key
               and not e.key.startswith("ProfilerStep")]
    assert [e.count for e in kernels] == [10], [(e.key, e.count)
                                               for e in kernels]
    assert "stopcheck_kernel" in kernels[0].key


def test_stopcheck_kernel_propagates_nan(cuda):
    counts, lil, liu = _stop_inputs(5000, cuda)
    omega = torch.tensor(3000.0, device=cuda)
    lil[4321] = float("nan")
    got = ts.stopcheck_fused(counts, 64, lil, liu, omega)
    assert torch.isnan(got[0]) and torch.equal(
        got[1], ts.stopcheck_ref(counts, 64, lil, liu, omega)[1])
    counts[7] = float("nan")
    assert torch.isnan(ts.stopcheck_fused(counts, 64, lil, liu, omega)).all()


def test_stopcheck_dispatcher_routes_cuda_to_the_kernel(cuda):
    counts, lil, liu = _stop_inputs(300, cuda)
    omega = torch.tensor(3000.0, device=cuda)
    ts.reset_launch_counts()
    ts.stopcheck(counts, 64, lil, liu, omega)
    assert ts.launch_counts[ts.STOPCHECK] == 1
    with pytest.raises(ValueError, match="CPU tensors"):
        ts.stopcheck(counts, 64, lil, liu, omega, use_kernel=False)
    with pytest.raises(TypeError, match="host number"):
        ts.stopcheck(counts, torch.tensor(64, device=cuda), lil, liu, omega)


def test_forward_run_on_the_card(cuda):
    """Three metrics on one forward stream: every level through the flat
    kernel, every epoch's three stop checks through the stop-check
    kernel."""
    import numpy as np
    graph = tc.hyperbolic_graph(300, 20.0, seed=1, device=cuda)
    tf.reset_launch_counts()
    ts.reset_launch_counts()
    res = tc.run_adaptive(graph, ("betweenness", "closeness", "harmonic"),
                          eps=0.05, device=cuda)
    assert tf.launch_counts[tf.FLAT] == tf.launch_counts[tf.WORDS] \
        == res.bfs_levels > 0
    assert ts.launch_counts[ts.STOPCHECK] == 3 * res.n_epochs > 0
    assert res.converged
    assert np.abs(res.reports[0].scores
                  - tc.brandes_numpy(graph)).max() < 0.05


def _segsum_inputs(n, v, d, s, device, dtype=torch.float32, integer=True,
                   skew=False, seed=0):
    gen = torch.Generator().manual_seed(seed)
    ids = torch.randint(0, v, (n,), generator=gen, dtype=torch.int32)
    if skew:    # a few hub segments above the kernel's split
        seg = torch.clamp((torch.rand(n, generator=gen) ** 6 * s).long(),
                          max=s - 1).to(torch.int32)
    else:
        seg = torch.randint(0, s, (n,), generator=gen, dtype=torch.int32)
    if integer:
        w = torch.randint(0, 4, (n,), generator=gen).float()
        table = torch.randint(-8, 9, (v, d), generator=gen).float()
    else:
        w = torch.rand(n, generator=gen)
        table = torch.randn(v, d, generator=gen)
    return (ids.to(device), seg.to(device), w.to(device),
            table.to(device=device, dtype=dtype))


@pytest.mark.parametrize("n,v,d,s,dtype,skew", [
    (512, 100, 128, 32, torch.float32, False),
    (4096, 1000, 384, 128, torch.float32, False),
    (1024, 50, 128, 16, torch.bfloat16, False),
    (20000, 300, 128, 40, torch.float32, True),     # split segments
    (3000, 70, 37, 500, torch.float32, True),       # scalar lanes, D % 4
    (3000, 70, 38, 500, torch.bfloat16, True),
    (0, 10, 128, 6, torch.float32, False),          # no entries
])
def test_segsum_kernel_matches_plain(cuda, n, v, d, s, dtype, skew):
    """Integer-valued inputs: every order gives the same bits."""
    ids, seg, w, table = _segsum_inputs(n, v, d, s, cuda, dtype, skew=skew,
                                        seed=n + d)
    plan = tk.build_plan(ids, seg, s, v)
    if skew:
        assert plan.n_items > 0
    before = tk.launch_counts[tk.SEGSUM]
    got = tk.gather_segment_sum_cuda(ids, seg, w, table, s, plan)
    want = tk.gather_segment_sum_ref(ids, seg, w, table, s)
    torch.cuda.synchronize()
    assert tk.launch_counts[tk.SEGSUM] == before + 1
    assert got.dtype == dtype and torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_segsum_kernel_is_deterministic_and_close_on_gaussian(cuda, dtype):
    """N(0, 1) table: two kernel calls give the same bits, and the kernel
    and the plain version (atomics, any order) each lie within the
    recursive-summation bound (n_s - 1) u sum|terms| of the exact sum, so
    within twice that of each other (for bfloat16 plus one rounding of
    each side to bfloat16, 2^-8 relative)."""
    ids, seg, w, table = _segsum_inputs(50000, 2000, 128, 300, cuda, dtype,
                                        integer=False, skew=True)
    plan = tk.build_plan(ids, seg, 300, 2000, hot_rows=100)
    a = tk.gather_segment_sum_cuda(ids, seg, w, table, 300, plan)
    b = tk.gather_segment_sum_cuda(ids, seg, w, table, 300, plan)
    want = tk.gather_segment_sum_ref(ids, seg, w, table, 300).float()
    deg = torch.bincount(seg.long(), minlength=300).float()[:, None]
    tol = 2.0 * deg * 2.0 ** -24 * tk.gather_segment_sum_ref(
        ids, seg, w.abs(), table.float().abs(), 300)
    if dtype == torch.bfloat16:
        tol = tol + 2.0 ** -8 * (2.0 * want.abs() + tol)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    assert bool(((a.float() - want).abs() <= tol).all())


@pytest.mark.parametrize("dtype,d", [(torch.float32, 128),
                                     (torch.float32, 37),
                                     (torch.bfloat16, 128),
                                     (torch.bfloat16, 38)])
@pytest.mark.parametrize("hot_rows", [0, 7, 1 << 20])
def test_segsum_kernel_hot_tier(cuda, dtype, d, hot_rows):
    """Skewed ids and segments (split segments too) with no hot source,
    a few, and every source hot: the marked rows read under the L2
    policy, the rest plainly, bitwise the plain version either way."""
    gen = torch.Generator().manual_seed(hot_rows + d)
    n, v, s = 30000, 400, 60
    ids = torch.clamp((torch.rand(n, generator=gen) ** 4 * v).long(),
                      max=v - 1).to(torch.int32).to(cuda)
    seg = torch.clamp((torch.rand(n, generator=gen) ** 6 * s).long(),
                      max=s - 1).to(torch.int32).to(cuda)
    w = torch.randint(0, 4, (n,), generator=gen).float().to(cuda)
    table = torch.randint(-8, 9, (v, d), generator=gen).float().to(
        device=cuda, dtype=dtype)
    plan = tk.build_plan(ids, seg, s, v, hot_rows=hot_rows)
    assert plan.n_items > 0 and plan.n_hot == min(hot_rows, v)
    assert bool((plan.ids_sorted < 0).any()) == (hot_rows > 0)
    for p, args in ((plan, (ids, seg, w, table, s)),
                    (plan.transpose, (seg, ids, w, table[:s], v))):
        got = tk.gather_segment_sum_cuda(*args, p)
        torch.cuda.synchronize()
        assert torch.equal(got, tk.gather_segment_sum_ref(*args))


def test_segsum_kernel_follows_weight_changes(cuda):
    """The plan's weights in plan order follow ``w``: after a change in
    place, and for another tensor, the kernel sums the new weights."""
    ids, seg, w, table = _segsum_inputs(20000, 300, 128, 40, cuda,
                                        skew=True)
    plan = tk.build_plan(ids, seg, 40, 300)
    for step in range(3):
        if step == 1:
            w.mul_(3.0)
        if step == 2:
            w = torch.randint(0, 4, w.shape, device=cuda).float()
        got = tk.gather_segment_sum_cuda(ids, seg, w, table, 40, plan)
        torch.cuda.synchronize()
        assert torch.equal(got, tk.gather_segment_sum_ref(ids, seg, w,
                                                          table, 40))


def test_segsum_dispatcher_gradient_through_the_kernel(cuda):
    """Forward and backward both launch the kernel; the gradient equals
    the plain route's, bitwise on integer-valued inputs."""
    ids, seg, w, table = _segsum_inputs(6000, 200, 64, 50, cuda, skew=True)
    cot = torch.randint(-3, 4, (50, 64), device=cuda).float()
    grads = []
    for use_kernel in (True, False):
        t = table.clone().requires_grad_(True)
        tk.reset_launch_counts()
        out = tk.gather_segment_sum(ids, seg, w, t, 50, use_kernel=use_kernel)
        (out * cot).sum().backward()
        torch.cuda.synchronize()
        assert tk.launch_counts[tk.SEGSUM] == (2 if use_kernel else 0)
        grads.append(t.grad)
    assert torch.equal(grads[0], grads[1])


def test_graphsage_on_the_card_matches_the_cpu(cuda):
    """A small GraphSAGE forward through the kernel (2 launches) against
    the same forward on the CPU's plain route."""
    from repro_torch.configs.graphsage_reddit import make_smoke_config
    from repro_torch.data import graph_to_batch
    from repro_torch.models.gnn import sage_forward, sage_init
    from repro_torch.tree import tree_map
    cfg = make_smoke_config()
    graph = tc.rmat_graph(10, 8, seed=2, device="cpu")
    batch = graph_to_batch(graph, d_feat=cfg.d_in, n_classes=3, device="cpu")
    params = sage_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    want = sage_forward(params, batch, cfg)
    tk.reset_launch_counts()
    got = sage_forward(tree_map(lambda x: x.to(cuda), params),
                       batch.to(cuda), cfg)
    torch.cuda.synchronize()
    assert tk.launch_counts[tk.SEGSUM] == cfg.n_layers
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-6)


def _molecule_edges(n_mol, atoms, per_mol, device, seed=0):
    """The equivariant models' edge layout at the molecule cell's shape:
    ``per_mol`` directed edges in each molecule, dst unsorted."""
    gen = torch.Generator().manual_seed(seed)
    off = torch.arange(n_mol).repeat_interleave(per_mol) * atoms
    src = torch.randint(0, atoms, (n_mol * per_mol,), generator=gen) + off
    dst = torch.randint(0, atoms, (n_mol * per_mol,), generator=gen) + off
    return src.to(torch.int32).to(device), dst.to(torch.int32).to(device)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [3, 64, 288, 1152])
def test_segsum_kernel_on_the_edge_plan(cuda, d, dtype):
    """K4 at the equivariant models' shapes: the identity-id edge plan
    (ids = arange(E), seg = dst, no hot tier) of 128 molecules x 64
    edges over 4,096 nodes, and its transpose (every segment one entry),
    at EGNN's coordinate (3) and message (64) widths, NequIP's (32 x 9)
    and MACE's (128 x 9).  Integer-valued tables and a 0/1 mask: bitwise
    the plain version, both ways."""
    e, n = 128 * 64, 4096
    src, dst = _molecule_edges(128, 30, 64, cuda)
    ids = torch.arange(e, dtype=torch.int32, device=cuda)
    gen = torch.Generator().manual_seed(d)
    w = (torch.rand(e, generator=gen) < 0.9).float().to(cuda)
    plan = tk.build_plan(ids, dst, n, e, hot_rows=0)
    assert plan.n_hot == 0 and plan.n_items == 0
    assert bool((torch.diff(plan.transpose.offsets) == 1).all())
    msgs = torch.randint(-8, 9, (e, d), generator=gen).float().to(
        device=cuda, dtype=dtype)
    cot = torch.randint(-8, 9, (n, d), generator=gen).float().to(
        device=cuda, dtype=dtype)
    tk.reset_launch_counts()
    got = tk.gather_segment_sum_cuda(ids, dst, w, msgs, n, plan)
    back = tk.gather_segment_sum_cuda(dst, ids, w, cot, e, plan.transpose)
    torch.cuda.synchronize()
    assert tk.launch_counts[tk.SEGSUM] == 2
    assert got.dtype == back.dtype == dtype
    assert torch.equal(got, tk.gather_segment_sum_ref(ids, dst, w, msgs, n))
    assert torch.equal(back, tk.gather_segment_sum_ref(dst, ids, w, cot, e))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_segsum_kernel_on_the_edge_plan_gaussian(cuda, dtype):
    """An N(0, 1) table at MACE's width: within the summation-order bound
    of the plain version (bf16: plus one rounding of each side), two
    calls the same bits."""
    e, n, d = 128 * 64, 4096, 1152
    src, dst = _molecule_edges(128, 30, 64, cuda, seed=1)
    ids = torch.arange(e, dtype=torch.int32, device=cuda)
    w = torch.ones(e, device=cuda)
    plan = tk.build_plan(ids, dst, n, e, hot_rows=0)
    msgs = torch.randn(e, d, device=cuda).to(dtype)
    a = tk.gather_segment_sum_cuda(ids, dst, w, msgs, n, plan)
    b = tk.gather_segment_sum_cuda(ids, dst, w, msgs, n, plan)
    want = tk.gather_segment_sum_ref(ids, dst, w, msgs, n).float()
    deg = torch.bincount(dst.long(), minlength=n).float()[:, None]
    tol = 2.0 * deg * 2.0 ** -24 * tk.gather_segment_sum_ref(
        ids, dst, w, msgs.float().abs(), n)
    if dtype == torch.bfloat16:
        tol = tol + 2.0 ** -8 * (2.0 * want.abs() + tol)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    assert bool(((a.float() - want).abs() <= tol).all())


@pytest.mark.parametrize("name", ["egnn", "egnn_bf16", "nequip", "mace"])
def test_equivariant_model_on_the_card_matches_the_cpu(cuda, name):
    """A smoke-size forward and training step through K4 (launches as the
    design counts them) against the same on the CPU's plain route."""
    import dataclasses as dc
    from repro_torch.models import gnn as tg
    from repro_torch.optim import AdamWConfig, init_state
    from repro_torch.train import make_train_step
    from repro_torch.tree import tree_leaves, tree_map
    base = name.split("_")[0]
    cfg = {"egnn": tg.EgnnConfig(n_layers=2, d_hidden=16),
           "nequip": tg.NequipConfig(n_layers=2, d_hidden=8),
           "mace": tg.MaceConfig(n_layers=2, d_hidden=8)}[base]
    if name == "egnn_bf16":
        cfg = dc.replace(cfg, agg_dtype="bf16")
    n_mol, atoms = 8, 10
    src, dst = _molecule_edges(n_mol, atoms, 40, "cpu", seed=3)
    gen = torch.Generator().manual_seed(4)
    n = n_mol * atoms
    batch = tg.GraphBatch(
        x=torch.zeros(n, 1), z=torch.randint(0, 8, (n,), generator=gen,
                                             dtype=torch.int32),
        pos=torch.randn(n, 3, generator=gen), src=src, dst=dst,
        edge_mask=torch.ones(src.shape[0]), node_mask=torch.ones(n),
        labels=torch.zeros(n, dtype=torch.int32),
        graph_id=torch.arange(n_mol).repeat_interleave(atoms).to(
            torch.int32),
        y=torch.randn(n_mol, generator=gen), n_graphs=n_mol)
    init = getattr(tg, f"{base}_init")
    fwd = getattr(tg, f"{base}_forward")
    loss = getattr(tg, f"{base}_loss")
    params = init(torch.Generator().manual_seed(0), cfg, device="cpu")
    layers = cfg.n_layers
    per_fwd = 2 * layers if base == "egnn" else layers
    per_step = 4 * layers - 1 if base == "egnn" else 2 * layers
    with torch.no_grad():
        want = fwd(params, batch, cfg)
    step = make_train_step(lambda p, b: loss(p, b, cfg), AdamWConfig())
    want_p, _, want_m = step(params, init_state(params), batch)
    cparams = tree_map(lambda x: x.to(cuda), params)
    cbatch = batch.to(cuda)
    tk.reset_launch_counts()
    with torch.no_grad():
        got = fwd(cparams, cbatch, cfg)
    torch.cuda.synchronize()
    assert tk.launch_counts[tk.SEGSUM] == per_fwd
    tk.reset_launch_counts()
    got_p, _, got_m = step(cparams, init_state(cparams), cbatch)
    torch.cuda.synchronize()
    assert tk.launch_counts[tk.SEGSUM] == per_step
    tol = dict(rtol=2e-2, atol=2e-2) if name == "egnn_bf16" else \
        dict(rtol=1e-4, atol=1e-5)
    outs = list(got) if base == "egnn" else \
        [got[0][l] for l in sorted(got[0])] + [got[1]]
    wants = list(want) if base == "egnn" else \
        [want[0][l] for l in sorted(want[0])] + [want[1]]
    for g, w_ in zip(outs, wants):
        torch.testing.assert_close(g.float().cpu(), w_.float(), **tol)
    torch.testing.assert_close(float(got_m["loss"]), float(want_m["loss"]),
                               **tol)
    for g, w_ in zip(tree_leaves(got_p), tree_leaves(want_p)):
        torch.testing.assert_close(g.cpu(), w_, rtol=0, atol=2e-3)


FLASH_TOL = {torch.float32: 3e-5, torch.bfloat16: 2e-2}
# bfloat16 per output row, ||got - want|| / ||want|| over dh: a row over
# n keys has |out| ~ 1/sqrt(n), which the absolute 2e-2 does not see.
# Rounding P and the outputs to bfloat16 leaves at most ~4e-3; a stale
# or skipped KV tile leaves several times 1e-2 (chip_smoke.py reads
# both at the serving shape)
FLASH_ROW_REL = 1e-2


def _qkv(b, s, h, n_kv, dh, dtype, device, seed=0):
    gen = torch.Generator().manual_seed(seed)
    q = torch.randn(b, s, h, dh, generator=gen)
    k = torch.randn(b, s, n_kv, dh, generator=gen)
    v = torch.randn(b, s, n_kv, dh, generator=gen)
    return [x.to(device=device, dtype=dtype) for x in (q, k, v)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("dh", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s", [1, 17, 100, 130, 1024, 257, 4097])
@pytest.mark.parametrize("h,n_kv", [(24, 8), (6, 2), (4, 4)])
def test_flash_kernel_matches_plain(cuda, dtype, dh, causal, s, h, n_kv):
    """K5 against its plain version: float32 within 3e-5 (summation
    order), bfloat16 within 2e-2 (P rounded to bfloat16 before P V, and
    both outputs rounded to bfloat16) and each row within FLASH_ROW_REL
    of its own norm.  Ragged S, S = 257 and 4097 wrap the bfloat16
    route's two-stage K/V ring (3 and 33 tiles of 128 keys), and H / KV
    = 3 catches a head mapped by h % KV."""
    q, k, v = _qkv(2, s, h, n_kv, dh, dtype, cuda, seed=s + h)
    before = fa.launch_counts[fa.FLASHATTN]
    got = fa.flash_attention_cuda(q, k, v, causal=causal)
    want = fa.flash_attention_gqa_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.launch_counts[fa.FLASHATTN] == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    if dtype == torch.bfloat16:
        g, w = got.float(), want.float()
        rel = (g - w).norm(dim=-1) / w.norm(dim=-1).clamp_min(1e-30)
        assert float(rel.max()) <= FLASH_ROW_REL


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_kernel_reads_strided_views(cuda, dtype):
    """q, k, v as views into wider tensors (head and row strides that
    are not the contiguous ones): the same output as contiguous copies."""
    wide = torch.randn(2, 130, 6, 256, device=cuda).to(dtype)
    kv = torch.randn(2, 130, 2, 384, device=cuda).to(dtype)
    q, k, v = wide[..., 64:192], kv[..., :128], kv[..., 256:]
    got = fa.flash_attention_cuda(q, k, v)
    want = fa.flash_attention_cuda(q.contiguous(), k.contiguous(),
                                   v.contiguous())
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_flash_kernel_refuses_what_it_cannot_take(cuda):
    q, k, v = _qkv(1, 8, 4, 2, 64, torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention_cuda(q[..., :32], k[..., :32], v[..., :32])
    with pytest.raises(ValueError, match="one type"):
        fa.flash_attention_cuda(q, k.float(), v)
    with pytest.raises(ValueError, match="multiple of KV"):
        fa.flash_attention_cuda(q[:, :, :3], k, v)


def test_lm_prefill_runs_the_kernel_once_a_layer(cuda):
    """A small llama-shaped model (head_dim 64) prefilled on the card:
    one K5 launch a layer and logits within float32 reach of the CPU's
    plain route; decode launches nothing."""
    from repro_torch.models import transformer as lm
    from repro_torch.tree import tree_map
    cfg = lm.TransformerConfig(
        name="lm-gpu-test", n_layers=3, d_model=256, n_heads=6,
        n_kv_heads=2, head_dim=64, d_ff=512, vocab=500,
        rope_theta=500_000.0, dtype=torch.float32)
    params = lm.init_params(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    tokens = torch.randint(0, cfg.vocab, (2, 200),
                           generator=torch.Generator().manual_seed(1))
    want, want_cache = lm.prefill_step(params, tokens, cfg)
    gpu_params = tree_map(lambda x: x.to(cuda), params)
    fa.reset_launch_counts()
    got, cache = lm.prefill_step(gpu_params, tokens.to(cuda), cfg)
    torch.cuda.synchronize()
    assert fa.launch_counts[fa.FLASHATTN] == cfg.n_layers
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(cache["k"].cpu(), want_cache["k"], rtol=1e-4,
                               atol=1e-4)
    cache = lm.grow_cache(cache, 2)
    fa.reset_launch_counts()
    lm.decode_step(gpu_params, cache, got.argmax(-1)[:, None], cfg)
    torch.cuda.synchronize()
    assert fa.launch_counts[fa.FLASHATTN] == 0


# the float32 route's K/V ring: FLASH_F32_STAGES slots of FLASH_F32_TILE
# keys (csrc/flashattn.cu)
FLASH_F32_TILE, FLASH_F32_STAGES = 64, 2


@pytest.mark.parametrize("dh", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s", [2 * FLASH_F32_STAGES * FLASH_F32_TILE + 1,
                               1000])
def test_flash_kernel_float32_sharp_softmax(cuda, dh, causal, s):
    """The float32 route on q and k doubled (scores 4x as large: a
    peaked softmax, where an error in q K^T moves the output more)
    within 3e-5, at an S that wraps the two-stage ring of 64-key tiles
    by one key and at a ragged one.  Scores 16x as large would test
    float32 itself: there the plain version lies 0.82 of 3e-5 from a
    float64 one at dh 128, S 512 (tools/flash_f32_emulation.py, which
    puts the kernel's arithmetic at 0.10-0.37 of 3e-5 on this case)."""
    q, k, v = _qkv(2, s, 6, 2, dh, torch.float32, cuda, seed=s + dh)
    q, k = 2 * q, 2 * k
    got = fa.flash_attention_cuda(q, k, v, causal=causal)
    want = fa.flash_attention_gqa_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=3e-5, atol=3e-5)


def test_flash_kernel_float32_head_dim_16(cuda):
    """The float32 route at head dim 16, the smoke configs' width."""
    for causal in (True, False):
        q, k, v = _qkv(2, 100, 4, 2, 16, torch.float32, cuda, seed=16)
        got = fa.flash_attention_cuda(q, k, v, causal=causal)
        want = fa.flash_attention_gqa_ref(q, k, v, causal=causal)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=3e-5, atol=3e-5)


def test_smoke_config_prefill_runs_the_kernel_once_a_global_layer(cuda):
    """``make_smoke_config()`` (float32, head dim 16) prefilled on the
    card: one K5 launch a global layer, logits within float32 reach of
    the CPU's plain route."""
    from repro_torch.configs.llama3_2_3b import make_smoke_config
    from repro_torch.models import transformer as lm
    from repro_torch.tree import tree_map
    cfg = make_smoke_config()
    assert cfg.hd == 16 and cfg.dtype == torch.float32
    params = lm.init_params(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    tokens = torch.randint(0, cfg.vocab, (4, 96),
                           generator=torch.Generator().manual_seed(1))
    want, _ = lm.prefill_step(params, tokens, cfg)
    fa.reset_launch_counts()
    got, _ = lm.prefill_step(tree_map(lambda x: x.to(cuda), params),
                             tokens.to(cuda), cfg)
    torch.cuda.synchronize()
    n_global = sum(kind != "local" for _, kind in lm._layers(params, cfg))
    assert fa.launch_counts[fa.FLASHATTN] == n_global == cfg.n_layers
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)


# K5's sliding-window mode: each query tile's KV loop starts at the first
# tile holding a key of its window; windows of 1 (the diagonal only), 100
# and 1000 (two masked tiles where the window begins, at 128-key tiles),
# 128 and 1024 (one), at a ragged S past several windows and at S = 1000


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("dh", [64, 128])
@pytest.mark.parametrize("window", [1, 100, 128, 1000, 1024])
@pytest.mark.parametrize("s", [1000, 2309])
def test_flash_kernel_window_matches_plain(cuda, dtype, dh, window, s):
    """The windowed kernel against its windowed plain twin, as
    ``test_flash_kernel_matches_plain`` holds the causal one (bfloat16
    also per row), one launch counted as a window launch."""
    q, k, v = _qkv(2, s, 6, 2, dh, dtype, cuda, seed=s + window)
    before = dict(fa.launch_counts)
    got = fa.flash_attention_cuda(q, k, v, window=window)
    want = fa.flash_attention_gqa_ref(q, k, v, window=window)
    torch.cuda.synchronize()
    assert fa.launch_counts == {**before, fa.FLASHATTN_WINDOW:
                                before[fa.FLASHATTN_WINDOW] + 1}
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    if dtype == torch.bfloat16:
        g, w = got.float(), want.float()
        rel = (g - w).norm(dim=-1) / w.norm(dim=-1).clamp_min(1e-30)
        assert float(rel.max()) <= FLASH_ROW_REL
    # a window as wide as S is the causal kernel's function
    if window >= s:
        causal = fa.flash_attention_cuda(q, k, v)
        torch.testing.assert_close(got.float(), causal.float(), rtol=tol,
                                   atol=tol)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_kernel_window_reads_strided_views(cuda, dtype):
    """A windowed call on views into wider tensors: the same output as on
    contiguous copies."""
    wide = torch.randn(2, 700, 6, 256, device=cuda).to(dtype)
    kv = torch.randn(2, 700, 2, 384, device=cuda).to(dtype)
    q, k, v = wide[..., 64:192], kv[..., :128], kv[..., 256:]
    got = fa.flash_attention_cuda(q, k, v, window=200)
    want = fa.flash_attention_cuda(q.contiguous(), k.contiguous(),
                                   v.contiguous(), window=200)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="causal"):
        fa.flash_attention_cuda(q, k, v, causal=False, window=200)


def test_gemma3_smoke_prefill_runs_the_kernel_once_a_layer(cuda):
    """gemma3's smoke config (float32, head dim 16, window 8; 7 layers, 5
    local) prefilled on the card: each local layer one window launch of
    K5, each global one a causal launch, logits and cache within float32
    reach of the CPU's plain route; decode launches nothing."""
    from repro_torch.configs.gemma3_27b import make_smoke_config
    from repro_torch.models import transformer as lm
    from repro_torch.tree import tree_map
    cfg = make_smoke_config()
    params = lm.init_params(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    tokens = torch.randint(0, cfg.vocab, (2, 96),
                           generator=torch.Generator().manual_seed(1))
    want, want_cache = lm.prefill_step(params, tokens, cfg)
    gpu_params = tree_map(lambda x: x.to(cuda), params)
    fa.reset_launch_counts()
    got, cache = lm.prefill_step(gpu_params, tokens.to(cuda), cfg)
    torch.cuda.synchronize()
    kinds = [kind for _, kind in lm._layers(params, cfg)]
    assert fa.launch_counts == {fa.FLASHATTN: kinds.count("global"),
                                fa.FLASHATTN_WINDOW: kinds.count("local"),
                                fa.FLASHATTN_BWD: 0,
                                fa.FLASHATTN_BWD_WINDOW: 0}
    assert (kinds.count("global"), kinds.count("local")) == (2, 5)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(cache["v"].cpu(), want_cache["v"], rtol=1e-4,
                               atol=1e-4)
    cache = lm.grow_cache(cache, 2)
    fa.reset_launch_counts()
    lm.decode_step(gpu_params, cache, got.argmax(-1)[:, None], cfg)
    torch.cuda.synchronize()
    assert fa.launch_counts == {fa.FLASHATTN: 0, fa.FLASHATTN_WINDOW: 0,
                                fa.FLASHATTN_BWD: 0,
                                fa.FLASHATTN_BWD_WINDOW: 0}


# ---------------------------------------------------------------------------
# K5's backward (csrc/flashattn_bwd.cu) and the forward's logsumexp
# ---------------------------------------------------------------------------

# relative L2 distance of each of dq, dk, dv from the plain backward in
# float32 on the same inputs (the kernel's q, k, v, its output and
# logsumexp, dO): float32 sums in another order (~1e-7), bfloat16 the
# gradients' one rounding (2^-9 relative) on top; a gradient that is 0
# by construction is held by its largest entry to the same number
FLASH_BWD_REL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
# the forward's logsumexp against the plain one's: float32 (split TF32
# products, 3e-5 on the output) and bfloat16 (exact float32 scores of
# bfloat16 inputs, ex2.approx)
FLASH_LSE_ATOL = {torch.float32: 3e-5, torch.bfloat16: 1e-4}


def _rel_l2(got, want):
    g, w = got.double(), want.double()
    return float((g - w).norm() / w.norm().clamp_min(1e-30))


def _bwd_case(cuda, dtype, dh, causal, window, s, h=6, n_kv=2, seed=0):
    """The kernel's forward (with logsumexp) and backward on N(0, 1)
    inputs, and the plain backward in float32 on the same inputs."""
    q, k, v = _qkv(2, s, h, n_kv, dh, dtype, cuda, seed=seed)
    gen = torch.Generator().manual_seed(seed + 1)
    do = torch.randn(2, s, h, dh, generator=gen).to(device=cuda, dtype=dtype)
    out, lse = fa.flash_attention_cuda(q, k, v, causal=causal, window=window,
                                       return_lse=True)
    got = fa.flash_attention_bwd_cuda(q, k, v, out, lse, do, causal=causal,
                                      window=window)
    want = fa.flash_attention_gqa_bwd_ref(
        q.float(), k.float(), v.float(), out.float(), lse, do.float(),
        causal=causal, window=window)
    torch.cuda.synchronize()
    return (q, k, v, out, lse, do), got, want


@pytest.mark.parametrize("dtype,dh", [(torch.bfloat16, 64),
                                      (torch.bfloat16, 128),
                                      (torch.float32, 16),
                                      (torch.float32, 64),
                                      (torch.float32, 128)])
@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 1), (True, 100)])
@pytest.mark.parametrize("s", [1, 100, 257])
def test_flash_bwd_kernel_matches_plain(cuda, dtype, dh, causal, window, s):
    """K5 bwd against the plain backward (float32) on the kernel's own
    output and logsumexp: each gradient within FLASH_BWD_REL in relative
    L2, in the inputs' type and shape; one backward launch counted; the
    forward's logsumexp within FLASH_LSE_ATOL of the plain one, and its
    output bitwise the serving launch's (no logsumexp)."""
    before = dict(fa.launch_counts)
    (q, k, v, out, lse, do), got, want = _bwd_case(
        cuda, dtype, dh, causal, window, s, seed=s + dh)
    name = fa.FLASHATTN_BWD if window is None else fa.FLASHATTN_BWD_WINDOW
    assert fa.launch_counts[name] == before[name] + 1
    # one key a row (S = 1, or a window of 1) takes all the weight: dq
    # and dk are 0 by construction, held by their largest entry
    lone = s == 1 or window == 1
    for i, (g, w, x) in enumerate(zip(got, want, (q, k, v))):
        assert g.dtype == dtype and g.shape == x.shape
        assert bool(torch.isfinite(g).all())
        gap = float((g.float() - w).abs().max()) if lone and i < 2 \
            else _rel_l2(g.float(), w)
        assert gap <= FLASH_BWD_REL[dtype]
    _, plain_lse = fa.flash_attention_gqa_ref(q, k, v, causal=causal,
                                              window=window, return_lse=True)
    torch.testing.assert_close(lse, plain_lse, rtol=0,
                               atol=FLASH_LSE_ATOL[dtype])
    serving = fa.flash_attention_cuda(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert torch.equal(serving, out)


@pytest.mark.parametrize("dtype,dh", [(torch.bfloat16, 128),
                                      (torch.float32, 64),
                                      (torch.bfloat16, 64)])
def test_flash_bwd_kernel_is_deterministic_and_reads_views(cuda, dtype, dh):
    """Two backward calls give the same bits (no atomics), and q, k, v as
    views into wider tensors give the same gradients as contiguous
    copies."""
    s, h, n_kv = 300, 6, 2
    wide = torch.randn(2, s, h, 2 * dh, device=cuda).to(dtype)
    kv = torch.randn(2, s, n_kv, 3 * dh, device=cuda).to(dtype)
    q, k, v = wide[..., dh // 2:dh // 2 + dh], kv[..., :dh], kv[..., 2 * dh:]
    do = torch.randn(2, s, h, dh, device=cuda).to(dtype)
    out, lse = fa.flash_attention_cuda(q, k, v, return_lse=True)
    a = fa.flash_attention_bwd_cuda(q, k, v, out, lse, do)
    b = fa.flash_attention_bwd_cuda(q, k, v, out, lse, do)
    c = fa.flash_attention_bwd_cuda(q.contiguous(), k.contiguous(),
                                    v.contiguous(), out, lse, do)
    torch.cuda.synchronize()
    for x, y, z in zip(a, b, c):
        assert torch.equal(x, y) and torch.equal(x, z)


def _bf16_bwd_within_limit(cuda, dh, causal, window, s, h=6, n_kv=2):
    """The bfloat16 backward against the plain one at one shape: one
    launch counted, each gradient finite, in q's type and shape and
    within FLASH_BWD_REL (a window of 1 leaves dq = dk = 0: their largest
    entry)."""
    before = dict(fa.launch_counts)
    (q, k, v, *_), got, want = _bwd_case(cuda, torch.bfloat16, dh, causal,
                                         window, s, h=h, n_kv=n_kv,
                                         seed=s + dh + h)
    name = fa.FLASHATTN_BWD if window is None else fa.FLASHATTN_BWD_WINDOW
    assert fa.launch_counts[name] == before[name] + 1
    for i, (g, w, x) in enumerate(zip(got, want, (q, k, v))):
        assert g.dtype == torch.bfloat16 and g.shape == x.shape
        assert bool(torch.isfinite(g).all())
        gap = float((g.float() - w).abs().max()) if window == 1 and i < 2 \
            else _rel_l2(g.float(), w)
        assert gap <= FLASH_BWD_REL[torch.bfloat16]


# The bfloat16 kernels' tiles: a dK/dV block owns 128 keys (64 a
# consumer warpgroup) and streams query tiles of 64 rows; a dQ block owns
# 128 rows (64 a warpgroup) and streams key tiles of 128.  S and the
# window on either side of those edges.
@pytest.mark.parametrize("dh", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s", [63, 64, 65, 127, 128, 129, 383])
def test_flash_bwd_bf16_tile_edges(cuda, dh, causal, s):
    """K5 bwd (bf16) at sequence lengths around its 64- and 128-wide
    tiles, causal and full."""
    _bf16_bwd_within_limit(cuda, dh, causal, None, s)


@pytest.mark.parametrize("dh", [64, 128])
@pytest.mark.parametrize("window", [127, 128, 129, 1024])
def test_flash_bwd_bf16_window_edges(cuda, dh, window):
    """K5 bwd's window mode (bf16) at windows around its tiles and at
    gemma3's 1,024, over a sequence longer than each."""
    _bf16_bwd_within_limit(cuda, dh, True, window, 1300, h=4)


@pytest.mark.parametrize("dh", [64, 128])
@pytest.mark.parametrize("group", [1, 3, 4])
@pytest.mark.parametrize("window", [None, 100])
def test_flash_bwd_bf16_gqa_groups(cuda, dh, group, window):
    """K5 bwd (bf16) with 1, 3 and 4 query heads a KV head: a dK/dV
    block's ring walks every query head of its group."""
    _bf16_bwd_within_limit(cuda, dh, True, window, 300, h=2 * group)


def test_flash_bwd_kernel_control_fails(cuda):
    """The check has teeth: a backward handed a logsumexp off by 0.05
    (what a wrong D or lse would do to P) lands beyond FLASH_BWD_REL in
    float32."""
    (q, k, v, out, lse, do), got, want = _bwd_case(
        cuda, torch.float32, 64, True, None, 200)
    bad = fa.flash_attention_bwd_cuda(q, k, v, out, lse + 0.05, do)
    torch.cuda.synchronize()
    assert max(_rel_l2(g, w) for g, w in zip(bad, want)) \
        > FLASH_BWD_REL[torch.float32]
    assert max(_rel_l2(g, w) for g, w in zip(got, want)) \
        <= FLASH_BWD_REL[torch.float32]


def test_flash_attention_gradient_on_the_card(cuda):
    """The dispatcher in grad mode on CUDA tensors: one forward launch
    and one backward launch, the gradients those of the plain route
    (``use_kernel=False``) within the float32 limits; under no_grad the
    serving launch alone."""
    q, k, v = [x.requires_grad_(True) for x in _qkv(
        2, 150, 6, 2, 64, torch.float32, cuda, seed=3)]
    do = torch.randn(2, 150, 6, 64, device=cuda)
    fa.reset_launch_counts()
    out = fa.flash_attention(q, k, v)
    grads = torch.autograd.grad(out, (q, k, v), do)
    torch.cuda.synchronize()
    assert fa.launch_counts[fa.FLASHATTN] == 1
    assert fa.launch_counts[fa.FLASHATTN_BWD] == 1
    fa.reset_launch_counts()
    plain = fa.flash_attention(q, k, v, use_kernel=False)
    want = torch.autograd.grad(plain, (q, k, v), do)
    assert sum(fa.launch_counts.values()) == 0
    torch.testing.assert_close(out, plain, rtol=3e-5, atol=3e-5)
    for g, w in zip(grads, want):
        assert _rel_l2(g, w) <= 1e-4
    with torch.no_grad():
        fa.flash_attention(q, k, v)
    assert fa.launch_counts[fa.FLASHATTN] == 1
    assert fa.launch_counts[fa.FLASHATTN_BWD] == 0


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("config", ["llama3_2_3b", "gemma3_27b"])
def test_smoke_config_train_step_launch_counts(cuda, config, remat):
    """One AdamW step of a smoke config (float32, head dim 16) on the
    card: each layer's attention one K5 launch in the forward (two for a
    group's layer under remat "full": the backward recomputes it; the
    remainder layers run outside remat) and one K5 bwd launch, a local
    layer's in the window modes; the loss within 1e-5 of the CPU step's
    and each leaf's gradient (AdamW's first moment, (1 - b1) g after one
    step) within 1e-4 of it in relative L2.  The parameters are not
    compared: Adam's first update g / (|g| + eps) turns a 1e-9 gradient
    gap at |g| ~ eps into ~lr."""
    import dataclasses
    import importlib
    from repro_torch.data import lm_batch_fn
    from repro_torch.models import transformer as lm
    from repro_torch.optim import AdamWConfig, init_state
    from repro_torch.train import make_train_step
    from repro_torch.tree import tree_leaves, tree_map
    mod = importlib.import_module(f"repro_torch.configs.{config}")
    cfg = dataclasses.replace(mod.make_smoke_config(), remat=remat)
    params = lm.init_params(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    batch = {k: torch.from_numpy(x) for k, x in
             lm_batch_fn(cfg.vocab, 2, 96, seed=1)(0).items()}
    step = make_train_step(lambda p, b: lm.lm_loss(p, b, cfg),
                           AdamWConfig(), donate=True)
    gpu = tree_map(lambda x: x.to(cuda), params)
    _, want_s, want = step(params, init_state(params), batch)
    fa.reset_launch_counts()
    _, got_s, got = step(gpu, init_state(gpu),
                         {k: x.to(cuda) for k, x in batch.items()})
    torch.cuda.synchronize()
    kinds = [kind for _, kind in lm._layers(params, cfg)]
    grouped = cfg.n_groups * len(cfg.layer_pattern)
    fwd = {"local": 0, "global": 0}
    for i, kind in enumerate(kinds):
        fwd[kind] += 2 if remat and i < grouped else 1
    assert fa.launch_counts == {
        fa.FLASHATTN: fwd["global"], fa.FLASHATTN_WINDOW: fwd["local"],
        fa.FLASHATTN_BWD: kinds.count("global"),
        fa.FLASHATTN_BWD_WINDOW: kinds.count("local")}
    assert abs(float(got["loss"]) - float(want["loss"])) \
        <= 1e-5 * abs(float(want["loss"]))
    for g, w in zip(tree_leaves(got_s["m"]), tree_leaves(want_s["m"])):
        assert _rel_l2(g.cpu(), w) <= 1e-4


# ---------------------------------------------------------------------------
# The weighted lane's kernels: W1 (min-plus relaxation), W2 (DAG count)
# ---------------------------------------------------------------------------

def _weighted(graph, seed=0):
    return tc.with_weights(graph, tc.symmetric_dyadic_weights(graph,
                                                              seed=seed))


def _relax_state(graph, batch, seed):
    """A mid-search state on the CPU: tentative distances of a finished
    search with a random third set back to +inf, and a random bucket
    (some of it on +inf rows, which must give +inf)."""
    gen = torch.Generator().manual_seed(seed)
    # sources with a neighbour (an R-MAT has isolated vertices)
    linked = torch.nonzero(graph.degree > 0)[:, 0]
    sources = linked[torch.randint(0, linked.shape[0], (batch,),
                                   generator=gen)].to(torch.int32)
    res = tc.delta_sssp_batched(graph, sources)
    tent = torch.where(res.dist >= 0, res.dist, float("inf"))
    tent = torch.where(torch.rand(tent.shape, generator=gen) < 0.3,
                       float("inf"), tent).contiguous()
    active = torch.rand(tent.shape, generator=gen) < 0.4
    return res, tent, active


@pytest.mark.parametrize("batch", [1, 8, 33, 64, 96])
@pytest.mark.parametrize("split", [tf.PULL_SPLIT, 5])
def test_relax_kernel_matches_plain(cuda, batch, split):
    """W1 at B = 1 .. 96 (1 or 4 columns a lane), hub rows cut into
    items at ``split``, rows past the plan's +inf: bitwise its plain
    versions (min is exact) over the plan and over the COO edges, one
    launch."""
    cpu = _weighted(tc.rmat_graph(10, 8, seed=4, device="cpu"), seed=batch)
    _res, tent, active = _relax_state(cpu, batch, seed=split)
    tent = torch.cat([tent, tent.new_full((5, batch), float("inf"))])
    active = torch.cat([active, active.new_ones((5, batch))])
    graph = cpu.to(cuda)
    plan = tf.build_relax_plan(graph.src, graph.dst, graph.weight,
                               graph.n_nodes + 1, split=split)
    assert split == tf.PULL_SPLIT or plan.plan.n_items > 0
    tf.reset_launch_counts()
    got = tf.frontier_relax_pull(plan, tent.to(cuda), active.to(cuda))
    torch.cuda.synchronize()
    assert tf.weighted_launch_counts[tf.RELAX] == 1
    cplan = tf.build_relax_plan(cpu.src, cpu.dst, cpu.weight,
                                cpu.n_nodes + 1, split=split)
    want = tf.frontier_relax_pull_ref(cplan, tent, active, tent.shape[0])
    coo = tf.frontier_relax_batched_ref(cpu.src, cpu.dst, cpu.weight, tent,
                                        active)
    assert torch.equal(want, coo)
    assert torch.equal(got.cpu(), want)
    assert bool(torch.isfinite(want).any())
    assert not bool(torch.isfinite(got[cpu.n_nodes:]).any())


def test_relax_kernel_on_a_star_hub_and_isolated_rows(cuda):
    """A hub over 3 splits (items and the combine) beside isolated
    vertices: the hub's row is the min over its items, an isolated row
    +inf."""
    leaves = 3 * tf.PULL_SPLIT + 17
    ids = torch.arange(1, leaves + 1)
    cpu = tc.from_edge_list(torch.stack([torch.zeros_like(ids), ids], 1),
                            leaves + 40, device="cpu")
    cpu = _weighted(cpu, seed=3)
    gen = torch.Generator().manual_seed(0)
    tent = (torch.randint(0, 64, (cpu.n_nodes + 1, 8), generator=gen)
            / 16.0).float()
    active = torch.rand(tent.shape, generator=gen) < 0.5
    graph = cpu.to(cuda)
    plan = graph.relax_plan()
    assert plan.plan.n_items == 4
    got = tf.frontier_relax_pull(plan, tent.to(cuda), active.to(cuda))
    want = tf.frontier_relax_batched_ref(cpu.src, cpu.dst, cpu.weight, tent,
                                         active)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    assert bool(torch.isfinite(want[0]).all())
    assert not bool(torch.isfinite(want[leaves + 1: cpu.n_nodes]).any())


def _dag_state(graph, batch, seed):
    """Converged distances, a random final mask over the reached cells
    and non-integer sigma: what one DAG round may see."""
    res, _t, _a = _relax_state(graph, batch, seed)
    tent = torch.where(res.dist >= 0, res.dist, float("inf")).contiguous()
    gen = torch.Generator().manual_seed(seed + 1)
    final = (torch.rand(tent.shape, generator=gen) < 0.5) \
        | ~torch.isfinite(tent)
    sigma = (torch.rand(tent.shape, generator=gen) * 7.0).contiguous()
    return tent, sigma, final


@pytest.mark.parametrize("batch", [1, 8, 33, 64, 96])
@pytest.mark.parametrize("split", [tf.PULL_SPLIT, 5])
def test_dag_kernel_matches_plain(cuda, batch, split):
    """W2 at B = 1 .. 96 on non-integer sigma: bitwise its plan-order
    plain version (each row's in-edges in plan order, a cut row's
    partials in item order), the same bits twice, the waiting bits
    equal; one launch."""
    cpu = _weighted(tc.rmat_graph(10, 8, seed=5, device="cpu"), seed=batch)
    tent, sigma, final = _dag_state(cpu, batch, seed=split)
    graph = cpu.to(cuda)
    plan = tf.build_relax_plan(graph.src, graph.dst, graph.weight,
                               graph.n_nodes + 1, split=split)
    args = (tent.to(cuda), sigma.to(cuda), final.to(cuda))
    tf.reset_launch_counts()
    a = tf.dag_sigma_pull(plan, *args)
    b = tf.dag_sigma_pull(plan, *args)
    torch.cuda.synchronize()
    assert tf.weighted_launch_counts[tf.DAG_SIGMA] == 2
    cplan = tf.build_relax_plan(cpu.src, cpu.dst, cpu.weight,
                                cpu.n_nodes + 1, split=split)
    want = tf.dag_sigma_pull_ref(cplan, tent, sigma, final, tent.shape[0])
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert torch.equal(a[0].cpu(), want[0])
    assert torch.equal(a[1].cpu(), want[1])
    assert bool(want[1].any()) and bool((want[0] > 0).any())
    assert not bool(a[0][final.to(cuda)].any())


def test_dag_kernel_on_a_star_hub(cuda):
    """Every leaf on the hub's DAG (unit weights from the hub's source):
    the hub row of a leaf-rooted search sums over its items through the
    combine, in item order."""
    leaves = 3 * tf.PULL_SPLIT + 17
    ids = torch.arange(1, leaves + 1)
    cpu = tc.from_edge_list(torch.stack([torch.zeros_like(ids), ids], 1),
                            leaves + 1, device="cpu")
    cpu = tc.with_weights(cpu, torch.ones(cpu.n_edges))
    tent = torch.full((cpu.n_nodes + 1, 4), float("inf"))
    tent[1:leaves + 1] = 1.0
    tent[0] = 2.0
    final = ~torch.isfinite(tent)
    final[1:leaves + 1] = True
    sigma = torch.rand(tent.shape, generator=torch.Generator().manual_seed(
        2))
    graph = cpu.to(cuda)
    got = tf.dag_sigma_pull(graph.relax_plan(), tent.to(cuda),
                            sigma.to(cuda), final.to(cuda))
    want = tf.dag_sigma_pull_ref(cpu.relax_plan(), tent, sigma, final,
                                 tent.shape[0])
    torch.cuda.synchronize()
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])
    assert bool((want[0][0] > 0).all()) and not bool(want[1].any())


@pytest.mark.parametrize("shard", [None, 0, 3])
def test_weighted_sharded_level_kernels_match_plain(cuda, shard):
    """W1 and W2 over a weighted sharded layout (whole, or one rank's
    local one) from the gathered state: one launch each for every held
    shard, bitwise the per-shard plain versions."""
    cpu = _weighted(tc.rmat_graph(10, 8, seed=6, device="cpu"), seed=1)
    kw = dict(block_v=64, block_e=128, shard=shard)
    pg_cpu = tc.partition_graph(cpu, 4, **kw)
    pg = tc.partition_graph(cpu.to(cuda), 4, **kw)
    _res, tent, active = _relax_state(cpu, 64, seed=2)
    pad = pg.v_pad - tent.shape[0]
    tent = torch.cat([tent, tent.new_full((pad, 64), float("inf"))])
    active = torch.cat([active, active.new_zeros((pad, 64))])
    tf.reset_launch_counts()
    got = tf.frontier_relax(None, None, None, tent.to(cuda), active.to(cuda),
                            shards=pg.shards)
    want = tf.frontier_relax(None, None, None, tent, active,
                             shards=pg_cpu.shards)
    dt, sigma, final = _dag_state(cpu, 64, seed=3)
    dt = torch.cat([dt, dt.new_full((pad, 64), float("inf"))])
    sigma = torch.cat([sigma, sigma.new_zeros((pad, 64))])
    final = torch.cat([final, final.new_ones((pad, 64))])
    gs, gw = tf.dag_sigma(None, None, None, dt.to(cuda), sigma.to(cuda),
                          final.to(cuda), shards=pg.shards)
    ws, ww = tf.dag_sigma(None, None, None, dt, sigma, final,
                          shards=pg_cpu.shards)
    torch.cuda.synchronize()
    assert tf.weighted_launch_counts == {tf.RELAX: 1, tf.DAG_SIGMA: 1}
    assert torch.equal(got.cpu(), want) and torch.equal(gw.cpu(), ww)
    assert torch.equal(gs.cpu(), ws)
    assert got.shape == (pg.shards.n_local_shards, pg.shard_rows, 64)


def test_weighted_search_on_the_card_matches_the_cpu(cuda):
    """delta_sssp_batched on the card (every round through W1, every DAG
    round through W2) gives the CPU's dist, sigma, levels and buckets on
    a weighted grid; the 64 x 64 unit grid's levels are the BFS's 126."""
    unit = tc.grid_graph(64, 64, device="cpu")
    for cpu, delta in ((_weighted(tc.grid_graph(30, 20, device="cpu")),
                        None),
                       (tc.with_weights(unit, torch.ones(unit.n_edges)),
                        1.0)):
        graph = cpu.to(cuda)
        sources = torch.tensor([0, 7, 99, 311], dtype=torch.int32)
        tf.reset_launch_counts()
        got = tc.delta_sssp_batched(graph, sources.to(cuda), delta=delta)
        torch.cuda.synchronize()
        assert tf.weighted_launch_counts == {tf.RELAX: got.n_iters,
                                             tf.DAG_SIGMA: got.n_dag_rounds}
        want = tc.delta_sssp_batched(cpu, sources, delta=delta)
        for f in ("dist", "sigma", "levels", "buckets"):
            assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), f
    assert int(got.levels[0]) == 126


def test_weighted_run_on_the_card(cuda):
    """run_adaptive on the weighted stream: every relaxation round one
    W1 launch, every DAG round one W2 launch, one stop check a metric an
    epoch; finite scores."""
    import numpy as np
    graph = _weighted(tc.hyperbolic_graph(300, 8, seed=2, device=cuda))
    tf.reset_launch_counts()
    ts.reset_launch_counts()
    res = tc.run_adaptive(graph, ("betweenness", "closeness"),
                          stream="weighted", eps=0.1, device=cuda)
    torch.cuda.synchronize()
    assert tf.weighted_launch_counts == {tf.RELAX: res.bfs_levels,
                                         tf.DAG_SIGMA: res.dag_rounds}
    assert res.bfs_levels > 0 and res.dag_rounds > 0
    assert tf.launch_counts[tf.FLAT] == tf.launch_counts[tf.WORDS] == 0
    assert ts.launch_counts[ts.STOPCHECK] == 2 * res.n_epochs
    assert res.distance_cap > 0
    for rep in res.reports:
        assert np.isfinite(rep.scores).all()


# ---------------------------------------------------------------------------
# MoE routing and serving, MIND: the card against the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("experts,k", [(40, 8), (64, 6), (4, 2)])
def test_moe_route_on_the_card_is_the_cpu_s(cuda, experts, k):
    """``route`` on the same float32 probabilities, as drawn and rounded
    to multiples of 2^-6 (ties at most tokens' k-th expert): expert ids,
    kept choices and slots bitwise the CPU's."""
    from repro_torch.models import moe
    cfg = moe.MoEConfig(n_experts=experts, top_k=k, d_model=8, d_ff=8)
    gen = torch.Generator(device=cuda).manual_seed(experts)
    logits = torch.randn((3, 1024, experts), generator=gen, device=cuda)
    probs = torch.softmax(logits, -1)
    for p in (probs, torch.round(probs * 64) / 64):
        card, host = moe.route(p, cfg), moe.route(p.cpu(), cfg)
        for name in ("expert_ids", "keep", "pos"):
            assert torch.equal(getattr(card, name).cpu(),
                               getattr(host, name)), name


def test_moe_smoke_prefill_on_the_card(cuda):
    """granite's smoke config (float32, head dim 16, 4 experts top-2)
    prefilled on the card: one K5 launch a layer, logits within float32
    reach of the CPU's plain route; a decode step launches none."""
    from repro_torch.configs.granite_moe_3b_a800m import make_smoke_config
    from repro_torch.models import transformer as lm
    from repro_torch.tree import tree_map
    cfg = make_smoke_config()
    params = lm.init_params(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    tokens = torch.randint(0, cfg.vocab, (2, 96),
                           generator=torch.Generator().manual_seed(1))
    want, _ = lm.prefill_step(params, tokens, cfg)
    gpu_params = tree_map(lambda x: x.to(cuda), params)
    fa.reset_launch_counts()
    got, cache = lm.prefill_step(gpu_params, tokens.to(cuda), cfg)
    torch.cuda.synchronize()
    assert fa.launch_counts[fa.FLASHATTN] == cfg.n_layers
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    fa.reset_launch_counts()
    lm.decode_step(gpu_params, lm.grow_cache(cache, 1),
                   got.argmax(-1)[:, None], cfg)
    torch.cuda.synchronize()
    assert fa.launch_counts[fa.FLASHATTN] == 0


def test_mind_on_the_card_matches_the_cpu(cuda):
    """MIND's smoke config: serving, retrieval and the training loss on
    the card within 1e-5 of the CPU's, same weights and batch."""
    from repro_torch.configs.mind import make_smoke_config
    from repro_torch.data import recsys_batch_fn
    from repro_torch.models import recsys
    cfg = make_smoke_config()
    params = recsys.init_params(torch.Generator().manual_seed(0), cfg,
                                device="cpu")
    batch = recsys_batch_fn(cfg.n_items, 64, cfg.hist_len,
                            device="cpu")(0)
    gp = {k: v.to(cuda) for k, v in params.items()}
    gb = {k: v.to(cuda) for k, v in batch.items()}
    torch.testing.assert_close(recsys.serve_interests(gp, gb, cfg).cpu(),
                               recsys.serve_interests(params, batch, cfg),
                               rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(recsys.train_loss(gp, gb, cfg).cpu(),
                               recsys.train_loss(params, batch, cfg),
                               rtol=1e-5, atol=1e-6)
    cand = torch.arange(cfg.n_items, dtype=torch.int32)
    one = {"hist": batch["hist"][:1], "hist_mask": batch["hist_mask"][:1],
           "candidates": cand}
    torch.testing.assert_close(
        recsys.retrieval_scores(gp,
                                {k: v.to(cuda) for k, v in one.items()},
                                cfg).cpu(),
        recsys.retrieval_scores(params, one, cfg), rtol=1e-5, atol=1e-6)
