"""The port's CUDA kernels against their plain versions, on the card.

Run on a machine with a card:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_kernels_gpu.py

Without a card every test skips (the ``cuda`` fixture decides at run
time, so every worker collects the same tests).  This file imports
torch and the port only, so it runs where JAX is not installed.
"""
import pytest
import torch

import repro_torch.core as tc
from repro_torch.kernels import flashattn as fa
from repro_torch.kernels import frontier as tf
from repro_torch.kernels import segsum as tk
from repro_torch.kernels import stopcheck as ts

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
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
    assert tf.launch_counts == {tf.FLAT: 0, tf.NODE_BLOCKED: 1, tf.WORDS: 1}
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
    assert tf.launch_counts == {tf.FLAT: 1, tf.NODE_BLOCKED: 1, tf.WORDS: 2}
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


def _stop_inputs(v, device, seed=0):
    gen = torch.Generator().manual_seed(seed)
    counts = torch.randint(0, 200, (v,), generator=gen).float()
    lil = torch.rand(v, generator=gen) * 20 + 1e-3
    liu = torch.rand(v, generator=gen) * 20 + 1e-3
    return counts.to(device), lil.to(device), liu.to(device)


@pytest.mark.parametrize("v", [1, 1000, (1 << 20) + 3])
def test_stopcheck_kernel_matches_plain(cuda, v):
    counts, lil, liu = _stop_inputs(v, cuda, seed=v)
    omega = torch.tensor(84_000.0, device=cuda)
    before = ts.launch_counts[ts.STOPCHECK]
    got = ts.stopcheck_fused(counts, 17_408, lil, liu, omega)
    want = ts.stopcheck_ref(counts, 17_408, lil, liu, omega)
    torch.cuda.synchronize()
    assert ts.launch_counts[ts.STOPCHECK] == before + 1
    # explicitly rounded arithmetic in the plain version's order: bitwise
    assert torch.equal(got, want)


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


def test_segsum_kernel_is_deterministic_and_close_on_gaussian(cuda):
    """N(0, 1) table: two kernel calls give the same bits, and the kernel
    and the plain version (atomics, any order) each lie within the
    recursive-summation bound (n_s - 1) u sum|terms| of the exact sum, so
    within twice that of each other."""
    ids, seg, w, table = _segsum_inputs(50000, 2000, 128, 300, cuda,
                                        integer=False, skew=True)
    plan = tk.build_plan(ids, seg, 300, 2000)
    a = tk.gather_segment_sum_cuda(ids, seg, w, table, 300, plan)
    b = tk.gather_segment_sum_cuda(ids, seg, w, table, 300, plan)
    want = tk.gather_segment_sum_ref(ids, seg, w, table, 300)
    deg = torch.bincount(seg.long(), minlength=300).float()[:, None]
    tol = 2.0 * deg * 2.0 ** -24 * tk.gather_segment_sum_ref(
        ids, seg, w.abs(), table.abs(), 300)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    assert bool(((a - want).abs() <= tol).all())


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


def test_flash_kernel_reads_strided_views(cuda):
    """q, k, v as views into wider tensors (head and row strides that
    are not the contiguous ones): the same output as contiguous copies."""
    wide = torch.randn(2, 130, 6, 256, device=cuda).to(torch.bfloat16)
    kv = torch.randn(2, 130, 2, 384, device=cuda).to(torch.bfloat16)
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
