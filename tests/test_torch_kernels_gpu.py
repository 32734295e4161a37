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
from repro_torch.kernels import frontier as tf
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
    graph = tc.rmat_graph(12, 16, seed=1, device=cuda)
    dist, sigma, levels = _state(graph, batch)
    before = tf.launch_counts[tf.FLAT]
    got = tf.frontier_expand_flat(graph.src, graph.dst, dist, sigma, levels)
    want = tf.frontier_expand_batched_ref(graph.src, graph.dst, dist, sigma,
                                          levels)
    torch.cuda.synchronize()
    assert tf.launch_counts[tf.FLAT] == before + 1
    assert want.max() < 2 ** 24        # exact integer sums: bitwise
    assert torch.equal(got, want)


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
    # an all-ones bitmap (skip nothing) gives the same bits
    from repro_torch.kernels.frontier.kernel import _launch_node_blocked
    every = _launch_node_blocked(
        csc, dist, sigma, levels.to(torch.int32),
        torch.ones(csc.n_edge_blocks, dtype=torch.int32, device=cuda))
    torch.cuda.synchronize()
    assert got.shape == dist.shape
    assert torch.equal(got, want) and torch.equal(every, want)


def test_dispatcher_routes_cuda_state_to_kernels(cuda):
    graph = tc.grid_graph(20, 20, device=cuda)
    dist, sigma, levels = _state(graph, 4)
    tf.reset_launch_counts()
    tf.frontier_expand(graph.src, graph.dst, dist, sigma, levels)
    csc = tc.build_csc_layout(graph, block_v=128, block_e=256)
    tf.frontier_expand(graph.src, graph.dst, dist, sigma, levels, csc=csc)
    assert tf.launch_counts == {tf.FLAT: 1, tf.NODE_BLOCKED: 1}
    with pytest.raises(ValueError, match="CPU tensors"):
        tf.frontier_expand(graph.src, graph.dst, dist, sigma, levels,
                           lane="ref")


def test_run_kadabra_on_the_card(cuda):
    graph = tc.hyperbolic_graph(300, 20.0, seed=1, device=cuda)
    tf.reset_launch_counts()
    ts.reset_launch_counts()
    res = tc.run_kadabra(graph, eps=0.05, device=cuda)
    assert tf.launch_counts[tf.FLAT] == res.bfs_levels > 0
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
    assert tf.launch_counts[tf.FLAT] == res.bfs_levels > 0
    assert ts.launch_counts[ts.STOPCHECK] == 3 * res.n_epochs > 0
    assert res.converged
    assert np.abs(res.reports[0].scores
                  - tc.brandes_numpy(graph)).max() < 0.05
