"""Frontier expansion of the PyTorch port against the JAX package.

The inputs are BFS-derived (sigma holds exact small integers), so every
summation order gives the same bits: the port's plain versions must equal
the JAX XLA references and the JAX Pallas kernels (interpret mode) bit
for bit.  Also the bitmap helpers, the frontier words of the
node-blocked route (which must reproduce the JAX row mask and block
bitmap), the CPU behaviour of the kernel wrappers, and the dispatcher's
routes and forced-lane errors.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jc
from repro.kernels.frontier import (frontier_block_bitmap as j_bitmap,
                                    frontier_expand_batched_pallas,
                                    frontier_expand_batched_ref,
                                    frontier_expand_node_blocked_pallas,
                                    frontier_expand_node_blocked_ref,
                                    frontier_expand_ref,
                                    frontier_row_mask as j_row_mask)
from repro_torch.kernels import frontier as tf
from _torch_parity import np_, to_port

GRAPHS = {
    "er": lambda: jc.erdos_renyi_graph(257, 6.0, seed=3),
    "grid": lambda: jc.grid_graph(16, 12),
    "rmat": lambda: jc.rmat_graph(8, 8, seed=5),
}


def _state(jgraph, batch, seed):
    rng = np.random.default_rng(seed)
    sources = jnp.asarray(rng.integers(0, jgraph.n_nodes, batch), jnp.int32)
    res = jc.bfs_sssp_batched(jgraph, sources)
    levels = jnp.asarray(rng.integers(0, 4, batch), jnp.int32)
    return res.dist, res.sigma, levels


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("name,batch", [("er", 5), ("grid", 3),
                                        ("rmat", 8), ("rmat", 1)])
def test_flat_matches_jax_ref_and_pallas(name, batch):
    jgraph = GRAPHS[name]()
    dist, sigma, levels = _state(jgraph, batch, seed=batch)
    want = np_(frontier_expand_batched_ref(jgraph.src, jgraph.dst, dist,
                                           sigma, levels))
    pallas = np_(frontier_expand_batched_pallas(
        jgraph.src, jgraph.dst, dist, sigma, levels, interpret=True))
    g = to_port(jgraph)
    got = tf.frontier_expand(g.src, g.dst, _t(dist), _t(sigma), _t(levels))
    np.testing.assert_array_equal(np_(got), want)
    np.testing.assert_array_equal(np_(got), pallas)
    np.testing.assert_array_equal(np_(tf.frontier_expand_batched_ref(
        g.src, g.dst, _t(dist), _t(sigma), _t(levels))), want)


@pytest.mark.parametrize("name,block_v,block_e,padded", [
    ("er", 64, 128, False), ("grid", 37, 128, True),
    ("rmat", 100, 256, True)])
def test_node_blocked_matches_jax_ref_and_pallas(name, block_v, block_e,
                                                 padded):
    jgraph = GRAPHS[name]()
    csc = jc.build_csc_layout(jgraph, block_v=block_v, block_e=block_e)
    dist, sigma, levels = _state(jgraph, 4, seed=block_v)
    if padded:      # the CSC-aware driver's (v_pad, B) allocation
        extra = csc.v_pad - dist.shape[0]
        dist = jnp.pad(dist, ((0, extra), (0, 0)), constant_values=-3)
        sigma = jnp.pad(sigma, ((0, extra), (0, 0)))
    want = np_(frontier_expand_node_blocked_ref(csc, dist, sigma, levels))
    pallas = np_(frontier_expand_node_blocked_pallas(csc, dist, sigma,
                                                     levels, interpret=True))
    tcsc = to_port(dataclasses.replace(jgraph, csc=csc)).csc
    got = np_(tf.frontier_expand_node_blocked_ref(tcsc, _t(dist), _t(sigma),
                                                  _t(levels)))
    assert got.shape == want.shape == tuple(dist.shape)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, pallas)


def test_unbatched_dispatch_matches_jax():
    jgraph = GRAPHS["grid"]()
    dist, sigma, _ = _state(jgraph, 1, seed=2)
    d1, s1 = dist[:, 0], sigma[:, 0]
    want = np_(frontier_expand_ref(jgraph.src, jgraph.dst, d1, s1, 3))
    g = to_port(jgraph)
    got = tf.frontier_expand(g.src, g.dst, _t(d1), _t(s1), 3)
    assert got.shape == (jgraph.n_nodes + 1,)
    np.testing.assert_array_equal(np_(got), want)


def test_bitmap_helpers_match_jax():
    jgraph = GRAPHS["rmat"]()
    csc = jc.build_csc_layout(jgraph, block_v=64, block_e=128)
    dist, sigma, levels = _state(jgraph, 6, seed=9)
    active = jnp.asarray([True, False, True, True, False, True])
    tcsc = to_port(dataclasses.replace(jgraph, csc=csc)).csc
    np.testing.assert_array_equal(
        np_(tf.frontier_row_mask(_t(dist), _t(levels))),
        np_(j_row_mask(dist, levels)))
    np.testing.assert_array_equal(
        np_(tf.frontier_row_mask(_t(dist), _t(levels), _t(active))),
        np_(j_row_mask(dist, levels, active)))
    got = np_(tf.frontier_block_bitmap(tcsc, _t(dist), _t(levels)))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, np_(j_bitmap(csc, dist, levels)))
    assert 0 < got.sum() < csc.n_edge_blocks


@pytest.mark.parametrize("batch", [1, 5, 8, 31, 32, 33, 64, 65])
def test_words_ref_unpacks_to_the_frontier(batch):
    """Bit b % 32 of word b // 32 is dist[:, b] == levels[b], bit for
    bit, and the padding bits of the last word are clear."""
    rng = np.random.default_rng(batch)
    dist = torch.from_numpy(rng.integers(-3, 4, (300, batch)).astype(
        np.int32))
    levels = torch.from_numpy(rng.integers(0, 3, batch).astype(np.int32))
    words = tf.frontier_words_ref(dist, levels)
    assert words.dtype == torch.int32
    assert words.shape == (300, -(-batch // 32))
    bits = (words.long()[:, :, None] >> torch.arange(32)) & 1
    bits = bits.reshape(300, -1).bool()
    assert torch.equal(bits[:, :batch], dist == levels[None, :])
    assert not bool(bits[:, batch:].any())


@pytest.mark.parametrize("name,batch", [("rmat", 8), ("er", 33),
                                        ("grid", 3)])
def test_words_or_is_the_jax_row_mask(name, batch):
    """A row's words OR-ed together are non-zero exactly on the JAX
    ``frontier_row_mask``."""
    dist, _, levels = _state(GRAPHS[name](), batch, seed=batch)
    words = tf.frontier_words_ref(_t(dist), _t(levels))
    np.testing.assert_array_equal(np_((words != 0).any(dim=1)),
                                  np_(j_row_mask(dist, levels)))


@pytest.mark.parametrize("name,block_v,block_e,padded", [
    ("er", 64, 128, False), ("grid", 37, 128, True),
    ("rmat", 100, 256, True)])
def test_words_or_over_edge_blocks_is_the_jax_bitmap(name, block_v, block_e,
                                                     padded):
    """The words of each edge block's sources OR-ed together are
    non-zero exactly on the JAX ``frontier_block_bitmap``: the block
    skip the node-blocked kernel decides by itself."""
    jgraph = GRAPHS[name]()
    csc = jc.build_csc_layout(jgraph, block_v=block_v, block_e=block_e)
    dist, _, levels = _state(jgraph, 4, seed=block_v)
    if padded:
        dist = jnp.pad(dist, ((0, csc.v_pad - dist.shape[0]), (0, 0)),
                       constant_values=-3)
    tcsc = to_port(dataclasses.replace(jgraph, csc=csc)).csc
    words = tf.frontier_words_ref(_t(dist), _t(levels))
    hit = (words[tcsc.src.long()] != 0).any(dim=1)
    got = hit.view(tcsc.n_edge_blocks, tcsc.block_e).any(dim=1)
    want = np_(j_bitmap(csc, dist, levels))
    np.testing.assert_array_equal(np_(got).astype(np.int32), want)
    assert 0 < want.sum() < csc.n_edge_blocks


def test_cpu_wrappers_run_the_plain_version_without_launching():
    """On CPU tensors the kernel wrappers return the plain version's
    result and count no launch."""
    jgraph = GRAPHS["rmat"]()
    g = to_port(jgraph)
    from repro_torch.core import build_csc_layout
    csc = build_csc_layout(g, block_v=64, block_e=128)
    dist, sigma, levels = (_t(x) for x in _state(jgraph, 4, seed=1))
    before = dict(tf.launch_counts)
    flat = tf.frontier_expand_flat(g.src, g.dst, dist, sigma, levels)
    nb = tf.frontier_expand_node_blocked(csc, dist, sigma, levels)
    words, zeros = tf.frontier_words(dist, levels)
    want = tf.frontier_expand_batched_ref(g.src, g.dst, dist, sigma, levels)
    assert torch.equal(flat, want) and torch.equal(nb, want)
    assert torch.equal(words, tf.frontier_words_ref(dist, levels))
    assert zeros.shape == dist.shape and not bool(zeros.any())
    assert tf.launch_counts == before


def test_wrappers_reject_bad_state():
    g = to_port(GRAPHS["grid"]())
    dist = torch.zeros((g.n_nodes + 1, 2), dtype=torch.int32)
    with pytest.raises(TypeError):
        tf.frontier_expand_flat(g.src, g.dst, dist, dist.float().double(),
                                torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError):
        tf.frontier_expand_flat(g.src, g.dst, dist,
                                torch.zeros((g.n_nodes, 2)),
                                torch.zeros(2, dtype=torch.int32))


class _Layout:
    def __init__(self, block_e):
        self.block_e = block_e


@pytest.mark.parametrize("cuda,csc,lane,route", [
    (False, None, None, "ref"),
    (False, _Layout(1024), None, "ref"),
    (False, None, "ref", "ref"),
    (True, None, None, "flat"),
    (True, _Layout(1024), None, "node_blocked"),
    (True, _Layout(1024), "flat", "flat"),
    (True, _Layout(29_056), "node_blocked", "node_blocked"),
])
def test_select_route(cuda, csc, lane, route):
    assert tf.select_route(cuda=cuda, csc=csc, lane=lane) == route


@pytest.mark.parametrize("cuda,csc,lane,match", [
    (False, None, "flat", "CPU"),
    (False, _Layout(1024), "node_blocked", "CPU"),
    (True, None, "node_blocked", "CSCLayout"),
    (True, _Layout(29_057), "node_blocked", "shared memory"),
    (True, _Layout(1024 * 64), None, "shared memory"),
    (True, None, "ref", "CPU tensors"),
    (True, None, "pallas", "unknown lane"),
])
def test_forced_lane_errors(cuda, csc, lane, match):
    with pytest.raises(ValueError, match=match):
        tf.select_route(cuda=cuda, csc=csc, lane=lane)


def test_dispatcher_forced_kernel_on_cpu_raises():
    g = to_port(GRAPHS["grid"]())
    dist = torch.full((g.n_nodes + 1, 2), -1, dtype=torch.int32)
    sigma = torch.zeros(dist.shape)
    with pytest.raises(ValueError, match="CPU"):
        tf.frontier_expand(g.src, g.dst, dist, sigma, [0, 0], lane="flat")
