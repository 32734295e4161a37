"""Graph storage of the PyTorch port against the JAX package: every array
of the generators, of ``from_edge_list`` and of the CSC layout at an
explicit blocking is equal, element for element."""
import numpy as np
import pytest

import repro.core.graph as jg
import repro_torch.core.graph as tg
from _torch_parity import np_, to_port

GRAPHS = {
    "er": (lambda m: m.erdos_renyi_graph(200, 6.0, seed=3)),
    "grid": (lambda m: m.grid_graph(12, 9)),
    "grid_diag": (lambda m: m.grid_graph(10, 10, diag_p=0.3, seed=2)),
    "rmat": (lambda m: m.rmat_graph(8, 8, seed=5)),
    "hyperbolic": (lambda m: m.hyperbolic_graph(150, 12.0, seed=1)),
}
FIELDS = ("indptr", "indices", "src", "dst", "degree")


class _CpuPort:
    """The port's graph module with device='cpu' bound."""

    def __getattr__(self, name):
        fn = getattr(tg, name)
        return lambda *a, **k: fn(*a, device="cpu", **k)


def _port(name):
    return GRAPHS[name](_CpuPort())


def _assert_same_graph(tgraph, jgraph):
    for f in FIELDS:
        np.testing.assert_array_equal(np_(getattr(tgraph, f)),
                                      np_(getattr(jgraph, f)), err_msg=f)
        assert np_(getattr(tgraph, f)).dtype == np.int32
    assert (tgraph.n_nodes, tgraph.n_edges, tgraph.max_degree) == \
        (jgraph.n_nodes, jgraph.n_edges, jgraph.max_degree)
    assert tgraph.e_pad == jgraph.e_pad


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_generators_match_jax(name):
    _assert_same_graph(_port(name), GRAPHS[name](jg))


def test_from_edge_list_dedupes_like_jax():
    rng = np.random.default_rng(7)
    edges = rng.integers(0, 40, size=(300, 2))
    edges[:5, 1] = edges[:5, 0]            # self loops
    edges = np.concatenate([edges, edges[:30, ::-1]])   # duplicates
    _assert_same_graph(tg.from_edge_list(edges, 40, pad_to=64,
                                         device="cpu"),
                       jg.from_edge_list(edges, 40, pad_to=64))


@pytest.mark.parametrize("name,block_v,block_e", [
    ("rmat", 64, 128), ("er", 100, 256), ("grid", 37, 128),
    ("hyperbolic", 32, 128)])
def test_csc_layout_matches_jax(name, block_v, block_e):
    tl = tg.build_csc_layout(_port(name), block_v=block_v, block_e=block_e)
    jl = jg.build_csc_layout(GRAPHS[name](jg), block_v=block_v,
                             block_e=block_e)
    for f in ("src", "dst", "block_nb", "block_sb", "block_first"):
        np.testing.assert_array_equal(np_(getattr(tl, f)),
                                      np_(getattr(jl, f)), err_msg=f)
    for f in ("block_v", "block_e", "n_node_blocks", "n_edge_blocks",
              "n_nodes", "n_src_blocks", "v_pad", "e_slots"):
        assert getattr(tl, f) == getattr(jl, f), f


def test_graph_from_numpy_carries_jax_graph_and_layout():
    jgraph = jg.with_csc_layout(GRAPHS["rmat"](jg), block_v=64, block_e=128)
    tgraph = to_port(jgraph)
    _assert_same_graph(tgraph, jgraph)
    own = tg.with_csc_layout(_port("rmat"), block_v=64, block_e=128)
    for f in ("src", "dst", "block_nb", "block_sb", "block_first"):
        np.testing.assert_array_equal(np_(getattr(tgraph.csc, f)),
                                      np_(getattr(own.csc, f)))
    assert tgraph.csc.v_pad == own.csc.v_pad


def test_card_blocking_bounds_pair_padding():
    """The card's default blocking: 2^14-row node blocks, capped at the
    padded vertex count; every (destination, source) block pair pads to
    at most one extra edge block."""
    assert tg.choose_csc_blocks(100) == (128, tg.CSC_BLOCK_E)
    assert tg.choose_csc_blocks(1 << 20) == (1 << 14, tg.CSC_BLOCK_E)
    g = tg.rmat_graph(12, 16, seed=0, device="cpu")
    csc = tg.build_csc_layout(g)
    assert csc.block_v == -(-(g.n_nodes + 1) // 128) * 128
    assert csc.e_slots <= g.n_edges + csc.n_node_blocks ** 2 * csc.block_e
    # explicit blocking always wins
    assert tg.build_csc_layout(g, block_v=256).block_v == 256


def test_csc_layout_holds_every_edge_once():
    g = tg.rmat_graph(9, 8, seed=5, device="cpu")
    csc = tg.build_csc_layout(g, block_v=64, block_e=128)
    src, dst = np_(csc.src), np_(csc.dst)
    real = dst != g.n_nodes
    assert (src[~real] == g.n_nodes).all()
    got = set(zip(src[real].tolist(), dst[real].tolist()))
    want = set(zip(np_(g.src)[: g.n_edges].tolist(),
                   np_(g.dst)[: g.n_edges].tolist()))
    assert got == want and real.sum() == g.n_edges
    assert np_(csc.block_first).sum() == csc.n_node_blocks
