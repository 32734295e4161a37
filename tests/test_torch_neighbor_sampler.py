"""The port's data pipeline against the JAX package's: the layer-wise
``NeighborSampler`` (its samples and their GraphBatch bitwise, every
leaf) and the ``PrefetchIterator``; GraphSAGE on a sampled batch; the
``minibatch_lg`` cell's shape, which 1,024 seeds at fanouts 15-10 fill
exactly."""
import jax
import numpy as np
import pytest
import torch

import repro.core as jc
import repro.data.pipeline as jpipe
import repro.models.gnn.models as jm
import repro_torch.models.gnn as tg
from repro_torch.configs._families import GNN_SHAPES
from repro_torch.data import NeighborSampler, PrefetchIterator
from _torch_parity import np_, to_port

SAMPLE_KEYS = ("node_ids", "src", "dst", "edge_mask", "n_seeds")


@pytest.fixture(scope="module")
def graphs():
    # R-MAT 2^9 x 4 leaves vertices of degree 0 (masked edges)
    jgraph = jc.rmat_graph(9, 4, seed=2)
    tgraph = to_port(jgraph)
    assert bool((np.diff(np.asarray(jgraph.indptr)) == 0).any())
    return jgraph, tgraph


def _same_sample(got, want):
    assert sorted(got) == sorted(want) == sorted(SAMPLE_KEYS)
    for k in SAMPLE_KEYS:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert g.tobytes() == w.tobytes(), k


@pytest.mark.parametrize("fanouts,batch_nodes,seed", [((15, 10), 32, 0),
                                                      ((5, 3, 2), 7, 3),
                                                      ((4,), 100, 11)])
def test_sample_is_bitwise_the_jax_samplers(graphs, fanouts, batch_nodes,
                                            seed):
    jgraph, tgraph = graphs
    js = jpipe.NeighborSampler(jgraph, fanouts, batch_nodes, seed=seed)
    ts = NeighborSampler(tgraph, fanouts, batch_nodes, seed=seed)
    assert (ts.layer_sizes, ts.total_nodes, ts.total_edges) == \
        (js.layer_sizes, js.total_nodes, js.total_edges)
    assert ts.indptr.tobytes() == js.indptr.tobytes()
    assert ts.indices.tobytes() == js.indices.tobytes()
    for step in (0, 1, 17):
        sub = ts.sample(step)
        _same_sample(sub, js.sample(step))
        assert len(sub["node_ids"]) == ts.total_nodes
        assert len(sub["src"]) == ts.total_edges
        assert (sub["edge_mask"] == 0).any()    # degree-0 frontier nodes


@pytest.mark.parametrize("pad", [None, (3000, 2700)])
def test_to_graph_batch_is_bitwise_the_jax_batch(graphs, pad):
    jgraph, tgraph = graphs
    rng = np.random.default_rng(4)
    feats = rng.standard_normal((jgraph.n_nodes, 12)).astype(np.float32)
    labels = rng.integers(0, 7, jgraph.n_nodes).astype(np.int32)
    kw = {} if pad is None else dict(pad_nodes=pad[0], pad_edges=pad[1])
    js = jpipe.NeighborSampler(jgraph, (8, 4), 64, seed=1)
    ts = NeighborSampler(tgraph, (8, 4), 64, seed=1)
    sub = ts.sample(3)
    want = js.to_graph_batch(js.sample(3), feats, labels, n_classes=7, **kw)
    got = ts.to_graph_batch(sub, feats, labels, n_classes=7, device="cpu",
                            **kw)
    assert got.n_graphs == want.n_graphs == 1
    assert got.n_nodes == (pad[0] if pad else ts.total_nodes)
    for name, t in got.tensors().items():
        j = np.asarray(getattr(want, name))
        assert np_(t).dtype == j.dtype and np_(t).shape == j.shape, name
        assert np_(t).tobytes() == j.tobytes(), name
    # the loss reads the seeds only
    assert float(got.node_mask.sum()) == 64.0


def test_graphsage_on_a_sampled_batch_matches_jax(graphs):
    """The sampled batch through GraphSAGE in both packages (weights
    carried across), within GraphSAGE's forward tolerance."""
    jgraph, tgraph = graphs
    rng = np.random.default_rng(5)
    feats = rng.standard_normal((jgraph.n_nodes, 16)).astype(np.float32)
    labels = rng.integers(0, 5, jgraph.n_nodes).astype(np.int32)
    js = jpipe.NeighborSampler(jgraph, (6, 3), 20, seed=2)
    ts = NeighborSampler(tgraph, (6, 3), 20, seed=2)
    jb = js.to_graph_batch(js.sample(0), feats, labels, n_classes=5)
    tb = ts.to_graph_batch(ts.sample(0), feats, labels, n_classes=5,
                           device="cpu")
    cfg = jm.SageConfig(d_in=16, d_hidden=32, n_classes=5)
    jp = jm.sage_init(jax.random.PRNGKey(0), cfg)
    tp = tg.sage_params_from_numpy(jax.tree.map(np.asarray, jp),
                                   device="cpu")
    tcfg = tg.SageConfig(d_in=16, d_hidden=32, n_classes=5)
    np.testing.assert_allclose(np_(tg.sage_forward(tp, tb, tcfg)),
                               np.asarray(jm.sage_forward(jp, jb, cfg)),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(tg.sage_loss(tp, tb, tcfg)),
                               float(jm.sage_loss(jp, jb, cfg)), rtol=1e-5)


def test_minibatch_lg_cell_is_filled_exactly(graphs):
    """1,024 seeds at fanouts 15-10: 169,984 nodes and 168,960 edges,
    the cell's padded sizes, so no padding is left."""
    _, tgraph = graphs
    cell = GNN_SHAPES["minibatch_lg"]
    ts = NeighborSampler(tgraph, (15, 10), 1024, seed=0)
    assert ts.layer_sizes == [1024, 15360, 153600]
    assert (ts.total_nodes, ts.total_edges) == (cell["nodes"], cell["edges"])
    sub = ts.sample(0)
    assert len(sub["node_ids"]) == cell["nodes"]
    assert len(sub["src"]) == cell["edges"]
    assert int(sub["dst"].max()) < 1024 + 15360    # parents: hops 0 and 1


def test_prefetch_iterator_yields_steps_in_order(graphs):
    _, tgraph = graphs
    ts = NeighborSampler(tgraph, (3,), 8, seed=4)
    it = PrefetchIterator(ts.sample, start_step=5, depth=2)
    try:
        for want_step in range(5, 9):
            step, sub = next(iter(it))
            assert step == want_step
            _same_sample(sub, ts.sample(step))
    finally:
        it.close()
    it._thread.join(timeout=5)
    assert not it._thread.is_alive()


def test_prefetch_iterator_matches_jax_on_its_batches():
    """The same step -> batch function gives the same (step, batch)
    sequence through either package's iterator."""
    def make(step):
        return np.random.default_rng((9, step)).standard_normal(4)

    its = (PrefetchIterator(make), jpipe.PrefetchIterator(make))
    try:
        for _ in range(3):
            (a_step, a), (b_step, b) = next(its[0]), next(its[1])
            assert a_step == b_step and a.tobytes() == b.tobytes()
    finally:
        for it in its:
            it.close()


def test_sampler_takes_a_graph_on_any_device_and_copies_its_csr(graphs):
    """The CSR comes to the host once; the batch goes to ``device``."""
    _, tgraph = graphs
    ts = NeighborSampler(tgraph, (2,), 4)
    assert isinstance(ts.indptr, np.ndarray) and ts.indptr.dtype == np.int32
    assert ts.indices.shape == (tgraph.n_edges,)
    sub = ts.sample(0)
    feats = np.zeros((tgraph.n_nodes, 3), np.float32)
    labels = np.zeros(tgraph.n_nodes, np.int32)
    b = ts.to_graph_batch(sub, feats, labels, n_classes=2, device="cpu")
    assert b.x.device == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ts.to_graph_batch(sub, feats, labels, n_classes=2)
