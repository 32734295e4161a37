"""The adaptive engine on the weighted stream, on every lane, on the CPU.

``run_adaptive(..., stream="weighted")`` against the exact weighted
Brandes oracle of the JAX weighted suite (scipy Dijkstra plus the
distance-ordered DP, normalized by n(n-1)); the sharded lane on a
``ShardMesh`` bitwise the replicated lane; one 4-rank gloo group with a
shard a rank (``GroupShardMesh``) and one 2-rank SPMD group, each a
single spawn (rank functions in ``tests/_torch_sharded_ranks.py`` and
``tests/_torch_spmd_ranks.py``); a checkpointed weighted run resumed
bitwise, and the stream in the checkpoint's stamp.
"""
import networkx as nx
import numpy as np
import pytest
import torch

import _torch_sharded_ranks as granks
import _torch_spmd_ranks as sranks
import repro_torch.core as tc
from _torch_parity import np_, to_port
from repro_torch.checkpoint import CheckpointSchemaError
from repro_torch.core import ShardMesh
from repro_torch.core.engine import draw_fold, resolve_estimators
from repro_torch.core.estimators.base import RunContext
from repro_torch.launch import spawn_local
from test_weighted import _brandes_weighted_numpy, _er_weighted, _scipy_dists

CPU = "cpu"
W = 4
N_GROUP = 64
WSEED = 5


@pytest.fixture(autouse=True)
def _one_thread():
    """Small cases: one intra-op thread keeps them from contending for
    the cores with the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jg():
    return _er_weighted(40, 90, seed=7)


@pytest.fixture(scope="module")
def exact(jg):
    return _brandes_weighted_numpy(jg)


def test_weighted_run_within_eps_of_weighted_brandes(jg, exact):
    g = to_port(jg)
    eps = 0.05
    res = tc.run_adaptive(g, ("betweenness", "closeness", "harmonic"),
                          eps=eps, delta=0.1, stream="weighted", seed=2,
                          device=CPU)
    bc, cl, ha = res.reports
    assert bc.converged and cl.converged and ha.converged
    assert np.abs(bc.scores - exact).max() < eps
    D = _scipy_dists(jg)
    n = jg.n_nodes
    assert np.isfinite(D).all()
    np.testing.assert_allclose(cl.scores, (n - 1) / D.sum(1), atol=0.1)
    H = np.where(D > 0, 1.0 / np.maximum(D, 1.0), 0.0)
    np.testing.assert_allclose(ha.scores, H.sum(0) / (n - 1), atol=0.1)
    # phase 1 is the weighted sweep: its bound is the closeness cap
    est = tc.estimate_diameter_weighted(
        g, torch.Generator().manual_seed(2))
    assert res.distance_cap == est.upper >= float(D.max())
    assert cl.extras["distance_cap"] == np.float32(est.upper)
    assert res.vertex_diameter == est.vertex_diameter
    assert res.bfs_levels > 0 and res.dag_rounds > 0


def test_run_fixed_weighted_all_metrics(jg, exact):
    reports = tc.run_fixed(to_port(jg), 1024,
                           metrics=("betweenness", "closeness", "harmonic"),
                           stream="weighted", seed=4, device=CPU)
    assert [r.name for r in reports] == ["betweenness", "closeness",
                                         "harmonic"]
    assert np.abs(reports[0].scores - exact).max() < 0.1
    for r in reports:
        assert r.tau == 1024 and np.isfinite(r.scores).all()


def test_sharded_weighted_lane_is_the_replicated_lane(jg):
    """ShardMesh(4): the search bitwise the replicated one (dist, sigma,
    levels, buckets), one exchange a round; a fold of weighted draws on
    the same generator bitwise; run_fixed and the adaptive run's phase 1
    the replicated lane's."""
    g = to_port(jg)
    pg = tc.partition_graph(g, W, block_v=8, block_e=128)
    mesh = ShardMesh(W, CPU)
    sources = np.arange(0, 40, 3, dtype=np.int32)
    rep = tc.delta_sssp_batched(g, sources)
    sh = tc.delta_sssp_batched_sharded(pg, sources, mesh=mesh)
    v1 = g.n_nodes + 1
    assert torch.equal(mesh.all_gather(sh.dist)[:v1], rep.dist)
    assert torch.equal(mesh.all_gather(sh.sigma)[:v1], rep.sigma)
    assert torch.equal(sh.levels, rep.levels)
    assert torch.equal(sh.buckets, rep.buckets)
    assert (sh.n_iters, sh.n_dag_rounds) == (rep.n_iters, rep.n_dag_rounds)
    assert int(sh.exchange[0]) == sh.n_iters
    ests = resolve_estimators(("betweenness", "harmonic"))
    ctx = RunContext(g.n_nodes, 0)
    folds = [draw_fold(x, torch.Generator().manual_seed(9), 40,
                       estimators=ests, ctx=ctx, stream="weighted",
                       batch_size=16, mesh=m)
             for x, m in ((g, None), (pg, mesh))]
    assert torch.equal(folds[0].counts, folds[1].counts)
    assert folds[0].n_dag_rounds == folds[1].n_dag_rounds > 0
    kw = dict(metrics=("closeness", "betweenness"), stream="weighted",
              seed=3, batch_size=8)
    for a, b in zip(tc.run_fixed(pg, 24, mesh=mesh, **kw),
                    tc.run_fixed(g, 24, device=CPU, **kw)):
        np.testing.assert_array_equal(a.scores, b.scores)
    est = tc.estimate_diameter_weighted_sharded(
        pg, mesh, torch.Generator().manual_seed(1))
    want = tc.estimate_diameter_weighted(g, torch.Generator().manual_seed(1))
    assert est[:3] == want[:3]


def _group_edges():
    return np.array(nx.connected_watts_strogatz_graph(
        N_GROUP, 6, 0.3, seed=1).edges(), dtype=np.int64)


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    edges = _group_edges()
    sources = np.arange(0, N_GROUP, 5, dtype=np.int32)
    root = tmp_path_factory.mktemp("weighted_group")
    out = spawn_local(granks.weighted_suite, W,
                      args=(edges, N_GROUP, WSEED, sources), timeout=300,
                      store_dir=str(root))
    return edges, sources, out


def test_group_shard_mesh_is_the_one_card_lane(group):
    """4 ranks, a shard each: every rank the same bits, and those of the
    one-process ShardMesh(4) lane on the whole partition (the search, an
    adaptive run and a fixed run on the weighted stream)."""
    edges, sources, out = group
    g = granks.weighted_graph(edges, N_GROUP, WSEED)
    pg = tc.partition_graph(g, W, **granks.WEIGHTED_BLOCKS)
    mesh = ShardMesh(W, CPU)
    res = tc.delta_sssp_batched_sharded(pg, sources, mesh=mesh)
    rep = tc.delta_sssp_batched(g, sources)
    run = tc.run_adaptive(pg, granks.WEIGHTED_METRICS, stream="weighted",
                          seed=2, mesh=mesh,
                          config=tc.AdaptiveConfig(**granks.WEIGHTED))
    fixed = tc.run_fixed(pg, granks.FIXED_N,
                         metrics=granks.WEIGHTED_METRICS, stream="weighted",
                         seed=granks.FIXED_SEED,
                         batch_size=granks.FIXED_BATCH, mesh=mesh)
    v1 = N_GROUP + 1
    for r in out:
        s = r["sssp"]
        np.testing.assert_array_equal(s["dist"], np_(mesh.all_gather(
            res.dist)))
        np.testing.assert_array_equal(s["sigma"], np_(mesh.all_gather(
            res.sigma)))
        np.testing.assert_array_equal(s["dist"][:v1], np_(rep.dist))
        np.testing.assert_array_equal(s["levels"], np_(rep.levels))
        np.testing.assert_array_equal(s["buckets"], np_(rep.buckets))
        assert s["exchange"] == res.exchange.tolist()
        a = r["adaptive"]
        assert (a["tau"], a["n_epochs"], a["bfs_levels"], a["dag_rounds"],
                a["distance_cap"]) == (run.tau, run.n_epochs,
                                       run.bfs_levels, run.dag_rounds,
                                       run.distance_cap)
        for (name, scores, tau, stop), rep_ in zip(a["reports"],
                                                   run.reports):
            assert name == rep_.name and tau == rep_.tau
            np.testing.assert_array_equal(scores, rep_.scores)
        for (name, scores, tau), rep_ in zip(r["fixed"], fixed):
            np.testing.assert_array_equal(scores, rep_.scores)


@pytest.fixture(scope="module")
def spmd(tmp_path_factory):
    root = tmp_path_factory.mktemp("weighted_spmd")
    return spawn_local(sranks.weighted_spmd, 2,
                       args=(_group_edges(), N_GROUP, WSEED), timeout=300,
                       store_dir=str(root))


def test_spmd_weighted_run_is_the_same_on_every_rank(spmd):
    """2 ranks in the hierarchical mode: the same result on both, phase 1
    the single lane's at the seed (the same vertex diameter and distance
    cap), betweenness finite in [0, 1]."""
    a, b = spmd
    assert (a["tau"], a["n_epochs"], a["vertex_diameter"],
            a["distance_cap"]) == (b["tau"], b["n_epochs"],
                                   b["vertex_diameter"], b["distance_cap"])
    for x, y in zip(a["reports"], b["reports"]):
        assert x[0] == y[0]
        np.testing.assert_array_equal(x[1], y[1])
    g = granks.weighted_graph(_group_edges(), N_GROUP, WSEED)
    est = tc.estimate_diameter_weighted(g, torch.Generator().manual_seed(1))
    assert a["distance_cap"] == est.upper > 0
    assert a["vertex_diameter"] == est.vertex_diameter
    bc = a["reports"][0][1]
    assert np.isfinite(bc).all() and (bc >= 0).all() and (bc <= 1).all()


def test_weighted_run_resumes_bitwise(jg, tmp_path):
    """Stopped after one epoch and resumed: the uninterrupted run's
    bits."""
    g = to_port(jg)
    kw = dict(metrics=("betweenness", "harmonic"), stream="weighted",
              seed=6, device=CPU)
    cfg = tc.AdaptiveConfig(eps=0.1, delta=0.1, n0_base=200)
    full = tc.run_adaptive(g, config=cfg, **kw)
    assert full.n_epochs >= 2
    ck = str(tmp_path / "ck")
    part = tc.run_adaptive(g, config=tc.AdaptiveConfig(
        eps=0.1, delta=0.1, n0_base=200, max_epochs=1), checkpoint_dir=ck,
        **kw)
    assert part.n_epochs == 1
    res = tc.run_adaptive(g, config=cfg, checkpoint_dir=ck, **kw)
    assert (res.tau, res.n_epochs) == (full.tau, full.n_epochs)
    for a, b in zip(res.reports, full.reports):
        np.testing.assert_array_equal(a.scores, b.scores)


@pytest.mark.parametrize("stream", ["forward", "weighted"])
def test_a_step_of_another_stream_raises_schema_error(jg, tmp_path,
                                                      stream):
    """The stamp names the stream: a bidirectional step of the same
    metric restores into neither a forward nor a weighted run."""
    g = to_port(jg)
    ck = str(tmp_path / "ck")
    cfg = tc.AdaptiveConfig(eps=0.1, delta=0.1, n0_base=200, max_epochs=1)
    tc.run_adaptive(g, ("betweenness",), stream="bidir", config=cfg,
                    seed=1, device=CPU, checkpoint_dir=ck)
    with pytest.raises(CheckpointSchemaError, match=":bidir:"):
        tc.run_adaptive(g, ("betweenness",), stream=stream, config=cfg,
                        seed=1, device=CPU, checkpoint_dir=ck)
