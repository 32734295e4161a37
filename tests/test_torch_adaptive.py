"""The sampler and the whole slice of the PyTorch port.

The port draws from ``torch.Generator``, so its sample stream is not the
JAX package's: the sampler is held to its law (uniform pairs, uniform
shortest paths) and the end-to-end run to the (eps, delta) guarantee
against exact Brandes, and to within 2 eps of the JAX ``run_kadabra``.
"""
import os

import numpy as np
import pytest
import torch

import repro.core as jc
import repro_torch.core as tc
from repro_torch.core.engine import draw_fold, resolve_estimators
from repro_torch.core.estimators.base import RunContext
from repro_torch.core.sampler import _finish_paths
from repro_torch.kernels.frontier import launch_counts
from repro_torch.runtime import InjectedFault
from _torch_parity import np_, to_port


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def test_sample_pairs_distinct_and_uniform():
    n, draws = 7, 42_000
    s, t = tc.sample_pairs(_gen(0), n, draws)
    s, t = np_(s), np_(t)
    assert (s != t).all() and s.min() >= 0 and max(s.max(), t.max()) < n
    counts = np.bincount(s * n + t, minlength=n * n).reshape(n, n)
    off = counts[~np.eye(n, dtype=bool)]
    expect = draws / (n * (n - 1))
    chi2 = ((off - expect) ** 2 / expect).sum()
    assert chi2 < 100.0     # 41 degrees of freedom: p < 1e-6 beyond


def _path_frequencies(graph, s, t, draws, seed):
    """Internal-vertex frequencies of ``draws`` sampled s-t paths, and
    the exact fraction of shortest s-t paths through each vertex."""
    res = tc.bidirectional_bfs_batched(graph, [s] * draws, [t] * draws)
    ps = _finish_paths(graph, _gen(seed), res)
    ids = np_(ps.internal)
    freq = np.bincount(ids[ids >= 0], minlength=graph.n_nodes) / draws
    fs, ft = tc.bfs_sssp(graph, s), tc.bfs_sssp(graph, t)
    ds, dt = np_(fs.dist)[: graph.n_nodes], np_(ft.dist)[: graph.n_nodes]
    ss, st = (np_(x.sigma)[: graph.n_nodes].astype(np.float64)
              for x in (fs, ft))
    d = ds[t]
    on = (ds + dt == d) & (ds >= 0) & (dt >= 0)
    exact = np.where(on, ss * st / ss[t], 0.0)
    exact[[s, t]] = 0.0
    assert (np_(ps.length) == d).all()
    return freq, exact


@pytest.mark.parametrize("kind", ["grid", "rmat"])
def test_paths_are_uniform_among_shortest_paths(kind):
    """Each vertex lies on the drawn path with the exact share of the
    s-t shortest paths through it (five binomial sigmas)."""
    if kind == "grid":
        graph, s, t = tc.grid_graph(5, 4, device="cpu"), 0, 19
    else:
        graph = tc.rmat_graph(7, 6, seed=3, device="cpu")
        fs = tc.bfs_sssp(graph, 1)
        dist, sigma = np_(fs.dist)[:128], np_(fs.sigma)[:128]
        # the farthest vertex with the most shortest paths from vertex 1
        t = int(np.lexsort((sigma, dist))[-1])
        s = 1
        assert sigma[t] >= 3 and dist[t] >= 3
    draws = 6000
    freq, exact = _path_frequencies(graph, s, t, draws, seed=11)
    sd = np.sqrt(exact * (1 - exact) / draws)
    assert (np.abs(freq - exact) <= 5 * sd + 1e-12).all()
    assert (freq[exact == 0] == 0).all()


def test_draw_fold_carries_the_surplus_exactly():
    graph = tc.grid_graph(6, 6, device="cpu")
    ests = resolve_estimators("betweenness")
    ctx = RunContext(graph.n_nodes, 11)
    fold = draw_fold(graph, _gen(5), 10, estimators=ests, ctx=ctx,
                     batch_size=4)
    assert (fold.tau, fold.sur_tau) == (10, 2)
    # the same draws taken by hand: three rounds of four
    gen = _gen(5)
    want = torch.zeros(graph.n_nodes + 1)
    sur = torch.zeros(graph.n_nodes + 1)
    for r in range(3):
        ps = tc.sample_path_batched(graph, gen, 4)
        for b in range(4):
            ids = ps.internal[b][ps.internal[b] >= 0]
            (sur if r * 4 + b >= 10 else want)[ids] += 1.0
    assert torch.equal(fold.counts[0], want)
    assert torch.equal(fold.sur_counts[0], sur)
    # the carry lands in the next frame; a batch wider than the request
    # is clamped to it, so this one has no surplus
    carried = draw_fold(graph, _gen(6), 3, estimators=ests, ctx=ctx,
                        batch_size=4, carry=(fold.sur_counts, fold.sur_tau))
    fresh = draw_fold(graph, _gen(6), 3, estimators=ests, ctx=ctx,
                      batch_size=4)
    assert (carried.tau, carried.sur_tau) == (5, 0)
    assert torch.equal(carried.counts, fresh.counts + fold.sur_counts)


def _hyperbolic():
    return jc.hyperbolic_graph(150, 10.0, seed=4)


def test_brandes_matches_jax():
    for jgraph in (_hyperbolic(), jc.grid_graph(7, 5)):
        np.testing.assert_allclose(tc.brandes_numpy(to_port(jgraph)),
                                   jc.brandes_numpy(jgraph), rtol=1e-12,
                                   atol=1e-15)


def test_run_kadabra_within_eps_of_brandes_and_jax():
    eps = 0.05
    jgraph = _hyperbolic()
    graph = to_port(jgraph)
    exact = tc.brandes_numpy(graph)
    got = tc.run_kadabra(graph, eps=eps, delta=0.1, device="cpu")
    want = jc.run_kadabra(jgraph, eps=eps, delta=0.1)
    assert got.converged and got.tau > 0
    assert got.btilde.shape == (graph.n_nodes,)
    assert np.abs(got.btilde - exact).max() < eps
    assert np.abs(got.btilde - want.btilde).max() < 2 * eps


def test_run_kadabra_through_csc_layout():
    graph = tc.with_csc_layout(tc.grid_graph(9, 7, device="cpu"),
                               block_v=16, block_e=128)
    before = dict(launch_counts)
    res = tc.run_kadabra(graph, eps=0.05, device="cpu")
    assert np.abs(res.btilde - tc.brandes_numpy(graph)).max() < 0.05
    assert res.bfs_levels > 0 and launch_counts == before


def test_run_kadabra_seeded_and_capped():
    graph = tc.erdos_renyi_graph(80, 5.0, seed=2, device="cpu")
    cfg = tc.AdaptiveConfig(eps=0.1, n0_base=100, max_epochs=2)
    a = tc.run_kadabra(graph, config=cfg, seed=3, device="cpu")
    b = tc.run_kadabra(graph, config=cfg, seed=3, device="cpu")
    c = tc.run_kadabra(graph, config=cfg, seed=4, device="cpu")
    np.testing.assert_array_equal(a.btilde, b.btilde)
    assert not np.array_equal(a.btilde, c.btilde)
    capped = tc.run_kadabra(graph, config=tc.AdaptiveConfig(
        eps=0.001, n0_base=50, max_epochs=1), device="cpu")
    assert not capped.converged and capped.n_epochs == 1
    # one epoch: its frame of n0 samples (calibration samples are not
    # part of the estimate)
    assert capped.tau == 50 and len(capped.stats) == 1


def test_explicit_eps_delta_override_config():
    graph = tc.erdos_renyi_graph(60, 5.0, seed=1, device="cpu")
    cfg = tc.AdaptiveConfig(eps=0.05, delta=0.1, n0_base=50)
    res = tc.run_kadabra(graph, config=cfg, eps=0.2, delta=0.3,
                         device="cpu")
    assert res.omega == pytest.approx(
        float(tc.compute_omega(res.vertex_diameter, 0.2, 0.3)))


def _refuse(epoch, state):
    raise InjectedFault(f"refused epoch {epoch}")


@pytest.mark.parametrize("kwargs,error,match", [
    # item 14's hook and telemetry are ported: a hook that refuses the
    # first epoch raises before anything reaches the disk, and a
    # telemetry argument of no known form raises before a draw
    pytest.param({"checkpoint_dir": "ckpt", "on_epoch": _refuse},
                 InjectedFault, "refused epoch 1", id="kwargs0-item 14"),
    pytest.param({"on_epoch": _refuse}, InjectedFault, "refused epoch 1",
                 id="kwargs1-item 14"),
    pytest.param({"telemetry": 3}, TypeError, "telemetry must be",
                 id="kwargs2-item 14"),
    # item 13's weighted stream is ported: on a graph without weights it
    # raises before a draw
    pytest.param({"stream": "weighted"}, ValueError, "needs a graph with "
                 "weights", id="kwargs3-item 13"),
    pytest.param({"metrics": ("harmonic",), "stream": "weighted"},
                 ValueError, "needs a graph with weights",
                 id="kwargs4-item 13"),
])
def test_unported_options_raise(kwargs, error, match):
    graph = tc.grid_graph(3, 3, device="cpu")
    with pytest.raises(error, match=match):
        tc.run_adaptive(graph, device="cpu", **kwargs)
    assert not os.path.exists("ckpt")


@pytest.mark.parametrize("kwargs", [
    {"mesh": object()},
    {"metrics": ("closeness",), "mesh": object()},
])
def test_a_replicated_graph_takes_only_a_sampler_mesh(kwargs):
    """A mesh with a replicated Graph is the SPMD lane's SamplerMesh
    (tests/test_torch_spmd.py); anything else raises before a draw."""
    graph = tc.grid_graph(3, 3, device="cpu")
    with pytest.raises(TypeError, match="SamplerMesh"):
        tc.run_adaptive(graph, device="cpu", **kwargs)


def test_checkpoint_every_below_one_raises(tmp_path):
    graph = tc.grid_graph(3, 3, device="cpu")
    for every in (0, -1):
        with pytest.raises(ValueError, match="checkpoint_every"):
            tc.run_kadabra(graph, device="cpu", checkpoint_every=every,
                           checkpoint_dir=str(tmp_path / "ck"))
    assert not (tmp_path / "ck").exists()


def test_betweenness_config_matches_jax():
    """The port's configs.betweenness carries the JAX package's values,
    its adaptive config's included (the SPMD lane's ``aggregation``
    too)."""
    import dataclasses
    import repro.configs.betweenness as jcfg
    import repro_torch.configs.betweenness as tcfg
    for make in ("make_config", "make_smoke_config"):
        want, got = getattr(jcfg, make)(), getattr(tcfg, make)()
        for f in ("rmat_scale", "edge_factor", "eps", "delta"):
            assert getattr(got, f) == getattr(want, f)
        got_a = dataclasses.asdict(got.adaptive)
        want_a = dataclasses.asdict(want.adaptive)
        assert want_a["aggregation"] == "hierarchical"
        assert got_a == want_a


def test_quickstart_example_runs_on_the_cpu(capsys):
    """examples/quickstart_torch.py at 150 vertices with --device cpu:
    betweenness within eps of Brandes, three metrics on one stream."""
    import importlib.util
    path = os.path.join(os.path.dirname(__file__), "..", "examples",
                        "quickstart_torch.py")
    spec = importlib.util.spec_from_file_location("quickstart_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    # a small run: one intra-op thread keeps it from contending for the
    # cores with the suite's other workers
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = mod.main(["--device", "cpu", "--n", "150"])
    finally:
        torch.set_num_threads(n_threads)
    assert out["max_err"] < 0.05 and out["kadabra"].converged
    assert [r.name for r in out["multi"].reports] == [
        "betweenness", "closeness", "harmonic"]
    assert capsys.readouterr().out.rstrip().endswith("OK")
