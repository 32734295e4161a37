"""The forward stream, closeness, harmonic and the fixed-count runs of
the PyTorch port, against the JAX package.

The port draws from ``torch.Generator``, so its samples are not the JAX
package's: deterministic pieces are held bitwise or at a stated
tolerance on the same inputs (distance columns, estimator hooks), the
sampler to its law, and whole runs to scipy's and Brandes' oracles with
the bounds of ``tests/test_estimators.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jc
import repro_torch.core as tc
from repro.core.estimators import get_estimator as j_get
from repro.core.estimators.base import DrawBatch as JBatch
from repro.core.estimators.base import RunContext as JCtx
from repro.core.estimators.closeness import hoeffding_omega as j_omega
from repro_torch.core.engine import (draw_fold, resolve_estimators,
                                     resolve_stream)
from repro_torch.core.estimators.base import DrawBatch as TBatch
from repro_torch.core.estimators.base import RunContext as TCtx
from repro_torch.core.estimators.closeness import hoeffding_omega as t_omega
from repro_torch.core.sampler import _finish_forward_paths
from _torch_parity import np_, to_port

# sums over the batch axis run in another order in the two libraries
RTOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The runs here are many small tensor ops: one intra-op thread keeps
    parallel test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("kind", ["er", "grid_csc", "rmat"])
def test_forward_dist_matches_jax_bfs(kind):
    """The stream's distance columns are bitwise JAX's ``bfs_sssp_batched``
    from the same sources; each drawn path has d(s, t) - 1 internal
    vertices, none of them s or t."""
    if kind == "er":
        jgraph = jc.erdos_renyi_graph(90, 2.5, seed=3)   # some unreached
    elif kind == "grid_csc":
        jgraph = jc.with_csc_layout(jc.grid_graph(9, 7), block_v=16,
                                    block_e=128)
    else:
        jgraph = jc.rmat_graph(8, 8, seed=2)
    graph = to_port(jgraph)
    ps = tc.sample_path_forward_batched(graph, _gen(7), 16)
    want = jc.bfs_sssp_batched(jgraph, jnp.asarray(np_(ps.sources)))
    np.testing.assert_array_equal(np_(ps.dist), np.asarray(want.dist))
    ids, length = np_(ps.internal), np_(ps.length)
    for b, s in enumerate(np_(ps.sources)):
        row = ids[b][ids[b] >= 0]
        if not np_(ps.valid)[b]:
            assert length[b] == -1 and row.size == 0
            continue
        assert row.size == length[b] - 1 and s not in row
        assert np.all(np_(ps.dist)[row, b] >= 1)
    assert (np_(ps.valid) == (length > 0)).all()


@pytest.mark.parametrize("kind", ["grid", "rmat"])
def test_forward_paths_are_uniform_among_shortest_paths(kind):
    """Each vertex lies on the drawn path with the exact share of the s-t
    shortest paths through it (five binomial sigmas); s and t never."""
    if kind == "grid":
        graph, s, t = tc.grid_graph(5, 4, device="cpu"), 0, 19
    else:
        graph = tc.rmat_graph(7, 6, seed=3, device="cpu")
        fs = tc.bfs_sssp(graph, 1)
        dist, sigma = np_(fs.dist)[:128], np_(fs.sigma)[:128]
        t, s = int(np.lexsort((sigma, dist))[-1]), 1
        assert sigma[t] >= 3 and dist[t] >= 3
    draws = 6000
    sv = torch.full((draws,), s, dtype=torch.int32)
    tv = torch.full((draws,), t, dtype=torch.int32)
    ps = _finish_forward_paths(graph, _gen(11), sv, tv,
                               tc.bfs_sssp_batched(graph, sv))
    ids = np_(ps.internal)
    freq = np.bincount(ids[ids >= 0], minlength=graph.n_nodes) / draws
    fs, ft = tc.bfs_sssp(graph, s), tc.bfs_sssp(graph, t)
    ds, dt = np_(fs.dist)[: graph.n_nodes], np_(ft.dist)[: graph.n_nodes]
    ss, st = (np_(x.sigma)[: graph.n_nodes].astype(np.float64)
              for x in (fs, ft))
    on = (ds + dt == ds[t]) & (ds >= 0) & (dt >= 0)
    exact = np.where(on, ss * st / ss[t], 0.0)
    exact[[s, t]] = 0.0
    assert (np_(ps.length) == ds[t]).all()
    assert freq[s] == 0 and freq[t] == 0
    sd = np.sqrt(exact * (1 - exact) / draws)
    assert (np.abs(freq - exact) <= 5 * sd + 1e-12).all()
    assert (freq[exact == 0] == 0).all()


@pytest.mark.parametrize("n,eps,delta", [(2, 0.05, 0.1), (120, 0.03, 0.1),
                                         (1 << 20, 0.01, 0.1),
                                         (5000, 0.02, 0.05)])
def test_hoeffding_omega_matches_jax_bitwise(n, eps, delta):
    got = np_(t_omega(n, eps, delta))
    want = np.asarray(j_omega(n, eps, delta))
    assert got.dtype == want.dtype == np.float32
    assert got.tobytes() == want.tobytes()


def _columns(seed=5, batch=24):
    """JAX distance columns of a graph with unreached vertices, and a
    keep mask cutting the last four samples."""
    jgraph = jc.erdos_renyi_graph(100, 2.0, seed=seed)
    rng = np.random.default_rng(seed)
    sources = rng.integers(0, 100, batch).astype(np.int32)
    dist = np.array(jc.bfs_sssp_batched(jgraph, jnp.asarray(sources)).dist)
    keep = np.arange(batch) < batch - 4
    return jgraph, dist, sources, keep


@pytest.mark.parametrize("name", ["closeness", "harmonic"])
def test_distance_estimators_match_jax(name):
    """accumulate, make_params and finalize on the same distance columns
    and keep mask: rtol 1e-6, the reached channel and omega bitwise."""
    jgraph, dist, sources, keep = _columns()
    n, b = jgraph.n_nodes, dist.shape[1]
    vd = 9
    jctx, tctx = JCtx(n, vd), TCtx(n, vd)
    jest, test_ = j_get(name), tc.get_estimator(name)
    valid = np.ones(b, bool)
    length = np.zeros(b, np.int32)
    jb = JBatch(jnp.zeros((b, n + 1)), jnp.asarray(valid),
                jnp.asarray(length), jnp.asarray(dist), jnp.asarray(sources))
    tb = TBatch(torch.full((b, 1), -1), torch.from_numpy(valid),
                torch.from_numpy(length), torch.from_numpy(dist),
                torch.from_numpy(sources))
    jacc = np.asarray(jest.accumulate(jb, jnp.asarray(keep), jctx))
    tacc = np_(test_.accumulate(tb, torch.from_numpy(keep), tctx))
    assert tacc.shape == jacc.shape == (test_.n_channels, n + 1)
    np.testing.assert_allclose(tacc, jacc, rtol=RTOL)
    if name == "closeness":
        np.testing.assert_array_equal(tacc[1], jacc[1])
    tau = int(keep.sum())
    jp = jest.make_params(None, jctx, 0.05, 0.1, jnp.asarray(jacc),
                          jnp.int32(tau))
    tp = test_.make_params(None, tctx, 0.05, 0.1, torch.from_numpy(tacc),
                           tau)
    assert np_(tp.omega).tobytes() == np.asarray(jp.omega).tobytes()
    np.testing.assert_allclose(np_(tp.log_inv_delta_l),
                               np.asarray(jp.log_inv_delta_l), rtol=RTOL)
    np.testing.assert_allclose(np_(tp.log_inv_delta_u),
                               np.asarray(jp.log_inv_delta_u), rtol=RTOL)
    np.testing.assert_allclose(
        test_.finalize(torch.from_numpy(tacc), tau, tp, tctx),
        jest.finalize(jnp.asarray(jacc), tau, jp, jctx), rtol=RTOL)
    assert test_.extras(tp, tctx).keys() == jest.extras(jp, jctx).keys()


def test_distance_estimators_refuse_the_bidirectional_stream():
    graph = tc.grid_graph(4, 4, device="cpu")
    ests = resolve_estimators(("betweenness", "closeness", "harmonic"))
    assert resolve_stream(ests) == "forward"
    assert resolve_stream(ests[:1]) == "bidir"
    assert resolve_stream(ests[:1], "forward") == "forward"
    with pytest.raises(ValueError, match="forward stream"):
        resolve_stream(ests, "bidir")
    with pytest.raises(ValueError, match="unknown stream"):
        resolve_stream(ests, "sideways")
    with pytest.raises(ValueError, match="forward stream"):
        draw_fold(graph, _gen(0), 4, estimators=ests[1:], ctx=TCtx(16, 7),
                  stream="bidir")


def _dense_distances(graph):
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import shortest_path
    n = graph.n_nodes
    indptr, indices = np_(graph.indptr), np_(graph.indices)
    adj = csr_matrix((np.ones(int(indptr[-1]), np.int8),
                      indices[: indptr[-1]], indptr), shape=(n, n))
    return shortest_path(adj, method="D", unweighted=True)


def _connected_er(n=120, deg=6.0, seed=1):
    for s in range(seed, seed + 20):
        graph = to_port(jc.erdos_renyi_graph(n, deg, seed=s))
        if np.isfinite(_dense_distances(graph)).all():
            return graph
    raise RuntimeError("no connected instance found")


def test_closeness_harmonic_match_scipy_oracle():
    """The bounds of tests/test_estimators.py on its connected ER(120)."""
    eps = 0.03
    graph = _connected_er()
    n = graph.n_nodes
    d = _dense_distances(graph)
    res = tc.run_adaptive(graph, ("closeness", "harmonic"), eps=eps,
                          delta=0.1, device="cpu")
    clo, har = res.reports
    exact_clo = (n - 1) / d.sum(axis=0)
    assert clo.converged
    rel = np.abs(clo.scores - exact_clo) / exact_clo
    assert rel.max() < 0.15, rel.max()
    assert np.corrcoef(clo.scores, exact_clo)[0, 1] > 0.99
    assert clo.extras["distance_cap"] >= d.max()
    dh = d.copy()
    np.fill_diagonal(dh, np.inf)
    exact_har = (1.0 / dh).sum(axis=0) / (n - 1)
    assert har.converged
    assert np.abs(har.scores - exact_har).max() < 2 * eps
    assert np.corrcoef(har.scores, exact_har)[0, 1] > 0.99
    assert har.omega == pytest.approx(float(j_omega(n, eps, 0.1)))


def test_multi_metric_run_equals_solo_runs():
    """One shared forward stream does not perturb any member metric: each
    report is bitwise the metric's solo run at the same seed."""
    graph = tc.erdos_renyi_graph(150, 6.0, seed=4, device="cpu")
    metrics = ("betweenness", "closeness", "harmonic")
    multi = tc.run_adaptive(graph, metrics, eps=0.05, delta=0.1, seed=3,
                            stream="forward", device="cpu")
    assert multi.n_epochs == max(r.stop_epoch for r in multi.reports)
    for rep in multi.reports:
        solo = tc.run_adaptive(graph, (rep.name,), eps=0.05, delta=0.1,
                               seed=3, stream="forward",
                               device="cpu").reports[0]
        np.testing.assert_array_equal(rep.scores, solo.scores)
        assert (rep.tau, rep.stop_epoch, rep.converged, rep.omega) == \
            (solo.tau, solo.stop_epoch, solo.converged, solo.omega)


def test_betweenness_on_the_forward_stream_within_eps():
    eps = 0.05
    graph = to_port(jc.hyperbolic_graph(150, 10.0, seed=4))
    res = tc.run_adaptive(graph, ("betweenness",), eps=eps, delta=0.1,
                          stream="forward", device="cpu")
    assert res.converged
    assert np.abs(res.reports[0].scores
                  - tc.brandes_numpy(graph)).max() < eps


def test_run_fixed_reports_every_metric():
    graph = tc.erdos_renyi_graph(80, 5.0, seed=2, device="cpu")
    reports = tc.run_fixed(graph, 64,
                           metrics=("betweenness", "closeness", "harmonic"),
                           device="cpu")
    assert [r.name for r in reports] == ["betweenness", "closeness",
                                         "harmonic"]
    for r in reports:
        assert r.tau == 64 and not r.converged and np.isnan(r.omega)
        assert r.scores.shape == (80,) and np.isfinite(r.scores).all()
    # closeness normalizes by the swept diameter bound
    assert reports[1].extras["distance_cap"] > 1
    with pytest.raises(TypeError, match="SamplerMesh"):
        tc.run_fixed(graph, 64, mesh=object(), device="cpu")


def test_run_fixed_sampling_within_eps_of_brandes():
    eps = 0.05
    graph = to_port(jc.hyperbolic_graph(150, 10.0, seed=4))
    got = tc.run_fixed_sampling(graph, 4000, seed=1, batch_size=64,
                                device="cpu")
    assert np.abs(got - tc.brandes_numpy(graph)).max() < eps


def test_sample_batch_and_sample_path():
    """``sample_batch`` is the betweenness fold of ``draw_fold``; its
    surplus frame carries into the next call."""
    graph = tc.grid_graph(6, 6, device="cpu")
    (counts, tau), (sur, sur_tau) = tc.sample_batch(
        graph, _gen(5), 10, batch_size=4, return_carry=True)
    fold = draw_fold(graph, _gen(5), 10,
                     estimators=resolve_estimators("betweenness"),
                     ctx=TCtx(36, 0), batch_size=4)
    assert (tau, sur_tau) == (10, 2)
    assert torch.equal(counts, fold.counts[0])
    assert torch.equal(sur, fold.sur_counts[0])
    c2, t2 = tc.sample_batch(graph, _gen(6), 3, batch_size=4,
                             carry=(sur, sur_tau))
    fresh, _ = tc.sample_batch(graph, _gen(6), 3, batch_size=4)
    assert t2 == 5 and torch.equal(c2, fresh + sur)
    ps = tc.sample_path(graph, _gen(1))
    assert ps.internal.dim() == 1 and bool(ps.valid)
    assert int((ps.internal >= 0).sum()) == int(ps.length) - 1
