"""The SPMD lane of the port (``run_adaptive`` / ``run_kadabra`` /
``run_fixed`` with ``mesh=SamplerMesh(...)``) on a 4-rank gloo group on
the CPU, over the JAX package's SPMD test graph
(``tests/test_adaptive.py``'s ``connected_watts_strogatz_graph(60, 6,
0.3, seed=0)`` on a mesh of independent samplers).

One group runs every case (``_torch_spmd_ranks.spmd_suite``); the tests
read its ranks' results.  Betweenness counts are integers in float32
below 2^24, so every aggregation order sums them exactly: the three
modes must give the same bits, and every rank rank 0's.  Accuracy is
held against the JAX package's ``brandes_numpy``.  The JAX package's
own SPMD lane is not run here (tests/test_adaptive.py runs it).
"""
import networkx as nx
import numpy as np
import pytest

import repro.core as jc
import _torch_spmd_ranks as ranks
from repro_torch.core import AdaptiveConfig, draw_fold, from_edge_list
from repro_torch.core.engine import make_agg_fn, resolve_estimators
from repro_torch.core.distributed import sampler_generator
from repro_torch.core.estimators.base import RunContext
from repro_torch.launch import spawn_local

W = 4
EPS = 0.05
RESUME_EPS = 0.03
N = 60


@pytest.fixture(scope="module")
def graph_edges():
    g = nx.connected_watts_strogatz_graph(N, 6, 0.3, seed=0)
    return np.array(g.edges(), dtype=np.int64)


@pytest.fixture(scope="module")
def suite(graph_edges, tmp_path_factory):
    root = tmp_path_factory.mktemp("spmd")
    return spawn_local(ranks.spmd_suite, W,
                       args=(graph_edges, N, str(root / "ckpt"), EPS,
                             RESUME_EPS),
                       timeout=300, store_dir=str(root))


@pytest.fixture(scope="module")
def exact(graph_edges):
    return np.asarray(jc.brandes_numpy(jc.from_edge_list(graph_edges, N)))


def _same(a: dict, b: dict) -> bool:
    return (np.array_equal(a["btilde"], b["btilde"]) and a["tau"] == b["tau"]
            and a["n_epochs"] == b["n_epochs"]
            and a["converged"] == b["converged"])


def test_every_rank_ran_on_the_mesh(suite):
    assert [r["rank"] for r in suite] == list(range(W))
    assert all(r["size"] == W and not r["staged"] for r in suite)


@pytest.mark.parametrize("mode", ranks.MODES)
def test_every_rank_returns_rank_zeros_bits(suite, mode):
    want = suite[0][("kadabra", mode)]
    for r in suite[1:]:
        assert _same(r[("kadabra", mode)], want)


@pytest.mark.parametrize("mode", ["flat", "root"])
def test_the_modes_give_the_same_bits(suite, mode):
    for r in suite:
        assert _same(r[("kadabra", mode)], r[("kadabra", "hierarchical")])


@pytest.mark.parametrize("mode", ranks.MODES)
def test_each_mode_converges_within_eps_of_brandes(suite, exact, mode):
    res = suite[0][("kadabra", mode)]
    assert res["converged"]
    assert np.abs(res["btilde"] - exact).max() < EPS


def test_epochs_record_their_aggregation(suite):
    """Each epoch's draw and wait seconds; nothing is staged on the
    CPU, where the collectives run on the frames' own device."""
    for r in suite:
        stats = r[("kadabra", "hierarchical")]["aggregation"]
        assert len(stats) == r[("kadabra", "hierarchical")]["n_epochs"]
        for s in stats:
            assert s["staged_bytes"] == 0
            assert min(s["start_s"], s["draw_s"], s["wait_s"]) >= 0


def test_a_mesh_of_one_rank_is_the_single_lane(suite):
    for r in suite:
        assert _same(r["size1"], r["single"])
        assert r["size1"]["bfs_levels"] == r["single"]["bfs_levels"]


def test_resume_after_one_epoch_is_bitwise(suite):
    for r in suite:
        assert r["resume_full"]["n_epochs"] >= 2
        assert r["resume_part"]["n_epochs"] == 1
        assert not r["resume_part"]["converged"]
        assert _same(r["resumed"], r["resume_full"])
        assert _same(r["resumed"], suite[0]["resumed"])


def test_a_damaged_newest_step_falls_back_on_every_rank(suite):
    """Rank 0 quarantines the damaged newest step and broadcasts the step
    before it; every rank redraws the last epoch and reports the
    uninterrupted run's bits."""
    for r in suite:
        assert r["quarantined"]
        assert r["newest"] == r["resume_full"]["n_epochs"]
        assert r["fallback_epochs"] == [r["newest"]]
        assert _same(r["fallback"], r["resume_full"])


def test_a_step_of_another_world_size_raises(suite):
    """Written at W = 4, read at W = 2 (ranks 0 and 1): both raise
    CheckpointSchemaError; ranks 2 and 3 took no part."""
    assert [r["w2_schema_error"] for r in suite] == [True, True, None, None]


@pytest.mark.parametrize("n", [150, 64])
def test_run_fixed_sums_the_ranks_draws(suite, graph_edges, n):
    """tau is W * ceil(n / W), and the counts are the sum of the four
    ranks' draws replayed in one process with their generators."""
    per = -(-n // W)
    g = from_edge_list(graph_edges, N, device="cpu")
    ests = resolve_estimators("betweenness")
    ctx = RunContext(N, 0)
    counts = sum(draw_fold(g, sampler_generator(5, r, "cpu"), per,
                           estimators=ests, ctx=ctx, batch_size=16).counts
                 for r in range(W))
    want = counts[0][:N].numpy() / (W * per)
    for r in suite:
        ((tau, scores),) = r["fixed"][n]
        assert tau == W * per
        assert np.array_equal(scores, want)


@pytest.mark.parametrize("mode", ranks.MODES)
def test_forward_metrics_agree_across_ranks_bitwise(suite, mode):
    want = suite[0][("forward", mode)]
    for r in suite[1:]:
        got = r[("forward", mode)]
        assert (got["tau"], got["n_epochs"]) == (want["tau"],
                                                 want["n_epochs"])
        for (n1, s1, t1, e1), (n2, s2, t2, e2) in zip(got["reports"],
                                                      want["reports"]):
            assert (n1, t1, e1) == (n2, t2, e2)
            assert np.array_equal(s1, s2)


@pytest.mark.parametrize("mode", ["flat", "root"])
def test_forward_metrics_agree_across_modes_within_rounding(suite, mode):
    """Closeness and harmonic sums are not integers: another order of
    summation moves them by float32 rounding.  The sums are of positive
    terms, each epoch adding four ranks' frames into the aggregate (four
    additions, at most u = 2^-24 relative each) and the flush four more:
    two orders differ by at most 2 x 4 (epochs + 1) u relative.  The
    stop decisions stay as they were."""
    want = suite[0][("forward", "hierarchical")]
    got = suite[0][("forward", mode)]
    assert (got["tau"], got["n_epochs"]) == (want["tau"], want["n_epochs"])
    rtol = 2 * 4 * (want["n_epochs"] + 1) * 2.0 ** -24
    for (n1, s1, t1, e1), (n2, s2, t2, e2) in zip(got["reports"],
                                                  want["reports"]):
        assert (n1, t1, e1) == (n2, t2, e2)
        np.testing.assert_allclose(s1, s2, rtol=rtol, atol=0)


def test_refusals(suite):
    for r in suite:
        assert r["device_refused"] is True
        assert "rank" in r["split_refused"] and "same" not in \
            r["split_refused"]


def test_an_unknown_aggregation_raises():
    with pytest.raises(ValueError, match="aggregation"):
        make_agg_fn(None, "ring")
    assert AdaptiveConfig().aggregation == "hierarchical"
