"""Checkpointed, resumable adaptive runs of the port on the CPU, on both
lanes: a run stopped and resumed from its ``checkpoint_dir`` is bitwise
the port's uninterrupted run at the same seed (scores, tau, epochs,
converged, stop epochs).  The port's own run is the reference: its
generator's stream is not ``jax.random``'s."""
import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

import repro.core as jc
import repro_torch.core as tc
from repro.runtime.faults import corrupt_newest_step
from _torch_parity import to_port
from repro_torch.checkpoint import CheckpointSchemaError, latest_step
from repro_torch.core import AdaptiveConfig, ShardMesh
from repro_torch.core.epoch import frame_schema_id
from repro_torch.core.estimators import get_estimator

CPU = "cpu"
CFG = AdaptiveConfig(eps=0.1, delta=0.1, n0_base=60)
FWD_METRICS = ("betweenness", "closeness", "harmonic")


@pytest.fixture(autouse=True)
def _one_thread():
    """These cases are small: one intra-op thread keeps them from
    contending for the cores with the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _er60():
    return tc.erdos_renyi_graph(60, 5.0, seed=1, device=CPU)


def _same_kadabra(got, want):
    np.testing.assert_array_equal(got.btilde, want.btilde)
    assert (got.tau, got.n_epochs, got.converged) == (
        want.tau, want.n_epochs, want.converged)


def _same_reports(got, want):
    assert (got.tau, got.n_epochs, got.converged) == (
        want.tau, want.n_epochs, want.converged)
    for g, w in zip(got.reports, want.reports):
        np.testing.assert_array_equal(g.scores, w.scores)
        assert (g.tau, g.stop_epoch, g.converged) == (
            w.tau, w.stop_epoch, w.converged)


def _steps(root):
    return sorted(int(d[5:]) for d in os.listdir(root)
                  if d.startswith("step_") and d[5:].isdigit())


@pytest.fixture(scope="module")
def kadabra_full():
    full = tc.run_kadabra(_er60(), config=CFG, seed=3, device=CPU)
    assert full.converged and full.n_epochs >= 4
    return full


def _kadabra(ck, every=1, **cfg):
    return tc.run_kadabra(_er60(), config=dataclasses.replace(CFG, **cfg),
                          seed=3, device=CPU, checkpoint_dir=ck,
                          checkpoint_every=every)


def test_resume_after_two_epochs_is_bitwise(tmp_path, kadabra_full):
    """Stopped after 2 epochs (the max_epochs freeze is not
    checkpointed) and resumed with the full budget: bitwise the
    uninterrupted run.  Resuming the completed run draws nothing and
    re-reports the same result."""
    ck = str(tmp_path / "ck")
    part = _kadabra(ck, max_epochs=2)
    assert not part.converged and part.n_epochs == 2
    assert latest_step(ck) == 2
    _same_kadabra(_kadabra(ck), kadabra_full)
    assert latest_step(ck) == kadabra_full.n_epochs
    again = _kadabra(ck)
    _same_kadabra(again, kadabra_full)
    assert again.stats == []


def test_corrupt_newest_step_is_quarantined_and_resume_is_bitwise(
        tmp_path, kadabra_full):
    ck = str(tmp_path / "ck")
    _kadabra(ck, max_epochs=3)
    assert corrupt_newest_step(ck) is not None
    res = _kadabra(ck)
    assert os.path.isdir(os.path.join(ck, "step_00000003.quarantined-0"))
    _same_kadabra(res, kadabra_full)
    # the resumed run drew the epochs after step 2 again
    assert [s.epoch for s in res.stats] == list(
        range(3, kadabra_full.n_epochs + 1))


def test_checkpoint_every_two_publishes_even_epochs(tmp_path, kadabra_full):
    ck = str(tmp_path / "ck")
    _kadabra(ck, every=2, max_epochs=3)
    assert _steps(ck) == [2]
    res = _kadabra(ck, every=2)
    _same_kadabra(res, kadabra_full)
    assert _steps(ck) == list(range(2, kadabra_full.n_epochs + 1, 2))[-3:]


def test_multi_metric_resume_after_a_metric_froze(tmp_path):
    """The three-metric forward run, stopped at the epoch its first
    metric froze and resumed: the frozen snapshot comes back from the
    checkpoint, and every report is bitwise the uninterrupted run's."""
    g = tc.erdos_renyi_graph(80, 5.0, seed=2, device=CPU)
    cfg = AdaptiveConfig(eps=0.08, delta=0.1, n0_base=100)
    full = tc.run_adaptive(g, FWD_METRICS, config=cfg, seed=2, device=CPU)
    first = min(r.stop_epoch for r in full.reports)
    assert first < full.n_epochs     # one metric froze before the others
    ck = str(tmp_path / "ck")
    part = tc.run_adaptive(g, FWD_METRICS, seed=2, device=CPU,
                           config=dataclasses.replace(cfg, max_epochs=first),
                           checkpoint_dir=ck)
    assert not part.converged
    assert [r.converged for r in part.reports] == [
        r.stop_epoch == first for r in full.reports]
    resumed = tc.run_adaptive(g, FWD_METRICS, config=cfg, seed=2,
                              device=CPU, checkpoint_dir=ck)
    _same_reports(resumed, full)


def test_sharded_lane_resume_is_bitwise(tmp_path):
    g = tc.erdos_renyi_graph(120, 5.0, seed=4, device=CPU)
    pg = tc.partition_graph(g, 8, block_v=16, block_e=128)
    mesh = ShardMesh(8, CPU)
    cfg = AdaptiveConfig(eps=0.1, delta=0.1, n0_base=60)
    full = tc.run_kadabra(pg, mesh=mesh, config=cfg, seed=5)
    assert full.converged and full.n_epochs >= 3
    ck = str(tmp_path / "ck")
    part = tc.run_kadabra(pg, mesh=mesh, seed=5, checkpoint_dir=ck,
                          config=dataclasses.replace(cfg, max_epochs=2))
    assert not part.converged and latest_step(ck) == 2
    resumed = tc.run_kadabra(pg, mesh=mesh, config=cfg, seed=5,
                             checkpoint_dir=ck)
    _same_kadabra(resumed, full)
    assert [s.exchange for s in resumed.stats] == [
        s.exchange for s in full.stats[2:]]
    # a sharded step is not the single lane's state
    with pytest.raises(CheckpointSchemaError, match="sharded8"):
        tc.run_kadabra(g, config=cfg, seed=5, device=CPU, checkpoint_dir=ck)


def test_schema_stamp_names_lane_generator_and_metrics(tmp_path):
    ck = str(tmp_path / "ck")
    _kadabra(ck, max_epochs=1)
    manifest = json.loads(
        open(os.path.join(ck, "step_00000001", "manifest.json")).read())
    want = frame_schema_id([get_estimator("betweenness")], lane="single",
                           generator="cpu", stream="bidir")
    assert manifest["schema"] == want
    assert want == ("epoch-state-torch-v1:single:cpu:bidir:"
                    "betweenness[path_counts]")
    assert manifest["n_leaves"] == 10
    assert manifest["metadata"] == {"epoch": 1, "done": False}


def test_other_metric_set_raises_schema_error(tmp_path):
    """A step of another metric set raises before any shape check (the
    closeness run's counts have another channel count)."""
    ck = str(tmp_path / "ck")
    _kadabra(ck, max_epochs=1)
    with pytest.raises(CheckpointSchemaError, match="is stamped"):
        tc.run_adaptive(_er60(), ("closeness",), config=CFG, seed=3,
                        device=CPU, checkpoint_dir=ck)


def test_jax_engine_checkpoint_raises_schema_error(tmp_path):
    """A checkpoint of the JAX engine (its key is no generator state)
    is refused by its stamp, not by a shape."""
    ck = str(tmp_path / "jax")
    jg = jc.erdos_renyi_graph(60, 5.0, seed=1)
    part = jc.run_kadabra(jg, key=jax.random.PRNGKey(0),
                          config=jc.AdaptiveConfig(eps=0.2, delta=0.1,
                                                   max_epochs=1),
                          checkpoint_dir=ck)
    assert not part.converged and latest_step(ck) == 1
    with pytest.raises(CheckpointSchemaError, match="epoch-state-v2"):
        tc.run_kadabra(to_port(jg), config=CFG, seed=3, device=CPU,
                       checkpoint_dir=ck)
